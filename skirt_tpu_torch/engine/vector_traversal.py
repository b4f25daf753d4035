"""Equal-panel ray decomposition for the analytic-density quadrature.

Twin of skirt_tpu/engine/vector_traversal.py (slice 1: panel_paths, used
by the emission peel of the polychromatic lifecycle).  The TPU's
`row_cumsum_mxu` matmul trick is `torch.cumsum` here.
"""

from __future__ import annotations

import torch


def panel_paths(grid, pos, direction, npanels: int):
    """Equal-length panel decomposition of the in-domain ray span.

    Returns (ds, t_exit, t_mid), each (N, P); zero-width panels for rays
    that miss the domain."""
    t0, t1 = grid.ray_span(pos, direction)
    delta = (t1 - t0) / npanels
    k = torch.arange(1, npanels + 1, dtype=pos.dtype, device=pos.device)[None, :]
    te = t0[:, None] + k * delta[:, None]
    mid = te - 0.5 * delta[:, None]
    ds = delta[:, None].expand(te.shape)
    return ds, te, mid
