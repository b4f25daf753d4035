"""Elementwise helpers of the fused event kernels.

Twin of the helpers in skirt_tpu/engine/fused.py (:55-144) that the
polychromatic event (engine/fused_poly.py) uses: the truncated-exponential
sampler, the slab-test ray span, the arithmetic cell locate and the
grouping of instruments by observer direction.  These are the plain
PyTorch forms; csrc/fused_poly.cu carries the same arithmetic as
`__device__` functions.  The monochromatic fused driver (kernel K3)
belongs to a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

_BIG = 3.4e38


def _f32(v) -> float:
    return float(np.float32(v))


def _expon_cutoff(u, taumax):
    """Truncated-exponential optical-depth sample, the in-kernel form:
    no expm1/log1p, and a small-taumax branch below 1e-4 (the driver-side
    rng.expon_cutoff switches below 1e-6)."""
    tau = -torch.log(torch.clamp(1.0 - u * (1.0 - torch.exp(-taumax)),
                                 min=1e-37))
    return torch.where(taumax < 1e-4, u * taumax, torch.minimum(tau, taumax))


def _axis_span(o, d, lo, hi, tn, tf, const_d):
    """Slab-test update for one axis; const_d means d is a Python float."""
    lo32 = _f32(lo)
    hi32 = _f32(hi)
    if const_d:
        if abs(d) > 1e-30:
            inv = _f32(1.0 / d)
            ta = (lo32 - o) * inv
            tb = (hi32 - o) * inv
            near = torch.minimum(ta, tb)
            far = torch.maximum(ta, tb)
        else:
            in_slab = (o >= lo32) & (o <= hi32)
            near = torch.where(in_slab, -_BIG, _BIG)
            far = torch.where(in_slab, _BIG, -_BIG)
    else:
        moving = torch.abs(d) > 1e-30
        inv = 1.0 / torch.where(moving, d, 1.0)
        ta = (lo32 - o) * inv
        tb = (hi32 - o) * inv
        in_slab = (o >= lo32) & (o <= hi32)
        near = torch.where(moving, torch.minimum(ta, tb),
                           torch.where(in_slab, -_BIG, _BIG))
        far = torch.where(moving, torch.maximum(ta, tb),
                          torch.where(in_slab, _BIG, -_BIG))
    return torch.maximum(tn, near), torch.minimum(tf, far)


def _make_span(box):
    """Elementwise in-domain ray span (mirrors CartesianGrid.ray_span)."""
    lo = (box[0], box[1], box[2])
    hi = (box[3], box[4], box[5])

    def span(X, Y, Z, DX, DY, DZ, const_d=False):
        tn = torch.full_like(X, -_BIG)
        tf = torch.full_like(X, _BIG)
        for o, d, lo_a, hi_a in ((X, DX, lo[0], hi[0]), (Y, DY, lo[1], hi[1]),
                                 (Z, DZ, lo[2], hi[2])):
            tn, tf = _axis_span(o, d, lo_a, hi_a, tn, tf, const_d)
        t0 = torch.clamp(tn, min=0.0)
        hit = (t0 <= tf) & (tf > 0)
        t0 = torch.where(hit, t0, 0.0)
        return t0, torch.where(hit, tf, t0)

    return span


def _make_locate(grid):
    """Arithmetic point location for uniform-spacing Cartesian grids."""
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    lo = [_f32(v) for v in grid._lo]
    inv = [_f32(1.0 / d) for d in grid._dx]

    def locate(X, Y, Z):
        ix = torch.floor((X - lo[0]) * inv[0]).to(torch.int32)
        iy = torch.floor((Y - lo[1]) * inv[1]).to(torch.int32)
        iz = torch.floor((Z - lo[2]) * inv[2]).to(torch.int32)
        ok = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
              & (iz >= 0) & (iz < nz))
        return torch.where(ok, (ix * ny + iy) * nz + iz, -1)

    return locate


def _group_leaders(instruments):
    """Group instruments by observer direction; returns (leaders, lead_of)
    where leaders is a list of unit-direction tuples and lead_of[i]
    indexes into it."""
    groups = {}
    lead_of = []
    leaders = []
    for ins in instruments:
        key = tuple(np.round(np.asarray(ins.kobs, np.float64), 12))
        if key not in groups:
            groups[key] = len(leaders)
            leaders.append(tuple(float(v) for v in
                                 np.asarray(ins.kobs, np.float64)))
        lead_of.append(groups[key])
    return leaders, lead_of
