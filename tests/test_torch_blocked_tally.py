"""Kernel K8 parity: the port's lambda-blocked tally against skirt_tpu's.

The port's `binned_add_lm` (which takes its plain version,
`bincount_blocked_plain`, for CPU tensors) and `lm_to_cell_major` against
skirt_tpu's, whose Pallas `_mxu_bincount_blocked` runs in interpret mode
off the TPU (as tests/test_ops.py runs it), on identical numpy inputs with
escaped (-1) and out-of-range cells and a non-zero starting tally: rtol
1e-6, atol 1e-6 (float32 sums of the same values in another order; a
scratch check against a float64 bincount found 1.3e-7 at worst).
`blocked_layout` against skirt_tpu's over a grid of shapes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import skirt_tpu.ops.binned as JB
from skirt_tpu_torch.ops import binned as TB

torch.set_num_threads(2)


def _lanes(nl, ncells, rows_pb, seed):
    n = nl * rows_pb * 128
    rs = np.random.default_rng(seed)
    cells = rs.integers(-1, ncells + 40, n).astype(np.int32)
    cells[rs.random(n) < 0.05] = -1
    vals = rs.uniform(0, 1, n).astype(np.float32)
    return cells, vals


def _numpy_tally(cells, vals, nl, ncells):
    """(ncells, nl) float64 bincount per wavelength block."""
    ref = np.zeros((ncells, nl))
    per = cells.size // nl
    for b in range(nl):
        c = cells[b * per:(b + 1) * per]
        v = vals[b * per:(b + 1) * per]
        ok = (c >= 0) & (c < ncells)
        np.add.at(ref[:, b], c[ok], v[ok])
    return ref


@pytest.mark.parametrize("nl, ncells, rows_pb", [
    (8, 1000, 16), (4, 16384, 8), (2, 20000, 8)])
def test_matches_skirt_tpu(nl, ncells, rows_pb):
    """(2, 20000, 8) gives R = 256; in each the Pallas tile divides
    nlambda."""
    cells, vals = _lanes(nl, ncells, rows_pb, seed=nl)
    Q, R, rpb = TB.blocked_layout(nl, ncells, cells.size)
    assert rpb == rows_pb and (R == 256) == (ncells > 16384)
    start = np.random.default_rng(9).random(nl * Q * R).astype(np.float32)
    want = JB.binned_add_lm(jnp.asarray(start), jnp.asarray(cells),
                            jnp.asarray(vals), nlambda=nl, ncells=ncells)
    got = TB.binned_add_lm(torch.from_numpy(start.copy()),
                           torch.from_numpy(cells), torch.from_numpy(vals),
                           nlambda=nl, ncells=ncells)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    cm = TB.lm_to_cell_major(got, nlambda=nl, ncells=ncells)
    cm_jax = JB.lm_to_cell_major(want, nlambda=nl, ncells=ncells)
    np.testing.assert_allclose(cm.numpy(), np.asarray(cm_jax), rtol=1e-6,
                               atol=1e-6)
    # and the tally itself against a float64 bincount
    ref = _numpy_tally(cells, vals, nl, ncells)
    base = start.reshape(nl, -1)[:, :ncells].T
    np.testing.assert_allclose(cm.numpy().reshape(ncells, nl) - base, ref,
                               rtol=1e-5, atol=1e-6)


def test_blocked_layout_matches_skirt_tpu():
    for nl in (1, 2, 3, 4, 7, 8, 20, 128):
        for ncells in (1, 300, 1000, 16384, 16385, 20000, 60000):
            for n in (1024, 8 * 1024, 8 * 1024 + 1, 20 * 1024, 3 * 2048,
                      1 << 17, 48 * 128 * 3):
                assert TB.blocked_layout(nl, ncells, n) == \
                    JB.blocked_layout(nl, ncells, n), (nl, ncells, n)


def test_uneven_layout_matches_numpy():
    """nlambda = 20, 1,000 cells, 8 rows of 128 lanes per block: the Pallas
    kernel tiles bpt = min(20, 128 // 8) = 16 blocks and runs 20 // 16 = 1
    grid step, so it never writes blocks 16-19 (skirt_tpu/ops/
    binned.py:174-176; NaN in interpret mode).  The port tallies every
    block, held here to a numpy bincount alone."""
    nl, ncells = 20, 1000
    cells, vals = _lanes(nl, ncells, 8, seed=11)
    Q, R, _ = TB.blocked_layout(nl, ncells, cells.size)
    got = TB.binned_add_lm(torch.zeros(nl * Q * R), torch.from_numpy(cells),
                           torch.from_numpy(vals), nlambda=nl, ncells=ncells)
    cm = TB.lm_to_cell_major(got, nlambda=nl, ncells=ncells)
    ref = _numpy_tally(cells, vals, nl, ncells)
    np.testing.assert_allclose(cm.numpy().reshape(ncells, nl), ref,
                               rtol=1e-6, atol=1e-6)
    assert (got.reshape(nl, -1)[:, ncells:] == 0).all()
    assert (ref[:, 16:].sum(axis=0) > 0).all()


def test_binned_add_lm_refuses():
    cells = torch.zeros(8 * 1024, dtype=torch.int32)
    vals = torch.ones(8 * 1024)
    Q, R, _ = TB.blocked_layout(8, 1000, 8 * 1024)
    with pytest.raises(ValueError, match="blocks"):
        TB.binned_add_lm(torch.zeros(7 * Q * R), cells[:7 * 1000], vals,
                         nlambda=7, ncells=1000)
    with pytest.raises(ValueError, match="tally of shape"):
        TB.binned_add_lm(torch.zeros(8 * Q * R - 1), cells, vals, nlambda=8,
                         ncells=1000)
    with pytest.raises(ValueError, match="differ in size"):
        TB.binned_add_lm(torch.zeros(8 * Q * R), cells, vals[:-1],
                         nlambda=8, ncells=1000)
