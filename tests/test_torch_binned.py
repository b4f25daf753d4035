"""Kernel K2 parity: the port's binned scatter-add against skirt_tpu's.

The port's `drop_add` (the plain version) and `binned_add` (its wrapper,
which takes the plain version for CPU tensors) against np.add.at,
skirt_tpu's `drop_add`, and skirt_tpu's Pallas `_mxu_bincount` run in
interpret mode (as tests/test_ops.py runs it).  Cases cover negative,
>= nbins and padding indices.  Exact for integer-valued data; rtol 1e-5
otherwise (float32 sums taken in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import skirt_tpu.ops.binned as JB
from skirt_tpu_torch.ops import binned as TB

torch.set_num_threads(2)


def _cases():
    rs = np.random.default_rng(7)
    out = {}
    nbins = 300
    idx = rs.integers(-40, nbins + 40, 5000).astype(np.int32)
    out["oob_int"] = (nbins, idx, rs.integers(0, 5, idx.size).astype(np.float32))
    out["oob_float"] = (nbins, idx, rs.random(idx.size).astype(np.float32))
    # the lifecycle's padding: -1 sentinels for escaped / padded lanes
    idx = np.concatenate([rs.integers(0, 4096, 3000), np.full(1000, -1)])
    out["padded"] = (4096, idx.astype(np.int32),
                     rs.random(idx.size).astype(np.float32))
    # a frame-detect shaped update: W rows sharing one pixel per lane
    W, npix, n = 8, 64, 512
    pix = rs.integers(-1, npix, n)
    idx = np.where(pix[None] >= 0, np.arange(W)[:, None] * npix + pix[None], -1)
    out["frame"] = (W * npix, idx.reshape(-1).astype(np.int32),
                    rs.random(idx.size).astype(np.float32))
    return out


CASES = _cases()


def _want(nbins, idx, val):
    want = np.zeros(nbins, np.float64)
    ok = (idx >= 0) & (idx < nbins)
    np.add.at(want, idx[ok], val[ok].astype(np.float64))
    return want


def _tol(val):
    exact = np.all(val == np.round(val))
    return dict(rtol=0, atol=0) if exact else dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fn", ["drop_add", "binned_add"])
def test_matches_numpy(case, fn):
    nbins, idx, val = CASES[case]
    tally = torch.zeros(nbins, dtype=torch.float32)
    got = getattr(TB, fn)(tally, torch.from_numpy(idx), torch.from_numpy(val))
    assert got is tally                     # updated in place
    np.testing.assert_allclose(got.numpy(), _want(nbins, idx, val), **_tol(val))


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_drop_add(case):
    nbins, idx, val = CASES[case]
    want = np.asarray(JB.drop_add(jnp.zeros(nbins, jnp.float32),
                                  jnp.asarray(idx), jnp.asarray(val)))
    got = TB.binned_add(torch.zeros(nbins, dtype=torch.float32),
                        torch.from_numpy(idx), torch.from_numpy(val)).numpy()
    np.testing.assert_allclose(got, want, **_tol(val))


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_pallas_bincount(case, monkeypatch):
    """skirt_tpu's binned_add on the TPU path: drop out-of-range updates,
    then the one-hot contraction kernel (interpret mode)."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp)
    nbins, idx, val = CASES[case]
    R = 128 if nbins <= 128 * 128 else 256
    Q = JB._ceil_to(-(-nbins // R), 8)
    ok = (idx >= 0) & (idx < nbins)
    want = np.asarray(JB._mxu_bincount(
        jnp.asarray(np.where(ok, idx, 0)), jnp.asarray(np.where(ok, val, 0)),
        nbins_padded=Q * R, R=R, Q=Q))[:nbins]
    got = TB.binned_add(torch.zeros(nbins, dtype=torch.float32),
                        torch.from_numpy(idx), torch.from_numpy(val)).numpy()
    np.testing.assert_allclose(got, want, **_tol(val))


def test_accumulates_and_counts_no_cpu_launch():
    nbins, idx, val = CASES["oob_int"]
    before = TB.binned_add.launches
    tally = torch.zeros(nbins, dtype=torch.float32)
    for _ in range(3):
        TB.binned_add(tally, torch.from_numpy(idx), torch.from_numpy(val))
    np.testing.assert_array_equal(tally.numpy(), 3 * _want(nbins, idx, val))
    assert TB.binned_add.launches == before
