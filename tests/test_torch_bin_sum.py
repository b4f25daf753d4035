"""The per-wavelength bin sum of the mono detects on the CPU.

The port's plain version (`bin_sum_plain`) against float64 np.bincount
and skirt_tpu's one-hot matvec (`instruments._bin_sum`), on one bin,
uniform and lane % nlambda indices with dead (zero) lanes; the wrapper
`bin_sum_add` on CPU tensors: the plain version added in place, bit for
bit, out-of-range indices dropped, no kernel launched, bad types and
shapes refused.  The kernel itself is held to float64 on the card
(tests/test_torch_cuda.py, marked gpu).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skirt_tpu.instruments import instruments as JI
from skirt_tpu_torch.ops import bin_sum

torch.set_num_threads(2)

LAYOUTS = ["one-bin", "uniform", "lane"]


def _inputs(n, nlambda, layout, seed=3):
    rs = np.random.default_rng(seed)
    values = (rs.random(n) * (rs.random(n) >= 0.25)).astype(np.float32)
    ell = {"one-bin": np.full(n, nlambda // 2),
           "uniform": rs.integers(0, nlambda, n),
           "lane": np.arange(n) % nlambda}[layout].astype(np.int32)
    return values, ell


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n, nlambda", [(1, 1), (4096, 1), (4096, 8),
                                        (20000, 128), (3000, 227)])
def test_plain_matches_float64_and_skirt_tpu(n, nlambda, layout):
    """Within float32 reduction noise of the float64 sums and of
    skirt_tpu's one-hot matvec on the same inputs."""
    values, ell = _inputs(n, nlambda, layout)
    got = bin_sum.bin_sum_plain(torch.from_numpy(values),
                                torch.from_numpy(ell), nlambda).numpy()
    want = np.bincount(ell, weights=values.astype(np.float64),
                       minlength=nlambda)
    jax = np.asarray(JI._bin_sum(jnp.asarray(values), jnp.asarray(ell),
                                 nlambda))
    assert got.shape == (nlambda,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, jax, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_wrapper_adds_the_plain_sums_in_place_on_the_cpu(layout):
    """On CPU tensors bin_sum_add is tally += bin_sum_plain, bit for bit,
    in place, and launches nothing; indices outside [0, nlambda) are
    dropped."""
    nlambda = 16
    values, ell = _inputs(5000, nlambda, layout)
    ell[::7] = -1
    ell[3::11] = nlambda + 2
    v, e = torch.from_numpy(values), torch.from_numpy(ell)
    start = torch.rand(nlambda, generator=torch.Generator().manual_seed(1))
    before = dict(bin_sum.bin_sum_add.launches)
    tally = start.clone()
    assert bin_sum.bin_sum_add(tally, v, e) is tally
    assert torch.equal(tally, start + bin_sum.bin_sum_plain(v, e, nlambda))
    kept = (ell >= 0) & (ell < nlambda)
    want = np.bincount(ell[kept], weights=values[kept].astype(np.float64),
                       minlength=nlambda)
    np.testing.assert_allclose(tally.numpy(), start.numpy() + want,
                               rtol=1e-5)
    assert bin_sum.bin_sum_add.launches == before
    assert bin_sum.bin_sum_add(tally, v[:0], e[:0]) is tally


@pytest.mark.parametrize("case, error", [
    ("int64 indices", TypeError), ("float64 values", TypeError),
    ("float64 tally", TypeError), ("2-D tally", ValueError),
    ("2-D values", ValueError), ("lengths differ", ValueError)])
def test_wrapper_refuses_bad_types_and_shapes(case, error):
    tally = torch.zeros(8)
    values = torch.ones(64)
    ell = torch.zeros(64, dtype=torch.int32)
    args = {"int64 indices": (tally, values, ell.long()),
            "float64 values": (tally, values.double(), ell),
            "float64 tally": (tally.double(), values, ell),
            "2-D tally": (tally.reshape(2, 4), values, ell),
            "2-D values": (tally, values.reshape(8, 8), ell.reshape(8, 8)),
            "lengths differ": (tally, values, ell[1:])}[case]
    before = args[0].clone()
    with pytest.raises(error):
        bin_sum.bin_sum_add(*args)
    assert torch.equal(args[0], before)
