"""The CUDA kernels' wrappers: argument packing here, parity on the card.

This file imports no JAX, so it also runs on a GPU machine without it:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py configures JAX).  The tests
marked `gpu` skip where torch sees no CUDA device; chip_smoke.py runs the
same comparisons at the main path's shapes.
"""

import re

import numpy as np
import pytest
import torch

from skirt_tpu_torch import kernels
from skirt_tpu_torch.engine import fused_poly as tfp
from skirt_tpu_torch.ops import binned

torch.set_num_threads(2)

W = 12


def _model(device="cpu", **kw):
    from bench_torch import _build
    args = dict(nlambda=W, ncells=16, packets=1024, refill_batches=4,
                quadrature_panels=16, peel_panels=8, max_scatt=8,
                vary_lambda=True, device=device)
    args.update(kw)
    return _build(**args)


def test_poly_args_mirror_the_c_struct():
    """kernels.PolyArgs lists the fields of `struct PolyArgs` in
    csrc/fused_poly.cu in the same order (the library checks the size
    when it loads; this checks the names here)."""
    src = (kernels.CSRC / "fused_poly.cu").read_text()
    body = re.search(r"struct PolyArgs \{(.*?)\};", src, re.S).group(1)
    names = []
    for decl in body.split(";"):
        decl = re.sub(r"\[[^\]]*\]", "", decl.strip())
        if decl:
            names += [n.strip().lstrip("*") for n in
                      decl.split(None, 1)[1].replace("*", " ").split(",")]
    names = [n.split()[-1] for n in names]
    assert names == [f[0] for f in kernels.PolyArgs._fields_]


def test_kernel_args_pack_the_spec():
    run, *_ = _model()
    spec = run.spec
    a, (dens, samp) = tfp._cuda_args(spec)
    assert (dens, samp) == (1, 2)
    assert (a.W, a.npanels, a.np_peel, a.nlead, a.K) == (W, 16, 8, 2, 4)
    assert a.inv_np == np.float32(1 / 16) and a.xi == np.float32(0.5)
    for j, kvec in enumerate(spec.leaders):
        for i, d in enumerate(kvec):
            assert a.lead_k[j][i] == np.float32(d)
            assert a.lead_moving[j][i] == int(abs(d) > 1e-30)
    geom = spec.density_geometry
    assert a.dens[0] == np.float32(geom.rho0 * spec.lscale ** 3)
    assert a.samp[0] == np.float32(spec.sampler_geometry.hR)
    g = spec.grid
    assert (a.nx, a.ny, a.nz) == (g.nx, g.ny, g.nz)
    assert a.loc_inv[0] == np.float32(1.0 / g._dx[0])


def test_kernel_args_raise_beyond_the_kernel():
    run, *_ = _model(quadrature_panels=33)
    with pytest.raises(ValueError, match="quadrature_panels <= 32"):
        tfp._cuda_args(run.spec)


def test_cpu_run_launches_no_kernel():
    """On CPU tensors both wrappers take their plain versions."""
    run, zero, ell, L0 = _model(packets=128)
    before = (binned.binned_add.launches, tfp.poly_event.launches)
    t = run(7, ell, L0, zero())
    assert float(t["labs"].sum()) > 0
    assert (binned.binned_add.launches, tfp.poly_event.launches) == before


@pytest.mark.gpu
def test_binned_add_kernel_matches_plain():
    """Both K2 routes (shared-memory histogram, global atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rs = np.random.default_rng(3)
    for nbins, n in ((32768, 1 << 20), (1 << 21, 1 << 15)):
        idx = torch.from_numpy(rs.integers(-100, nbins + 100, n)
                               .astype(np.int32)).cuda()
        val = torch.from_numpy(rs.random(n).astype(np.float32)).cuda()
        before = binned.binned_add.launches
        got = binned.binned_add(torch.zeros(nbins, device="cuda"), idx, val)
        want = binned.drop_add(torch.zeros(nbins, device="cuda"), idx, val)
        assert binned.binned_add.launches == before + 1
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
def test_poly_event_kernel_matches_plain():
    """K1 against its plain version on identical inputs (dead lanes, used-up
    launch budgets, axis-parallel directions, a weight cut that fires),
    chained over a few events: discrete outputs as in
    test_torch_fused_poly, floats on every discretely agreeing lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.testing import event_agreement, event_case

    run, *_ = _model(device="cuda")
    n = 4096
    spec, u, oc, L, l0, state = event_case(run.spec, n, 1, "cuda")
    for it in range(4):
        if it:
            u = rng.uniform_open(it, (spec.n_uniform, n), "cuda")
        before = tfp.poly_event.launches
        got = tfp.poly_event(spec, u, oc, L, l0, state)
        assert tfp.poly_event.launches == before + 1
        want = tfp.poly_event_plain(spec, u, oc, L, l0, state)
        res = event_agreement(got, want)
        assert res["discrete"] >= 0.999 and res["float_bad"] == 0, (it, res)
        state = list(got["state"]) + [got["bc"]]
        L = got["Ln"]
