"""The CUDA kernels' wrappers: argument packing here, parity on the card.

This file imports no JAX, so it also runs on a GPU machine without it:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py configures JAX).  The tests
marked `gpu` skip where torch sees no CUDA device; chip_smoke.py runs the
same comparisons at the main path's shapes.
"""

import re
import warnings

import numpy as np
import pytest
import torch

from skirt_tpu_torch import kernels
from skirt_tpu_torch.engine import fused as tfm
from skirt_tpu_torch.engine import fused_poly as tfp
from skirt_tpu_torch.engine import fused_table as tft
from skirt_tpu_torch.engine import fused_table_poly as tftp
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


def _c_fields(source, struct):
    """Field names of `struct <struct> { ... };` in csrc/<source>."""
    src = (kernels.CSRC / source).read_text()
    body = re.search(r"struct %s \{(.*?)\};" % struct, src, re.S).group(1)
    names = []
    for decl in body.split(";"):
        decl = re.sub(r"\[[^\]]*\]", "", decl.strip())
        if decl:
            names += [n.strip().lstrip("*") for n in
                      decl.split(None, 1)[1].replace("*", " ").split(",")]
    return [n.split()[-1] for n in names]


def test_poly_args_mirror_the_c_struct():
    """kernels.PolyArgs lists the fields of `struct PolyArgs` in
    csrc/fused_poly.cu in the same order (the library checks the size
    when it loads; this checks the names here)."""
    names = _c_fields("fused_poly.cu", "PolyArgs")
    assert names == [f[0] for f in kernels.PolyArgs._fields_]


@pytest.mark.parametrize("source, struct, mirror", [
    ("common.cuh", "Geom", kernels.Geom),
    ("fused_mono.cu", "MonoArgs", kernels.MonoArgs),
    ("fused_table.cu", "TableArgs", kernels.TableArgs),
    ("fused_table_multi.cu", "TableMultiArgs", kernels.TableMultiArgs),
    ("fused_table_poly.cu", "TablePolyArgs", kernels.TablePolyArgs),
    ("fused_table_poly_multi.cu", "TablePolyMultiArgs",
     kernels.TablePolyMultiArgs)])
def test_structs_mirror_the_c_structs(source, struct, mirror):
    """kernels.Geom, MonoArgs and the table events' argument structs list
    the fields of their C structs in the same order."""
    assert _c_fields(source, struct) == [f[0] for f in mirror._fields_]


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


def test_mono_kernel_args_pack_the_spec():
    run, *_ = _model(nlambda=4, polychromatic=False)
    spec = run.spec
    a, (dens, samp) = tfm._cuda_args(spec)
    assert (dens, samp) == (1, 2)
    assert (a.nlambda, a.H, a.npanels, a.np_peel, a.nlead, a.K) == \
        (4, 1, 16, 8, 2, 4)
    assert a.u_comp == 5 + 4 + 2 and spec.n_uniform == 11
    assert a.xi == np.float32(0.5) and a.one_m_xi == np.float32(0.5)
    geom = spec.density_geometries[0]
    assert a.dens[0] == np.float32(geom.rho0 * spec.lscale ** 3)
    assert a.samp[0] == np.float32(spec.sampler_geometry.hR)
    assert a.lead_k[1][0] == np.float32(spec.leaders[1][0])
    assert a.nx == spec.grid.nx and a.invL == np.float32(spec.invL)
    assert spec.tab.shape == (3, 4)


def _table_model(lanes=64, **kw):
    """Config 3 (bench_torch's octree torus) at max_level 4: 16^3 voxels."""
    from bench_torch import _octree_build
    args = dict(polychromatic=False, max_level=4, refill_batches=2,
                quadrature_panels=16, peel_panels=8)
    args.update(kw)
    return _octree_build(lanes, **args)


def _multi_model(lanes=64, **kw):
    """The two-component table model (bench_torch._multi_model, 16^3
    voxels)."""
    from bench_torch import _octree_build
    args = dict(polychromatic=False, refill_batches=2)
    args.update(kw)
    return _octree_build(lanes, multi=True, **args)


def _voronoi_model(lanes=64, **kw):
    """Config 4 (bench_torch's Voronoi model) at 300 sites, on the exact
    tessellation by default (the direct table: K4d, K6d)."""
    from bench_torch import _octree_build
    args = dict(voronoi=True, nsites=300, direct=True, polychromatic=False,
                refill_batches=2, quadrature_panels=16, peel_panels=8)
    args.update(kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the staged-peel downgrade
        return _octree_build(lanes, **args)


def test_direct_kernels_refuse_more_panels_than_registers():
    """K4d and K6d keep their panels in registers (MAXP = 32): past it the
    wrappers raise naming quadrature_panels and the limit, before any
    launch and without running the plain version in its place."""
    from skirt_tpu_torch.testing import (table_event_inputs,
                                         table_poly_state, table_state)

    for poly, event in ((False, tft._table_event_cuda),
                        (True, tftp._table_poly_event_cuda)):
        run, *_, model = _voronoi_model(polychromatic=poly,
                                        quadrature_panels=33)
        spec, ds = run.spec, model[1]
        assert spec.npanels == 33 and not spec.arith_locate
        inp = table_event_inputs(ds, 64, spec.n_uniform, 2, npanels=33)
        if poly:
            args = (inp["rows"], torch.from_numpy(spec.oc), inp["L"],
                    inp["L0"], table_poly_state(inp))
        else:
            kr, state = table_state(inp, ds)
            args = (kr, state)
        with pytest.raises(ValueError, match="quadrature_panels <= 32"):
            event(spec, inp["u"], *args)


def test_table_locate_args_pack_the_grid():
    """The K4 / K6 deposit locate reads the voxel grid's float32 lower
    corner and inverse spacing, as the plain locate does."""
    run, *_, model = _table_model()
    grid = model[0]
    a = kernels.Geom()
    tft._locate_args(a, grid)
    assert (a.nx, a.ny, a.nz) == (16, 16, 16)
    for i in range(3):
        assert a.loc_lo[i] == np.float32(grid._lo[i])
        assert a.loc_inv[i] == np.float32(1.0 / grid._dx[i])
    assert tftp._sum_block(24) == 24 and tftp._sum_block(128) == 32
    assert tftp._sum_block(48) == 24 and tftp._sum_block(7) == 7


def test_kernel_args_raise_beyond_the_kernel():
    run, *_ = _model(quadrature_panels=33)
    with pytest.raises(ValueError, match="quadrature_panels <= 32"):
        tfp._cuda_args(run.spec)
    run, *_ = _model(quadrature_panels=33, nlambda=4, polychromatic=False)
    with pytest.raises(ValueError, match="quadrature_panels <= 32"):
        tfm._cuda_args(run.spec)


def test_cpu_run_launches_no_kernel():
    """On CPU tensors the wrappers take their plain versions."""
    def counts():
        return (binned.binned_add.launches, tfp.poly_event.launches,
                tfm.mono_event.launches, tft.table_event.launches,
                tft.table_event.direct_launches,
                tft.table_multi_event.launches,
                tftp.table_poly_event.launches,
                tftp.table_poly_event.direct_launches,
                tftp.table_poly_multi_event.launches)

    before = counts()
    for poly in (True, False):
        run, zero, ell, L0 = _model(packets=128, polychromatic=poly)
        t = run(7, ell, L0, zero())
        assert float(t["labs"].sum()) > 0
        for build in (_table_model, _multi_model, _voronoi_model):
            run, zero, ell, L0, *_ = build(polychromatic=poly)
            t = run(7, ell, L0, zero())
            assert float(t["labs"].sum()) > 0
    assert counts() == before


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


@pytest.mark.gpu
@pytest.mark.parametrize("nlambda, ncomp", [(4, 1), (2, 2), (128, 1)],
                         ids=["W4", "two-components", "lam-inputs-128"])
def test_mono_event_kernel_matches_plain(nlambda, ncomp):
    """K3 against its plain version on identical inputs (dead lanes,
    used-up launch budgets, axis-parallel directions, a weight cut that
    fires), chained over a few events, with one or two dust components
    and compile-time or per-lane tables: discrete outputs as in
    test_torch_fused, floats on every discretely agreeing lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.testing import event_agreement, mono_event_case

    run, *_ = _model(nlambda=nlambda, ncomp=ncomp, polychromatic=False,
                     device="cuda")
    n = 4096
    spec, u, state = mono_event_case(run.spec, n, 1, "cuda")
    for it in range(4):
        if it:
            u = rng.uniform_open(it, (spec.n_uniform, n), "cuda")
        before = tfm.mono_event.launches
        got = tfm.mono_event(spec, u, state)
        assert tfm.mono_event.launches == before + 1
        want = tfm.mono_event_plain(spec, u, state)
        res = event_agreement(got, want)
        assert res["discrete"] >= 0.999 and res["float_bad"] == 0, (it, res)
        state = list(got["state"]) + state[9:11] + [got["bc"]]


def _chain_table_events(kernel, plain, spec, u, rows, state, args, restage,
                        events=4):
    """Hold a table event kernel against its plain version over a few
    chained events, re-staging the panels between them; returns the
    outputs of the last event."""
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.testing import event_agreement

    n = state[0].shape[0]
    for it in range(events):
        if it:
            u = rng.uniform_open(it, (spec.n_uniform, n), "cuda")
        before = kernel.launches
        got = kernel(spec, u, rows, *args(), state)
        assert kernel.launches == before + 1
        want = plain(spec, u, rows, *args(), state)
        res = event_agreement(got, want)
        assert res["discrete"] >= 0.999 and res["float_bad"] == 0, (it, res)
        rows, state = restage(got, state)
    return got


@pytest.mark.gpu
def test_table_event_kernel_matches_plain():
    """K4 against its plain version on identical inputs (dead lanes, lanes
    with optical depths below 1e-3, a weight cut that fires, deposits
    outside the grid), chained over a few events."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from skirt_tpu_torch.testing import (table_event_inputs, table_restage,
                                         table_state)

    run, *_, model = _table_model(device="cuda")
    grid, ds = model[0], model[1]
    spec = dataclasses.replace(run.spec, min_scatt=1,
                               inv_minred=float(np.float32(0.01)))
    inp = table_event_inputs(ds, 4096, 5, 2, seed=1, npanels=16,
                             small_tau=0.02, outside=0.02, device="cuda")
    kr, state = table_state(inp, ds)
    kext_pk = ds.packet_kappas(state[9])[1]

    def restage(got, state):
        st = got["state"]
        kr, t0, dt = table_restage(grid, ds, torch.stack(st[:3], -1),
                                   torch.stack(st[3:6], -1), 16, kext_pk)
        return kr, list(st) + [state[9], state[10], t0, dt, state[13],
                               state[14]]

    _chain_table_events(tft.table_event, tft.table_event_plain, spec,
                        inp["u"], kr, state, lambda: (), restage)


@pytest.mark.gpu
@pytest.mark.parametrize("W", [2, 24])
def test_table_poly_event_kernel_matches_plain(W):
    """K6 against its plain version on identical inputs, chained over a
    few events, the lanes' luminosities carried from event to event."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from skirt_tpu_torch.testing import (table_event_inputs,
                                         table_poly_state, table_restage)

    run, *_, model = _table_model(device="cuda", nlambda=W,
                                  polychromatic=True)
    grid, ds = model[0], model[1]
    spec = dataclasses.replace(run.spec, min_scatt=1,
                               inv_minred=float(np.float32(0.01)))
    n = 4096
    inp = table_event_inputs(ds, n, 7, W, seed=W, npanels=16,
                             small_tau=0.02, outside=0.02, device="cuda")
    oc = torch.as_tensor(spec.oc, device="cuda")
    lum = {"L": inp["L"]}
    ones = [torch.ones(n, device="cuda")]

    def restage(got, state):
        st = got["state"]
        lum["L"] = got["Ln"]
        r, t0, dt = table_restage(grid, ds, torch.stack(st[:3], -1),
                                  torch.stack(st[3:6], -1), 16, ones)
        return r, list(st) + [t0, dt]

    _chain_table_events(tftp.table_poly_event, tftp.table_poly_event_plain,
                        spec, inp["u"], inp["rows"], table_poly_state(inp),
                        lambda: (oc, lum["L"], inp["L0"]), restage)


@pytest.mark.gpu
def test_table_multi_event_kernel_matches_plain():
    """K5 against its plain version on identical inputs (dead lanes, lanes
    with optical depths below 1e-3, a weight cut that fires, deposits
    outside the grid), chained over a few events with both panel sums
    re-staged between them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from skirt_tpu_torch.testing import (table_event_inputs,
                                         table_multi_state, table_restage)

    run, *_, model = _multi_model(device="cuda")
    grid, ds = model[0], model[1]
    spec = dataclasses.replace(run.spec, min_scatt=1,
                               inv_minred=float(np.float32(0.01)))
    P = spec.npanels
    inp = table_event_inputs(ds, 4096, 3, 2, seed=5, npanels=P,
                             small_tau=0.02, outside=0.02, device="cuda")
    kr, ks, state = table_multi_state(inp, ds)
    ksca_pk, kext_pk = ds.packet_kappas(state[9])

    def restage(got, state):
        st = got["state"]
        # the torch-side scatter leaves the direction; keep it
        kr, ks, t0, dt = table_restage(grid, ds, torch.stack(st[:3], -1),
                                       torch.stack(state[3:6], -1), P,
                                       kext_pk, ksca_pk)
        return (kr, ks), list(st[:3]) + state[3:6] + [
            st[3], st[4], state[8] + st[4], state[9], state[10], t0, dt]

    def kernel(spec, u, rows, state):
        return tft.table_multi_event(spec, u, *rows, state)

    def plain(spec, u, rows, state):
        return tft.table_multi_event_plain(spec, u, *rows, state)

    _chain_table_events(_Counted(kernel, tft.table_multi_event), plain, spec,
                        inp["u"], (kr, ks), state, lambda: (), restage)


class _Counted:
    """A kernel call with the launch count of the wrapper it calls."""

    def __init__(self, fn, wrapper):
        self.fn, self.wrapper = fn, wrapper

    def __call__(self, *a):
        return self.fn(*a)

    @property
    def launches(self):
        return self.wrapper.launches


@pytest.mark.gpu
@pytest.mark.parametrize("W", [2, 24])
def test_table_poly_multi_event_kernel_matches_plain(W):
    """K7 against its plain version on identical inputs, chained over a
    few events, the lanes' luminosities carried from event to event."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from skirt_tpu_torch.testing import (table_event_inputs,
                                         table_poly_state, table_restage)

    run, *_, model = _multi_model(device="cuda", polychromatic=True)
    grid, ds = model[0], model[1]
    spec = dataclasses.replace(run.spec, min_scatt=1,
                               inv_minred=float(np.float32(0.01)))
    if W != spec.W:
        # the kernel at a wider W: the two mixes' constants repeated
        spec = dataclasses.replace(
            spec, W=W, inv_W=float(np.float32(1.0 / W)),
            oc=np.ascontiguousarray(np.repeat(spec.oc, W // spec.W, 1)))
    P = spec.npanels
    n = 4096
    inp = table_event_inputs(ds, n, 8, W, seed=W + 1, npanels=P,
                             small_tau=0.02, outside=0.02, device="cuda")
    oc = torch.as_tensor(spec.oc, device="cuda")
    lum = {"L": inp["L"]}

    def restage(got, state):
        st = got["state"]
        lum["L"] = got["Ln"]
        r, t0, dt = table_restage(grid, ds, torch.stack(st[:3], -1),
                                  torch.stack(st[3:6], -1), P, None)
        return r, list(st) + [t0, dt]

    _chain_table_events(tftp.table_poly_multi_event,
                        tftp.table_poly_multi_event_plain, spec, inp["u"],
                        inp["rows"], table_poly_state(inp),
                        lambda: (oc, lum["L"], inp["L0"]), restage)


@pytest.mark.gpu
def test_table_event_direct_kernel_matches_plain():
    """K4d against its plain version on the 300-site tessellation (dead
    lanes, optical depths below 1e-3, a weight cut that fires, deposits
    outside the grid), chained over a few events; each launch counted as
    a K4d launch too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from skirt_tpu_torch.testing import (table_event_inputs, table_restage,
                                         table_state)

    run, *_, model = _voronoi_model(device="cuda")
    grid, ds = model[0], model[1]
    spec = dataclasses.replace(run.spec, min_scatt=1,
                               inv_minred=float(np.float32(0.01)))
    assert not spec.arith_locate
    inp = table_event_inputs(ds, 4096, 5, 2, seed=3, npanels=16,
                             small_tau=0.02, outside=0.02, device="cuda")
    kr, state = table_state(inp, ds)
    kext_pk = ds.packet_kappas(state[9])[1]

    def restage(got, state):
        st = got["state"]
        kr, t0, dt = table_restage(grid, ds, torch.stack(st[:3], -1),
                                   torch.stack(st[3:6], -1), 16, kext_pk)
        return kr, list(st) + [state[9], state[10], t0, dt, state[13],
                               state[14]]

    before = tft.table_event.direct_launches
    got = _chain_table_events(tft.table_event, tft.table_event_plain, spec,
                              inp["u"], kr, state, lambda: (), restage)
    assert tft.table_event.direct_launches == before + 4
    assert "depi" not in got and (got["depd"] >= 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("W", [2, 8])
def test_table_poly_event_direct_kernel_matches_plain(W):
    """K6d against its plain version on the 300-site tessellation, chained
    over a few events, the lanes' luminosities carried from event to
    event."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from skirt_tpu_torch.testing import (table_event_inputs,
                                         table_poly_state, table_restage)

    run, *_, model = _voronoi_model(device="cuda", nlambda=W,
                                    polychromatic=True)
    grid, ds = model[0], model[1]
    spec = dataclasses.replace(run.spec, min_scatt=1,
                               inv_minred=float(np.float32(0.01)))
    assert not spec.arith_locate
    n = 4096
    inp = table_event_inputs(ds, n, 7, W, seed=W + 3, npanels=16,
                             small_tau=0.02, outside=0.02, device="cuda")
    oc = torch.as_tensor(spec.oc, device="cuda")
    lum = {"L": inp["L"]}
    ones = [torch.ones(n, device="cuda")]

    def restage(got, state):
        st = got["state"]
        lum["L"] = got["Ln"]
        r, t0, dt = table_restage(grid, ds, torch.stack(st[:3], -1),
                                  torch.stack(st[3:6], -1), 16, ones)
        return r, list(st) + [t0, dt]

    before = tftp.table_poly_event.direct_launches
    got = _chain_table_events(tftp.table_poly_event,
                              tftp.table_poly_event_plain, spec, inp["u"],
                              inp["rows"], table_poly_state(inp),
                              lambda: (oc, lum["L"], inp["L0"]), restage)
    assert tftp.table_poly_event.direct_launches == before + 4
    assert torch.equal(got["depd"] >= 0, got["depi"] >= 0)


@pytest.mark.gpu
@pytest.mark.parametrize("W, direct", [(2, False), (24, False), (8, True)],
                         ids=["W2", "W24", "direct-W8"])
def test_table_poly_event_pol_kernel_matches_plain(W, direct):
    """K6p (K6, or K6d on the 300-site tessellation, with I_s and I_tot
    out) against its plain version, chained over a few events: every
    output bit-identical, the column densities included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from skirt_tpu_torch import rng
    from skirt_tpu_torch.testing import table_poly_case, table_restage

    build = _voronoi_model if direct else _table_model
    run, *_, model = build(device="cuda", nlambda=W, polychromatic=True)
    grid, ds = model[0], model[1]
    spec = dataclasses.replace(run.spec, min_scatt=1, want_pol=True,
                               inv_minred=float(np.float32(0.01)))
    assert spec.arith_locate is not direct
    n = 4096
    (u, r, oc, L, L0, state), _ = table_poly_case(
        spec, ds, n, seed=W + 5, device="cuda", small_tau=0.02,
        outside=0.02)
    ones = [torch.ones(n, device="cuda")]
    for it in range(4):
        if it:
            u = rng.uniform_open(it, (spec.n_uniform, n), "cuda")
        before = tftp.table_poly_event.pol_launches
        got = tftp.table_poly_event(spec, u, r, oc, L, L0, state)
        assert tftp.table_poly_event.pol_launches == before + 1
        want = tftp.table_poly_event_plain(spec, u, r, oc, L, L0, state)
        assert sorted(got) == sorted(want)
        for a, b in zip(got["state"], want["state"]):
            assert torch.equal(a, b), it
        for k in want:
            if k != "state":
                assert torch.equal(got[k], want[k]), (it, k)
        st = got["state"]
        L = got["Ln"]
        r, t0, dt = table_restage(grid, ds, torch.stack(st[:3], -1),
                                  torch.stack(st[3:6], -1), 16, ones)
        state = list(st) + [t0, dt]



@pytest.mark.gpu
@pytest.mark.parametrize("nl, ncells, rows_pb", [
    (128, 16384, 8), (20, 1000, 8), (2, 60000, 16)],
    ids=["flagship", "uneven", "global-route"])
def test_binned_add_lm_kernel_matches_plain(nl, ncells, rows_pb):
    """K8 against its plain version: the flagship layout (shared route),
    one where skirt_tpu's tiles do not divide nlambda, and one whose slice
    exceeds shared memory (global atomics); dropped lanes, a random
    starting tally; rtol 1e-4 (atomics add in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rs = np.random.default_rng(nl)
    n = nl * rows_pb * 128
    cells = torch.from_numpy(rs.integers(-9, ncells + 9, n)
                             .astype(np.int32)).cuda()
    vals = torch.from_numpy(rs.random(n).astype(np.float32)).cuda()
    Q, R, _ = binned.blocked_layout(nl, ncells, n)
    start = torch.rand(nl * Q * R, device="cuda")
    before = binned.binned_add_lm.launches
    got = binned.binned_add_lm(start.clone(), cells, vals, nlambda=nl,
                               ncells=ncells)
    assert binned.binned_add_lm.launches == before + 1
    want = binned.bincount_blocked_plain(start.clone(), cells, vals,
                                         nlambda=nl, ncells=ncells)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    route = kernels.library().skirt_binned_blocked_route(Q * R)
    assert route == (Q * R * 4 <= 227 * 1024)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["l2", "smem"])
@pytest.mark.parametrize("T, steps", [(16384, 0), (32768, 0), (128, 0),
                                      (16384, 64)])
def test_table_gather_kernel_matches_plain(route, T, steps):
    """PG against its plain version, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from skirt_tpu_torch.experiments import gather

    tab = torch.from_numpy(gather.tables_like_jax(T)).cuda()
    idx = torch.randint(0, T, (1 << 16,), device="cuda", dtype=torch.int32)
    before = gather.table_gather.launches
    got = gather.table_gather(tab, idx, steps=steps, route=route)
    assert gather.table_gather.launches == before + 1
    assert torch.equal(got, gather.table_gather_plain(tab, idx, steps=steps))


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    "P11 split=False group8=True", "P11 split=True group8=True",
    "P12 onehot", "P12 matmul", "P13 mm_pure", "P13 oh_slice",
    "P14 kern_unroll1_mm4"])
def test_onehot_gather_kernel_matches_plain(name):
    """PO against its plain version at every stage, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from skirt_tpu_torch.experiments import onehot_gather as po

    v = po.variant(name)
    t = po.tables_like_jax()
    th, tl, bfix = (torch.from_numpy(t[k]).cuda().to(torch.bfloat16)
                    for k in ("tab_hi", "tab_lo", "bfix"))
    idx = torch.randint(0, po.T, (2048, 128), device="cuda",
                        dtype=torch.int32)
    kw = dict(stage=v.stage, js=v.js, nmm=v.nmm,
              tab_lo=tl if v.split else None,
              bfix=bfix if v.stage == "fixed_B" else None)
    before = po.onehot_gather.launches
    got = po.onehot_gather(th, idx, **kw)
    assert po.onehot_gather.launches == before + 1
    assert torch.equal(got, po.onehot_gather_plain(th, idx, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("M, K, N, bf16, inner", [
    (128, 128, 128, True, 1), (256, 128, 1024, True, 8),
    (256, 128, 1024, False, 1), (512, 512, 512, True, 1)])
def test_mm_kernel_matches_plain(M, K, N, bf16, inner):
    """PM against its plain version within mm.tolerance (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from skirt_tpu_torch.experiments import mm

    torch.backends.cuda.matmul.allow_tf32 = False
    dt = torch.bfloat16 if bf16 else torch.float32
    a, b = (t.cuda() for t in mm.tables_like_jax(M, K, N, dt))
    before = mm.mm.launches
    got = mm.mm(a, b, inner=inner)
    assert mm.mm.launches == before + 1
    err = (got - mm.mm_plain(a, b, inner=inner)).abs()
    assert bool((err <= mm.tolerance(a, b, inner)).all())


@pytest.mark.gpu
def test_new_wrappers_refuse_wrong_dtype_or_device():
    """K8, PG, PO and PM raise on a CUDA tensor of the wrong type and on
    tensors split over the CPU and the card; none falls back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from skirt_tpu_torch.experiments import gather, mm, onehot_gather

    Q, R, _ = binned.blocked_layout(8, 1000, 8 * 1024)
    cells = torch.zeros(8 * 1024, dtype=torch.int32, device="cuda")
    vals = torch.ones(8 * 1024, device="cuda")
    tally = torch.zeros(8 * Q * R, device="cuda")
    with pytest.raises(TypeError):
        binned.binned_add_lm(tally, cells.long(), vals, nlambda=8,
                             ncells=1000)
    with pytest.raises(ValueError):
        binned.binned_add_lm(tally, cells.cpu(), vals, nlambda=8,
                             ncells=1000)
    tab = torch.ones(64, device="cuda")
    idx = torch.zeros(64, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        gather.table_gather(tab.double(), idx)
    with pytest.raises(ValueError):
        gather.table_gather(tab, idx.cpu())
    th = torch.ones(256, 128, dtype=torch.bfloat16, device="cuda")
    rows = torch.zeros(8, 128, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        onehot_gather.onehot_gather(th.float(), rows)
    with pytest.raises(ValueError):
        onehot_gather.onehot_gather(th, rows.cpu())
    a = torch.ones(64, 32, dtype=torch.bfloat16, device="cuda")
    b = torch.ones(32, 64, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(TypeError):
        mm.mm(a, b.float())
    with pytest.raises(ValueError):
        mm.mm(a, b.cpu())
