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
from skirt_tpu_torch.engine import common as tcm
from skirt_tpu_torch.engine import fused as tfm
from skirt_tpu_torch.engine import fused_poly as tfp
from skirt_tpu_torch.engine import fused_table as tft
from skirt_tpu_torch.engine import fused_table_poly as tftp
from skirt_tpu_torch.experiments import mm
from skirt_tpu_torch.ops import bin_sum, binned

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


class _RecordingLibrary:
    """Stands in for the kernel library on the CPU: every entry point
    records the argument struct it was handed and returns 0 without a
    launch, so the wrappers' packing and route choice run here."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(args, *rest):
            self.calls.append((name, getattr(args, "_obj", args), rest))
            return 0
        return entry


@pytest.fixture
def recorded(monkeypatch):
    lib = _RecordingLibrary()
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    return lib


@pytest.mark.parametrize("P", [33, 84, 280])
def test_direct_kernels_refuse_more_panels_than_registers(recorded, P):
    """K4d and K6d past MAXP = 32 panels (84 on the main grid, 280 on
    33,000 Voronoi sites): the wrappers no longer refuse; they pack the
    panel count and a chunk scratch array of nchunks(P) rows for the
    kernels' chunked route."""
    from skirt_tpu_torch.testing import (table_event_inputs,
                                         table_poly_state, table_state)

    for poly, event in ((False, tft._table_event_cuda),
                        (True, tftp._table_poly_event_cuda)):
        run, *_, model = _voronoi_model(polychromatic=poly,
                                        quadrature_panels=P)
        spec, ds = run.spec, model[1]
        assert spec.npanels == P and not spec.arith_locate
        inp = table_event_inputs(ds, 64, spec.n_uniform, 2, npanels=P)
        if poly:
            args = (inp["rows"], torch.from_numpy(spec.oc), inp["L"],
                    inp["L0"], table_poly_state(inp))
        else:
            kr, state = table_state(inp, ds)
            args = (kr, state)
        event(spec, inp["u"], *args)
        name, a, _ = recorded.calls[-1]
        assert name == ("skirt_table_poly_event" if poly
                        else "skirt_table_event")
        assert a.npanels == P and a.direct == 1 and a.cend
        assert tft.chunk_rows(P) == kernels.nchunks(P) == -(-P // 32)
    assert tft.chunk_rows(32) == 0


def test_table_locate_args_pack_the_grid():
    """The K4 / K6 deposit locate reads the voxel grid's float32 lower
    corner and inverse spacing, as the plain locate does."""
    run, *_, model = _table_model()
    grid = model[0]
    a = kernels.Geom()
    tcm._locate_args(a, grid)
    assert (a.nx, a.ny, a.nz) == (16, 16, 16)
    for i in range(3):
        assert a.loc_lo[i] == np.float32(grid._lo[i])
        assert a.loc_inv[i] == np.float32(1.0 / grid._dx[i])
    assert tftp._sum_block(24) == 24 and tftp._sum_block(128) == 32
    assert tftp._sum_block(48) == 24 and tftp._sum_block(7) == 7


@pytest.mark.parametrize("P", [33, 84, 280])
def test_kernel_args_raise_beyond_the_kernel(P):
    """K1 and K3 past MAXP = 32 panels pack the arguments and pick the
    chunked route (scratch rows: the panel chunks, and K3's absorbed
    fractions with two components and labs); the one refusal left is
    the one skirt_tpu shares, more than 128 wavelengths, in its words."""
    import dataclasses

    run, *_ = _model(quadrature_panels=P)
    a, _ = tfp._cuda_args(run.spec)
    assert a.npanels == P
    assert tfp.cuda_route(run.spec) == (True, -(-P // 32))
    run, *_ = _model(quadrature_panels=P, nlambda=4, polychromatic=False)
    a, _ = tfm._cuda_args(run.spec)
    assert a.npanels == P
    assert tfm.cuda_route(run.spec) == (True, -(-P // 32))
    spec2 = dataclasses.replace(run.spec, H=2)
    assert tfm.cuda_route(spec2) == (True, -(-P // 32) + P)
    run, *_ = _model(quadrature_panels=32)
    assert tfp.cuda_route(run.spec) == (False, 0)
    with pytest.raises(ValueError, match=r"nlambda <= 128 \(split wider"):
        tfp._cuda_args(dataclasses.replace(run.spec, W=129))


def _route_case(kernel, P=16, nlead=2, H=None, table=None):
    """A K1 or K3 spec of the test model at the given shape."""
    import dataclasses

    poly = kernel == "k1"
    run, *_ = _model(quadrature_panels=P, nlambda=4 if not poly else W,
                     polychromatic=poly, ncomp=2 if H else 1)
    spec = run.spec
    if nlead != 2:
        inc = np.linspace(0.1, 3.0, nlead)
        leaders = [(float(np.sin(i) * np.cos(0.3 * j)),
                    float(np.sin(i) * np.sin(0.3 * j)), float(np.cos(i)))
                   for j, i in enumerate(inc)]
        spec = dataclasses.replace(spec, leaders=leaders)
    if H:
        spec = dataclasses.replace(
            spec, H=H, tab=np.ones((3 * H, spec.nlambda), np.float32),
            density_geometries=[spec.density_geometries[0]] * H)
    if table:
        spec = dataclasses.replace(
            spec, nlambda=table // 3, tab=np.ones((3, table // 3), np.float32))
    return spec


@pytest.mark.parametrize("kernel, shape", [
    ("k1", dict(nlead=12)), ("k3", dict(nlead=12)), ("k3", dict(H=3)),
    ("k3", dict(table=15000)), ("k1", dict(P=84, nlead=12))],
    ids=["k1-12-leaders", "k3-12-leaders", "k3-H3", "k3-table-15000",
         "k1-P84-12-leaders"])
def test_analytic_kernels_take_any_leaders_components_and_tables(
        recorded, kernel, shape):
    """K1 and K3 at 12 observer directions, K3 at 3 dust components and at
    a 15,000-float table: the wrappers pick the chunked route and hand it
    a scratch array, every direction in a device buffer (float32 k, 1 / k
    where the component moves, the moving flags, as Geom.lead_* holds the
    first 8) and K3 every component's density constants."""
    spec = _route_case(kernel, **shape)
    N = 64
    if kernel == "k1":
        from skirt_tpu_torch.testing import event_case
        spec, u, oc, L, L0, state = event_case(spec, N, 1, "cpu")
        tfp._poly_event_cuda(spec, u, oc, L, L0, state)
    else:
        from skirt_tpu_torch.testing import mono_event_case
        spec, u, state = mono_event_case(spec, N, 1, "cpu")
        tfm._mono_event_cuda(spec, u, state)
    name, a, _ = recorded.calls[-1]
    assert name == ("skirt_poly_event" if kernel == "k1"
                    else "skirt_mono_event")
    nlead = len(spec.leaders)
    assert a.nlead == nlead and a.cend
    assert a.lead            # the chunked route reads every direction there
    rows = kernels.lead_rows(spec.leaders)
    assert len(rows) == kernels.LEAD_FLOATS * nlead
    for j in range(min(nlead, kernels.MAX_LEAD)):
        assert rows[9 * j:9 * j + 3] == [a.lead_k[j][i] for i in range(3)]
        assert rows[9 * j + 3:9 * j + 6] == [a.lead_inv[j][i]
                                             for i in range(3)]
    if kernel == "k3":
        assert a.H == spec.H and a.dens_h
        assert len(a.dens_rows) == 8 * spec.H
        assert a.dens_rows[:7] == [a.dens[i] for i in range(7)]


@pytest.mark.parametrize("P, H", [(33, 2), (84, 2), (280, 2), (24, 4)])
def test_table_kernels_take_any_panels_and_components(recorded, P, H):
    """K4, K5, K6 (and K6p) past 32 panels and K7 at 4 dust components: the
    wrappers pack the shape and a chunk scratch array (K5: two running
    sums) for the chunked routes; at 24 panels and 2 components the
    one-pass routes, no scratch."""
    import dataclasses

    from skirt_tpu_torch.testing import (table_event_inputs,
                                         table_multi_state,
                                         table_poly_state, table_state)

    nc = -(-P // 32) if P > 32 else 0
    run, *_, model = _table_model(quadrature_panels=P)
    ds = model[1]
    inp = table_event_inputs(ds, 64, 5, 2, npanels=P)
    kr, state = table_state(inp, ds)
    tft._table_event_cuda(run.spec, inp["u"], kr, state)
    name, a, _ = recorded.calls[-1]
    assert (name, a.npanels, bool(a.cend)) == ("skirt_table_event", P,
                                               bool(nc))
    run, *_, model = _table_model(quadrature_panels=P, polychromatic=True)
    spec = run.spec
    for pol in (False, True):
        spec = dataclasses.replace(spec, want_pol=pol)
        inp = table_event_inputs(model[1], 64, 7, spec.W, npanels=P)
        tftp._table_poly_event_cuda(spec, inp["u"], inp["rows"],
                                    torch.from_numpy(spec.oc), inp["L"],
                                    inp["L0"], table_poly_state(inp))
        name, a, _ = recorded.calls[-1]
        assert (name, a.npanels, a.pol, bool(a.cend)) == (
            "skirt_table_poly_event", P, int(pol), bool(nc))
    # the two-component model's specs at P panels (its builder fixes 24)
    run, *_, model = _multi_model()
    ds = model[1]
    inp = table_event_inputs(ds, 64, 3, 2, npanels=P)
    kr, ks, state = table_multi_state(inp, ds)
    tft._table_multi_event_cuda(dataclasses.replace(run.spec, npanels=P),
                                inp["u"], kr, ks, state)
    name, a, _ = recorded.calls[-1]
    assert (name, a.npanels, bool(a.cend)) == ("skirt_table_multi_event", P,
                                               bool(nc))
    run, *_, model = _multi_model(polychromatic=True)
    spec = dataclasses.replace(run.spec, npanels=P)
    oc = np.concatenate([spec.oc.reshape(3, 2, -1)] * (H // 2), 1)
    spec = dataclasses.replace(spec, H=H, oc=np.ascontiguousarray(
        oc.reshape(3 * H, -1)))
    inp = table_event_inputs(model[1], 64, 8, spec.W, npanels=P)
    rows = torch.cat([inp["rows"]] * (H // 2))
    tftp._table_poly_multi_event_cuda(spec, inp["u"], rows,
                                      torch.from_numpy(spec.oc), inp["L"],
                                      inp["L0"], table_poly_state(inp))
    name, a, _ = recorded.calls[-1]
    chunked = P > 32 or H > 3
    assert tftp.k7_route(P, H) == (chunked, -(-P // 32) if chunked else 0)
    assert (name, a.npanels, a.H, bool(a.cend)) == (
        "skirt_table_poly_multi_event", P, H, chunked)


def test_cpu_run_launches_no_kernel():
    """On CPU tensors the wrappers take their plain versions."""
    def counts():
        return (binned.binned_add.launches,
                dict(bin_sum.bin_sum_add.launches), tfp.poly_event.launches,
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


def _kernels_of(source):
    """Names of the __global__ functions in csrc/<source>."""
    src = (kernels.CSRC / source).read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                      r"\s+)?(\w+)\s*\(", src)


def test_profile_layers_name_the_poly_path_kernels():
    """profile_torch.layer_of files the device names of K1's and K2's
    kernels under K1 and K2's two routes, not under plain torch, so the
    poly profile attributes the kernels the path launches."""
    import profile_torch

    k1, k2 = _kernels_of("fused_poly.cu"), _kernels_of("binned.cu")
    assert k1 == ["poly_event_kernel"]
    assert sorted(k2) == ["binned_add_global", "binned_add_shared"]
    layer = profile_torch.layer_of
    assert layer("void (anonymous namespace)::poly_event_kernel<1, 2, "
                 "true>(PolyArgs)") == "K1 poly_event"
    assert layer("(anonymous namespace)::binned_add_shared(float *, const "
                 "int *, const float *, long long, int, long long)") == \
        "K2 binned_add, shared route (frame)"
    assert layer("(anonymous namespace)::binned_add_global(float *, const "
                 "int *, const float *, long long, int)") == \
        "K2 binned_add, global route (labs)"


def test_profile_layers_name_the_bin_sum_kernel():
    """csrc/bin_sum.cu holds one kernel, whose device name profile_torch.
    layer_of files under the bin sum and the benchmark's classifier, which
    names only the older kernels, under the drivers' arithmetic."""
    import profile_torch
    from rtbench import kernel_names

    assert _kernels_of("bin_sum.cu") == ["bin_sum_kernel"]
    name = ("(anonymous namespace)::bin_sum_kernel(float *, const float *, "
            "const int *, long long, int, int, long long, double *, "
            "unsigned int *)")
    assert profile_torch.layer_of(name) == "bin sum (the mono detects' SEDs)"
    assert kernel_names.classify(name) == (
        "plain torch: the drivers' arithmetic", None)


def _smem_limit_bins():
    """The most bins K2's shared route takes on this card."""
    route = kernels.library().skirt_binned_route
    lo, hi = 1, 1 << 22
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if route(mid) else (lo, mid - 1)
    return lo


def _banded_stream(rs, W, N, npix=256):
    """A frame stream as the poly path sends it: (W, N) bins w * npix +
    pixel flattened w-major, the pixels centre-heavy (a narrow Gaussian
    on a 16 x 16 frame), 10% of the lanes off the frame (-1), 20% zero
    contributions."""
    ix = np.clip(np.rint(rs.normal(7.5, 1.5, N)), 0, 15).astype(np.int64)
    iy = np.clip(np.rint(rs.normal(7.5, 1.5, N)), 0, 15).astype(np.int64)
    pix = np.where(rs.random(N) < 0.1, -1, iy * 16 + ix)
    idx = np.where(pix[None] >= 0, np.arange(W)[:, None] * npix + pix[None],
                   -1)
    val = rs.random((W, N)) * (rs.random((W, N)) > 0.2)
    return idx.reshape(-1), val.reshape(-1)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    "frame-uniform", "labs-global", "w-banded", "one-bin", "smem-limit",
    "smem-limit+1", "ragged-n", "misaligned"])
def test_binned_add_kernel_matches_plain(case):
    """Both K2 routes (shared-memory histogram, global atomics) against
    drop_add: uniform indices with dropped ones on either route, the poly
    path's w-banded centre-heavy stream, every update on one bin, the
    most bins the shared route takes and one more (the global route), n
    not a multiple of 4, and views that are not 16-byte aligned (the
    scalar loads); then into an offset tally that already holds sums (the
    scalar flush)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rs = np.random.default_rng(3)
    lim = _smem_limit_bins()
    nbins, n = {"frame-uniform": (32768, 1 << 20),
                "labs-global": (1 << 21, 1 << 15),
                "w-banded": (32768, 128 * 4096),
                "one-bin": (32768, 1 << 16),
                "smem-limit": (lim, 1 << 20),
                "smem-limit+1": (lim + 1, 1 << 20),
                "ragged-n": (1024, (1 << 20) + 3),
                "misaligned": (32768, (1 << 20) + 1)}[case]
    if case == "w-banded":
        idx, val = _banded_stream(rs, 128, 4096)
    elif case == "one-bin":
        idx, val = np.full(n, 12345), rs.random(n)
    else:
        idx, val = rs.integers(-100, nbins + 100, n), rs.random(n)
    idx = torch.from_numpy(idx.astype(np.int32)).cuda()
    val = torch.from_numpy(val.astype(np.float32)).cuda()
    if case == "misaligned":
        idx, val = idx[1:], val[1:]
        assert idx.data_ptr() % 16 and val.data_ptr() % 16
    assert (kernels.library().skirt_binned_route(nbins) == 1) == \
        (case not in ("labs-global", "smem-limit+1"))
    before = binned.binned_add.launches
    got = binned.binned_add(torch.zeros(nbins, device="cuda"), idx, val)
    want = binned.drop_add(torch.zeros(nbins, device="cuda"), idx, val)
    assert binned.binned_add.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    tally = torch.ones(nbins + 1, device="cuda")[1:]
    got = binned.binned_add(tally, idx, val)
    torch.testing.assert_close(got, want + 1.0, rtol=1e-4, atol=1e-6)


# the bin-sum kernel's card shapes: N from none to past 2^24; nlambda from
# one bin through the mono path's 128 to the one-pass route's largest on
# an H100 (226) and past it (the passes route: 2 and 23 ranges)
BIN_SUM_N = [0, 1, 1 << 15, 1 << 21, (1 << 24) + 3]
BIN_SUM_NLAMBDA = [1, 8, 128, 226, 227, 5000]
BIN_SUM_LAYOUTS = ["one-bin", "uniform", "lane"]
H100_OPTIN, H100_SMS = 232448, 132


def _bin_sum_inputs(n, nlambda, layout, device, seed=5):
    """(values, ell): uniform values with a quarter of the lanes dead
    (zero), the indices all in one bin, uniform, or lane % nlambda (the
    mono path's layout)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    values = torch.rand(n, generator=gen, device=device)
    values *= torch.rand(n, generator=gen, device=device) >= 0.25
    if layout == "one-bin":
        ell = torch.full((n,), nlambda // 2, dtype=torch.int32,
                         device=device)
    elif layout == "uniform":
        ell = torch.randint(0, nlambda, (n,), generator=gen, device=device,
                            dtype=torch.int32)
    else:
        ell = (torch.arange(n, device=device) % nlambda).to(torch.int32)
    return values, ell


def _bin_err(got, want):
    """Largest relative bin error of a float32 tally against float64 sums
    (0 where both are 0)."""
    g = got.double().cpu().numpy()
    return float(np.max(np.abs(g - want) / np.maximum(np.abs(want),
                                                       1e-300)))


def test_bin_sum_plan_pins_the_routes():
    """bin_sum_plan on an H100's limits: the mono path's 2^21 values into
    128 bins in one pass on one 128 KB block an SM; 226 bins the one-pass
    route's largest, 227 two ranges; every plan's columns fit a block,
    its ranges cover the bins exactly, and the card test's shapes reach
    every route."""
    plan = bin_sum.bin_sum_plan
    assert plan(1 << 21, 128, H100_OPTIN, H100_SMS) == (
        "one_pass", 128, 1, 132)
    assert plan(1 << 21, 1, H100_OPTIN, H100_SMS) == ("one_pass", 1, 1, 264)
    assert plan(1 << 15, 128, H100_OPTIN, H100_SMS).blocks == 16
    assert plan(1, 8, H100_OPTIN, H100_SMS).blocks == 1
    assert plan(1 << 21, 226, H100_OPTIN, H100_SMS).route == "one_pass"
    assert plan(1 << 21, 227, H100_OPTIN, H100_SMS) == ("passes", 114, 2, 66)
    routes = set()
    for n in BIN_SUM_N[1:]:
        for nl in BIN_SUM_NLAMBDA + [65536]:
            p = plan(n, nl, H100_OPTIN, H100_SMS)
            assert 4 * bin_sum.THREADS * p.bins + bin_sum.STATIC_SMEM <= \
                H100_OPTIN
            assert p.bins * (p.ranges - 1) < nl <= p.bins * p.ranges
            assert p.blocks >= 1 and p.route == bin_sum.ROUTES[p.ranges > 1]
            if nl in BIN_SUM_NLAMBDA:
                routes.add(p.route)
    assert routes == set(bin_sum.ROUTES)


@pytest.mark.parametrize("nlambda", [8, 128, 227])
def test_bin_sum_hands_the_plan_to_the_kernel(recorded, nlambda):
    """The bin-sum wrapper's launch passes the C entry point the plan an
    H100's limits give, its workspace (a float32 row of partials a block
    of each range, a ticket a range) and counts one launch on the plan's
    route."""
    values, ell = _bin_sum_inputs(1 << 15, nlambda, "uniform", "cpu")
    tally = torch.zeros(nlambda)
    before = dict(bin_sum.bin_sum_add.launches)
    bin_sum._bin_sum_cuda(tally, values, ell, H100_OPTIN, H100_SMS)
    name, _, rest = recorded.calls[-1]
    p = bin_sum.bin_sum_plan(1 << 15, nlambda, H100_OPTIN, H100_SMS)
    assert name == "skirt_bin_sum"
    assert rest[2:7] == (1 << 15, nlambda, p.bins, p.ranges, p.blocks)
    nparts = p.ranges * p.blocks * bin_sum.row_floats(p)
    tickets, parts = bin_sum._workspace(tally.device, 0, p.ranges, nparts)
    assert rest[7:9] == (parts.data_ptr(), tickets.data_ptr())
    assert int(tickets.abs().sum()) == 0 and parts.numel() >= nparts
    assert parts.dtype == torch.float32 and tickets.dtype == torch.int32
    before[p.route] += 1
    assert bin_sum.bin_sum_add.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("layout", BIN_SUM_LAYOUTS)
@pytest.mark.parametrize("nlambda", BIN_SUM_NLAMBDA)
@pytest.mark.parametrize("n", BIN_SUM_N)
def test_bin_sum_kernel_matches_float64(n, nlambda, layout):
    """The bin-sum kernel against float64 np.bincount: its largest
    relative bin error at most twice the plain version's; two launches
    equal to the bit; each launch counted on the plan's route (none at
    N = 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    values, ell = _bin_sum_inputs(n, nlambda, layout, "cuda")
    want = np.bincount(ell.cpu().numpy(), weights=values.double().cpu()
                       .numpy(), minlength=nlambda)
    before = dict(bin_sum.bin_sum_add.launches)
    got = [bin_sum.bin_sum_add(torch.zeros(nlambda, device="cuda"), values,
                               ell) for _ in range(2)]
    plain = bin_sum.bin_sum_plain(values, ell, nlambda)
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1])
    assert _bin_err(got[0], want) <= 2 * _bin_err(plain, want)
    optin, sms = binned.device_limits("cuda")
    if n:
        before[bin_sum.bin_sum_plan(n, nlambda, optin, sms).route] += 2
    assert bin_sum.bin_sum_add.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("nlambda", [128, 227])
def test_bin_sum_kernel_drops_and_adds_in_place(nlambda):
    """Indices outside [0, nlambda) dropped, as the plain version drops
    them; the sums added into a tally that already holds values, through
    views off 16 bytes (the wrapper's aligned copies) and a tally view off
    the start of its storage."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = (1 << 20) + 5
    values, _ = _bin_sum_inputs(n, nlambda, "uniform", "cuda")
    ell = torch.randint(-3, nlambda + 3, (n,), device="cuda",
                        dtype=torch.int32)
    values, ell = values[1:], ell[1:]
    assert values.data_ptr() % 16 and ell.data_ptr() % 16
    start = torch.rand(nlambda + 1, device="cuda")
    tally = start.clone()[1:]
    got = bin_sum.bin_sum_add(tally, values, ell)
    assert got is tally
    e, v = ell.cpu().numpy(), values.double().cpu().numpy()
    kept = (e >= 0) & (e < nlambda)
    want = np.bincount(e[kept], weights=v[kept], minlength=nlambda)
    plain = start[1:] + bin_sum.bin_sum_plain(values, ell, nlambda)
    torch.testing.assert_close(got, plain, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               start[1:].double().cpu().numpy() + want,
                               rtol=1e-6)


@pytest.mark.gpu
def test_bin_sum_refuses_wrong_dtype_device_or_plan():
    """The bin-sum wrapper raises on a CUDA tensor of the wrong type and
    on tensors split over the CPU and the card (no fallback); the C entry
    point refuses a pass whose columns pass the opt-in limit, ranges that
    do not cover the bins exactly, and values off 16 bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tally = torch.zeros(8, device="cuda")
    values = torch.ones(64, device="cuda")
    ell = torch.zeros(64, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        bin_sum.bin_sum_add(tally, values, ell.long())
    with pytest.raises(TypeError):
        bin_sum.bin_sum_add(tally, values.double(), ell)
    with pytest.raises(ValueError):
        bin_sum.bin_sum_add(tally, values.cpu(), ell)
    with pytest.raises(ValueError):
        bin_sum.bin_sum_add(tally.cpu(), values, ell)
    lib = kernels.library()
    optin, _ = binned.device_limits("cuda")
    most = (optin - bin_sum.STATIC_SMEM) // (4 * bin_sum.THREADS)
    tickets, parts = bin_sum._workspace("cuda", kernels.stream_of(tally),
                                        4, 4 * 1000)
    big = torch.zeros(1000, device="cuda")

    def call(v, nl, bins, ranges):
        return lib.skirt_bin_sum(big.data_ptr(), v.data_ptr(),
                                 ell.data_ptr(), 63, nl, bins, ranges, 1,
                                 parts.data_ptr(), tickets.data_ptr(),
                                 kernels.stream_of(big))

    assert call(values, most + 1, most + 1, 1) != 0     # past the opt-in
    assert call(values, 100, 40, 2) != 0                 # 80 bins < 100
    assert call(values, 100, 50, 3) != 0                 # an empty range
    assert call(values[1:], 8, 8, 1) != 0                # off 16 bytes
    assert call(values, 100, 50, 2) == 0
    torch.cuda.synchronize()
    assert int(tickets.abs().sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("refill", [True, False], ids=["refill", "no-refill"])
@pytest.mark.parametrize("labs", [True, False], ids=["labs", "no-labs"])
@pytest.mark.parametrize("npanels", [7, 32])
@pytest.mark.parametrize("nlambda", [1, 4, 12, 33, 128])
def test_poly_event_kernel_matches_plain(nlambda, npanels, labs, refill):
    """K1 against its plain version on identical inputs (dead lanes, used-up
    launch budgets, axis-parallel directions, a weight cut that fires),
    chained over a few events, at W from 1 to 128 (33: not a multiple of
    the lane's 16 threads), a few panels or the most the kernel takes,
    with and without labs and the in-kernel relaunch, on a lane count
    that leaves the last block part empty: every output bit-identical
    (the kernel keeps the plain version's sum orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.testing import event_case

    run, *_ = _model(nlambda=nlambda, quadrature_panels=npanels,
                     store_absorption=labs, refill_batches=4 if refill else 0,
                     device="cuda")
    assert run.spec.refill is refill and run.spec.want_labs is labs
    n = 4096 + 17
    spec, u, oc, L, l0, state = event_case(run.spec, n, 1, "cuda")
    for it in range(4):
        if it:
            u = rng.uniform_open(it, (spec.n_uniform, n), "cuda")
        before = tfp.poly_event.launches
        got = tfp.poly_event(spec, u, oc, L, l0, state)
        assert tfp.poly_event.launches == before + 1
        want = tfp.poly_event_plain(spec, u, oc, L, l0, state)
        assert sorted(got) == sorted(want)
        for a, b in zip(got["state"], want["state"]):
            assert torch.equal(a, b), it
        for k in want:
            if k != "state":
                assert torch.equal(got[k], want[k]), (it, k)
        state = list(got["state"]) + ([got["bc"]] if refill else [])
        L = got["Ln"]


def _mono_cases():
    """(sampler, H, labs, npanels, nlambda) of the K3 GPU test: every
    sampler the wrapper reaches, one and two components, labs on and off,
    7 and 32 panels at W = 4, and the 128-wavelength table (the Pallas
    driver's per-lane tables, lam_inputs)."""
    cases = [(samp, H, labs, P, 4) for samp in ("none", "point", "expdisk")
             for H in (1, 2) for labs in (True, False) for P in (7, 32)]
    return cases + [("expdisk", 1, True, 32, 128)]


def _mono_spec(samp, H, labs, P, nlambda):
    """The K3 spec of the dusty disc with the given sampler (the ExpDisk
    stars relaunch dead lanes, or a point source at the centre, or no
    relaunch), components, labs and panels."""
    import dataclasses

    from skirt_tpu_torch.geometry import PointGeometry

    run, *_ = _model(nlambda=nlambda, ncomp=H, polychromatic=False,
                     store_absorption=labs, quadrature_panels=P,
                     refill_batches=0 if samp == "none" else 4,
                     device="cuda")
    spec = run.spec
    if samp == "point":
        geom = PointGeometry()
        nu_pos = geom.device_sampler_xyz()[0]
        spec = dataclasses.replace(
            spec, sampler_geometry=geom, nu_pos=nu_pos,
            n_uniform=5 + nu_pos + 2 + (1 if H > 1 else 0),
            u_comp=5 + nu_pos + 2)
    assert (spec.refill, spec.H, spec.want_labs, spec.npanels) == (
        samp != "none", H, labs, P)
    return spec


def _assert_bits(got, want, it):
    """Every output of an event kernel equal to its plain version's."""
    assert sorted(got) == sorted(want)
    for a, b in zip(got["state"], want["state"]):
        assert torch.equal(a, b), it
    for k in want:
        if k != "state":
            assert torch.equal(got[k], want[k]), (it, k)


@pytest.mark.gpu
@pytest.mark.parametrize("samp, H, labs, npanels, nlambda", _mono_cases(),
                         ids=[f"{s}-H{h}-{'labs' if l else 'nolabs'}-P{p}-W{w}"
                              for s, h, l, p, w in _mono_cases()])
def test_mono_event_kernel_matches_plain(samp, H, labs, npanels, nlambda):
    """K3 against its plain version on identical inputs (dead lanes,
    used-up launch budgets, axis-parallel directions, a weight cut that
    fires), chained over a few events, for every template instance the
    wrapper reaches and both table branches: every output bit-identical
    (the kernel keeps the plain version's sum orders, and its branch-free
    divisions and roots round as the operators do)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.testing import mono_event_case

    n = 4096 + 17
    spec, u, state = mono_event_case(_mono_spec(samp, H, labs, npanels,
                                                nlambda), n, 1, "cuda")
    for it in range(4):
        if it:
            u = rng.uniform_open(it, (spec.n_uniform, n), "cuda")
        before = tfm.mono_event.launches
        got = tfm.mono_event(spec, u, state)
        assert tfm.mono_event.launches == before + 1
        _assert_bits(got, tfm.mono_event_plain(spec, u, state), it)
        state = list(got["state"]) + state[9:11] + (
            [got["bc"]] if spec.refill else [])


def _chain_table_events(kernel, plain, spec, u, rows, state, args, restage,
                        events=4, bits=False):
    """Hold a table event kernel against its plain version over a few
    chained events, re-staging the panels between them (with bits, every
    output to the bit); returns the outputs of the last event."""
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
        if bits:
            _assert_bits(got, want, it)
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
@pytest.mark.parametrize("W", [1, 2, 4, 8, 24, 33, 128])
def test_table_poly_event_kernel_matches_plain(W):
    """K6 against its plain version on identical inputs (dead lanes, lanes
    with optical depths below 1e-3, a weight cut that fires, deposits
    outside the grid), chained over a few events, the lanes' luminosities
    carried from event to event, at widths that reach each of the
    dispatch's thread-group routes (G = 1, 2, 8, 16; W = 33 sums blocks of
    11): every output bit-identical."""
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
                        lambda: (oc, lum["L"], inp["L0"]), restage,
                        bits=True)


@pytest.mark.gpu
def test_table_multi_event_kernel_matches_plain():
    """K5 against its plain version on identical inputs (dead lanes, lanes
    with optical depths below 1e-3, a weight cut that fires, deposits
    outside the grid), chained over a few events with both panel sums
    re-staged between them: every output bit-identical."""
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
                        inp["u"], (kr, ks), state, lambda: (), restage,
                        bits=True)


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
@pytest.mark.parametrize("W, H, labs", [
    (W, H, labs) for W in (1, 2, 24, 33, 128) for H in (2, 3)
    for labs in (True, False)])
def test_table_poly_multi_event_kernel_matches_plain(W, H, labs):
    """K7 against its plain version on identical inputs, chained over a
    few events, the lanes' luminosities carried from event to event, at
    ragged widths (W = 33 sums blocks of 11), two or three components
    (the third a copy of the first's panels at half the density, with
    1.3x its opacities) and labs on and off: every output bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from skirt_tpu_torch.testing import (table_event_inputs,
                                         table_poly_state, table_restage)

    run, *_, model = _multi_model(device="cuda", polychromatic=True)
    grid, ds = model[0], model[1]
    spec = run.spec
    P = spec.npanels
    # W wavelengths from the model's two: the opacities scaled down the
    # band, g as the model's
    oc = np.asarray(spec.oc, np.float64).reshape(3, 2, spec.W)
    scale = np.linspace(1.0, 0.5, W)
    oc = oc[:, :, np.arange(W) % spec.W] * np.stack(
        [scale, scale, np.ones(W)])[:, None]
    if H == 3:
        oc = np.concatenate([oc, oc[:, :1] * np.array(
            [1.3, 1.3, 1.0])[:, None, None]], 1)
    spec = dataclasses.replace(
        spec, W=W, H=H, want_labs=labs, min_scatt=1,
        inv_minred=float(np.float32(0.01)), inv_W=float(np.float32(1 / W)),
        oc=np.ascontiguousarray(oc.reshape(3 * H, W), np.float32))
    n = 4096 + 17
    inp = table_event_inputs(ds, n, 8, W, seed=W + 1, npanels=P,
                             small_tau=0.02, outside=0.02, device="cuda")
    oc = torch.as_tensor(spec.oc, device="cuda")
    lum = {"L": inp["L"]}

    def rows_of(r):
        return torch.cat([r, 0.5 * r[:P]]) if H == 3 else r

    def restage(got, state):
        st = got["state"]
        lum["L"] = got["Ln"]
        r, t0, dt = table_restage(grid, ds, torch.stack(st[:3], -1),
                                  torch.stack(st[3:6], -1), P, None)
        return rows_of(r), list(st) + [t0, dt]

    got = _chain_table_events(
        tftp.table_poly_multi_event, tftp.table_poly_multi_event_plain,
        spec, inp["u"], rows_of(inp["rows"]), table_poly_state(inp),
        lambda: (oc, lum["L"], inp["L0"]), restage, bits=True)
    assert (got["state"][6] != 0).any()


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
    event: every output bit-identical."""
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
                              lambda: (oc, lum["L"], inp["L0"]), restage,
                              bits=True)
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



# -- every thread-group route of K6, each instance forced -----------------

# K6's instances: the widest W of G threads a lane (csrc/fused_table_poly.cu
# wpt<G>)
_K6_ROUTES = {1: 4, 2: 16, 4: 32, 16: 128}
_K6_CASES = [(W, G) for W in (1, 2, 4, 8, 24, 33, 128)
             for G, top in _K6_ROUTES.items() if W <= top]
_K6_VARIANTS = ("K6", "K6 no labs", "K6d", "K6p", "K6p direct")


@pytest.fixture(scope="module")
def forced_routes(tmp_path_factory):
    """K6's source with its dispatch held to one instance by
    experiments.phases.force_threads, built with the package's flags:
    {kernel: (library, entry point, its name)}."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import ctypes

    from skirt_tpu_torch.experiments import phases

    common = (kernels.CSRC / "common.cuh").read_text()
    libs = {}
    for kernel, threads in (("k6", list(_K6_ROUTES)),):
        source, struct, _, entry = phases.KERNELS[kernel]
        src = phases.force_threads((kernels.CSRC / source).read_text(),
                                   threads, kernel)
        so, _ = phases._build(tmp_path_factory.mktemp(kernel), source, src,
                              common)
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.POINTER(getattr(kernels, struct)),
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[kernel] = (lib, fn, entry)
    return libs


class _Route:
    """The package's library with one kernel's entry point swapped for the
    forced build's, its dispatch held to G threads a lane."""

    def __init__(self, libs, kernel, G):
        self.lib, self.fn, self.entry = libs[kernel]
        self.G = G

    def __getattr__(self, name):
        if name == self.entry:
            return self.fn
        return getattr(kernels.library(), name)

    def __enter__(self):
        import ctypes
        ctypes.c_int.in_dll(self.lib, "phases_threads").value = self.G
        kernels.library()
        self.saved = kernels._lib
        kernels._lib = self
        return self

    def __exit__(self, *exc):
        kernels._lib = self.saved


_route_models = {}


def _route_model(variant, W):
    """The spec, dust system and grid of a K6 variant at W wavelengths
    (built once per module)."""
    import dataclasses

    key = (variant.endswith("direct") or variant == "K6d", W)
    if key not in _route_models:
        build = _voronoi_model if key[0] else _table_model
        run, *_, model = build(device="cuda", nlambda=W, polychromatic=True)
        _route_models[key] = (run.spec, model[1], model[0])
    spec, ds, grid = _route_models[key]
    spec = dataclasses.replace(spec, min_scatt=1,
                               inv_minred=float(np.float32(0.01)),
                               want_pol=variant.startswith("K6p"),
                               want_labs=variant != "K6 no labs")
    return spec, ds, grid


@pytest.mark.gpu
@pytest.mark.parametrize("variant", _K6_VARIANTS)
@pytest.mark.parametrize("W, G", _K6_CASES,
                         ids=[f"W{w}-G{g}" for w, g in _K6_CASES])
def test_table_poly_event_every_route_matches_plain(forced_routes, W, G,
                                                    variant):
    """K6, K6 without labs, K6d, K6p and K6p on the direct table, each
    instance of G = 1, 2, 8, 16 threads a lane at every W it holds, held
    to its plain version over three chained events on inputs with dead
    lanes, lanes with optical depths below 1e-3, a weight cut that fires
    and deposits outside the grid: every output bit-identical, K6p's I_s
    and I_tot (dead lanes' too) included."""
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.testing import table_poly_case, table_restage

    spec, ds, grid = _route_model(variant, W)
    n = 4096 + 17
    (u, r, oc, L, L0, state), inp = table_poly_case(
        spec, ds, n, seed=100 + W + G, device="cuda", small_tau=0.05,
        outside=0.05)
    assert (state[6] == 0).any() and inp["small_tau"].any()
    ones = [torch.ones(n, device="cuda")]
    with _Route(forced_routes, "k6", G):
        for it in range(3):
            if it:
                u = rng.uniform_open(it, (spec.n_uniform, n), "cuda")
            got = tftp.table_poly_event(spec, u, r, oc, L, L0, state)
            _assert_bits(got, tftp.table_poly_event_plain(
                spec, u, r, oc, L, L0, state), it)
            st = got["state"]
            L = got["Ln"]
            r, t0, dt = table_restage(grid, ds, torch.stack(st[:3], -1),
                                      torch.stack(st[3:6], -1), 16, ones)
            state = list(st) + [t0, dt]


@pytest.mark.gpu
def test_table_poly_event_route_refuses_a_narrow_group(forced_routes):
    """An instance too narrow for W (G = 1 holds 4 wavelengths) is
    refused with an error, never run."""
    from skirt_tpu_torch.testing import table_poly_case

    spec, ds, _ = _route_model("K6", 8)
    args, _ = table_poly_case(spec, ds, 256, seed=3, device="cuda")
    with _Route(forced_routes, "k6", 1):
        with pytest.raises(RuntimeError, match="CUDA error"):
            tftp.table_poly_event(spec, *args)


@pytest.mark.gpu
@pytest.mark.parametrize("small", [0.05, 0.5], ids=["few-small", "half-small"])
@pytest.mark.parametrize("labs", [True, False], ids=["labs", "no-labs"])
def test_table_multi_event_kernel_edges_match_plain(small, labs):
    """K5, labs on and off, held to the plain version over three chained
    events (dead lanes, optical depths below 1e-3 on a few or half of the
    lanes, so panel opacities below 2^-64 that the kernel scales before its
    division, a weight cut that fires, deposits outside the grid, empty
    panels where kr = ks = 0): every output bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from skirt_tpu_torch import rng
    from skirt_tpu_torch.testing import (table_event_inputs,
                                         table_multi_state, table_restage)

    run, *_, model = _multi_model(device="cuda")
    grid, ds = model[0], model[1]
    spec = dataclasses.replace(run.spec, min_scatt=1, want_labs=labs,
                               inv_minred=float(np.float32(0.01)))
    P, n = spec.npanels, 4096 + 17
    inp = table_event_inputs(ds, n, 3, 2, seed=7 + int(labs), npanels=P,
                             small_tau=small, outside=0.05, device="cuda")
    kr, ks, state = table_multi_state(inp, ds)
    assert bool((kr == 0).any())
    ksca_pk, kext_pk = ds.packet_kappas(state[9])
    u = inp["u"]
    for it in range(3):
        if it:
            u = rng.uniform_open(it, (spec.n_uniform, n), "cuda")
        got = tft.table_multi_event(spec, u, kr, ks, state)
        _assert_bits(got, tft.table_multi_event_plain(spec, u, kr, ks,
                                                      state), it)
        st = got["state"]
        kr, ks, t0, dt = table_restage(
            grid, ds, torch.stack(st[:3], -1), torch.stack(state[3:6], -1),
            P, kext_pk, ksca_pk)
        state = list(st[:3]) + state[3:6] + [
            st[3], st[4], state[8] + st[4], state[9], state[10], t0, dt]


# K8's layouts: (nlambda, cells, 128-lane rows a wavelength block) and
# the (route, split) k8_route gives each on an H100 (232,448 opt-in bytes,
# 132 SMs)
K8_LAYOUTS = {
    "flagship": ((128, 16384, 8), (binned.K8_SPARSE, 1)),
    "uneven": ((20, 1000, 8), (binned.K8_SPARSE, 1)),
    "crossover": ((8, 1000, 64), (binned.K8_SPARSE, 1)),
    "dense": ((8, 1000, 128), (binned.K8_DENSE, 8)),
    "dense-split4": ((20, 1000, 64), (binned.K8_DENSE, 4)),
    "dense-split2": ((64, 1000, 32), (binned.K8_DENSE, 2)),
    "dense-alone": ((128, 1000, 32), (binned.K8_DENSE, 1)),
    "dense-quarter": ((128, 16384, 32), (binned.K8_DENSE, 1)),
    "global-route": ((2, 60000, 16), (binned.K8_GLOBAL, 1))}


def _k8_lanes(nl, ncells, rows_pb, device):
    rs = np.random.default_rng(nl + rows_pb)
    n = nl * rows_pb * 128
    cells = torch.from_numpy(rs.integers(-9, ncells + 9, n)
                             .astype(np.int32)).to(device)
    vals = torch.from_numpy(rs.random(n).astype(np.float32)).to(device)
    Q, R, _ = binned.blocked_layout(nl, ncells, n)
    return cells, vals, Q * R


@pytest.mark.parametrize("layout", list(K8_LAYOUTS))
def test_k8_route_rule_pins_each_layout(layout):
    """k8_route at the flagship (sparse: 1,024 lanes over 16,384 bins), the
    uneven and crossover layouts (sparse: 1 and 8 lanes a bin, where the
    split dense route only ties), the dense ones (split over 8, 4 and 2
    blocks at nlambda 8, 20 and 64; alone at nlambda 128, at 4 and at a
    quarter lane a bin) and past the opt-in limit (global); a tally off 16
    bytes never takes the dense route."""
    (nl, ncells, rows_pb), want = K8_LAYOUTS[layout]
    per = rows_pb * 128
    _, _, qr = _k8_lanes(nl, ncells, rows_pb, "cpu")
    assert binned.k8_route(per, qr, 232448, nl, 132) == want
    route, _ = binned.k8_route(per, qr, 232448, nl, 132, aligned=False)
    assert route == (binned.K8_SPARSE if want[0] == binned.K8_DENSE
                     else want[0])


def test_k8_route_rule_splits_to_fill_the_card():
    """The dense route's split: the fewest blocks a wavelength block (a
    power of two up to 8) that put a block on at least half the SMs; the
    lanes a bin each block needs: a quarter alone, 2 split."""
    big = 1 << 30
    splits = {nl: binned.k8_route(big, 1024, 232448, nl, 132)[1]
              for nl in (1, 8, 16, 20, 32, 64, 66, 128, 1024)}
    assert splits == {1: 8, 8: 8, 16: 8, 20: 4, 32: 4, 64: 2, 66: 1,
                      128: 1, 1024: 1}
    assert binned.k8_route(256, 1024, 232448, 128) == (binned.K8_DENSE, 1)
    assert binned.k8_route(255, 1024, 232448, 128)[0] == binned.K8_SPARSE
    assert binned.k8_route(4096, 16384, 232448, 128) == (binned.K8_DENSE, 1)
    assert binned.k8_route(1024, 16384, 232448, 128)[0] == binned.K8_SPARSE
    assert binned.k8_route(2 * 1024 * 4, 1024, 232448, 20) == (
        binned.K8_DENSE, 4)
    assert binned.k8_route(2 * 1024 * 4 - 1, 1024, 232448, 20)[0] == (
        binned.K8_SPARSE)
    assert binned.k8_route(14528, 58112, 232448, 128)[0] == binned.K8_DENSE
    assert binned.k8_route(58113, 58113, 232448, 128)[0] == binned.K8_GLOBAL


@pytest.mark.gpu
@pytest.mark.parametrize("layout", list(K8_LAYOUTS))
def test_binned_add_lm_kernel_matches_plain(layout):
    """K8 against its plain version on each layout of K8_LAYOUTS, on the
    route k8_route picks: dropped lanes, a random starting tally; rtol
    1e-4 (atomics add in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (nl, ncells, rows_pb), want = K8_LAYOUTS[layout]
    cells, vals, qr = _k8_lanes(nl, ncells, rows_pb, "cuda")
    start = torch.rand(nl * qr, device="cuda")
    optin, sms = binned.device_limits("cuda")
    assert binned.k8_route(rows_pb * 128, qr, optin, nl, sms) == want
    before = binned.binned_add_lm.launches
    got = binned.binned_add_lm(start.clone(), cells, vals, nlambda=nl,
                               ncells=ncells)
    assert binned.binned_add_lm.launches == before + 1
    want = binned.bincount_blocked_plain(start.clone(), cells, vals,
                                         nlambda=nl, ncells=ncells)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("layout", list(K8_LAYOUTS))
def test_binned_add_lm_hands_the_rule_to_the_kernel(recorded, layout):
    """The K8 wrapper's launch passes the C entry point the (route, split)
    k8_route gives on an H100's limits, and the sparse route for a dense
    layout whose tally sits off 16 bytes; one launch counted each."""
    (nl, ncells, rows_pb), want = K8_LAYOUTS[layout]
    cells, vals, qr = _k8_lanes(nl, ncells, rows_pb, "cpu")
    buf = torch.zeros(nl * qr + 4)
    before = binned.binned_add_lm.launches
    for tally, route in ((buf[:nl * qr], want), (buf[1:nl * qr + 1], (
            binned.K8_SPARSE, 1) if want[0] == binned.K8_DENSE else want)):
        binned._binned_add_lm_cuda(tally, cells, vals, nl, ncells, qr,
                                   232448, 132)
        name, _, rest = recorded.calls[-1]
        assert name == "skirt_binned_blocked_add"
        assert rest[2:8] == (nl * rows_pb * 128, nl, ncells, qr, *route)
    assert binned.binned_add_lm.launches == before + 2


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
    (s.M, s.K, s.N, s.dtype == torch.bfloat16, s.inner) for s in mm.SHAPES])
def test_mm_kernel_matches_plain(M, K, N, bf16, inner):
    """PM against its plain version within mm.tolerance (TF32 off) at
    every shape of P15, 1024^3 included, on the plan's tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = torch.bfloat16 if bf16 else torch.float32
    a, b = (t.cuda() for t in mm.tables_like_jax(M, K, N, dt))
    before = mm.mm.launches
    got = mm.mm(a, b, inner=inner)
    assert mm.mm.launches == before + 1
    err = (got - mm.mm_plain(a, b, inner=inner)).abs()
    assert bool((err <= mm.tolerance(a, b, inner)).all())


# shapes the wrapper accepts that the plan's tiles do not divide, and the
# tile the plan gives each on an H100's 132 SMs: M 192 against 64-row
# tiles of which the TMA box passes the matrix, N 320 and 960 against 128
# columns, K 32 and 96 against the 128-deep stages
MM_OFF_TILE = {
    (64, 32, 64, torch.bfloat16): (64, 64),
    (192, 96, 320, torch.bfloat16): (64, 64),
    (1024, 96, 960, torch.bfloat16): (64, 128),
    (64, 32, 64, torch.float32): (32, 64),
    (192, 96, 320, torch.float32): (32, 64)}


@pytest.mark.gpu
@pytest.mark.parametrize("inner", [1, 3])
@pytest.mark.parametrize("M, K, N, dt", list(MM_OFF_TILE),
                         ids=lambda v: str(v).replace("torch.", ""))
def test_mm_kernel_off_tile_shapes_match_plain(M, K, N, dt, inner):
    """PM at shapes the wrapper accepts that its tiles do not divide, on
    the plan's tile (each of the three): within mm.tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = (t.cuda() for t in mm.tables_like_jax(M, K, N, dt))
    got = mm.mm(a, b, inner=inner)
    err = (got - mm.mm_plain(a, b, inner=inner)).abs()
    assert bool((err <= mm.tolerance(a, b, inner)).all())


@pytest.mark.parametrize("M, K, N, dt", list(MM_OFF_TILE)
                         + [(s.M, s.K, s.N, s.dtype) for s in mm.SHAPES],
                         ids=lambda v: str(v).replace("torch.", ""))
def test_mm_hands_the_plan_to_the_kernel(recorded, M, K, N, dt):
    """The PM wrapper's launch passes the C entry point the plan's route
    and tile on an H100's 132 SMs (the off-tile shapes' tiles as
    MM_OFF_TILE lists them), and counts one launch."""
    a = torch.zeros(M, K, dtype=dt)
    b = torch.zeros(K, N, dtype=dt)
    p = mm.plan(M, K, N, dt)
    if (M, K, N, dt) in MM_OFF_TILE:
        assert (p.bm, p.bn) == MM_OFF_TILE[M, K, N, dt]
    before = mm.mm.launches
    out = mm._mm_cuda(a, b, 2, 132)
    name, _, rest = recorded.calls[-1]
    assert name == "skirt_probe_mm"
    assert rest[2:9] == (M, K, N, int(dt == torch.bfloat16), 2, p.bm, p.bn)
    assert out.shape == (M, N) and mm.mm.launches == before + 1


def _accepted_shapes():
    return [(M, K, N) for M in range(64, 1089, 64) for N in (64, 192, 320,
                                                              1024, 2048)
            for K in (32, 96, 1024)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_mm_plan_covers_every_accepted_shape(dtype):
    """mm.plan over shapes the wrapper accepts: its route is the dtype's,
    its tile one the route takes, its blocks cover C (float32 tiles divide
    it), and no tile leaves the card with fewer waves x tile area."""
    for M, K, N in _accepted_shapes():
        p = mm.plan(M, K, N, dtype)
        assert p.route == ("wgmma" if dtype == torch.bfloat16 else "simt")
        assert (p.bm, p.bn) in mm.TILES[p.route]
        rows, cols = -(-M // p.bm), -(-N // p.bn)
        assert rows * p.bm >= M and cols * p.bn >= N
        assert (rows - 1) * p.bm < M and (cols - 1) * p.bn < N
        if p.route == "simt":
            assert M % p.bm == 0 and N % p.bn == 0

        def cost(t):
            return -(-(-(-M // t[0]) * -(-N // t[1])) // mm.SMS) * t[0] * t[1]
        assert cost((p.bm, p.bn)) == min(cost(t) for t in mm.TILES[p.route])


def test_mm_plan_pins_the_p15_shapes():
    """The plan at P15's shapes on an H100's 132 SMs: 64 x 128 tiles at
    1024^3 (128 blocks), 64 x 64 at the smaller bf16 shapes, 32 x 64 for
    float32; every tile of TILES is some P15 shape's."""
    got = {(s.M, s.K, s.N, str(s.dtype)): mm.plan(s.M, s.K, s.N, s.dtype)
           for s in mm.SHAPES}
    want = {(1024, 1024, 1024, "torch.bfloat16"): mm.Plan("wgmma", 64, 128),
            (512, 512, 512, "torch.bfloat16"): mm.Plan("wgmma", 64, 64),
            (256, 128, 1024, "torch.bfloat16"): mm.Plan("wgmma", 64, 64),
            (128, 128, 128, "torch.bfloat16"): mm.Plan("wgmma", 64, 64),
            (256, 128, 1024, "torch.float32"): mm.Plan("simt", 32, 64),
            (128, 128, 128, "torch.float32"): mm.Plan("simt", 32, 64)}
    assert got == want
    assert {(p.route, p.bm, p.bn) for p in got.values()} == {
        (r, *t) for r, tiles in mm.TILES.items() for t in tiles}
    with pytest.raises(TypeError):
        mm.plan(64, 32, 64, torch.float16)


@pytest.mark.gpu
def test_new_wrappers_refuse_wrong_dtype_or_device():
    """K8, PG, PO and PM raise on a CUDA tensor of the wrong type and on
    tensors split over the CPU and the card; none falls back.  The C entry
    points refuse a PM tile the plan never gives and a K8 route or split
    the layout cannot take."""
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
    lib = kernels.library()
    c = torch.empty(64, 64, device="cuda")
    stream = kernels.stream_of(c)
    for bf16, bm, bn in ((1, 128, 128), (1, 128, 64), (0, 64, 64)):
        x, y = (a, b) if bf16 else (a.float(), b.float())
        assert lib.skirt_probe_mm(x.data_ptr(), y.data_ptr(), c.data_ptr(),
                                  64, 32, 64, bf16, 1, bm, bn, stream) != 0
    cells, vals, qr = _k8_lanes(2, 60000, 16, "cuda")
    tally = torch.zeros(2 * qr + 4, device="cuda")
    for t, route, split in (
            (tally[:2 * qr], binned.K8_DENSE, 1),      # past the opt-in
            (tally[:2 * qr], binned.K8_GLOBAL, 2),     # split off dense
            (tally[:2 * qr], 3, 1)):                   # no such route
        assert lib.skirt_binned_blocked_add(
            t.data_ptr(), cells.data_ptr(), vals.data_ptr(), cells.numel(),
            2, 60000, qr, route, split, stream) != 0
    cells, vals, qr = _k8_lanes(8, 1000, 128, "cuda")
    tally = torch.zeros(8 * qr + 4, device="cuda")
    assert lib.skirt_binned_blocked_add(                # off 16 bytes
        tally[1:].data_ptr(), cells.data_ptr(), vals.data_ptr(),
        cells.numel(), 8, 1000, qr, binned.K8_DENSE, 8, stream) != 0
    assert lib.skirt_binned_blocked_add(
        tally[:8 * qr].data_ptr(), cells.data_ptr(), vals.data_ptr(),
        cells.numel(), 8, 1000, qr, binned.K8_DENSE, 3, stream) != 0
    torch.cuda.synchronize()
