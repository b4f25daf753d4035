"""Slice S4b-2 on the CPU: the direct-table events K4d and K6d and the
direct-table slices against skirt_tpu.

The model is tests/test_poly.py's TestPolyDirect model: a point source in
a uniform dust sphere of 1.8 kpc (tau ~ 2 at 0.55 um) on the exact
Voronoi tessellation of 300 uniform sites in +-2 kpc (volume_samples 16),
W wavelengths log-spaced from 0.55 to 2.2 um with bench_voronoi.py's
power-law optics (at W = 2 the test's kappa 2600 / 600, albedo 0.5 / 0.4,
g 0.4 / 0.2), one SED instrument at inclination 1.2, azimuth 0.7;
16 propagation and 16 staged peel panels, max_scatt_events 48.

- K4d and K6d (skirt_tpu's _build_kernel with arith_locate=False): the
  plain events against the Pallas bodies in interpret mode on identical
  numpy-made inputs, labs on and off, K6d at W = 1, 2 and 8.  Criterion
  (skirt_tpu_torch.testing.event_agreement): discrete outputs (alive,
  nscatt, whether a lane deposits, K6d's deposit wavelength, the
  wavelengths that survive the weight cut) on >= 99.9% of 1,024 lanes,
  floats (among them the deposit distance) to rtol 1e-4 on every
  discretely agreeing lane but at most FLOAT_BAD_LANES (XLA's CPU backend
  fuses a*b+c into one rounding where torch rounds twice).
- End to end at tests/test_poly.py's direct-table tolerances (SED per
  wavelength 0.08, labs total 0.06, labs per wavelength 0.08; the
  frameworks draw different random streams): the mono (K4d) and poly
  (K6d) slices against skirt_tpu's, the mono slice on an uneven Cartesian
  grid (a second direct-table grid), and OligoSimulation(voxelize=
  "table") on the voxel view (field error 4%: K6 on 53^3 voxels) and on a
  clumpy field above the 10% bound (the direct table, K6d), with the labs
  on the Voronoi cells.
- table_peel='exact' warns in skirt_tpu's words and runs the staged peel.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from skirt_tpu.engine import fused_table as jft
from skirt_tpu.engine import fused_table_poly as jftp
from skirt_tpu_torch import rng
from skirt_tpu_torch.convert import from_skirt_tpu
from skirt_tpu_torch.engine import fused_table as tft
from skirt_tpu_torch.engine import fused_table_poly as tftp
from skirt_tpu_torch.testing import (event_agreement, table_event_inputs,
                                     table_poly_state, table_state)

torch.set_num_threads(2)

N = 1 << 13
R = 8                       # event parity: rows of 128 lanes, 1,024 lanes
NPANELS = 16
FLOAT_BAD_LANES = 2         # of 1,024 (module docstring)


def jax_voronoi_model(W=2, poly=False, nsites=300, clumpy=False,
                      table=True, **opt_kw):
    """The 300-site model in skirt_tpu (module docstring): (grid, dust
    system, stellar system, instruments, options); table=False keeps the
    gridded system (for OligoSimulation(voxelize="table")), clumpy=True
    multiplies the density of a random 3% of the cells by 1e3 (tests/
    test_voronoi.py's clumpy import)."""
    from skirt_tpu.constants import KPC
    from skirt_tpu.engine.lifecycle import LifecycleOptions
    from skirt_tpu.geometry import PointGeometry, UniformSphereGeometry
    from skirt_tpu.grids.voronoi import VoronoiGrid
    from skirt_tpu.instruments import SEDInstrument
    from skirt_tpu.media import (DustComponent, DustMassNormalization,
                                 DustSystem, SimpleOligoDustMix)
    from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                           StellarSystem)
    from skirt_tpu.wavelengths import OligoWavelengthGrid

    lams = np.geomspace(0.55e-6, 2.2e-6, W) if W > 1 else [0.55e-6]
    f = np.log(np.asarray(lams) / 0.55e-6) / np.log(2.2 / 0.55)
    wg = OligoWavelengthGrid(list(lams))
    ss = StellarSystem([LuminosityStellarComponent(PointGeometry(), wg,
                                                   [1e36] * W)])
    half = 2.0 * KPC
    rs = np.random.default_rng(11)
    sites = rs.uniform(-0.98 * half, 0.98 * half, size=(nsites, 3))
    grid = VoronoiGrid(sites, (-half, -half, -half, half, half, half),
                       volume_samples=16)
    mix = SimpleOligoDustMix(wg, list(2600.0 * (600.0 / 2600.0) ** f),
                             list(0.5 + (0.4 - 0.5) * f),
                             list(0.4 + (0.2 - 0.4) * f))
    mass = 2.0 / 2600.0 * (4 / 3 * np.pi * (1.8 * KPC) ** 3) / (1.8 * KPC)
    comp = DustComponent(UniformSphereGeometry(1.8 * KPC), mix,
                         DustMassNormalization(mass))
    ds = DustSystem(grid, [comp], density_mode="gridded")
    if clumpy:
        hot = np.random.default_rng(3).random(grid.ncells) < 0.03
        ds.rho64[:, hot] *= 1e3
        ds.rho = np.asarray(ds.rho64, np.float32)
    if table:
        ds = ds.as_table()
    ins = [SEDInstrument("sed", 3.08e23, W, inclination=1.2, azimuth=0.7)]
    kw = dict(store_absorption=True, deposition="sampled",
              quadrature_panels=NPANELS, peel_panels=16, max_scatt_events=48,
              fused=True, table_peel="staged", polychromatic=poly)
    kw.update(opt_kw)
    return grid, ds, ss, ins, LifecycleOptions(**kw)


@pytest.fixture(scope="module")
def mono_models():
    jm = jax_voronoi_model()
    return jm, from_skirt_tpu(*jm)


# ---------------------------------------------------------------------------
# K4d and K6d: the plain events against the Pallas bodies
# ---------------------------------------------------------------------------

def _blk(tr):
    return pl.BlockSpec((tr, 128), lambda i: (i, 0), memory_space=pltpu.VMEM)


def _blkW(lead, tr):
    return pl.BlockSpec((lead, tr, 128), lambda i: (0, i, 0),
                        memory_space=pltpu.VMEM)


def jax_mono_event(model, inputs):
    """skirt_tpu's K4 Pallas body built with arith_locate=False, in
    interpret mode, called as make_fused_table_lifecycle's call_kernel
    calls it (the deposit slot float32)."""
    grid, ds, ss, ins, options = model
    want_labs = bool(options.store_absorption)
    kern = jft._build_kernel(grid, options, 2, NPANELS, want_labs, False)
    u, kr, state = inputs
    tr = min(32, R)
    out_dtypes = ([jnp.float32] * 7 + [jnp.int32] * 2
                  + ([jnp.float32, jnp.float32] if want_labs else []))
    outs = pl.pallas_call(
        kern, grid=(R // tr,),
        in_specs=[_blkW(5, tr), _blkW(NPANELS, tr)]
        + [_blk(tr) for _ in state],
        out_specs=tuple(_blk(tr) for _ in out_dtypes),
        out_shape=tuple(jax.ShapeDtypeStruct((R, 128), dt)
                        for dt in out_dtypes),
        interpret=True,
    )(jnp.array(u.reshape(5, R, 128)), jnp.array(kr.reshape(-1, R, 128)),
      *[jnp.array(s.reshape(R, 128)) for s in state])
    outs = [torch.from_numpy(np.array(o).reshape(-1))
            for o in jax.block_until_ready(outs)]
    res = {"state": outs[:9]}
    if want_labs:
        res["depd"], res["depv"] = outs[9], outs[10]
    return res


@pytest.mark.parametrize("labs", [True, False], ids=["labs", "nolabs"])
def test_mono_event_matches_pallas(mono_models, labs):
    """K4d: the deposit distance (-1 for none) in place of the bin."""
    jm, (grid, ds, ss, ins, opts) = mono_models
    cut = dict(min_weight_reduction=20.0, min_scatt_events=1,
               store_absorption=labs)
    jm = jm[:4] + (dataclasses.replace(jm[4], **cut),)
    inp = table_event_inputs(ds, R * 128, 5, 2, seed=41 + labs,
                             npanels=NPANELS, small_tau=0.01, outside=0.01)
    kr, state = table_state(inp, ds)
    spec = tft._build_kernel(grid, dataclasses.replace(opts, **cut), 2,
                             NPANELS, labs, arith_locate=False)
    assert spec.locate is None
    got = tft.table_event(spec, inp["u"], kr, state)
    want = jax_mono_event(jm, (inp["u"].numpy(), kr.numpy(),
                               [s.numpy() for s in state]))
    res = event_agreement(got, want)
    assert res["discrete"] >= 0.999, res
    assert res["float_bad"] <= FLOAT_BAD_LANES, res
    alive_in = state[7] != 0
    alive = got["state"][7] != 0
    assert (alive_in & ~alive).sum() > 50 and alive.sum() > 300
    assert (got["state"][8] > state[8]).sum() > 300
    if labs:
        assert "depi" not in got
        dep = got["depd"] >= 0
        assert dep.sum() > 300 and (got["depd"][~dep] == -1.0).all()
        assert (got["depv"][~dep] == 0).all() and not dep[~alive_in].any()
        # outside lanes still emit their distance: the lifecycle drops them
        assert dep[inp["outside"] & alive_in].all()
    else:
        assert "depd" not in got and "depi" not in got


def jax_poly_event(model, W, inputs):
    """skirt_tpu's K6 Pallas body built with arith_locate=False, in
    interpret mode, called as make_fused_table_poly_lifecycle's
    call_kernel calls it (a third deposit output: the distance)."""
    grid, ds, ss, ins, options = model
    want_labs = bool(options.store_absorption)
    mix = ds.components[0].mix
    kern, n_uniform = jftp._build_kernel(
        grid, options, W, NPANELS, want_labs,
        [float(np.asarray(ds.kappaext)[0, w]) for w in range(W)],
        [float(np.asarray(mix.albedo)[w]) for w in range(W)],
        [float(np.asarray(mix.g)[w]) for w in range(W)],
        arith_locate=False)
    u, r, oc, L, L0, state = inputs
    tr = min(min(32, max(8, (1024 // W) // 8 * 8)), R)
    out_shapes = [jax.ShapeDtypeStruct((R, 128), dt)
                  for dt in [jnp.float32] * 6 + [jnp.int32] * 2]
    out_shapes += [jax.ShapeDtypeStruct((W, R, 128), jnp.float32)] * 2
    out_specs = [_blk(tr) for _ in range(8)] + [_blkW(W, tr)] * 2
    if want_labs:
        out_shapes += [jax.ShapeDtypeStruct((R, 128), dt)
                       for dt in (jnp.int32, jnp.float32, jnp.float32)]
        out_specs += [_blk(tr)] * 3
    outs = pl.pallas_call(
        kern, grid=(R // tr,),
        in_specs=[_blkW(n_uniform, tr), _blkW(NPANELS, tr),
                  pl.BlockSpec((3, W, 128), lambda i: (0, 0, 0),
                               memory_space=pltpu.VMEM),
                  _blkW(W, tr), _blkW(W, tr)] + [_blk(tr) for _ in state],
        out_specs=tuple(out_specs), out_shape=tuple(out_shapes),
        interpret=True,
    )(jnp.array(u.reshape(n_uniform, R, 128)),
      jnp.array(r.reshape(NPANELS, R, 128)),
      jnp.array(np.broadcast_to(oc[:, :, None], (3, W, 128)).copy()),
      jnp.array(L.reshape(W, R, 128)), jnp.array(L0.reshape(W, R, 128)),
      *[jnp.array(s.reshape(R, 128)) for s in state])
    outs = [torch.from_numpy(np.array(o)) for o in jax.block_until_ready(outs)]
    res = {"state": [o.reshape(-1) for o in outs[:8]],
           "Ln": outs[8].reshape(W, -1), "Lp": outs[9].reshape(W, -1)}
    if want_labs:
        res["depi"], res["depv"], res["depd"] = (o.reshape(-1)
                                                 for o in outs[10:13])
    return res


@pytest.mark.parametrize("W, labs", [(1, True), (2, True), (2, False),
                                     (8, True)],
                         ids=["W1", "W2", "W2-nolabs", "W8"])
def test_poly_event_matches_pallas(W, labs):
    """K6d: the deposit wavelength, total and distance."""
    cut = dict(min_weight_reduction=20.0, min_scatt_events=1,
               store_absorption=labs)
    jm = jax_voronoi_model(W, poly=True, **cut)
    grid, ds, ss, ins, opts = from_skirt_tpu(*jm)
    spec = tftp._build_kernel(grid, ds, opts, W, NPANELS, labs,
                              arith_locate=False)
    # no lanes below tau ~ 1e-3 (small_tau), as in test_torch_table_poly:
    # 1 - exp(-tau) there magnifies an ulp of exp into the deposit weights
    inp = table_event_inputs(ds, R * 128, 7, W, seed=W + 17 * labs,
                             npanels=NPANELS, outside=0.01)
    state = table_poly_state(inp)
    oc = torch.from_numpy(spec.oc)
    got = tftp.table_poly_event(spec, inp["u"], inp["rows"], oc, inp["L"],
                                inp["L0"], state)
    want = jax_poly_event(jm, W, [inp["u"].numpy(), inp["rows"].numpy(),
                                  spec.oc, inp["L"].numpy(),
                                  inp["L0"].numpy(),
                                  [s.numpy() for s in state]])
    res = event_agreement(got, want)
    assert res["discrete"] >= 0.999, res
    assert res["float_bad"] <= FLOAT_BAD_LANES, res
    alive_in = state[6] != 0
    alive = got["state"][6] != 0
    assert (alive_in & ~alive).sum() > 50 and alive.sum() > 300
    if W > 1:
        assert ((got["Ln"] == 0) & alive[None]).sum() > 100
    if labs:
        dep = got["depd"] >= 0
        assert dep.sum() > 300 and torch.equal(dep, got["depi"] >= 0)
        assert len(torch.unique(got["depi"][dep])) == W
        assert (got["depi"][~dep] == -1).all() and \
            (got["depv"][~dep] == 0).all()
        assert dep[inp["outside"] & alive_in].all()
    else:
        assert "depd" not in got and "depi" not in got


def test_direct_deposits_locate_the_pre_event_point(mono_models):
    """direct_deposits bins cell(pos + d * dir) * width + wl and drops
    lanes without a deposit, without a wavelength or outside the grid."""
    _, (grid, ds, *_) = mono_models
    rs = np.random.default_rng(2)
    n = 512
    pos = torch.from_numpy(rs.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
                           * np.float32(3.0857e19))
    d = torch.from_numpy(rs.normal(size=(n, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    mid = torch.from_numpy(rs.uniform(0, 4e19, n).astype(np.float32))
    mid[:32] = -1.0
    wl = torch.from_numpy(rs.integers(0, 3, n).astype(np.int32))
    wl[32:48] = -1
    val = torch.from_numpy(rs.random(n).astype(np.float32))
    bins, v = tft.direct_deposits(grid, pos, d, mid, val, wl, 3)
    cell = grid.locate_batched(pos + mid[:, None] * d)
    ok = (mid >= 0) & (wl >= 0) & (cell >= 0)
    assert torch.equal(bins, torch.where(ok, cell * 3 + wl, -1))
    assert torch.equal(v, torch.where(ok, val, 0.0))
    assert ok.sum() > 100 and (cell < 0).sum() > 10


# ---------------------------------------------------------------------------
# the slices end to end
# ---------------------------------------------------------------------------

def _jax_run(model, n, W, poly):
    from skirt_tpu import rng as jrng
    from skirt_tpu.engine.lifecycle import make_lifecycle

    grid, ds, ss, ins, opts = model
    run = jax.jit(make_lifecycle(grid, ds, ss, ins, opts, W))
    if poly:
        ell = jnp.zeros(n, jnp.int32)
        L0 = jnp.full((n, W), 1e36 / n, jnp.float32)
    else:
        ell = jnp.asarray(np.arange(n, dtype=np.int32) % W)
        L0 = jnp.full((n,), W * 1e36 / n, jnp.float32)
    t = run(jrng.root_key(4357), ell, L0, {
        "instruments": [ins[0].zero_tallies()],
        "labs": jnp.zeros((grid.ncells * W,), jnp.float32)})
    return (np.asarray(t["instruments"][0]["Ftot"], np.float64),
            np.asarray(t["labs"], np.float64))


def _port_run(model, n, W, poly, seed=4357):
    from skirt_tpu_torch.engine.lifecycle import make_lifecycle

    grid, ds, ss, ins, opts = model
    run = make_lifecycle(grid, ds, ss, ins, opts, W)
    if poly:
        ell = torch.zeros(n, dtype=torch.int32)
        L0 = torch.full((n, W), 1e36 / n)
    else:
        ell = torch.arange(n, dtype=torch.int32) % W
        L0 = torch.full((n,), W * 1e36 / n)
    t = run(rng.root_key(seed), ell, L0, {
        "instruments": [ins[0].zero_tallies("cpu")],
        "labs": torch.zeros(grid.ncells * W)})
    return (run, t["instruments"][0]["Ftot"].double().numpy(),
            t["labs"].double().numpy())


def _assert_slices_agree(sed, labs, jsed, jlabs, W):
    np.testing.assert_allclose(sed, jsed, rtol=0.08)
    assert labs.sum() == pytest.approx(jlabs.sum(), rel=0.06)
    np.testing.assert_allclose(labs.reshape(-1, W).sum(0),
                               jlabs.reshape(-1, W).sum(0), rtol=0.08)
    assert np.isfinite(labs).all() and (labs >= 0).all()


@pytest.mark.parametrize("poly", [False, True], ids=["mono", "poly"])
def test_slice_matches_skirt_tpu(mono_models, poly):
    """make_lifecycle(fused=True) on the exact tessellation: kernel K4d
    (one wavelength per lane, N lanes) or K6d (both wavelengths per lane,
    N / 2 lanes) with the staged peel, against skirt_tpu at the same
    per-wavelength launch totals."""
    jm, tm = mono_models
    if poly:
        jm = jm[:4] + (dataclasses.replace(jm[4], polychromatic=True),)
        tm = tm[:4] + (dataclasses.replace(tm[4], polychromatic=True),)
    n = N // 2 if poly else N
    jsed, jlabs = _jax_run(jm, n, 2, poly)
    run, sed, labs = _port_run(tm, n, 2, poly)
    assert type(run.spec) is (tftp.TablePolyEventSpec if poly
                              else tft.TableEventSpec)
    assert run.spec.arith_locate is False
    _assert_slices_agree(sed, labs, jsed, jlabs, 2)
    assert labs.shape == (tm[0].ncells * 2,) and (labs > 0).mean() > 0.5


def test_exact_peel_downgrades_with_a_warning(mono_models):
    """table_peel='exact' on the tessellation: skirt_tpu's warning, then
    the staged peel (the same optical depths as table_peel='staged')."""
    from skirt_tpu_torch.engine.lifecycle import make_lifecycle

    _, (grid, ds, ss, ins, opts) = mono_models
    exact = dataclasses.replace(opts, table_peel="exact")
    with pytest.warns(UserWarning, match=r"downgrading to 'staged' \(16 "
                      r"panels\) on VoronoiGrid"):
        make_lifecycle(grid, ds, ss, ins, exact, 2)
    with pytest.warns(UserWarning,
                      match="downgrading to 'staged' on VoronoiGrid"):
        make_lifecycle(grid, ds, ss, ins,
                       dataclasses.replace(exact, polychromatic=True), 2)
    outs = []
    for o in (exact, opts):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            outs.append(_port_run((grid, ds, ss, ins, o), 256, 2, False,
                                  seed=5)[1])
    np.testing.assert_array_equal(outs[0], outs[1])


def test_uneven_cartesian_direct_slice_matches_skirt_tpu():
    """A second direct-table grid: the uniform sphere on an uneven
    Cartesian grid (border search locate_batched, no arithmetic locate)
    through K4d, against skirt_tpu's direct branch."""
    from skirt_tpu.constants import KPC
    from skirt_tpu.grids.cartesian import CartesianGrid
    from skirt_tpu.media import DustSystem

    _, jds, jss, jins, jopts = jax_voronoi_model(table=False)
    b = np.concatenate([[-2.0], np.linspace(-1.2, 1.2, 13), [2.0]]) * KPC
    grid = CartesianGrid(b, b, b)
    tds = DustSystem(grid, jds.components, samples_per_cell=4).as_table()
    jm = (grid, tds, jss, jins, jopts)
    tm = from_skirt_tpu(*jm)
    assert not all(tm[0]._uniform)
    np.testing.assert_array_equal(tm[1].rho64, tds.rho64)
    jsed, jlabs = _jax_run(jm, N, 2, False)
    run, sed, labs = _port_run(tm, N, 2, False)
    assert run.spec.arith_locate is False
    _assert_slices_agree(sed, labs, jsed, jlabs, 2)


# ---------------------------------------------------------------------------
# the public entry point: the voxel view and the direct table
# ---------------------------------------------------------------------------

def jax_simulation(out_dir, clumpy, packets=N):
    from skirt_tpu.engine.simulation import OligoSimulation
    from skirt_tpu.log import SilentLog

    _, ds, ss, ins, opts = jax_voronoi_model(
        clumpy=clumpy, table=False, voxelize="table", polychromatic=True,
        refill_batches=4, table_peel="exact")
    return OligoSimulation(stellar_system=ss, instruments=ins,
                           dust_system=ds, packets=packets,
                           batch_size=1 << 12, dispatch_batches=1,
                           options=opts, log=SilentLog(),
                           out_dir=str(out_dir), use_mesh=False)


@pytest.mark.parametrize("clumpy", [False, True],
                         ids=["voxel-view", "direct-table"])
def test_simulation_voxelize_table_matches_skirt_tpu(tmp_path, clumpy):
    """OligoSimulation(voxelize="table"), polychromatic: on the smooth
    sphere the field error (4%) passes the 10% bound and both frameworks
    run K6 on the 53^3 voxel view; on the clumpy field (16.7%) they refuse
    it and run the direct table (K6d).  Labs land on the 300 Voronoi
    cells either way."""
    from skirt_tpu import rng as jrng
    from skirt_tpu_torch.convert import convert_simulation
    from skirt_tpu_torch.log import SilentLog

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsim = jax_simulation(tmp_path / "jax", clumpy)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tsim = convert_simulation(jsim, log=SilentLog(), device="cpu",
                                  out_dir=str(tmp_path / "torch"))
    # the direct table downgrades the exact peel, with skirt_tpu's warning
    assert any("downgrading to 'staged'" in str(w.message)
               for w in caught) == clumpy
    spec = tsim._lifecycle.spec
    assert tsim._poly and tsim.dust_system.table
    assert isinstance(spec, tftp.TablePolyEventSpec)
    assert spec.arith_locate is (not clumpy)
    assert (tsim._labs_fold is None) == clumpy == (jsim._labs_fold is None)
    assert type(tsim.grid).__name__ == type(jsim.grid).__name__
    assert tsim.grid.ncells == jsim.grid.ncells
    if not clumpy:
        vds = tsim.dust_system
        assert vds.voxelization_error == pytest.approx(
            jsim.dust_system.voxelization_error, rel=1e-6)
        assert vds.voxelization_error < 0.1 and tsim.grid.nx == 53
    accj = jsim._run_phase(jrng.root_key(4357), 0)
    acct = tsim._run_phase(rng.root_key(4357), 0)
    assert acct["labs"].shape == accj["labs"].shape == (300 * 2,)
    _assert_slices_agree(acct["instruments"][0]["Ftot"], acct["labs"],
                         accj["instruments"][0]["Ftot"], accj["labs"], 2)
