"""Slice S4a on the CPU: the octree torus model, the table densities, the
exact peel and kernel K4 against skirt_tpu.

The model is tests/test_voxelize.py's small octree torus (max_level 4:
16^3 voxels, tau_x = 3) and the instrument of tests/test_fused_table.py
(inclination 1.2, azimuth 0.7), with N = 2^13 lanes, 24 propagation and
8 peel panels, max_scatt_events 48.

- Host state must be identical: the torus density, the octree's leaves,
  the voxel view's cell_of, the gridded rho64 (the same numpy draws).
- Float32 device rows agree to rtol 1e-5: the table analytic_rows (the
  arithmetic locate and the rho gather), rho_at, and the exact peel in
  both of its lateral branches (azimuth 0: one lateral axis inactive;
  0.7: both active, merged crossings).  XLA's CPU backend may fuse a*b+c
  into one rounding where torch rounds twice, so crossings and sums
  differ in the last ulp.
- Kernel K4: the plain event against the Pallas body (interpret mode) on
  identical numpy-made inputs, by skirt_tpu_torch.testing's criterion:
  discrete outputs (deposit bin, alive, nscatt) on >= 99.9% of 1,024
  lanes (a float32 comparison landing within an ulp may flip between the
  two rounding styles), floats to rtol 1e-4 on every discretely agreeing
  lane but at most FLOAT_BAD_LANES.
- End to end at Monte Carlo tolerance (the two frameworks draw different
  random streams): the slice against skirt_tpu's fused table engine (SED
  per wavelength 0.05 and labs 0.05, as tests/test_fused_table.py holds
  its fused run; 0.06 with refill), and OligoSimulation(voxelize='table')
  against skirt_tpu's with the labs folded onto the leaves.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from skirt_tpu.engine import fused_table as jft
from skirt_tpu_torch import rng
from skirt_tpu_torch.constants import KPC
from skirt_tpu_torch.convert import from_skirt_tpu
from skirt_tpu_torch.engine import fused_table as tft
from skirt_tpu_torch.testing import (event_agreement, table_event_inputs,
                                     table_state)

from test_voxelize import _torus_setup

torch.set_num_threads(2)

N = 1 << 13
R = 8                       # event parity: rows of 128 lanes, 1,024 lanes
NPANELS = 24
FLOAT_BAD_LANES = 2         # of 1,024 (module docstring)


def jax_table_model(azimuth=0.7, **opt_kw):
    """tests/test_fused_table.py's table model in skirt_tpu: (grid, table
    dust system, stellar system, instruments, options)."""
    from skirt_tpu.engine.lifecycle import LifecycleOptions
    from skirt_tpu.instruments import SEDInstrument

    wg, ss, grid, dsys = _torus_setup()
    vds, _ = dsys.voxelized()
    tds = vds.as_table()
    ins = [SEDInstrument("sed", 3.08e23, 2, inclination=1.2,
                         azimuth=azimuth)]
    kw = dict(store_absorption=True, max_scatt_events=48,
              deposition="sampled", quadrature_panels=NPANELS, peel_panels=8,
              fused=True, table_peel="exact")
    kw.update(opt_kw)
    return tds.grid, tds, ss, ins, LifecycleOptions(**kw)


@pytest.fixture(scope="module")
def models():
    jm = jax_table_model()
    return jm, from_skirt_tpu(*jm)


# ---------------------------------------------------------------------------
# the host model: identical
# ---------------------------------------------------------------------------

def _port_native():
    """The same torus model built from the port's own classes."""
    from skirt_tpu_torch.geometry import TorusGeometry
    from skirt_tpu_torch.grids import OctreeGrid
    from skirt_tpu_torch.media import (DustComponent, DustSystem,
                                       OpticalDepthNormalization,
                                       SimpleOligoDustMix)
    from skirt_tpu_torch.wavelengths import OligoWavelengthGrid

    wg = OligoWavelengthGrid([0.55e-6, 2.2e-6])
    torus = TorusGeometry(1.0, 2.0, 0.7, 0.05 * KPC, 2 * KPC)
    half = 2.2 * KPC
    grid = OctreeGrid((-half, -half, -half, half, half, half),
                      lambda pos: torus.density(pos), min_level=2,
                      max_level=4)
    mix = SimpleOligoDustMix(wg, [2600.0, 600.0], [0.5, 0.4], [0.4, 0.2])
    comp = DustComponent(torus, mix,
                         OpticalDepthNormalization("x", wg.lambdav[0], 3.0))
    return torus, grid, DustSystem(grid, [comp], samples_per_cell=8)


def test_host_model_identical():
    """Torus density and normalisation, octree leaves and cell numbers,
    the voxel view and its cell_of, the gridded densities: bit for bit."""
    _, _, jgrid, jds = _torus_setup()
    jtorus = jds.components[0].geometry
    torus, grid, ds = _port_native()
    assert torus.A == jtorus.A and torus.sigma_x() == jtorus.sigma_x()
    pos = np.random.default_rng(4).uniform(-2.2, 2.2, (5000, 3)) * KPC
    np.testing.assert_array_equal(torus.density(pos),
                                  np.asarray(jtorus.density(pos)))
    assert (torus.density(pos) > 0).mean() > 0.1
    for name in ("lo64", "hi64", "child64", "levels", "leaf_nodes",
                 "cellnum64"):
        np.testing.assert_array_equal(getattr(grid, name),
                                      getattr(jgrid, name))
    (cart, cell_of), (jcart, jcell_of) = grid.voxelize(), jgrid.voxelize()
    np.testing.assert_array_equal(cell_of, jcell_of)
    for b in ("xb64", "yb64", "zb64"):
        np.testing.assert_array_equal(getattr(cart, b), getattr(jcart, b))
    assert cart._uniform == jcart._uniform and cart._dx == jcart._dx
    np.testing.assert_array_equal(ds.rho64, jds.rho64)
    (vds, fold), (jvds, jfold) = ds.voxelized(), jds.voxelized()
    np.testing.assert_array_equal(vds.rho64, jvds.rho64)
    assert vds.gridded_mass() == jvds.gridded_mass()
    labs = np.random.default_rng(5).random(cart.ncells * 2)
    np.testing.assert_array_equal(fold(labs), jfold(labs))
    assert ds.voxelized(max_voxels=10) is None


# ---------------------------------------------------------------------------
# device rows: float32-tight
# ---------------------------------------------------------------------------

def _rays(n, seed):
    rs = np.random.default_rng(seed)
    pos = rs.uniform(-2.0, 2.0, (n, 3)) * KPC
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return pos.astype(np.float32), d.astype(np.float32)


def test_table_rows_match(models):
    """Panel paths, the arithmetic locate and the rho gather of the table
    analytic_rows; rho_at and the border-search locate on their own."""
    from skirt_tpu.engine import vector_traversal as jvt
    from skirt_tpu_torch.engine import vector_traversal as tvt

    (jgrid, jds, *_), (grid, ds, *_) = models
    pos, d = _rays(2048, 6)
    ell = np.arange(2048, dtype=np.int32) % 2
    jds_, jmid_ = jvt.panel_paths(jgrid, jnp.asarray(pos), jnp.asarray(d),
                                  NPANELS)[::2]
    _, jke = jds.packet_kappas(jnp.asarray(ell))
    jrows = np.asarray(jds.analytic_rows(jnp.asarray(pos), jnp.asarray(d),
                                         jmid_, None, jke, want_sca=False))
    pt, dt_ = torch.from_numpy(pos), torch.from_numpy(d)
    tds_, _, tmid = tvt.panel_paths(grid, pt, dt_, NPANELS)
    _, tke = ds.packet_kappas(torch.from_numpy(ell))
    trows = ds.analytic_rows(pt, dt_, tmid, None, tke, want_sca=False)
    np.testing.assert_allclose(tmid.numpy(), np.asarray(jmid_), rtol=1e-6)
    np.testing.assert_allclose(trows.numpy(), jrows, rtol=1e-5,
                               atol=1e-6 * np.abs(jrows).max())
    assert (jrows > 0).mean() > 0.2
    cells = np.random.default_rng(7).integers(0, grid.ncells, 4096)
    np.testing.assert_array_equal(
        ds.rho_at(0, torch.from_numpy(cells)).numpy(),
        np.asarray(jds.rho_at(0, jnp.asarray(cells))))
    np.testing.assert_array_equal(grid.locate(pt).numpy(),
                                  np.asarray(jgrid.locate(jnp.asarray(pos))))
    np.testing.assert_array_equal(
        grid.locate_batched(pt).numpy(),
        np.asarray(jgrid.locate_batched(jnp.asarray(pos))))


@pytest.mark.parametrize("azimuth", [0.0, 0.7],
                         ids=["one-lateral-axis", "two-lateral-axes"])
def test_exact_peel_matches(azimuth):
    """The column-DDA peel optical depths toward an inclination-1.2
    observer: azimuth 0 leaves one lateral axis inactive (the main path's
    instrument), azimuth 0.7 merges two crossing sequences."""
    jm = jax_table_model(azimuth=azimuth)
    grid, ds, _, ins, _ = from_skirt_tpu(*jm)
    leaders = [tuple(float(v) for v in ins[0].kobs)]
    pos, _ = _rays(4096, 8)
    ell = np.arange(4096, dtype=np.int32) % 2
    _, jke = jm[1].packet_kappas(jnp.asarray(ell))
    jt = np.asarray(jft.make_exact_peel(jm[0], jm[1], leaders)(
        jnp.asarray(pos), jke)[0])
    _, tke = ds.packet_kappas(torch.from_numpy(ell))
    tt = tft.make_exact_peel(grid, ds, leaders)(torch.from_numpy(pos),
                                                tke)[0].numpy()
    np.testing.assert_allclose(tt, jt, rtol=1e-5, atol=1e-6 * jt.max())
    assert (jt > 0.01).mean() > 0.3


# ---------------------------------------------------------------------------
# kernel K4: the plain event against the Pallas body
# ---------------------------------------------------------------------------

def jax_event(model, inputs, npanels=NPANELS):
    """skirt_tpu's K4 Pallas body in interpret mode, called as
    make_fused_table_lifecycle's call_kernel calls it."""
    grid, ds, ss, ins, options = model
    want_labs = bool(options.store_absorption)
    kern = jft._build_kernel(grid, options, 2, npanels, want_labs, True)
    u, kr, state = inputs
    tr = min(32, R)

    def blk():
        return pl.BlockSpec((tr, 128), lambda i: (i, 0),
                            memory_space=pltpu.VMEM)

    out_dtypes = ([jnp.float32] * 7 + [jnp.int32] * 2
                  + ([jnp.int32, jnp.float32] if want_labs else []))
    outs = pl.pallas_call(
        kern, grid=(R // tr,),
        in_specs=[pl.BlockSpec((5, tr, 128), lambda i: (0, i, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((npanels, tr, 128), lambda i: (0, i, 0),
                               memory_space=pltpu.VMEM)]
        + [blk() for _ in state],
        out_specs=tuple(blk() for _ in out_dtypes),
        out_shape=tuple(jax.ShapeDtypeStruct((R, 128), dt)
                        for dt in out_dtypes),
        interpret=True,
    )(jnp.array(u.reshape(5, R, 128)), jnp.array(kr.reshape(-1, R, 128)),
      *[jnp.array(s.reshape(R, 128)) for s in state])
    outs = [torch.from_numpy(np.array(o).reshape(-1))
            for o in jax.block_until_ready(outs)]
    res = {"state": outs[:9]}
    if want_labs:
        res["depi"], res["depv"] = outs[9], outs[10]
    return res


def test_event_past_32_panels_matches_pallas(models):
    """40 panels: a shape past the card's one-pass route (the chunked
    route's)."""
    (jm, (grid, ds, ss, ins, opts)) = models
    cut = dict(min_weight_reduction=20.0, min_scatt_events=1)
    jm = jm[:4] + (dataclasses.replace(jm[4], **cut),)
    P = 40
    inp = table_event_inputs(ds, R * 128, 5, 2, seed=40, npanels=P,
                             small_tau=0.01, outside=0.01)
    kr, state = table_state(inp, ds)
    spec = tft._build_kernel(grid, dataclasses.replace(opts, **cut), 2, P,
                             True)
    got = tft.table_event(spec, inp["u"], kr, state)
    want = jax_event(jm, (inp["u"].numpy(), kr.numpy(),
                          [s.numpy() for s in state]), npanels=P)
    res = event_agreement(got, want)
    assert res["discrete"] >= 0.999, res
    assert res["float_bad"] <= FLOAT_BAD_LANES, res
    assert (got["depi"] >= 0).sum() > 300


@pytest.mark.parametrize("labs", [True, False], ids=["labs", "nolabs"])
def test_event_matches_pallas(models, labs):
    (jm, (grid, ds, ss, ins, opts)) = models
    cut = dict(min_weight_reduction=20.0, min_scatt_events=1)
    jm = jm[:4] + (dataclasses.replace(jm[4], store_absorption=labs,
                                       **cut),)
    n = R * 128
    inp = table_event_inputs(ds, n, 5, 2, seed=11 + labs, npanels=NPANELS,
                             small_tau=0.01, outside=0.01)
    kr, state = table_state(inp, ds)
    spec = tft._build_kernel(grid, dataclasses.replace(opts, **cut), 2,
                             NPANELS, labs)
    got = tft.table_event(spec, inp["u"], kr, state)
    want = jax_event(jm, (inp["u"].numpy(), kr.numpy(),
                          [s.numpy() for s in state]))
    res = event_agreement(got, want)
    assert res["discrete"] >= 0.999, res
    assert res["float_bad"] <= FLOAT_BAD_LANES, res
    # the inputs exercise every branch: deposits, kills, scatters
    alive_in = state[7] != 0
    alive = got["state"][7] != 0
    assert (alive_in & ~alive).sum() > 50 and alive.sum() > 300
    assert (got["state"][8] > state[8]).sum() > 300
    if labs:
        assert (got["depi"] >= 0).sum() > 300
        assert (got["depi"][inp["outside"] & alive_in] < 0).all()
    else:
        assert "depi" not in got


def test_event_wrapper_takes_plain_version_on_cpu(models):
    """On CPU tensors the wrapper runs the plain version and launches no
    kernel (the launch count stays put)."""
    _, (grid, ds, ss, ins, opts) = models
    inp = table_event_inputs(ds, 256, 5, 2, seed=3, npanels=NPANELS)
    kr, state = table_state(inp, ds)
    spec = tft._build_kernel(grid, opts, 2, NPANELS, True)
    before = tft.table_event.launches
    out = tft.table_event(spec, inp["u"], kr, state)
    assert tft.table_event.launches == before
    for a, b in zip(out["state"], tft.table_event_plain(
            spec, inp["u"], kr, state)["state"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------

def _jax_run(model, n, refill=0, mueller=None):
    from skirt_tpu import rng as jrng
    from skirt_tpu.engine.lifecycle import make_lifecycle

    grid, ds, ss, ins, opts = model
    opts = dataclasses.replace(opts, refill_batches=refill)
    ell = jnp.asarray(np.arange(n, dtype=np.int32) % 2)
    L0 = jnp.full((n,), 1e36 / N, jnp.float32)
    run = jax.jit(make_lifecycle(grid, ds, ss, ins, opts, 2,
                                 mueller=mueller))
    t = run(jrng.root_key(4357), ell, L0, {
        "instruments": [ins[0].zero_tallies()],
        "labs": jnp.zeros((grid.ncells * 2,), jnp.float32)})
    return jax.tree.map(lambda a: np.asarray(a, np.float64), t)


def _port_run(model, n, refill=0, seed=4357, mueller=None, **opt_kw):
    from skirt_tpu_torch.engine.lifecycle import make_lifecycle

    grid, ds, ss, ins, opts = model
    opts = dataclasses.replace(opts, refill_batches=refill, **opt_kw)
    run = make_lifecycle(grid, ds, ss, ins, opts, 2, mueller=mueller)
    t = run(rng.root_key(seed), torch.arange(n, dtype=torch.int32) % 2,
            torch.full((n,), 1e36 / N), {
                "instruments": [ins[0].zero_tallies("cpu")],
                "labs": torch.zeros(grid.ncells * 2)})
    return run, {"sed": t["instruments"][0]["Ftot"].double().numpy(),
                 "labs": t["labs"].double().numpy(),
                 "nevents": float(t.get("nevents", 0.0))}


@pytest.mark.parametrize("refill", [0, 4], ids=["plain", "refill"])
def test_slice_matches_skirt_tpu(models, refill):
    """make_lifecycle(fused=True) on the table model: kernel K4 with the
    exact peel against skirt_tpu's fused table engine; with refill, K = 4
    packets on N / 4 persistent lanes."""
    jm, tm = models
    n = N // 4 if refill else N
    tj = _jax_run(jm, n, refill)
    run, tt = _port_run(tm, n, refill)
    assert isinstance(run.spec, tft.TableEventSpec)
    tol = 0.06 if refill else 0.05
    np.testing.assert_allclose(tt["sed"], tj["instruments"][0]["Ftot"],
                               rtol=tol)
    assert tt["labs"].sum() == pytest.approx(tj["labs"].sum(), rel=tol)
    assert np.isfinite(tt["labs"]).all() and (tt["labs"] >= 0).all()


def test_polarized_slice_matches_skirt_tpu(models):
    """The polarized mono table engine (K4 with the torch-side Mueller
    scatter and peel) on the torus with the Thomson Mueller tables, as
    experiments/bench_polarized.py runs its table chain: SED and labs
    against skirt_tpu's at the table tolerance (0.05)."""
    from skirt_tpu.media.polarization import thomson_mueller as jthomson
    from skirt_tpu_torch.media.polarization import thomson_mueller

    jm, tm = models
    tj = _jax_run(jm, N, mueller=jthomson(2))
    run, tt = _port_run(tm, N, mueller=thomson_mueller(2))
    assert isinstance(run.spec, tft.TableEventSpec)
    np.testing.assert_allclose(tt["sed"], tj["instruments"][0]["Ftot"],
                               rtol=0.05)
    assert tt["labs"].sum() == pytest.approx(tj["labs"].sum(), rel=0.05)


def test_count_events_and_staged_peel(models):
    """count_events adds the events run (at least one per launched packet,
    no more than max_scatt_events each); the staged peel at 64 panels
    agrees with the exact one (tests/test_fused_table.py's 1%, here on
    different event streams at Monte Carlo tolerance)."""
    _, tm = models
    _, te = _port_run(tm, N // 2, count_events=True)
    assert N // 2 <= te["nevents"] <= 48 * N // 2
    _, ts = _port_run(tm, N // 2, seed=99, table_peel="staged",
                      peel_panels=64)
    np.testing.assert_allclose(ts["sed"], te["sed"], rtol=0.05)


def test_unported_table_branches_raise(models):
    from skirt_tpu_torch.engine.lifecycle import make_lifecycle

    _, (grid, ds, ss, ins, opts) = models
    for kw, slice_ in ((dict(table_peel="taumap"), "S2b"),):
        with pytest.raises(ValueError, match=f"slice {slice_}"):
            make_lifecycle(grid, ds, ss, ins,
                           dataclasses.replace(opts, **kw), 2)
    # a Mueller table builds the polarized engine around the unchanged K4
    from skirt_tpu_torch.media.polarization import thomson_mueller
    run = make_lifecycle(grid, ds, ss, ins, opts, 2,
                         mueller=thomson_mueller(2))
    assert type(run.spec) is tft.TableEventSpec and run.spec.arith_locate
    # several dust components build (kernel K5); with polarization or on
    # a non-uniform grid they raise in skirt_tpu's words.  One component on
    # the non-uniform grid builds the direct table (kernel K4d, staged peel)
    two = type(ds).from_state(grid, ds.components * 2,
                              np.concatenate([ds.rho64, ds.rho64]), "table")
    assert isinstance(make_lifecycle(grid, two, ss, ins, opts, 2).spec,
                      tft.TableMultiEventSpec)
    with pytest.raises(ValueError, match="single-component only"):
        make_lifecycle(grid, two, ss, ins, opts, 2, mueller=object())
    from skirt_tpu_torch.grids import CartesianGrid
    b = np.concatenate([[-2.2], np.linspace(-1, 1, 14), [2.2]]) * KPC
    uneven = CartesianGrid(b, b, b)
    ds_u = type(ds).from_state(uneven, ds.components,
                               np.zeros((1, uneven.ncells)), "table")
    with pytest.warns(UserWarning, match="downgrading to 'staged'"):
        spec = make_lifecycle(uneven, ds_u, ss, ins, opts, 2).spec
    assert type(spec) is tft.TableEventSpec and not spec.arith_locate
    two_u = type(ds).from_state(uneven, ds.components * 2,
                                np.zeros((2, uneven.ncells)), "table")
    with pytest.raises(ValueError, match="uniform Cartesian voxel view"):
        make_lifecycle(uneven, two_u, ss, ins, opts, 2)


# ---------------------------------------------------------------------------
# the public entry point
# ---------------------------------------------------------------------------

def jax_simulation(out_dir, packets=N):
    from skirt_tpu.engine.lifecycle import LifecycleOptions
    from skirt_tpu.engine.simulation import OligoSimulation
    from skirt_tpu.instruments import SEDInstrument
    from skirt_tpu.log import SilentLog

    wg, ss, grid, dsys = _torus_setup()
    ins = [SEDInstrument("sed", 3.08e23, 2, inclination=1.2, azimuth=0.7)]
    opts = LifecycleOptions(store_absorption=True, voxelize="table",
                            deposition="sampled", quadrature_panels=NPANELS,
                            max_scatt_events=48, fused=True, refill_batches=4)
    return OligoSimulation(stellar_system=ss, instruments=ins,
                           dust_system=dsys, packets=packets,
                           batch_size=1 << 11, dispatch_batches=2,
                           options=opts, log=SilentLog(), out_dir=str(out_dir),
                           use_mesh=False)


def test_simulation_voxelize_table_matches_skirt_tpu(tmp_path):
    """OligoSimulation(voxelize='table') on the octree torus: both
    frameworks voxelize, run the fused table engine and fold the labs
    back onto the 2,066 leaves."""
    from skirt_tpu_torch.convert import convert_simulation
    from skirt_tpu_torch.log import SilentLog

    jsim = jax_simulation(tmp_path / "jax")
    tsim = convert_simulation(jsim, log=SilentLog(), device="cpu",
                              out_dir=str(tmp_path / "torch"))
    assert tsim.dust_system.table and tsim._labs_fold is not None
    assert isinstance(tsim._lifecycle.spec, tft.TableEventSpec)
    assert tsim.grid.ncells == jsim.grid.ncells == 16 ** 3
    from skirt_tpu import rng as jrng

    accj = jsim._run_phase(jrng.root_key(4357), 0)
    acct = tsim._run_phase(rng.root_key(4357), 0)
    ncells = jsim.dust_system_out.grid.ncells
    assert acct["labs"].shape == accj["labs"].shape == (ncells * 2,)
    np.testing.assert_allclose(acct["instruments"][0]["Ftot"],
                               accj["instruments"][0]["Ftot"], rtol=0.05)
    assert acct["labs"].sum() == pytest.approx(accj["labs"].sum(), rel=0.05)
    lj = accj["labs"].reshape(-1, 2).sum(1)
    lt = acct["labs"].reshape(-1, 2).sum(1)
    # the brightest leaves (a third of the absorbed energy) agree at MC
    # tolerance cell by cell
    top = np.argsort(lj)[::-1][:8]
    np.testing.assert_allclose(lt[top], lj[top], rtol=0.25)


def test_default_device_is_the_card(monkeypatch, tmp_path):
    """Without a CUDA device the entry points refuse to run unless they are
    given device='cpu'; they never fall back quietly."""
    from skirt_tpu_torch.convert import convert_simulation
    from skirt_tpu_torch.geometry import PointGeometry
    from skirt_tpu_torch.log import SilentLog

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jsim = jax_simulation(tmp_path, packets=1 << 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert_simulation(jsim, log=SilentLog())
    tsim = convert_simulation(jsim, log=SilentLog(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        type(tsim)(stellar_system=tsim.stellar_system,
                   instruments=tsim.instruments,
                   dust_system=tsim.dust_system_out, options=tsim.options,
                   log=SilentLog())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsim.instruments[0].zero_tallies()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PointGeometry().generate_position(1, 8)
    assert tsim.device.type == "cpu"
