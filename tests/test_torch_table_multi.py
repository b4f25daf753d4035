"""The multi-component voxel-table path on the CPU: kernels K5 and K7, the
two-component model and its slices against skirt_tpu.

The model is tests/test_fused_table.py's TestMultiComponentFused._setup2:
a point source in the AGN torus (mix 1) inside a uniform dust sphere (mix
2, by dust mass) on an octree (max_level 4: 16^3 voxels), one SED
instrument at inclination 1.2, azimuth 0.7; 24 propagation panels,
max_scatt_events 48, the exact peel.

- Host state must be identical: the sphere's density and normalisation,
  the converted system's gridded rho64 per component, its float32
  kappa_ext, kappa_sca and g per component, the (3H, W) constants of K7.
- Kernels K5 and K7: the plain events against the Pallas bodies
  (interpret mode) on identical numpy-made inputs, by
  skirt_tpu_torch.testing's criterion: discrete outputs (deposit bin,
  alive, nscatt, K5's interaction cell, K7's surviving wavelengths) on
  >= 99.9% of 1,024 lanes (a float32 comparison landing within an ulp may
  flip between the rounding of XLA's CPU backend, which fuses a*b+c, and
  torch's), floats to rtol 1e-4 on every discretely agreeing lane but at
  most FLOAT_BAD_LANES.  K7 at W = 1, 2 and 24 with H = 2, and at W = 2
  with a third component.  At W = 24 mix 2's g passes near 0 (it falls
  from 0.1 to 0), where the HG inversion cos = (1 + g^2 - f^2) / 2g
  cancels and magnifies XLA's contraction of that sum into an FMA by
  1 / |g|: scattered directions there differ by up to ~2e-5 absolute, so
  K7's cap at W = 24 is K7_FLOAT_BAD_LANES (on the card, kernel and plain
  version agree on every lane).
- End to end at Monte Carlo tolerance (the frameworks draw different
  random streams), at the tolerances skirt_tpu's own tests hold these
  engines to: the multi-component mono slice (K5) at
  tests/test_fused_table.py's (SED and labs total 0.06, 0.08 with
  refill), the multi-component poly slice (K7) at
  tests/test_poly.py::TestPolyMulti's (SED 0.06, labs 0.06, per-wavelength
  labs split 0.08), and OligoSimulation(voxelize='table') on the octree.
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
from skirt_tpu.engine import fused_table_poly as jftp
from skirt_tpu_torch import rng
from skirt_tpu_torch.constants import KPC
from skirt_tpu_torch.convert import from_skirt_tpu
from skirt_tpu_torch.engine import fused_table as tft
from skirt_tpu_torch.engine import fused_table_poly as tftp
from skirt_tpu_torch.testing import (event_agreement, table_event_inputs,
                                     table_multi_state, table_poly_state)

torch.set_num_threads(2)

N = 1 << 13
R = 8                       # event parity: rows of 128 lanes, 1,024 lanes
NPANELS = 24
FLOAT_BAD_LANES = 2         # of 1,024 (module docstring)
K7_FLOAT_BAD_LANES = 8      # of 1,024, K7 at W = 24 only (docstring)


def jax_multi_model(W=2, H=2, voxelize=True, **opt_kw):
    """The two-component model in skirt_tpu (W = 2: exactly
    TestMultiComponentFused._setup2; other W: log-spaced wavelengths from
    0.55 to 2.2 um with each mix's optics interpolated in log lambda; H = 3
    adds a third component, a denser 0.9 kpc sphere, H = 4 a fourth, a
    thin shell of the torus's extent), voxelized, in table
    mode, with one SED instrument: (grid, dust system, stellar system,
    instruments, options).  With voxelize=False: (stellar system, gridded
    leaf-resolution dust system) before the voxel view."""
    from skirt_tpu.constants import KPC as JKPC
    from skirt_tpu.engine.lifecycle import LifecycleOptions
    from skirt_tpu.geometry import (PointGeometry, TorusGeometry,
                                    UniformSphereGeometry)
    from skirt_tpu.grids.octree import OctreeGrid
    from skirt_tpu.instruments import SEDInstrument
    from skirt_tpu.media import (DustComponent, DustMassNormalization,
                                 DustSystem, OpticalDepthNormalization,
                                 SimpleOligoDustMix)
    from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                           StellarSystem)
    from skirt_tpu.wavelengths import OligoWavelengthGrid

    lams = np.geomspace(0.55e-6, 2.2e-6, W) if W > 1 else [0.55e-6]
    f = np.log(np.asarray(lams) / 0.55e-6) / np.log(4.0)

    def lerp(a, b, geometric=False):
        # exact end values, so that W = 2 is _setup2's model to the bit
        mid = [a * (b / a) ** x if geometric else a + (b - a) * x
               for x in f]
        return [a if i == 0 else b if i == W - 1 and W > 1 else v
                for i, v in enumerate(mid)]

    wg = OligoWavelengthGrid(list(lams))
    ss = StellarSystem([LuminosityStellarComponent(PointGeometry(), wg,
                                                   [1e36] * W)])
    torus = TorusGeometry(1.0, 2.0, 0.7, 0.05 * JKPC, 2 * JKPC)
    sphere = UniformSphereGeometry(1.8 * JKPC)
    half = 2.2 * JKPC
    grid = OctreeGrid((-half, -half, -half, half, half, half),
                      lambda pos: np.asarray(torus.density(pos))
                      + np.asarray(sphere.density(pos)),
                      min_level=2, max_level=4)
    mix1 = SimpleOligoDustMix(wg, lerp(2600.0, 600.0, True), lerp(0.5, 0.4),
                              lerp(0.5, 0.3))
    mix2 = SimpleOligoDustMix(wg, lerp(1800.0, 900.0, True), lerp(0.7, 0.6),
                              lerp(0.1, 0.0))
    vol = 4 / 3 * np.pi * (1.8 * JKPC) ** 3
    comps = [DustComponent(torus, mix1, OpticalDepthNormalization(
                 "x", 0.55e-6, 2.0)),
             DustComponent(sphere, mix2, DustMassNormalization(
                 1.0 / 1800.0 * vol / (1.8 * JKPC)))]
    if H >= 3:
        core = UniformSphereGeometry(0.9 * JKPC)
        mix3 = SimpleOligoDustMix(wg, lerp(3000.0, 900.0, True),
                                  lerp(0.3, 0.2), lerp(-0.2, 0.4))
        comps.append(DustComponent(core, mix3, DustMassNormalization(
            0.5 / 3000.0 * 4 / 3 * np.pi * (0.9 * JKPC) ** 3 / (0.9 * JKPC))))
    if H == 4:
        mix4 = SimpleOligoDustMix(wg, lerp(1200.0, 700.0, True),
                                  lerp(0.6, 0.5), lerp(0.3, 0.1))
        comps.append(DustComponent(
            TorusGeometry(0.5, 1.2, 0.3, 0.2 * JKPC, 1.6 * JKPC), mix4,
            OpticalDepthNormalization("x", 0.55e-6, 0.7)))
    ds = DustSystem(grid, comps, samples_per_cell=8)
    if not voxelize:
        return ss, ds
    tds = ds.voxelized()[0].as_table()
    ins = [SEDInstrument("sed", 3.08e23, W, inclination=1.2, azimuth=0.7)]
    kw = dict(store_absorption=True, max_scatt_events=48,
              deposition="sampled", quadrature_panels=NPANELS, peel_panels=8,
              fused=True, table_peel="exact")
    kw.update(opt_kw)
    return tds.grid, tds, ss, ins, LifecycleOptions(**kw)


@pytest.fixture(scope="module")
def models():
    jm = jax_multi_model()
    return jm, from_skirt_tpu(*jm)


# ---------------------------------------------------------------------------
# the host model and the pieces around the kernels
# ---------------------------------------------------------------------------

def test_model_is_test_fused_tables_two_component_model(models):
    """At W = 2 the model is TestMultiComponentFused._setup2's."""
    from test_fused_table import TestMultiComponentFused

    _, ss, tds = TestMultiComponentFused()._setup2()
    (_, jds, *_), _ = models
    np.testing.assert_array_equal(jds.rho64, tds.rho64)
    for a in ("kappaext", "kappasca", "g"):
        np.testing.assert_array_equal(getattr(jds, a), getattr(tds, a))


def test_converted_constants(models):
    """The converted two-component system: gridded densities per
    component, float32 opacities and g per component, the sphere's host
    quantities, and the constants the kernels close over."""
    (jgrid, jds, *_), (grid, ds, ss, ins, opts) = models
    assert ds.ncomp == jds.ncomp == 2 and ds.table
    np.testing.assert_array_equal(ds.rho64, jds.rho64)
    np.testing.assert_array_equal(ds.rho, np.asarray(jds.rho))
    for a in ("kappaext", "kappasca", "kappaabs", "g"):
        np.testing.assert_array_equal(getattr(ds, a),
                                      np.asarray(getattr(jds, a)))
    np.testing.assert_array_equal(ds.masses, jds.masses)
    js, ts = jds.components[1].geometry, ds.components[1].geometry
    assert (ts.rmax, ts.volume, ts.sigma_x()) == \
        (js.rmax, js.volume, js.sigma_x())
    pos = np.random.default_rng(3).uniform(-2.2, 2.2, (4000, 3)) * KPC
    np.testing.assert_array_equal(ts.density(pos), np.asarray(js.density(pos)))
    spec = tftp._build_kernel_multi(grid, ds, opts, 2, NPANELS, True)
    want = np.concatenate([np.asarray(jds.kappaext, np.float32)[:, :2],
                           np.asarray(jds.kappasca, np.float32)[:, :2],
                           np.stack([np.asarray(c.mix.g, np.float32)[:2]
                                     for c in jds.components])])
    np.testing.assert_array_equal(spec.oc, want)
    assert spec.H == 2 and spec.n_uniform == 8
    spec5 = tft._build_kernel_multi(grid, opts, 2, NPANELS, True)
    assert spec5.n_uniform == 3 and spec5.xi == np.float32(0.5)


def test_sphere_device_forms_and_scatter_helpers():
    """UniformSphereGeometry's float32 closed form and sampler on identical
    inputs; lifecycle.hg_costheta on identical uniforms; the port's
    direction_about_axis draws its own azimuths: unit vectors at the
    requested polar cosine, azimuths uniform."""
    from skirt_tpu.engine.lifecycle import hg_costheta as j_hg
    from skirt_tpu.geometry import UniformSphereGeometry as JSphere
    from skirt_tpu_torch.engine.lifecycle import hg_costheta
    from skirt_tpu_torch.geometry import UniformSphereGeometry

    js, ts = JSphere(1.8 * KPC), UniformSphereGeometry(1.8 * KPC)
    L = 4.4 * KPC
    xs = np.random.default_rng(4).uniform(-0.6, 0.6, (3, 5000)) \
        .astype(np.float32)
    want = np.asarray(js.density_scaled_xyz(*[jnp.asarray(x) for x in xs], L))
    got = ts.density_scaled_xyz(*[torch.from_numpy(x) for x in xs], L)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.1 < (want > 0).mean() < 0.9
    u = np.random.default_rng(5).uniform(1e-7, 1 - 1e-7, (3, 5000)) \
        .astype(np.float32)
    nj, fj = js.device_sampler_xyz()
    nt, ft = ts.device_sampler_xyz()
    assert nj == nt == 3
    for a, b in zip(ft([torch.from_numpy(x) for x in u]),
                    fj([jnp.asarray(x) for x in u])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6 * 1.8 * KPC)
    p = ts.generate_position(rng.root_key(3), 100000, "cpu").double()
    r = torch.linalg.norm(p, dim=1).numpy() / (1.8 * KPC)
    assert r.max() <= 1.0 + 1e-6
    assert np.mean(r ** 3) == pytest.approx(0.5, abs=0.01)
    g = np.random.default_rng(6).uniform(-0.9, 0.9, 5000).astype(np.float32)
    g[:50] = 0.0
    ug = u[0]
    np.testing.assert_allclose(
        hg_costheta(torch.from_numpy(g), torch.from_numpy(ug)).numpy(),
        np.asarray(j_hg(jnp.asarray(g), jnp.asarray(ug))), rtol=1e-5,
        atol=1e-6)
    axis = rng.isotropic_direction(7, (20000,), "cpu")
    cos = torch.from_numpy(np.random.default_rng(8).uniform(-1, 1, 20000)
                           .astype(np.float32))
    d = rng.direction_about_axis(9, axis, cos)
    np.testing.assert_allclose(torch.linalg.norm(d, dim=1).numpy(), 1.0,
                               rtol=1e-6)
    np.testing.assert_allclose((d * axis).sum(1).numpy(), cos.numpy(),
                               atol=1e-5)
    # the azimuth about +z axes is uniform: its mean cosine vanishes
    dz = rng.direction_about_axis(
        10, torch.tensor([[0.0, 0.0, 1.0]]).expand(20000, 3), cos)
    assert abs(float(dz[:, 0].mean())) < 0.02


# ---------------------------------------------------------------------------
# kernel K5: the plain event against the Pallas body
# ---------------------------------------------------------------------------

def jax_k5(model, inputs, labs):
    """skirt_tpu's K5 Pallas body in interpret mode, called as
    make_fused_table_lifecycle's call_kernel_multi calls it."""
    grid, ds, ss, ins, options = model
    kern = jft._build_kernel_multi(grid, options, 2, NPANELS, labs)
    u, kr, ks, state = inputs
    tr = min(32, R)

    def blk():
        return pl.BlockSpec((tr, 128), lambda i: (i, 0),
                            memory_space=pltpu.VMEM)

    out_dtypes = ([jnp.float32] * 4 + [jnp.int32] * 2
                  + ([jnp.int32, jnp.float32] if labs else []))
    row_spec = pl.BlockSpec((NPANELS, tr, 128), lambda i: (0, i, 0),
                            memory_space=pltpu.VMEM)
    outs = pl.pallas_call(
        kern, grid=(R // tr,),
        in_specs=[pl.BlockSpec((3, tr, 128), lambda i: (0, i, 0),
                               memory_space=pltpu.VMEM), row_spec, row_spec]
        + [blk() for _ in state],
        out_specs=tuple(blk() for _ in out_dtypes),
        out_shape=tuple(jax.ShapeDtypeStruct((R, 128), dt)
                        for dt in out_dtypes),
        interpret=True,
    )(jnp.array(u.reshape(3, R, 128)), jnp.array(kr.reshape(-1, R, 128)),
      jnp.array(ks.reshape(-1, R, 128)),
      *[jnp.array(s.reshape(R, 128)) for s in state])
    outs = [torch.from_numpy(np.array(o).reshape(-1))
            for o in jax.block_until_ready(outs)]
    res = {"state": outs[:5], "cell": outs[5]}
    if labs:
        res["depi"], res["depv"] = outs[6], outs[7]
    return res


@pytest.mark.parametrize("labs", [True, False], ids=["labs", "nolabs"])
def test_k5_matches_pallas(models, labs):
    jm, (grid, ds, ss, ins, opts) = models
    cut = dict(min_weight_reduction=20.0, min_scatt_events=1)
    jm = jm[:4] + (dataclasses.replace(jm[4], **cut),)
    inp = table_event_inputs(ds, R * 128, 3, 2, seed=41 + labs,
                             npanels=NPANELS, small_tau=0.01, outside=0.01)
    kr, ks, state = table_multi_state(inp, ds)
    spec = tft._build_kernel_multi(grid, dataclasses.replace(opts, **cut),
                                   2, NPANELS, labs)
    got = tft.table_multi_event(spec, inp["u"], kr, ks, state)
    want = jax_k5(jm, (inp["u"].numpy(), kr.numpy(), ks.numpy(),
                       [s.numpy() for s in state]), labs)
    res = event_agreement(got, want)
    assert res["discrete"] >= 0.999, res
    assert res["float_bad"] <= FLOAT_BAD_LANES, res
    # the inputs exercise every branch: deposits, kills, scatters, cells
    alive_in = state[7] != 0
    alive = got["state"][4] != 0
    assert (alive_in & ~alive).sum() > 50 and alive.sum() > 300
    assert (got["cell"] >= 0).sum() > 300 and (got["cell"][~alive] < 0).all()
    # the albedo differs per panel: scattered luminosity is not one albedo
    # times the interacting energy
    if labs:
        assert (got["depi"] >= 0).sum() > 300
        assert (got["depi"][inp["outside"] & alive_in] < 0).all()
    else:
        assert "depi" not in got


# ---------------------------------------------------------------------------
# kernel K7: the plain event against the Pallas body
# ---------------------------------------------------------------------------

def jax_k7(model, W, H, inputs, labs, npanels=NPANELS):
    """skirt_tpu's K7 Pallas body in interpret mode, called as
    make_fused_table_poly_lifecycle's call_kernel calls it."""
    grid, ds, ss, ins, options = model
    kern, n_uniform = jftp._build_kernel_multi(grid, options, W, H, npanels,
                                               labs)
    u, r, oc, L, L0, state = inputs
    tr = min(min(32, max(8, (1024 // W) // 8 * 8)), R)

    def blk():
        return pl.BlockSpec((tr, 128), lambda i: (i, 0),
                            memory_space=pltpu.VMEM)

    def blkW(lead):
        return pl.BlockSpec((lead, tr, 128), lambda i: (0, i, 0),
                            memory_space=pltpu.VMEM)

    out_shapes = [jax.ShapeDtypeStruct((R, 128), dt)
                  for dt in [jnp.float32] * 6 + [jnp.int32] * 2]
    out_shapes += [jax.ShapeDtypeStruct((W, R, 128), jnp.float32)] * 2
    out_specs = [blk() for _ in range(8)] + [blkW(W)] * 2
    if labs:
        out_shapes += [jax.ShapeDtypeStruct((R, 128), jnp.int32),
                       jax.ShapeDtypeStruct((R, 128), jnp.float32)]
        out_specs += [blk(), blk()]
    outs = pl.pallas_call(
        kern, grid=(R // tr,),
        in_specs=[blkW(n_uniform), blkW(H * npanels),
                  pl.BlockSpec((3 * H, W, 128), lambda i: (0, 0, 0),
                               memory_space=pltpu.VMEM),
                  blkW(W), blkW(W)] + [blk() for _ in state],
        out_specs=tuple(out_specs), out_shape=tuple(out_shapes),
        interpret=True,
    )(jnp.array(u.reshape(n_uniform, R, 128)),
      jnp.array(r.reshape(H * npanels, R, 128)),
      jnp.array(np.broadcast_to(oc[:, :, None], (3 * H, W, 128)).copy()),
      jnp.array(L.reshape(W, R, 128)), jnp.array(L0.reshape(W, R, 128)),
      *[jnp.array(s.reshape(R, 128)) for s in state])
    outs = [torch.from_numpy(np.array(o)) for o in jax.block_until_ready(outs)]
    res = {"state": [o.reshape(-1) for o in outs[:8]],
           "Ln": outs[8].reshape(W, -1), "Lp": outs[9].reshape(W, -1)}
    if labs:
        res["depi"] = outs[10].reshape(-1)
        res["depv"] = outs[11].reshape(-1)
    return res


@pytest.mark.parametrize("W, H, labs", [(1, 2, True), (2, 2, True),
                                        (2, 2, False), (24, 2, True),
                                        (2, 3, True), (2, 4, True)],
                         ids=["W1", "W2", "W2-nolabs", "W24", "W2-H3",
                              "W2-H4"])
def test_k7_matches_pallas(W, H, labs):
    cut = dict(min_weight_reduction=20.0, min_scatt_events=1,
               store_absorption=labs, polychromatic=True)
    jm = jax_multi_model(W, H, **cut)
    grid, ds, ss, ins, opts = from_skirt_tpu(*jm)
    assert ds.ncomp == H
    spec = tftp._build_kernel_multi(grid, ds, opts, W, NPANELS, labs)
    # no lanes below tau ~ 1e-3, as in test_torch_table_poly.py's K6 case
    inp = table_event_inputs(ds, R * 128, 8, W, seed=W + 7 * H + 17 * labs,
                             npanels=NPANELS, outside=0.01)
    state = table_poly_state(inp)
    oc = torch.from_numpy(spec.oc)
    got = tftp.table_poly_multi_event(spec, inp["u"], inp["rows"], oc,
                                      inp["L"], inp["L0"], state)
    want = jax_k7(jm, W, H, [inp["u"].numpy(), inp["rows"].numpy(), spec.oc,
                             inp["L"].numpy(), inp["L0"].numpy(),
                             [s.numpy() for s in state]], labs)
    res = event_agreement(got, want)
    assert res["discrete"] >= 0.999, res
    assert res["float_bad"] <= (K7_FLOAT_BAD_LANES if W == 24
                                else FLOAT_BAD_LANES), res
    alive_in = state[6] != 0
    alive = got["state"][6] != 0
    assert (alive_in & ~alive).sum() > 50 and alive.sum() > 300
    if W > 1:
        assert ((got["Ln"] == 0) & alive[None]).sum() > 20
    if labs:
        dep = got["depi"][got["depi"] >= 0]
        assert dep.numel() > 300
        assert len(torch.unique(dep % W)) == W
        assert (got["depi"][inp["outside"] & alive_in] < 0).all()


def test_wrappers_take_plain_versions_on_cpu(models):
    """On CPU tensors the K5 and K7 wrappers run the plain versions and
    launch no kernel; the K7 wrapper refuses what its kernel cannot take
    only on the card."""
    _, (grid, ds, ss, ins, opts) = models
    inp = table_event_inputs(ds, 256, 3, 2, seed=3, npanels=NPANELS)
    kr, ks, state = table_multi_state(inp, ds)
    spec = tft._build_kernel_multi(grid, opts, 2, NPANELS, True)
    before = (tft.table_multi_event.launches,
              tftp.table_poly_multi_event.launches)
    out = tft.table_multi_event(spec, inp["u"], kr, ks, state)
    for a, b in zip(out["state"], tft.table_multi_event_plain(
            spec, inp["u"], kr, ks, state)["state"]):
        assert torch.equal(a, b)
    spec7 = tftp._build_kernel_multi(grid, ds, opts, 2, NPANELS, True)
    inp = table_event_inputs(ds, 256, 8, 2, seed=4, npanels=NPANELS)
    args = (inp["u"], inp["rows"], torch.from_numpy(spec7.oc), inp["L"],
            inp["L0"], table_poly_state(inp))
    out = tftp.table_poly_multi_event(spec7, *args)
    assert torch.equal(out["Ln"],
                       tftp.table_poly_multi_event_plain(spec7, *args)["Ln"])
    assert (tft.table_multi_event.launches,
            tftp.table_poly_multi_event.launches) == before


# ---------------------------------------------------------------------------
# the slices end to end
# ---------------------------------------------------------------------------

def _tallies(t):
    return {"sed": np.asarray(t["instruments"][0]["Ftot"], np.float64),
            "labs": np.asarray(t["labs"], np.float64)}


def _jax_mono(model, n, refill=0):
    from skirt_tpu import rng as jrng
    from skirt_tpu.engine.lifecycle import make_lifecycle

    grid, ds, ss, ins, opts = model
    opts = dataclasses.replace(opts, refill_batches=refill)
    ell = jnp.asarray(np.arange(n, dtype=np.int32) % 2)
    L0 = jnp.full((n,), 1e36 / N, jnp.float32)
    run = jax.jit(make_lifecycle(grid, ds, ss, ins, opts, 2))
    return _tallies(run(jrng.root_key(4357), ell, L0, {
        "instruments": [ins[0].zero_tallies()],
        "labs": jnp.zeros((grid.ncells * 2,), jnp.float32)}))


def _port_mono(model, n, refill=0):
    from skirt_tpu_torch.engine.lifecycle import make_lifecycle

    grid, ds, ss, ins, opts = model
    opts = dataclasses.replace(opts, refill_batches=refill)
    run = make_lifecycle(grid, ds, ss, ins, opts, 2)
    assert isinstance(run.spec, tft.TableMultiEventSpec)
    t = run(rng.root_key(4357), torch.arange(n, dtype=torch.int32) % 2,
            torch.full((n,), 1e36 / N), {
                "instruments": [ins[0].zero_tallies("cpu")],
                "labs": torch.zeros(grid.ncells * 2)})
    return {"sed": t["instruments"][0]["Ftot"].double().numpy(),
            "labs": t["labs"].double().numpy()}


@pytest.mark.parametrize("refill", [0, 4], ids=["plain", "refill"])
def test_multi_mono_slice_matches_skirt_tpu(models, refill):
    """make_lifecycle(fused=True) on the two-component model: kernel K5
    with the torch-side component selection and blended peel against
    skirt_tpu's fused multi-component engine; with refill, K = 4 packets
    on N / 4 persistent lanes."""
    jm, tm = models
    n = N // 4 if refill else N
    tj = _jax_mono(jm, n, refill)
    tt = _port_mono(tm, n, refill)
    tol = 0.08 if refill else 0.06
    np.testing.assert_allclose(tt["sed"], tj["sed"], rtol=tol)
    assert tt["labs"].sum() == pytest.approx(tj["labs"].sum(), rel=tol)
    assert np.isfinite(tt["labs"]).all() and (tt["labs"] >= 0).all()


def test_multi_poly_slice_matches_skirt_tpu(models):
    """make_lifecycle(fused=True, polychromatic=True) on the two-component
    model: kernel K7 with the per-component peel integrals and the blended
    phase at the new cell, against skirt_tpu's, N / 2 lanes of W = 2 at
    N / 2 packets per wavelength of 1e36 / N W (TestPolyMulti's)."""
    from skirt_tpu import rng as jrng
    from skirt_tpu.engine.lifecycle import make_lifecycle as jax_lifecycle
    from skirt_tpu_torch.engine.lifecycle import make_lifecycle

    jm, _ = models
    jm = jm[:4] + (dataclasses.replace(jm[4], polychromatic=True),)
    n = N // 2
    grid, ds, ss, ins, opts = jm
    run = jax.jit(jax_lifecycle(grid, ds, ss, ins, opts, 2))
    tj = _tallies(run(jrng.root_key(4357), jnp.zeros((n,), jnp.int32),
                      jnp.full((n, 2), 5e35 / n, jnp.float32),
                      {"instruments": [ins[0].zero_tallies()],
                       "labs": jnp.zeros((grid.ncells * 2,), jnp.float32)}))
    grid, ds, ss, ins, opts = from_skirt_tpu(*jm)
    run = make_lifecycle(grid, ds, ss, ins, opts, 2)
    assert isinstance(run.spec, tftp.TablePolyMultiEventSpec)
    t = run(rng.root_key(4357), torch.zeros(n, dtype=torch.int32),
            torch.full((n, 2), 5e35 / n),
            {"instruments": [ins[0].zero_tallies("cpu")],
             "labs": torch.zeros(grid.ncells * 2)})
    tt = {"sed": t["instruments"][0]["Ftot"].double().numpy(),
          "labs": t["labs"].double().numpy()}
    np.testing.assert_allclose(tt["sed"], tj["sed"], rtol=0.06)
    assert tt["labs"].sum() == pytest.approx(tj["labs"].sum(), rel=0.06)
    np.testing.assert_allclose(tt["labs"].reshape(-1, 2).sum(0),
                               tj["labs"].reshape(-1, 2).sum(0), rtol=0.08)
    assert np.isfinite(tt["labs"]).all() and (tt["labs"] >= 0).all()


def test_simulation_voxelize_table_matches_skirt_tpu(tmp_path):
    """OligoSimulation(voxelize='table') on the two-component octree: both
    frameworks voxelize, run the multi-component fused table engine (K5,
    refill K = 4) and fold the labs back onto the leaves."""
    from skirt_tpu import rng as jrng
    from skirt_tpu.engine.lifecycle import LifecycleOptions
    from skirt_tpu.engine.simulation import OligoSimulation
    from skirt_tpu.instruments import SEDInstrument
    from skirt_tpu.log import SilentLog
    from skirt_tpu_torch.convert import convert_simulation
    from skirt_tpu_torch.log import SilentLog as TSilentLog

    ss, jds = jax_multi_model(voxelize=False)
    ins = [SEDInstrument("sed", 3.08e23, 2, inclination=1.2, azimuth=0.7)]
    opts = LifecycleOptions(store_absorption=True, voxelize="table",
                            deposition="sampled", quadrature_panels=NPANELS,
                            max_scatt_events=48, fused=True, refill_batches=4)
    jsim = OligoSimulation(stellar_system=ss, instruments=ins,
                           dust_system=jds, packets=N, batch_size=1 << 11,
                           dispatch_batches=2, options=opts, log=SilentLog(),
                           out_dir=str(tmp_path / "jax"), use_mesh=False)
    tsim = convert_simulation(jsim, log=TSilentLog(), device="cpu",
                              out_dir=str(tmp_path / "torch"))
    assert tsim.dust_system.table and tsim._labs_fold is not None
    assert tsim.dust_system.ncomp == 2
    assert isinstance(tsim._lifecycle.spec, tft.TableMultiEventSpec)
    np.testing.assert_array_equal(tsim.dust_system.rho64,
                                  jax_multi_model()[1].rho64)
    accj = jsim._run_phase(jrng.root_key(4357), 0)
    acct = tsim._run_phase(rng.root_key(4357), 0)
    ncells = jsim.dust_system_out.grid.ncells
    assert acct["labs"].shape == accj["labs"].shape == (ncells * 2,)
    np.testing.assert_allclose(acct["instruments"][0]["Ftot"],
                               accj["instruments"][0]["Ftot"], rtol=0.08)
    assert acct["labs"].sum() == pytest.approx(accj["labs"].sum(), rel=0.08)


def test_multi_builds_and_its_unported_neighbours_raise(models):
    """Both table engines build on the two-component system; several
    components on a non-uniform grid, and with polarization, raise in
    skirt_tpu's words.  The poly engine takes table_peel='staged' with
    several components and runs the exact peel, as skirt_tpu's does."""
    from skirt_tpu.engine.lifecycle import make_lifecycle as jax_lifecycle
    from skirt_tpu_torch.engine.lifecycle import make_lifecycle
    from skirt_tpu_torch.grids import CartesianGrid

    jm, (grid, ds, ss, ins, opts) = models
    staged = dict(polychromatic=True, table_peel="staged")
    jax_lifecycle(*jm[:4], dataclasses.replace(jm[4], **staged), 2)
    make_lifecycle(grid, ds, ss, ins, dataclasses.replace(opts, **staged), 2)
    for poly in (False, True):
        o = dataclasses.replace(opts, polychromatic=poly)
        assert make_lifecycle(grid, ds, ss, ins, o, 2).spec.n_uniform == \
            (8 if poly else 3)
        with pytest.raises(ValueError, match="single"):
            make_lifecycle(grid, ds, ss, ins, o, 2, mueller=object())
        b = np.concatenate([[-2.2], np.linspace(-1, 1, 14), [2.2]]) * KPC
        uneven = CartesianGrid(b, b, b)
        ds_u = type(ds).from_state(uneven, ds.components,
                                   np.zeros((2, uneven.ncells)), "table")
        with pytest.raises(ValueError, match="uniform Cartesian voxel view"):
            make_lifecycle(uneven, ds_u, ss, ins, o, 2)
