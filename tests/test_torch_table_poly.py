"""Kernel K6 and the polychromatic table slice on the CPU, against
skirt_tpu.

- Kernel K6: the plain event against the Pallas body (interpret mode) on
  identical numpy-made inputs at W = 1, 2 and 24 wavelengths per lane, on
  the octree torus of tests/test_voxelize.py (max_level 4, 16^3 voxels)
  with bench_octree.py's log-spaced optics (0.55-2.2 um, power-law kext,
  albedo and g).  Criterion (skirt_tpu_torch.testing.event_agreement):
  discrete outputs (deposit bin with its sampled wavelength, alive,
  nscatt, the wavelengths that survive the weight cut) on >= 99.9% of
  1,024 lanes, floats to rtol 1e-4 on every discretely agreeing lane but
  at most FLOAT_BAD_LANES (XLA's CPU backend fuses a*b+c into one
  rounding where torch rounds twice).
- The wavelength sums: the Pallas body's jnp.sum over w, as XLA's CPU
  backend evaluates it in interpret mode, equals the port's _wsum order
  bit for bit (blocks of the largest divisor of W not above 32).
- End to end at tests/test_poly.py's table tolerances (SED 0.06, labs
  total 0.05 and per wavelength 0.06; refill 0.08): the port's
  polychromatic table slice against skirt_tpu's on the same model at the
  same per-wavelength launch totals (the frameworks draw different random
  streams).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from skirt_tpu.engine import fused_table_poly as jftp
from skirt_tpu_torch import rng
from skirt_tpu_torch.convert import from_skirt_tpu
from skirt_tpu_torch.engine import fused_table_poly as tftp
from skirt_tpu_torch.testing import (event_agreement, table_event_inputs,
                                     table_poly_state)

torch.set_num_threads(2)

N = 1 << 13
R = 8                       # event parity: rows of 128 lanes, 1,024 lanes
NPANELS = 24
FLOAT_BAD_LANES = 2         # of 1,024 (module docstring)


def jax_poly_model(W, **opt_kw):
    """The small octree torus with W log-spaced wavelengths in skirt_tpu
    (as tests/test_voxelize.py::_torus_setup; at W = 2 the same optics),
    voxelized, in table mode, with one SED instrument."""
    from skirt_tpu.constants import KPC
    from skirt_tpu.engine.lifecycle import LifecycleOptions
    from skirt_tpu.geometry import PointGeometry, TorusGeometry
    from skirt_tpu.grids.octree import OctreeGrid
    from skirt_tpu.instruments import SEDInstrument
    from skirt_tpu.media import (DustComponent, DustSystem,
                                 OpticalDepthNormalization,
                                 SimpleOligoDustMix)
    from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                           StellarSystem)
    from skirt_tpu.wavelengths import OligoWavelengthGrid

    lams = np.geomspace(0.55e-6, 2.2e-6, W) if W > 1 else [0.55e-6]
    fpl = np.log(np.asarray(lams) / 0.55e-6) / np.log(2.2 / 0.55)
    wg = OligoWavelengthGrid(list(lams))
    ss = StellarSystem([LuminosityStellarComponent(PointGeometry(), wg,
                                                   [1e36] * W)])
    torus = TorusGeometry(1.0, 2.0, 0.7, 0.05 * KPC, 2 * KPC)
    half = 2.2 * KPC
    grid = OctreeGrid((-half, -half, -half, half, half, half),
                      lambda pos: np.asarray(torus.density(pos)),
                      min_level=2, max_level=4)
    mix = SimpleOligoDustMix(wg, list(2600.0 * (600.0 / 2600.0) ** fpl),
                             list(0.5 + (0.4 - 0.5) * fpl),
                             list(0.4 + (0.2 - 0.4) * fpl))
    comp = DustComponent(torus, mix,
                         OpticalDepthNormalization("x", wg.lambdav[0], 3.0))
    tds = DustSystem(grid, [comp], samples_per_cell=8).voxelized()[0] \
        .as_table()
    ins = [SEDInstrument("sed", 3.08e23, W, inclination=1.2, azimuth=0.7)]
    kw = dict(store_absorption=True, max_scatt_events=48,
              deposition="sampled", quadrature_panels=NPANELS, fused=True,
              polychromatic=True, table_peel="exact")
    kw.update(opt_kw)
    return tds.grid, tds, ss, ins, LifecycleOptions(**kw)


def jax_event(model, W, inputs, npanels=NPANELS):
    """skirt_tpu's K6 Pallas body in interpret mode, called as
    make_fused_table_poly_lifecycle's call_kernel calls it."""
    grid, ds, ss, ins, options = model
    want_labs = bool(options.store_absorption)
    mix = ds.components[0].mix
    kern, n_uniform = jftp._build_kernel(
        grid, options, W, npanels, want_labs,
        [float(np.asarray(ds.kappaext)[0, w]) for w in range(W)],
        [float(np.asarray(mix.albedo)[w]) for w in range(W)],
        [float(np.asarray(mix.g)[w]) for w in range(W)])
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
    if want_labs:
        out_shapes += [jax.ShapeDtypeStruct((R, 128), jnp.int32),
                       jax.ShapeDtypeStruct((R, 128), jnp.float32)]
        out_specs += [blk(), blk()]
    outs = pl.pallas_call(
        kern, grid=(R // tr,),
        in_specs=[blkW(n_uniform), blkW(npanels),
                  pl.BlockSpec((3, W, 128), lambda i: (0, 0, 0),
                               memory_space=pltpu.VMEM),
                  blkW(W), blkW(W)] + [blk() for _ in state],
        out_specs=tuple(out_specs), out_shape=tuple(out_shapes),
        interpret=True,
    )(jnp.array(u.reshape(n_uniform, R, 128)),
      jnp.array(r.reshape(npanels, R, 128)),
      jnp.array(np.broadcast_to(oc[:, :, None], (3, W, 128)).copy()),
      jnp.array(L.reshape(W, R, 128)), jnp.array(L0.reshape(W, R, 128)),
      *[jnp.array(s.reshape(R, 128)) for s in state])
    outs = [torch.from_numpy(np.array(o)) for o in jax.block_until_ready(outs)]
    res = {"state": [o.reshape(-1) for o in outs[:8]],
           "Ln": outs[8].reshape(W, -1), "Lp": outs[9].reshape(W, -1)}
    if want_labs:
        res["depi"] = outs[10].reshape(-1)
        res["depv"] = outs[11].reshape(-1)
    return res


@pytest.mark.parametrize("W, labs", [(1, True), (2, True), (2, False),
                                     (24, True)],
                         ids=["W1", "W2", "W2-nolabs", "W24"])
def test_event_matches_pallas(W, labs):
    cut = dict(min_weight_reduction=20.0, min_scatt_events=1,
               store_absorption=labs)
    jm = jax_poly_model(W, **cut)
    grid, ds, ss, ins, opts = from_skirt_tpu(*jm)
    spec = tftp._build_kernel(grid, ds, opts, W, NPANELS, labs)
    # no lanes below tau ~ 1e-3 (small_tau): there 1 - exp(-tau) magnifies
    # the ulp by which XLA's and torch's CPU exp differ into percent-level
    # deposit weights, which move the sampled wavelength (kernel vs plain
    # on the card, both with CUDA's expf, are held there too)
    inp = table_event_inputs(ds, R * 128, 7, W, seed=W + 17 * labs,
                             npanels=NPANELS, outside=0.01)
    state = table_poly_state(inp)
    oc = torch.from_numpy(spec.oc)
    got = tftp.table_poly_event(spec, inp["u"], inp["rows"], oc, inp["L"],
                                inp["L0"], state)
    want = jax_event(jm, W, [inp["u"].numpy(), inp["rows"].numpy(),
                             spec.oc, inp["L"].numpy(), inp["L0"].numpy(),
                             [s.numpy() for s in state]])
    res = event_agreement(got, want)
    assert res["discrete"] >= 0.999, res
    assert res["float_bad"] <= FLOAT_BAD_LANES, res
    # the inputs exercise every branch: deposits on every wavelength,
    # (lane, wavelength) cuts, kills, scatters
    alive_in = state[6] != 0
    alive = got["state"][6] != 0
    assert (alive_in & ~alive).sum() > 50 and alive.sum() > 300
    if W > 1:
        assert ((got["Ln"] == 0) & alive[None]).sum() > 100
    if labs:
        dep = got["depi"][got["depi"] >= 0]
        assert dep.numel() > 300
        assert len(torch.unique(dep % W)) == W
        assert (got["depi"][inp["outside"] & alive_in] < 0).all()


def test_event_past_32_panels_matches_pallas():
    """40 panels at W = 2: a shape past the card's one-pass route (the
    chunked route's)."""
    W, P = 2, 40
    cut = dict(min_weight_reduction=20.0, min_scatt_events=1,
               store_absorption=True)
    jm = jax_poly_model(W, **cut)
    grid, ds, ss, ins, opts = from_skirt_tpu(*jm)
    spec = tftp._build_kernel(grid, ds, opts, W, P, True)
    inp = table_event_inputs(ds, R * 128, 7, W, seed=40, npanels=P,
                             outside=0.01)
    state = table_poly_state(inp)
    oc = torch.from_numpy(spec.oc)
    got = tftp.table_poly_event(spec, inp["u"], inp["rows"], oc, inp["L"],
                                inp["L0"], state)
    want = jax_event(jm, W, [inp["u"].numpy(), inp["rows"].numpy(),
                             spec.oc, inp["L"].numpy(), inp["L0"].numpy(),
                             [s.numpy() for s in state]], npanels=P)
    res = event_agreement(got, want)
    assert res["discrete"] >= 0.999, res
    assert res["float_bad"] <= FLOAT_BAD_LANES, res
    assert (got["depi"] >= 0).sum() > 300


def test_wavelength_sums_follow_xla_order():
    """The Pallas body's jnp.sum over w, run as the CPU tests run it, and
    the port's _wsum agree bit for bit (the blocked order of XLA's CPU
    reduction); the prefix sum is the Hillis-Steele one."""
    rs = np.random.default_rng(2)
    for W in (3, 24, 48, 128):
        x = (rs.uniform(size=(W, 8, 128))
             * 10.0 ** rs.integers(-6, 6, (W, 8, 128))).astype(np.float32)

        def kern(x_ref, o_ref):
            o_ref[:] = jnp.sum(x_ref[:], axis=0)

        want = pl.pallas_call(
            kern, grid=(1,),
            in_specs=[pl.BlockSpec((W, 8, 128), lambda i: (0, 0, 0),
                                   memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((8, 128), lambda i: (0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
            interpret=True)(jnp.asarray(x))
        got = tftp._wsum(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = torch.arange(1.0, 6.0)[:, None]
    assert tftp._cumsum_w(x)[:, 0].tolist() == [1.0, 3.0, 6.0, 10.0, 15.0]


# ---------------------------------------------------------------------------
# the polychromatic table slice end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    return jax_poly_model(2)


def _runs(jm, n, refill, mueller=False):
    """skirt_tpu's and the port's polychromatic table runs, n lanes, K =
    refill packets each, at N / 2 packets per wavelength of 1e36 / N W;
    mueller=True polarizes both with the Thomson Mueller tables."""
    from skirt_tpu.media.polarization import thomson_mueller as jthomson
    from skirt_tpu_torch.media.polarization import thomson_mueller

    from skirt_tpu import rng as jrng
    from skirt_tpu.engine.lifecycle import make_lifecycle as jax_lifecycle
    from skirt_tpu_torch.engine.lifecycle import make_lifecycle

    K = max(refill, 1)
    grid, ds, ss, ins, opts = jm
    opts = dataclasses.replace(opts, refill_batches=refill)
    run = jax.jit(jax_lifecycle(grid, ds, ss, ins, opts, 2,
                                mueller=jthomson(2) if mueller else None))
    tj = run(jrng.root_key(4357), jnp.zeros((n,), jnp.int32),
             jnp.full((n, 2), 5e35 / (n * K), jnp.float32),
             {"instruments": [ins[0].zero_tallies()],
              "labs": jnp.zeros((grid.ncells * 2,), jnp.float32)})
    tj = jax.tree.map(lambda a: np.asarray(a, np.float64), tj)
    grid, ds, ss, ins, opts = from_skirt_tpu(grid, ds, ss, ins, opts)
    run = make_lifecycle(grid, ds, ss, ins, opts, 2,
                         mueller=thomson_mueller(2) if mueller else None)
    assert isinstance(run.spec, tftp.TablePolyEventSpec)
    assert run.spec.want_pol is mueller
    tt = run(rng.root_key(4357), torch.zeros(n, dtype=torch.int32),
             torch.full((n, 2), 5e35 / (n * K)),
             {"instruments": [ins[0].zero_tallies("cpu")],
              "labs": torch.zeros(grid.ncells * 2)})
    return ({"sed": tj["instruments"][0]["Ftot"], "labs": tj["labs"]},
            {"sed": tt["instruments"][0]["Ftot"].double().numpy(),
             "labs": tt["labs"].double().numpy()})


@pytest.mark.parametrize("refill", [0, 4], ids=["plain", "refill"])
def test_slice_matches_skirt_tpu(model, refill):
    tj, tt = _runs(model, N // 2 // max(refill, 1), refill)
    tol = 0.08 if refill else 0.06
    np.testing.assert_allclose(tt["sed"], tj["sed"], rtol=tol)
    assert tt["labs"].sum() == pytest.approx(tj["labs"].sum(),
                                             rel=0.08 if refill else 0.05)
    if not refill:
        np.testing.assert_allclose(tt["labs"].reshape(-1, 2).sum(0),
                                   tj["labs"].reshape(-1, 2).sum(0),
                                   rtol=0.06)
    assert np.isfinite(tt["labs"]).all() and (tt["labs"] >= 0).all()


def test_polarized_slice_matches_skirt_tpu(model):
    """The polarized poly table engine (K6p, the torch-side Mueller
    reweighting, scatter and peel) on the torus with the Thomson Mueller
    tables, as experiments/bench_polarized.py runs its poly chain, against
    skirt_tpu's at the table tolerances (SED 0.06, labs total 0.05)."""
    tj, tt = _runs(model, N // 2, 0, mueller=True)
    np.testing.assert_allclose(tt["sed"], tj["sed"], rtol=0.06)
    assert tt["labs"].sum() == pytest.approx(tj["labs"].sum(), rel=0.05)
    assert np.isfinite(tt["labs"]).all() and (tt["labs"] >= 0).all()


def test_unported_poly_table_branches_raise(model):
    from skirt_tpu_torch.engine.lifecycle import make_lifecycle
    from skirt_tpu_torch.media.polarization import thomson_mueller

    grid, ds, ss, ins, opts = from_skirt_tpu(*model)
    # a Mueller table builds the polarized engine (kernel K6p): the
    # arithmetic locate here, K6d's direct table on the uneven grid below
    spec = make_lifecycle(grid, ds, ss, ins, opts, 2,
                          mueller=thomson_mueller(2)).spec
    assert type(spec) is tftp.TablePolyEventSpec and spec.want_pol
    assert spec.arith_locate
    assert not make_lifecycle(grid, ds, ss, ins, opts, 2).spec.want_pol
    with pytest.raises(ValueError, match="slice S3"):
        make_lifecycle(grid, ds, ss, ins, opts, 2, launch_fn=lambda *a: 0)
    # several dust components build (kernel K7); with polarization or on
    # a non-uniform grid they raise in skirt_tpu's words.  One component on
    # the non-uniform grid builds the direct table (kernel K6d, staged peel)
    two = type(ds).from_state(grid, ds.components * 2,
                              np.concatenate([ds.rho64, ds.rho64]), "table")
    assert isinstance(make_lifecycle(grid, two, ss, ins, opts, 2).spec,
                      tftp.TablePolyMultiEventSpec)
    with pytest.raises(ValueError, match="single dust component"):
        make_lifecycle(grid, two, ss, ins, opts, 2, mueller=object())
    from skirt_tpu_torch.constants import KPC
    from skirt_tpu_torch.grids import CartesianGrid
    b = np.concatenate([[-2.2], np.linspace(-1, 1, 14), [2.2]]) * KPC
    uneven = CartesianGrid(b, b, b)
    two_u = type(ds).from_state(uneven, ds.components * 2,
                                np.zeros((2, uneven.ncells)), "table")
    with pytest.raises(ValueError, match="uniform Cartesian voxel view"):
        make_lifecycle(uneven, two_u, ss, ins, opts, 2)
    ds_u = type(ds).from_state(uneven, ds.components,
                               np.zeros((1, uneven.ncells)), "table")
    with pytest.warns(UserWarning, match="downgrading to 'staged'"):
        spec = make_lifecycle(uneven, ds_u, ss, ins, opts, 2).spec
    assert type(spec) is tftp.TablePolyEventSpec and not spec.arith_locate
    with pytest.warns(UserWarning, match="downgrading to 'staged'"):
        spec = make_lifecycle(uneven, ds_u, ss, ins, opts, 2,
                              mueller=[thomson_mueller(2)]).spec
    assert spec.want_pol and not spec.arith_locate
