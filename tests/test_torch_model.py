"""The model carried across: skirt_tpu_torch.convert.from_skirt_tpu.

The __graft_entry__._build model at a small size, built in skirt_tpu and
carried across, must reproduce the JAX objects' state exactly in float32:
densities, opacities, m/L^3, lscale, the event kernel's optical
constants (skirt_tpu/engine/fused_poly.py:113-117), the observer
directions and the frame pixel of any position.  The port's own
constructors, given the same arguments, must reproduce it too (same
host discretisation, seed 8672).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skirt_tpu.engine import fused_poly as jfp
from skirt_tpu.engine.fused import _group_leaders as j_group_leaders
from skirt_tpu_torch.convert import from_skirt_tpu
from skirt_tpu_torch.engine import common as tcm
from skirt_tpu_torch.engine import fused_poly as tfp

torch.set_num_threads(2)

W = 6


def _jax_model():
    from test_torch_fused_poly import jax_model
    return jax_model(W, "expdisk", K_refill=4)


def _port_native():
    """The same model from the port's own constructors (no JAX objects)."""
    from skirt_tpu_torch.constants import KPC
    from skirt_tpu_torch.geometry import ExpDiskGeometry
    from skirt_tpu_torch.grids import CartesianGrid
    from skirt_tpu_torch.media import (DustComponent, DustSystem,
                                       OpticalDepthNormalization,
                                       SimpleOligoDustMix)
    from skirt_tpu_torch.wavelengths import OligoWavelengthGrid

    wg = OligoWavelengthGrid(list(np.linspace(0.4e-6, 1.2e-6, W)))
    half = 12 * KPC
    b = np.linspace(-half, half, 9)
    bz = np.linspace(-2 * KPC, 2 * KPC, 5)
    grid = CartesianGrid(b, b, bz)
    fac = np.linspace(1.0, 0.3, W)
    mix = SimpleOligoDustMix(wg, list(2600.0 * fac),
                             list(0.6 * np.linspace(1.0, 0.5, W)),
                             list(0.5 * np.linspace(1.0, 0.4, W)))
    comp = DustComponent(ExpDiskGeometry(4 * KPC, 0.2 * KPC), mix,
                         OpticalDepthNormalization("z", wg.lambdav[0], 1.0))
    return DustSystem(grid, [comp], samples_per_cell=2,
                      density_mode="analytic")


@pytest.fixture(scope="module")
def models():
    jm = _jax_model()
    return jm, from_skirt_tpu(*jm)


def test_dust_state_exact(models):
    (jgrid, jds, *_), (grid, ds, *_) = models
    np.testing.assert_array_equal(ds.rho, jds.rho)
    np.testing.assert_array_equal(ds.rho64, jds.rho64)
    np.testing.assert_array_equal(ds.kappaext, jds.kappaext)
    np.testing.assert_array_equal(ds.kappasca, jds.kappasca)
    np.testing.assert_array_equal(ds.g, jds.g)
    np.testing.assert_array_equal(ds.masses, jds.masses)
    np.testing.assert_array_equal(ds._mass_over_L3, jds._mass_over_L3)
    assert ds.lscale == jds.lscale
    assert grid.bounding_box() == jgrid.bounding_box()
    assert grid._uniform == jgrid._uniform
    assert grid._lo == jgrid._lo and grid._dx == jgrid._dx


def test_constants_and_wavelength_grid_twins():
    """The port's own constants and oligochromatic grid equal skirt_tpu's,
    normalisation lookups (nearest) included."""
    from skirt_tpu import constants as jc
    from skirt_tpu.wavelengths import OligoWavelengthGrid as JGrid
    from skirt_tpu_torch import constants as tc
    from skirt_tpu_torch.wavelengths import OligoWavelengthGrid as TGrid

    assert (tc.PC, tc.KPC) == (jc.PC, jc.KPC)
    lams = [1.2e-6, 0.4e-6, 0.55e-6, 0.9e-6]
    jg, tg = JGrid(lams), TGrid(lams)
    np.testing.assert_array_equal(tg.lambdav, jg.lambdav)
    np.testing.assert_array_equal(tg.dlambdav, jg.dlambdav)
    assert tg.nlambda == jg.nlambda
    for lam in np.linspace(0.3e-6, 1.3e-6, 41).tolist() + lams:
        assert tg.nearest(lam) == jg.nearest(lam)


def test_port_constructors_reproduce_discretisation(models):
    (_, jds, *_), _ = models
    ds = _port_native()
    np.testing.assert_array_equal(ds.rho64, jds.rho64)
    np.testing.assert_array_equal(ds._mass_over_L3, jds._mass_over_L3)
    assert ds.gridded_mass() == jds.gridded_mass()


def test_event_constants_exact(models):
    (jgrid, jds, jss, jins, jopt), (grid, ds, ss, ins, opt) = models
    jleaders, jlead_of = j_group_leaders(jins)
    leaders, lead_of = tcm._group_leaders(ins)
    assert leaders == jleaders and lead_of == jlead_of
    _, _, oc_np, kextm_w, g_w = jfp._build_kernel(
        jgrid, jds, jleaders, 8, 4, jopt, W, True, True,
        jss.components[0].geometry.device_sampler_xyz())
    spec = tfp._build_kernel(grid, ds, leaders, 8, 4, opt, W, True, True,
                             ss.components[0].geometry)
    np.testing.assert_array_equal(spec.oc, oc_np[:, :, 0])
    assert spec.oc[0].tolist() == kextm_w and spec.oc[2].tolist() == g_w
    assert spec.n_uniform == 7 + 4 + 2
    from skirt_tpu_torch.engine.lifecycle import PORT_OPTIONS

    mine = set(opt.__dataclass_fields__) - set(PORT_OPTIONS)
    assert mine == set(jopt.__dataclass_fields__)
    assert opt == type(opt)(**{f: getattr(jopt, f) for f in mine})


def test_instruments_exact(models):
    (*_, jins, _), (*_, ins, _) = models
    for a, b in zip(jins, ins):
        assert type(a).__name__ == type(b).__name__
        np.testing.assert_array_equal(a.kobs, b.kobs)
        np.testing.assert_array_equal(a.kx, b.kx)
        np.testing.assert_array_equal(a.ky, b.ky)


def test_frame_pixels_exact(models):
    (jgrid, *_, jins, _), (*_, ins, _) = models
    rs = np.random.default_rng(2)
    box = np.asarray(jgrid.bounding_box())
    pos = rs.uniform(box[:3] * 1.2, box[3:] * 1.2,
                     size=(20000, 3)).astype(np.float32)
    # positions on pixel edges, where floor() decides
    frame_j, frame_t = jins[1], ins[1]
    edges = (frame_t.xmin + frame_t.psize_x * np.arange(frame_t.nx + 1))
    pos[:17, 1] = edges.astype(np.float32)
    want = np.asarray(frame_j.pixel(jnp.asarray(pos)))
    got = frame_t.pixel(torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).mean() > 0.3 and (want < 0).any()


def test_emission_peel_rows_match(models):
    """The analytic density rows of the emission peel (panel_paths +
    analytic_rows), float32 against float32."""
    from skirt_tpu.engine import vector_traversal as jvt
    from skirt_tpu_torch.engine import vector_traversal as tvt

    (jgrid, jds, *_), (grid, ds, *_) = models
    rs = np.random.default_rng(4)
    box = np.asarray(jgrid.bounding_box())
    pos = rs.uniform(box[:3], box[3:], size=(512, 3)).astype(np.float32)
    k = np.asarray([0.3, -0.4, 0.866], np.float32)
    kobs = np.broadcast_to(k, pos.shape)
    # each framework gets its own copy of the inputs (jnp.asarray and
    # torch.from_numpy would both alias pos), and the JAX side finishes
    # before the torch side starts
    pos_j, kobs_j = jnp.array(pos), jnp.array(kobs)
    jd, _, jm = jvt.panel_paths(jgrid, pos_j, kobs_j, 8)
    jr = jds.analytic_rows(pos_j, kobs_j, jm, None, [jnp.ones(512)],
                           want_sca=False)
    jd, jm, jr = (np.asarray(a) for a in jax.block_until_ready((jd, jm, jr)))
    pos_t, kobs_t = torch.tensor(pos), torch.tensor(kobs)
    td, _, tm = tvt.panel_paths(grid, pos_t, kobs_t, 8)
    tr = ds.analytic_rows(pos_t, kobs_t, tm, None, [torch.ones(512)],
                          want_sca=False)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-6)
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-6)
    np.testing.assert_allclose(tr.numpy(), jr, rtol=1e-5,
                               atol=1e-6 * float(np.abs(jr).max()))


def test_unported_branches_raise(models):
    import dataclasses

    from skirt_tpu_torch.engine.lifecycle import (
        make_lifecycle, make_lifecycle_with_fallback)

    _, (grid, ds, ss, ins, opt) = models
    with pytest.raises(ValueError, match="slice S2b"):
        make_lifecycle(grid, ds, ss, ins,
                       dataclasses.replace(opt, fused=False), W)
    with pytest.raises(ValueError, match="slice S2b"):
        make_lifecycle(grid, ds, ss, ins,
                       dataclasses.replace(opt, polychromatic=False,
                                           tally_flush=2), W)
    with pytest.raises(ValueError, match="slice S3"):
        make_lifecycle(grid, ds, ss, ins, opt, W, launch_fn=lambda *a: None)
    # a gridded system (the per-crossing walk of the unfused lifecycle)
    gridded = type(ds)(grid, ds.components, samples_per_cell=2,
                       density_mode="gridded")
    with pytest.raises(ValueError, match="slice S2b"):
        make_lifecycle_with_fallback(grid, gridded, ss, ins, opt, W)


def test_writers_match(models, tmp_path):
    """The SED table and FITS cube writers, given the same tallies, write
    what skirt_tpu's write (through the shared skirt_tpu.io.fits)."""
    from skirt_tpu.io.fits import read_fits
    from skirt_tpu.units import Units

    (*_, jins, _), (grid, ds, *_, ins, _) = models
    wg = ds.wavelength_grid
    rs = np.random.default_rng(8)
    units = Units()
    for a, b in zip(jins, ins):
        acc_t = b.zero_tallies("cpu")
        for v in acc_t.values():
            v.copy_(torch.from_numpy(rs.random(v.shape[0]).astype(np.float32)))
        acc_j = {k: jnp.asarray(v.numpy()) for k, v in acc_t.items()}
        (tmp_path / "j").mkdir(exist_ok=True)
        (tmp_path / "t").mkdir(exist_ok=True)
        a.write(acc_j, wg, units, str(tmp_path / "j"), "run")
        b.write(acc_t, wg, units, str(tmp_path / "t"), "run")
    files = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert any(f.endswith(".fits") for f in files)
    for f in files:
        if f.endswith(".fits"):
            dj, hj = read_fits(str(tmp_path / "j" / f))
            dt, ht = read_fits(str(tmp_path / "t" / f))
            np.testing.assert_array_equal(dt, dj)
            assert ht == hj
        else:
            assert (tmp_path / "t" / f).read_text() == \
                (tmp_path / "j" / f).read_text()
