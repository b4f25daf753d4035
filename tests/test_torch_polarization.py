"""Polarization on the port's fused engines (slice S5a) against skirt_tpu,
on the CPU.

- The Stokes algebra (rotate_stokes, apply_mueller with its clamp,
  rotate_normal, angle_between_planes) on the same seeded inputs: rtol
  1e-5, atol 1e-6 (torch's and XLA's sin, cos, atan2 and cross differ by
  ulps); for parallel directions the port's angle is the reference's 0.
- thomson_mueller's host tables bit for bit at nlambda 1, 2 and 24; the
  samplers fed the same uniforms (skirt_tpu's draw them from a key: its
  module's rng is stubbed to hand them out): theta within 1e-5 rad, phi
  within 1e-4 rad (26 bisection steps on float32 sines); lookup and
  lookup_all exact; convert_mueller copies the tables bit for bit.
- FullInstrument's detect and detect_poly with nscatt levels, the
  transparent and dust tags and the Stokes tags: every tally at float32
  sum-order tolerance (rtol 1e-5, atol 1e-6 x the tally's largest value);
  the writer emits the same files and values.
- Kernel K6p: the plain event with want_pol against skirt_tpu's Pallas
  body built with want_pol=True (interpret mode), arithmetic locate (the
  torus of test_torch_table_poly.py) and direct (the 300-site tessellation
  of test_torch_table_direct.py), with and without labs, by
  event_agreement's criterion (discrete outputs on >= 99.9% of lanes, I_s
  and I_tot among the floats).
- The Thomson sphere of tests/test_polarization.py (TestFusedPolarized,
  TestFusedTablePolarized, TestPolyPolarized) through both packages'
  fused chains, the port held to skirt_tpu at those tests' tolerances:
  Ftot 0.03 (mono) and 0.04 per wavelength (poly), Fscastel 0.08 and
  0.10, the tangential ring (|q| > 0.15, opposite signs), the integrated
  |P| below 0.05 and 0.06 of the scattered flux; the refill variants
  against 1 at 0.05 and 0.06.  The analytic sphere runs K3's plain
  version.  The Stokes tallies themselves (the fQ, fU, fV and fscastel
  frames, their ring amplitudes, FQ, FU, FV) are held to skirt_tpu's at
  tolerances set from the two packages' spread over seeds
  (_assert_stokes_match), on the Thomson sphere and on a tau-1 sphere
  with Mueller tables that differ by wavelength (_chromatic_mueller),
  where a torch-side driver wavelength that is not the kernel's shows.
- The direct table: one polarized poly run on the 300-site tessellation
  (K6p with DIRECT) against skirt_tpu at the direct table's gates (SED
  0.08, labs 0.06).
- OligoSimulation on an ElectronDustMix system wires the mix's Mueller
  tables into its lifecycle and writes the Stokes frames.
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
from skirt_tpu.media import polarization as jpol
from skirt_tpu_torch import rng
from skirt_tpu_torch.convert import convert_mueller, from_skirt_tpu
from skirt_tpu_torch.engine import fused_table_poly as tftp
from skirt_tpu_torch.media import polarization as tpol
from skirt_tpu_torch.testing import event_agreement, table_poly_case

torch.set_num_threads(2)

R = 8                       # K6p parity: rows of 128 lanes, 1,024 lanes
FLOAT_BAD_LANES = 2         # of 1,024 (as test_torch_table_poly.py)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# Stokes algebra
# ---------------------------------------------------------------------------

def _stokes_inputs(n=4096, seed=3):
    rs = np.random.default_rng(seed)
    q, u, v = (rs.uniform(-0.6, 0.6, n).astype(np.float32)
               for _ in range(3))
    phi = rs.uniform(-np.pi, np.pi, n).astype(np.float32)
    S = [rs.uniform(0.1, 1.0, n).astype(np.float32)]
    S += [(S[0] * rs.uniform(-1, 1, n)).astype(np.float32) for _ in range(3)]
    # a tenth of the lanes fully polarized into their zero-intensity
    # direction: the clamp to the physical ball
    k = n // 10
    q[:k], u[:k], v[:k] = 1.0, 0.0, 0.0
    S[1][:k] = -S[0][:k] * np.float32(1 - 1e-7)
    d = _unit(rs, n)
    nrm = np.cross(d, _unit(rs, n))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    kn = _unit(rs, n)
    kn[:16] = d[:16]                 # degenerate planes: angle 0
    return q, u, v, phi, S, d, nrm, kn


@pytest.mark.parametrize("fn", ["rotate_stokes", "apply_mueller",
                                "rotate_normal", "angle_between_planes"])
def test_stokes_algebra_matches_skirt_tpu(fn):
    q, u, v, phi, S, d, nrm, kn = _stokes_inputs()
    t = torch.from_numpy
    if fn == "rotate_stokes":
        got = tpol.rotate_stokes(t(q), t(u), t(phi))
        want = jpol.rotate_stokes(jnp.asarray(q), jnp.asarray(u),
                                  jnp.asarray(phi))
    elif fn == "apply_mueller":
        got = tpol.apply_mueller(t(q), t(u), t(v), *map(t, S))
        want = jpol.apply_mueller(*map(jnp.asarray, (q, u, v, *S)))
        qn, un, vn = (g.numpy() for g in got[1:])
        assert (qn * qn + un * un + vn * vn <= 1 + 1e-5).all()
    elif fn == "rotate_normal":
        got = [tpol.rotate_normal(t(nrm), t(d), t(phi))]
        want = [jpol.rotate_normal(jnp.asarray(nrm), jnp.asarray(d),
                                   jnp.asarray(phi))]
    else:
        # parallel kc and kn: the port's cross product is exactly 0 there
        # and the angle 0, as the reference intends; XLA fuses the cross
        # product's differences (~1e-9 left), so skirt_tpu's degenerate
        # branch does not fire and its angle is noise: compared elsewhere
        got = [tpol.angle_between_planes(t(nrm), t(d), t(kn))[16:]]
        want = [jpol.angle_between_planes(jnp.asarray(nrm), jnp.asarray(d),
                                          jnp.asarray(kn))[16:]]
        assert (tpol.angle_between_planes(t(nrm), t(d), t(kn))[:16]
                == 0).all()
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# Mueller tables and samplers
# ---------------------------------------------------------------------------

_HOST_TABLES = ("S11", "S12", "S33", "S34", "thetav", "theta_cdf", "pfnorm",
                "theta_quantile", "S_packed", "S_theta_major")


@pytest.mark.parametrize("nlambda", [1, 2, 24])
def test_thomson_tables_bit_identical(nlambda):
    got, want = tpol.thomson_mueller(nlambda), jpol.thomson_mueller(nlambda)
    conv = convert_mueller(want)
    for name in _HOST_TABLES:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
        np.testing.assert_array_equal(getattr(conv, name),
                                      getattr(want, name), err_msg=name)
        assert getattr(got, name).dtype == np.float32
    assert got.ntheta == want.ntheta and got.nq == want.nq


class _Draws:
    """Stands in for skirt_tpu's rng inside its polarization module: hands
    out the given uniforms instead of drawing them from the key."""

    def __init__(self, u):
        self.u = u

    def uniform_open(self, key, shape):
        assert tuple(shape) == self.u.shape
        return jnp.asarray(self.u)


@pytest.fixture(scope="module")
def tables():
    """A Mueller table with wavelength-dependent, partly polarizing S
    (Thomson's at the first wavelength, a forward-peaked blend at the
    others) in both packages."""
    th = np.linspace(0.0, np.pi, 181)
    c = np.cos(th)
    S11 = np.stack([0.5 * (c * c + 1)] + [0.5 * (c * c + 1) + a * (1 + c) ** 3
                                           for a in (0.5, 2.0, 5.0)])
    S12 = np.stack([0.5 * (c * c - 1) * (1 - a) for a in (0, .3, .6, .9)])
    S33 = np.stack([c * (1 - a) for a in (0, .2, .4, .6)])
    S34 = np.stack([np.sin(th) * a for a in (0, .1, .2, .3)])
    return (tpol.MuellerTables(th, S11, S12, S33, S34),
            jpol.MuellerTables(th, S11, S12, S33, S34))


def test_samplers_match_skirt_tpu(tables, monkeypatch):
    tm, jm = tables
    for name in _HOST_TABLES:
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    n = 8192
    rs = np.random.default_rng(5)
    ell = rs.integers(0, 4, n).astype(np.int32)
    u_t = rs.uniform(1e-7, 1 - 1e-7, n).astype(np.float32)
    u_p = rs.uniform(1e-7, 1 - 1e-7, n).astype(np.float32)
    pdeg = rs.uniform(0.0, 1.0, n).astype(np.float32)
    pdeg[:512] = 1.0                  # the |a| = 1 case Newton fails on
    pang = rs.uniform(-np.pi / 2, np.pi / 2, n).astype(np.float32)
    t = torch.from_numpy
    th_t = tm.sample_theta_u(t(u_t), t(ell))
    monkeypatch.setattr(jpol, "rng", _Draws(u_t))
    th_j = np.asarray(jm.sample_theta(None, jnp.asarray(ell)))
    assert np.abs(th_t.numpy() - th_j).max() < 1e-5
    ph_t = tm.sample_phi_u(t(u_p), t(ell), th_t, t(pdeg), t(pang))
    monkeypatch.setattr(jpol, "rng", _Draws(u_p))
    ph_j = np.asarray(jm.sample_phi(None, jnp.asarray(ell),
                                    jnp.asarray(th_t.numpy()),
                                    jnp.asarray(pdeg), jnp.asarray(pang)))
    assert np.abs(ph_t.numpy() - ph_j).max() < 1e-4
    # the keyed samplers draw their uniforms from the port's streams
    key = rng.root_key(3)
    np.testing.assert_array_equal(
        tm.sample_theta(key, t(ell)).numpy(),
        tm.sample_theta_u(rng.uniform_open(key, (n,), "cpu"), t(ell)).numpy())
    for got, want in zip(tm.lookup(t(ell), th_t),
                         jm.lookup(jnp.asarray(ell),
                                   jnp.asarray(th_t.numpy()))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(tm.lookup_all(th_t),
                         jm.lookup_all(jnp.asarray(th_t.numpy()))):
        assert got.shape == (4, n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# FullInstrument
# ---------------------------------------------------------------------------

def _instruments(W):
    from skirt_tpu.instruments import FullInstrument as JFull
    from skirt_tpu_torch.convert import convert_instrument

    j = JFull("full", 3.08e20, W, 7, 5, fov_x=2.0, fov_y=1.5,
              inclination=1.1, azimuth=0.4, position_angle=0.3,
              nscatt_levels=3, polarization=True)
    return j, convert_instrument(j)


def _detect_inputs(W, n=3000, seed=9):
    rs = np.random.default_rng(seed)
    pos = rs.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    ns = rs.integers(0, 5, n).astype(np.int32)
    dust = rs.random(n) < 0.3
    c = rs.uniform(0.0, 1.0, (W, n)).astype(np.float32)
    tr = (c * rs.uniform(1.0, 2.0, (W, n))).astype(np.float32)
    st = [rs.uniform(-0.5, 0.5, (W, n)).astype(np.float32) for _ in range(3)]
    ell = rs.integers(0, W, n).astype(np.int32)
    return pos, ns, dust, c, tr, st, ell


def _assert_tallies(tt, tj):
    assert sorted(tt) == sorted(tj)
    for k in tj:
        w = np.asarray(tj[k], np.float64)
        g = tt[k].double().numpy()
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-6 * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


@pytest.mark.parametrize("poly", [False, True], ids=["detect", "poly"])
def test_full_instrument_matches_skirt_tpu(poly):
    W = 3
    j, t = _instruments(W)
    pos, ns, dust, c, tr, st, ell = _detect_inputs(W)
    T = torch.from_numpy
    tj, tt = j.zero_tallies(), t.zero_tallies("cpu")
    if poly:
        wls = np.arange(W, dtype=np.int32)
        tags_j = {"nscatt": jnp.asarray(ns), "is_dust": jnp.asarray(dust),
                  "transparent": jnp.asarray(tr),
                  "stokes": tuple(jnp.asarray(s) for s in st)}
        tj = j.detect_poly(tj, jnp.asarray(pos), wls, jnp.asarray(c), tags_j)
        tags_t = {"nscatt": T(ns), "is_dust": T(dust), "transparent": T(tr),
                  "stokes": tuple(T(s) for s in st)}
        t.detect_poly(tt, T(pos), torch.arange(W), T(c), tags_t)
        # lambda-independent ratios (N,) broadcast over the wavelengths
        tj = j.detect_poly(tj, jnp.asarray(pos), wls, jnp.asarray(c),
                           dict(tags_j, stokes=tuple(jnp.asarray(s[0])
                                                     for s in st)))
        t.detect_poly(tt, T(pos), torch.arange(W), T(c),
                      dict(tags_t, stokes=tuple(T(s[0]) for s in st)))
    else:
        args = [c[0], tr[0], [s[0] for s in st]]
        tj = j.detect(tj, jnp.asarray(pos), jnp.asarray(ell),
                      jnp.asarray(args[0]),
                      {"nscatt": jnp.asarray(ns), "is_dust": jnp.asarray(dust),
                       "transparent": jnp.asarray(args[1]),
                       "stokes": tuple(jnp.asarray(s) for s in args[2])})
        t.detect(tt, T(pos), T(ell), T(args[0]),
                 {"nscatt": T(ns), "is_dust": T(dust),
                  "transparent": T(args[1]),
                  "stokes": tuple(T(s) for s in args[2])})
    # without tags a detect adds to the total frame and SED only
    t.detect(tt, T(pos), T(ell), T(c[0]), None)
    tj = j.detect(tj, jnp.asarray(pos), jnp.asarray(ell), jnp.asarray(c[0]),
                  None)
    _assert_tallies(tt, tj)
    assert float(tt["fscatlev"].sum()) > 0 and float(tt["FQ"].abs().sum()) > 0


def test_full_instrument_writer_matches_skirt_tpu(tmp_path):
    from skirt_tpu.io.fits import read_fits
    from skirt_tpu.units import Units
    from skirt_tpu.wavelengths import OligoWavelengthGrid

    W = 3
    j, t = _instruments(W)
    wg = OligoWavelengthGrid([0.5e-6, 1e-6, 2e-6])
    rs = np.random.default_rng(4)
    acc_t = t.zero_tallies("cpu")
    for v in acc_t.values():
        v.copy_(torch.from_numpy(rs.random(v.shape).astype(np.float32)))
    acc_j = {k: jnp.asarray(v.numpy()) for k, v in acc_t.items()}
    for d in ("j", "t"):
        (tmp_path / d).mkdir()
    j.write(acc_j, wg, Units(), str(tmp_path / "j"), "run")
    t.write(acc_t, wg, Units(), str(tmp_path / "t"), "run")
    files = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert "run_full_stokesQ.fits" in files
    for f in files:
        if f.endswith(".fits"):
            dj, hj = read_fits(str(tmp_path / "j" / f))
            dt, ht = read_fits(str(tmp_path / "t" / f))
            np.testing.assert_array_equal(dt, dj)
            assert ht == hj
        else:
            assert (tmp_path / "t" / f).read_text() == \
                (tmp_path / "j" / f).read_text()


# ---------------------------------------------------------------------------
# kernel K6p: the plain event against the Pallas body
# ---------------------------------------------------------------------------

def jax_pol_event(model, W, npanels, arith_locate, inputs):
    """skirt_tpu's K6 Pallas body built with want_pol=True (and
    arith_locate as given), in interpret mode, called as
    make_fused_table_poly_lifecycle's call_kernel calls it: I_s and I_tot
    are its last two outputs."""
    grid, ds, ss, ins, options = model
    want_labs = bool(options.store_absorption)
    mix = ds.components[0].mix
    kern, n_uniform = jftp._build_kernel(
        grid, options, W, npanels, want_labs,
        [float(np.asarray(ds.kappaext)[0, w]) for w in range(W)],
        [float(np.asarray(mix.albedo)[w]) for w in range(W)],
        [float(np.asarray(mix.g)[w]) for w in range(W)],
        arith_locate=arith_locate, want_pol=True)
    u, r, oc, L, L0, state = inputs
    tr = min(min(32, max(8, (1024 // W) // 8 * 8)), R)

    def blk():
        return pl.BlockSpec((tr, 128), lambda i: (i, 0),
                            memory_space=pltpu.VMEM)

    def blkW(lead):
        return pl.BlockSpec((lead, tr, 128), lambda i: (0, i, 0),
                            memory_space=pltpu.VMEM)

    dts = [jnp.float32] * 6 + [jnp.int32] * 2
    out_shapes = [jax.ShapeDtypeStruct((R, 128), dt) for dt in dts]
    out_shapes += [jax.ShapeDtypeStruct((W, R, 128), jnp.float32)] * 2
    out_specs = [blk() for _ in dts] + [blkW(W)] * 2
    tail = []
    if want_labs:
        tail = [jnp.int32, jnp.float32] + ([] if arith_locate
                                           else [jnp.float32])
    tail += [jnp.float32, jnp.float32]
    out_shapes += [jax.ShapeDtypeStruct((R, 128), dt) for dt in tail]
    out_specs += [blk() for _ in tail]
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
    outs = [torch.from_numpy(np.array(o)).reshape(-1)
            for o in jax.block_until_ready(outs)]
    res = {"state": outs[:8], "Ln": outs[8].reshape(W, -1),
           "Lp": outs[9].reshape(W, -1), "I_s": outs[-2],
           "I_tot": outs[-1]}
    if want_labs:
        res["depi"], res["depv"] = outs[10], outs[11]
        if not arith_locate:
            res["depd"] = outs[12]
    return res


@pytest.mark.parametrize("direct, labs", [(False, True), (False, False),
                                          (True, True), (True, False)],
                         ids=["arith", "arith-nolabs", "direct",
                              "direct-nolabs"])
def test_pol_event_matches_pallas(direct, labs):
    cut = dict(min_weight_reduction=20.0, min_scatt_events=1,
               store_absorption=labs)
    if direct:
        from test_torch_table_direct import NPANELS, jax_voronoi_model
        W = 8
        jm = jax_voronoi_model(W, poly=True, **cut)
    else:
        from test_torch_table_poly import NPANELS, jax_poly_model
        W = 24
        jm = jax_poly_model(W, **cut)
    grid, ds, ss, ins, opts = from_skirt_tpu(*jm)
    spec = tftp._build_kernel(grid, ds, opts, W, NPANELS, labs,
                              arith_locate=not direct, want_pol=True)
    # no lanes below tau ~ 1e-3, as in test_torch_table_poly.py
    args, inp = table_poly_case(spec, ds, R * 128, seed=40 + W + labs,
                                outside=0.01)
    got = tftp.table_poly_event(spec, *args)
    want = jax_pol_event(jm, W, NPANELS, not direct,
                         [a.numpy() for a in args[:5]]
                         + [[s.numpy() for s in args[5]]])
    res = event_agreement(got, want)
    assert res["discrete"] >= 0.999, res
    assert res["float_bad"] <= FLOAT_BAD_LANES, res
    # the column densities: every lane, dead ones included; positive on
    # the torus and the sphere, I_s within the path
    alive_in = args[5][6] != 0
    assert (got["I_tot"] > 0).float().mean() > 0.7
    assert (got["I_s"] <= got["I_tot"] * (1 + 1e-5)).all()
    assert torch.equal(got["I_tot"] > 0, want["I_tot"] > 0)
    assert (~alive_in).sum() > 50
    # the event without want_pol writes the same K6 outputs
    base = tftp.table_poly_event(dataclasses.replace(spec, want_pol=False),
                                 *args)
    assert "I_s" not in base
    for a, b in zip(base["state"], got["state"]):
        assert torch.equal(a, b)
    assert torch.equal(base["Ln"], got["Ln"])


# ---------------------------------------------------------------------------
# the Thomson sphere end to end (tests/test_polarization.py's harnesses)
# ---------------------------------------------------------------------------

def _sphere(nlambda, density_mode, tau=0.2):
    from skirt_tpu.geometry import PointGeometry, UniformSphereGeometry
    from skirt_tpu.grids import CartesianGrid
    from skirt_tpu.instruments import FullInstrument
    from skirt_tpu.media import (DustComponent, DustMassNormalization,
                                 DustSystem, ElectronDustMix)
    from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                           StellarSystem)
    from skirt_tpu.wavelengths import OligoWavelengthGrid

    wg = OligoWavelengthGrid([1e-6, 1.2e-6][:nlambda])
    ss = StellarSystem([LuminosityStellarComponent(PointGeometry(), wg,
                                                   [1.0] * nlambda)])
    b = np.linspace(-1, 1, 9)
    grid = CartesianGrid(b, b, b)
    mix = ElectronDustMix(wg)
    R_ = 0.9
    mass = tau / (float(mix.kappaext64[0]) * R_) * (4 / 3 * np.pi * R_ ** 3)
    comp = DustComponent(UniformSphereGeometry(R_), mix,
                         DustMassNormalization(mass))
    ds = DustSystem(grid, [comp], samples_per_cell=4,
                    density_mode=density_mode)
    if density_mode == "gridded":
        ds = ds.as_table()
    ins = FullInstrument("pol", 100.0, nlambda, 9, 9, fov_x=2.2, fov_y=2.2,
                         inclination=np.pi / 2, polarization=True)
    return grid, ds, ss, [ins]


# (chain, nlambda, density mode, options)
CHAINS = {"mono": (1, "analytic", {}),
          "table": (1, "gridded", {"table_peel": "exact"}),
          "poly": (2, "gridded", {"table_peel": "exact",
                                  "polychromatic": True})}


def _chromatic_mueller(pkg, ntheta=181):
    """Mueller tables that differ by wavelength, in package `pkg`'s
    MuellerTables: wavelength 0 forward (HG g = 0.6 in S11) with Thomson's
    polarization degree, perpendicular to the scattering plane; wavelength 1
    backward (g = -0.5), polarized in the plane, with a retardance of 1 rad
    (S34 != 0, so circular polarization appears from the second scatter).
    Each row is a pure Mueller matrix: S12^2 + S33^2 + S34^2 = S11^2."""
    theta = np.linspace(0.0, np.pi, ntheta)
    c = np.cos(theta)
    rows = []
    for g, sign, delta in ((0.6, -1.0, 0.0), (-0.5, 1.0, 1.0)):
        S11 = (1 - g * g) / (1 + g * g - 2 * g * c) ** 1.5
        m = S11 * 2 * c / (1 + c * c)
        rows.append((S11, sign * S11 * (1 - c * c) / (1 + c * c),
                     m * np.cos(delta), m * np.sin(delta)))
    return pkg.MuellerTables(theta, *(np.stack(x) for x in zip(*rows)))


def _thomson_runs(chain, refill, n=20000, seed=5, tau=0.2, chromatic=False):
    """The chain's Thomson sphere in skirt_tpu and in the port: per package
    the FullInstrument's tallies (float64 NumPy).  Mono lanes carry 1/n W
    each (n / K lanes, K packets per lane); poly lanes 1 / (n/2) W per
    wavelength, as tests/test_polarization.py launches them.  `chromatic`
    swaps the electron mix's Thomson tables for _chromatic_mueller's."""
    from skirt_tpu import rng as jrng
    from skirt_tpu.engine.lifecycle import LifecycleOptions
    from skirt_tpu.engine.lifecycle import make_lifecycle as jax_lifecycle
    from skirt_tpu_torch.engine.lifecycle import make_lifecycle

    W, mode, kw = CHAINS[chain]
    model = _sphere(W, mode, tau)
    opts = LifecycleOptions(fused=True, quadrature_panels=16,
                            refill_batches=refill, **kw)
    K = max(refill, 1)
    lanes = (n // 2 if W == 2 else n) // K
    L = 1.0 / (lanes * K)
    grid, ds, ss, ins = model
    mj = _chromatic_mueller(jpol) if chromatic else jpol.thomson_mueller(W)
    run = jax.jit(jax_lifecycle(grid, ds, ss, ins, opts, W, mueller=mj))
    L0 = (jnp.full((lanes, 2), L, jnp.float32) if W == 2
          else jnp.full((lanes,), L, jnp.float32))
    tj = run(jrng.root_key(seed), jnp.zeros(lanes, jnp.int32), L0,
             {"instruments": [ins[0].zero_tallies()]})["instruments"][0]
    tg, tds, tss, tins, topts = from_skirt_tpu(grid, ds, ss, ins, opts)
    assert tds.mueller is not None
    mt = _chromatic_mueller(tpol) if chromatic else tds.mueller
    run = make_lifecycle(tg, tds, tss, tins, topts, W, mueller=mt)
    if chain == "poly":
        assert run.spec.want_pol
    L0 = torch.full((lanes, 2) if W == 2 else (lanes,), L)
    tt = run(rng.root_key(seed), torch.zeros(lanes, dtype=torch.int32), L0,
             {"instruments": [tins[0].zero_tallies("cpu")]})["instruments"][0]
    return ({k: np.asarray(v, np.float64) for k, v in tj.items()},
            {k: v.double().numpy() for k, v in tt.items()})


@pytest.fixture(scope="module")
def thomson():
    """Each chain's runs, made once for the module."""
    cache = {}

    def get(chain, refill, **kw):
        key = (chain, refill) + tuple(sorted(kw.items()))
        if key not in cache:
            cache[key] = _thomson_runs(chain, refill, **kw)
        return cache[key]

    return get


def _ring(t, W):
    """(q right of centre, q above centre) per wavelength of the 9x9
    scattered frame."""
    fQ = t["fQ"].reshape(W, 9, 9)
    fs = t["fscastel"].reshape(W, 9, 9)
    return [(fQ[w, 4, 6] / max(fs[w, 4, 6], 1e-12),
             fQ[w, 6, 4] / max(fs[w, 6, 4], 1e-12)) for w in range(W)]


def _ring_amplitudes(t, W, npix=9):
    """Per wavelength the scattered frames' Stokes rings over their
    scattered flux: (sum fQ cos 2phi, sum fU sin 2phi, sum fQ sin 2phi,
    sum fU cos 2phi) / sum fscastel, phi the pixel's position angle about
    the centre.  A tangential or radial pattern loads the first two (a
    sign flip of U, or of the rotation into the instrument frame, flips the
    second); the last two vanish by symmetry."""
    y, x = np.mgrid[:npix, :npix] - (npix - 1) / 2
    phi = np.arctan2(y, x).ravel()
    c2, s2 = np.cos(2 * phi), np.sin(2 * phi)
    fQ, fU = t["fQ"].reshape(W, -1), t["fU"].reshape(W, -1)
    fs = t["fscastel"].reshape(W, -1).sum(1)[:, None]
    return np.stack([fQ @ c2, fU @ s2, fQ @ s2, fU @ c2], axis=1) / fs


def _assert_stokes_match(tt, tj, W):
    """The port's Stokes tallies held to skirt_tpu's.  The packages draw
    from their own streams (rng.py), so the tolerances are set from their
    spread over seeds 5-8 on these spheres: the ring amplitudes differed by
    at most 0.011 (held at 0.03), a Stokes pixel by 0.022 of the
    wavelength's peak scattered pixel (held at 0.05), a scattered pixel by
    0.062 of it (held at 0.10), and FQ, FU over Fscastel by 0.018 (held at
    0.03)."""
    np.testing.assert_allclose(_ring_amplitudes(tt, W),
                               _ring_amplitudes(tj, W), atol=0.03)
    peak = np.maximum(tt["fscastel"].reshape(W, -1).max(1),
                      tj["fscastel"].reshape(W, -1).max(1))[:, None]
    for k, tol in (("fscastel", 0.10), ("fQ", 0.05), ("fU", 0.05),
                   ("fV", 0.05)):
        d = np.abs(tt[k].reshape(W, -1) - tj[k].reshape(W, -1)) / peak
        assert d.max() <= tol, (k, d.max(1))
    for k in ("FQ", "FU", "FV"):
        np.testing.assert_allclose(tt[k] / tt["Fscastel"],
                                   tj[k] / tj["Fscastel"], atol=0.03)


@pytest.mark.parametrize("chain", ["mono", "table", "poly"])
def test_thomson_sphere_matches_skirt_tpu(thomson, chain):
    tj, tt = thomson(chain, 0)
    W = CHAINS[chain][0]
    poly = W == 2
    np.testing.assert_allclose(tt["Ftot"], tj["Ftot"],
                               rtol=0.04 if poly else 0.03)
    np.testing.assert_allclose(tt["Ftot"], np.ones(W),
                               rtol=0.05)
    np.testing.assert_allclose(tt["Fscastel"], tj["Fscastel"],
                               rtol=0.10 if poly else 0.08)
    for qx, qy in _ring(tt, W):
        assert abs(qx) > 0.15 and abs(qy) > 0.15, (qx, qy)
        assert np.sign(qx) == -np.sign(qy)
    p = np.hypot(tt["FQ"], tt["FU"]) / np.maximum(tt["Fscastel"], 1e-12)
    assert p.max() < (0.06 if poly else 0.05)
    # direct light is the emission peel's, and nothing is dust emission
    assert (tt["Fdirdust"] == 0).all() and (tt["Fscadust"] == 0).all()
    np.testing.assert_allclose(tt["Fdirstel"] + tt["Fscastel"], tt["Ftot"],
                               rtol=1e-5)
    _assert_stokes_match(tt, tj, W)
    # Thomson scattering of unpolarized light makes no circular
    # polarization (S34 = 0)
    assert (tt["fV"] == 0).all() and (tj["fV"] == 0).all()


def test_chromatic_mueller_matches_skirt_tpu(thomson):
    """The poly table with Mueller tables that differ by wavelength
    (_chromatic_mueller) on an optically thick (tau 1) sphere, where half
    the scattered light has scattered before: a driver wavelength on the
    torch side that is not the kernel's, or a Stokes row taken at the wrong
    wavelength, moves the scattered SED and the rings."""
    tj, tt = thomson("poly", 0, tau=1.0, chromatic=True)
    np.testing.assert_allclose(tt["Fscastel"], tj["Fscastel"], rtol=0.10)
    np.testing.assert_allclose(tt["Ftot"], tj["Ftot"], rtol=0.04)
    _assert_stokes_match(tt, tj, 2)
    # wavelength 0 polarizes across the scattering plane, wavelength 1 in
    # it: opposite rings
    rings = _ring_amplitudes(tt, 2)
    assert (np.sign(rings[0, :2]) == -np.sign(rings[1, :2])).all(), rings
    assert (np.abs(rings[:, :2]) > 0.08).all(), rings
    # circular polarization only where S34 != 0 (wavelength 1), the image
    # summed over |V| as large as skirt_tpu's (over seeds 5-8 the two
    # differed by at most 17%; the mean image is 0 by mirror symmetry)
    assert (tt["fV"].reshape(2, -1)[0] == 0).all()
    vabs = [np.abs(t["fV"].reshape(2, -1)[1]).sum() / t["Fscastel"][1]
            for t in (tt, tj)]
    assert vabs[1] > 0.005 and vabs[0] == pytest.approx(vabs[1], rel=0.35)


@pytest.mark.parametrize("chain", ["mono", "table", "poly"])
def test_thomson_sphere_refill(thomson, chain):
    tj, tt = thomson(chain, 4)
    W = CHAINS[chain][0]
    tol = 0.06 if W == 2 else 0.05
    np.testing.assert_allclose(tt["Ftot"], np.ones(W), rtol=tol)
    np.testing.assert_allclose(tj["Ftot"], np.ones(W), rtol=tol)
    for qx, qy in _ring(tt, W)[:1]:
        assert np.sign(qx) == -np.sign(qy)


def test_direct_table_polarized_matches_skirt_tpu():
    """K6p with DIRECT: the 300-site tessellation's polychromatic run with
    the Thomson Mueller tables in both packages (the staged peel), at the
    direct table's gates (SED 0.08, labs 0.06)."""
    from skirt_tpu import rng as jrng
    from skirt_tpu.engine.lifecycle import make_lifecycle as jax_lifecycle
    from skirt_tpu_torch.engine.lifecycle import make_lifecycle
    from test_torch_table_direct import jax_voronoi_model

    W, n = 2, 1 << 12
    grid, ds, ss, ins, opts = jax_voronoi_model(W, poly=True)
    L = 5e35 / n
    run = jax.jit(jax_lifecycle(grid, ds, ss, ins, opts, W,
                                mueller=jpol.thomson_mueller(W)))
    tj = run(jrng.root_key(4357), jnp.zeros(n, jnp.int32),
             jnp.full((n, W), L, jnp.float32),
             {"instruments": [ins[0].zero_tallies()],
              "labs": jnp.zeros((grid.ncells * W,), jnp.float32)})
    tg, tds, tss, tins, topts = from_skirt_tpu(grid, ds, ss, ins, opts)
    run = make_lifecycle(tg, tds, tss, tins, topts, W,
                         mueller=tpol.thomson_mueller(W))
    assert run.spec.want_pol and not run.spec.arith_locate
    tt = run(rng.root_key(4357), torch.zeros(n, dtype=torch.int32),
             torch.full((n, W), L),
             {"instruments": [tins[0].zero_tallies("cpu")],
              "labs": torch.zeros(tg.ncells * W)})
    sj = np.asarray(tj["instruments"][0]["Ftot"], np.float64)
    st = tt["instruments"][0]["Ftot"].double().numpy()
    np.testing.assert_allclose(st, sj, rtol=0.08)
    lj = float(np.asarray(tj["labs"], np.float64).sum())
    assert float(tt["labs"].double().sum()) == pytest.approx(lj, rel=0.06)


# ---------------------------------------------------------------------------
# OligoSimulation wires a polarizing mix
# ---------------------------------------------------------------------------

def test_simulation_wires_the_mueller_tables(tmp_path):
    from skirt_tpu_torch.engine.lifecycle import LifecycleOptions
    from skirt_tpu_torch.engine.simulation import OligoSimulation
    from skirt_tpu_torch.geometry import PointGeometry, UniformSphereGeometry
    from skirt_tpu_torch.grids import CartesianGrid
    from skirt_tpu_torch.instruments import FullInstrument
    from skirt_tpu_torch.log import SilentLog
    from skirt_tpu_torch.media import (DustComponent, DustMassNormalization,
                                       DustSystem, ElectronDustMix)
    from skirt_tpu_torch.sources import (LuminosityStellarComponent,
                                         StellarSystem)
    from skirt_tpu_torch.wavelengths import OligoWavelengthGrid

    wg = OligoWavelengthGrid([1e-6, 1.2e-6])
    mix = ElectronDustMix(wg)
    assert mix.polarization and mix.mueller is not None
    np.testing.assert_array_equal(mix.mueller.S_packed,
                                  jpol.thomson_mueller(2).S_packed)
    b = np.linspace(-1, 1, 5)
    grid = CartesianGrid(b, b, b)
    ds = DustSystem(grid, [DustComponent(UniformSphereGeometry(0.9), mix,
                                         DustMassNormalization(1e-3))],
                    samples_per_cell=2)
    assert ds.mueller is mix.mueller and ds.muellers == [mix.mueller]
    ss = StellarSystem([LuminosityStellarComponent(PointGeometry(), wg,
                                                   [1.0, 1.0])])
    ins = [FullInstrument("pol", 100.0, 2, 5, 5, fov_x=2.2, fov_y=2.2,
                          inclination=np.pi / 2, polarization=True)]
    for poly in (False, True):
        opts = LifecycleOptions(fused=True, quadrature_panels=8,
                                voxelize="table", polychromatic=poly,
                                refill_batches=2)
        sim = OligoSimulation(stellar_system=ss, instruments=ins,
                              dust_system=ds, options=opts, packets=1 << 10,
                              batch_size=1 << 10, log=SilentLog(),
                              out_dir=str(tmp_path), prefix=f"p{poly:d}",
                              device="cpu")
        assert sim._mueller is mix.mueller and sim._poly is poly
        if poly:
            assert sim._lifecycle.spec.want_pol
        acc = sim._run_phase(rng.root_key(sim.seed), 0)
        t = acc["instruments"][0]
        assert np.all(np.asarray(t["Fscastel"]) > 0)
        assert np.abs(np.asarray(t["FQ"])).sum() > 0
        sim.write(acc)
        for name in ("stokesQ", "stokesU", "stokesV"):
            assert (tmp_path / f"p{poly:d}_pol_{name}.fits").exists()


# ---------------------------------------------------------------------------
# refusals in skirt_tpu's words
# ---------------------------------------------------------------------------

def _refusal(case):
    """Build the lifecycle that `case` names on a port model and return
    the callable that raises."""
    from bench_torch import _model
    from skirt_tpu_torch.engine import fused
    from skirt_tpu_torch.engine.lifecycle import make_lifecycle
    from skirt_tpu_torch.geometry import PointGeometry
    from skirt_tpu_torch.sources import (LuminosityStellarComponent,
                                         StellarSystem)

    class Beamed(PointGeometry):
        is_isotropic = False

    if case.startswith("analytic"):
        poly = case.startswith("analytic-poly")
        grid, ds, ss, ins, opts = _model(
            nlambda=2, ncells=4, polychromatic=poly,
            ncomp=2 if case.endswith("two-components") else 1)
    else:
        poly = case.startswith("table-poly")
        from skirt_tpu_torch.engine.lifecycle import LifecycleOptions
        grid, ds, ss, ins = _port_sphere(2)
        opts = LifecycleOptions(fused=True, polychromatic=poly,
                                quadrature_panels=8)
    m = tpol.thomson_mueller(2)
    kw = {}
    if case.endswith("io_state"):
        kw = dict(io_state=True)
    elif case.endswith("polarization") or case.endswith("two-components"):
        kw = dict(mueller=m)
    elif case.endswith("tally_flush"):
        kw = dict(mueller=m)
        opts = dataclasses.replace(opts, tally_flush=2)
    elif case.endswith("no-table"):
        kw = dict(mueller=[None])
    elif case.endswith("launch_fn"):
        kw = dict(mueller=m, launch_fn=lambda *a: None)
    elif case.endswith("anisotropic"):
        kw = dict(mueller=m)
        ss = StellarSystem([LuminosityStellarComponent(
            Beamed(), ss.wavelength_grid, ss.Lv)])
    if case == "analytic-mono-table":
        return lambda: fused.make_fused_lifecycle(grid, ds.as_table(), ss,
                                                  ins, opts, 2)
    return lambda: make_lifecycle(grid, ds, ss, ins, opts, 2, **kw)


def _port_sphere(W):
    grid, ds, ss, ins = _sphere(W, "gridded")
    from skirt_tpu_torch.convert import (convert_dust_system, convert_grid,
                                         convert_instrument,
                                         convert_stellar_system)
    g = convert_grid(grid)
    return (g, convert_dust_system(ds, g), convert_stellar_system(ss),
            [convert_instrument(i) for i in ins])


REFUSALS = {
    "analytic-poly-polarization":
        r"polarization not supported \(vector/fused-mono paths carry",
    "analytic-poly-io_state": "io_state not supported",
    "analytic-mono-io_state": "io_state not supported",
    "analytic-mono-table": "table \\(gathered\\) densities are not supported "
                           "in-kernel",
    "analytic-mono-tally_flush": "polarized fused path requires tally_flush=1",
    "analytic-mono-no-table": "polarized fused path needs a Mueller table",
    "analytic-mono-two-components": "polarized fused path supports a single "
                                    "dust component",
    "table-mono-io_state": "io_state not supported",
    "table-poly-io_state": "io_state not supported",
    "table-poly-launch_fn": "polarization with launch_fn \\(dust phases\\) "
                            "not supported",
    "table-poly-anisotropic": "polarized mode with anisotropic stellar "
                              "emission is not supported",
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_use_skirt_tpu_words(case):
    with pytest.raises(ValueError, match=REFUSALS[case]) as e:
        _refusal(case)()
    assert "slice" not in str(e.value)
