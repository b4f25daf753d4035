"""Geometries, grid and random streams of the port against skirt_tpu.

Host-side (NumPy float64) quantities must be identical; device-side
float32 closed forms agree to float32 rounding on identical inputs;
samplers that draw their own numbers agree in distribution.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skirt_tpu import geometry as jgeom
from skirt_tpu import rng as jrng
from skirt_tpu.constants import KPC
from skirt_tpu_torch import geometry as tgeom
from skirt_tpu_torch import rng
from skirt_tpu_torch.engine import common as tcm

torch.set_num_threads(2)

DISCS = {"plain": (4 * KPC, 0.35 * KPC, 0.0, 0.0, 0.0),
         "truncated": (4 * KPC, 0.35 * KPC, 10 * KPC, 1.5 * KPC, 1 * KPC)}


@pytest.fixture(params=sorted(DISCS))
def discs(request):
    args = DISCS[request.param]
    return jgeom.ExpDiskGeometry(*args), tgeom.ExpDiskGeometry(*args)


def test_host_quantities_identical(discs):
    j, t = discs
    assert t.rho0 == j.rho0
    assert (t.sigma_x(), t.sigma_y(), t.sigma_z()) == \
        (j.sigma_x(), j.sigma_y(), j.sigma_z())
    pos = np.random.default_rng(1).normal(scale=3 * KPC, size=(4000, 3))
    np.testing.assert_array_equal(t.density(pos), np.asarray(j.density(pos)))


def test_scaled_density_float32(discs):
    """Both float32 closed forms against a float64 evaluation of the same
    closed form on the same float32 inputs, per element within the bound
    float32 rounding allows.

    The exponent's argument a = R / hR + |z| / hz is a chain of about six
    float32 roundings per term (squares, sum, sqrt, the scale factor, the
    reciprocal scale length and its product, the final sum), so it is off
    by up to ~3 |a| 2^-23; exp turns that absolute error into the same
    relative error of the density, and exp and the prefactor add a few
    ulps of their own.  Bound: (4 |a| + 8) 2^-23 relative.  A fixed rtol
    cannot hold here: a reaches ~9 on these inputs, where one ulp of a is
    ~1e-6 relative after the exp, and XLA's CPU backend contracts
    multiply-adds into FMAs to a degree that depends on the CPU it
    compiles for, so the two frameworks round a differently by machine.

    Each framework reads its own copy of the inputs (JAX zero-copies a
    64-byte-aligned numpy row, torch.from_numpy always does): a precaution,
    not a known repair, since JAX only reads the rows.  A failure reports
    the elements out of bound, whether a second evaluation in the same
    process repeats them, and whether the inputs still hold their seeded
    values."""
    j, t = discs
    L = 24 * KPC

    def seeded():
        xs = np.random.default_rng(2).uniform(-0.6, 0.6, size=(3, 5000))
        xs[2] *= 0.1
        return xs.astype(np.float32)

    xs = seeded()

    def port():
        return t.density_scaled_xyz(
            *[torch.from_numpy(x.copy()) for x in xs], L).numpy()

    want = np.array(j.density_scaled_xyz(*[jnp.array(x) for x in xs], L))
    got = port()
    x, y, z = (v.astype(np.float64) * L for v in xs)
    R = np.hypot(x, y)
    arg = R / t.hR + np.abs(z) / t.hz
    inside = R >= t.Rmin
    if t.Rmax > 0:
        inside &= R <= t.Rmax
    if t.zmax > 0:
        inside &= np.abs(z) <= t.zmax
    ref = np.where(inside, t.rho0 * L ** 3 * np.exp(-arg), 0.0)
    bound = (4.0 * arg + 8.0) * 2.0 ** -23 * ref + 1e-7 * ref.max()
    for name, val in (("skirt_tpu", want), ("port", got)):
        err = np.abs(val.astype(np.float64) - ref)
        bad = np.nonzero(err > bound)[0]
        assert bad.size == 0, (
            name, float((err / bound).max()), bad.size, bad[:8].tolist(),
            float((err[bad] / ref[bad]).max()),
            "port again: %d out of bound" % (
                np.abs(port().astype(np.float64) - ref) > bound).sum(),
            "inputs unchanged: %s" % np.array_equal(xs, seeded()))
    assert (want > 0).mean() > 0.2 and arg[inside].max() > 6.0


def test_device_samplers_on_identical_uniforms():
    u = np.random.default_rng(3).uniform(1e-7, 1 - 1e-7, (4, 5000)) \
        .astype(np.float32)
    for j, t in ((jgeom.ExpDiskGeometry(*DISCS["plain"]),
                  tgeom.ExpDiskGeometry(*DISCS["plain"])),
                 (jgeom.PointGeometry(), tgeom.PointGeometry())):
        nj, fj = j.device_sampler_xyz()
        nt, ft = t.device_sampler_xyz()
        assert nt == nj
        want = fj([jnp.asarray(x) for x in u[:nj]])
        got = ft([torch.from_numpy(x) for x in u[:nt]])
        for a, b in zip(got, want):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                       atol=1e-6 * max(np.abs(b).max(), 1.0))
    assert tgeom.ExpDiskGeometry(*DISCS["truncated"]).device_sampler_xyz() \
        is None


def test_generate_position_distribution(discs):
    """generate_position draws from its own stream: compare moments."""
    j, t = discs
    n = 200000
    pj = np.asarray(j.generate_position(jrng.root_key(5), n), np.float64)
    pt = t.generate_position(rng.root_key(5), n, "cpu").numpy().astype(np.float64)
    for p in (pj, pt):
        assert np.isfinite(p).all()
    Rj, Rt = np.hypot(pj[:, 0], pj[:, 1]), np.hypot(pt[:, 0], pt[:, 1])
    assert Rt.mean() == pytest.approx(Rj.mean(), rel=0.01)
    assert np.abs(pt[:, 2]).mean() == pytest.approx(np.abs(pj[:, 2]).mean(),
                                                    rel=0.01)
    if j.Rmax > 0:
        assert Rt.min() >= j.Rmin * 0.999 and Rt.max() <= j.Rmax * 1.001
        assert np.abs(pt[:, 2]).max() <= j.zmax * 1.001


def test_locate_and_span_match_reference():
    from skirt_tpu.engine import fused as jfused
    from skirt_tpu.grids import CartesianGrid as JGrid
    from skirt_tpu_torch.grids import CartesianGrid as TGrid

    half = 12 * KPC
    b = np.linspace(-half, half, 9)
    bz = np.linspace(-2 * KPC, 2 * KPC, 5)
    jg, tg = JGrid(b, b, bz), TGrid(b, b, bz)
    rs = np.random.default_rng(6)
    p = rs.uniform(-1.2 * half, 1.2 * half, size=(3, 4000)).astype(np.float32)
    d = rs.normal(size=(3, 4000))
    d[0, :50] = 0.0
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    want = np.asarray(jfused._make_locate(jg)(*[jnp.asarray(x) for x in p]))
    got = tcm._make_locate(tg)(*[torch.from_numpy(x) for x in p]).numpy()
    np.testing.assert_array_equal(got, want)
    sj = jfused._make_span(jg.bounding_box())(
        *[jnp.asarray(x) for x in (*p, *d)])
    st = tcm._make_span(tg.bounding_box())(
        *[torch.from_numpy(x) for x in (*p, *d)])
    for a, b_ in zip(st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-6)
    kvec = (0.3, 0.0, -0.9539392014169456)
    sj = jfused._make_span(jg.bounding_box())(
        *[jnp.asarray(x) for x in p], *kvec, const_d=True)
    st = tcm._make_span(tg.bounding_box())(
        *[torch.from_numpy(x) for x in p], *kvec, const_d=True)
    for a, b_ in zip(st, sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))


def test_expon_cutoff_forms():
    """The driver-side rng.expon_cutoff (expm1/log1p, small branch below
    1e-6) and the in-kernel _expon_cutoff (exp/log, below 1e-4)."""
    from skirt_tpu.engine.fused import _expon_cutoff as j_kernel_form

    rs = np.random.default_rng(7)
    u = rs.uniform(1e-7, 1 - 1e-7, 20000).astype(np.float32)
    tau = np.exp(rs.uniform(np.log(1e-8), np.log(30.0), 20000)) \
        .astype(np.float32)
    # the kernel form's 1 - u (1 - exp(-tau)) carries the absolute
    # rounding of numbers near 1 (~6e-8), one ulp of which moves a small
    # sample by that much: hence its atol
    pairs = ((jrng.expon_cutoff, rng.expon_cutoff, 0.0),
             (j_kernel_form, tcm._expon_cutoff, 2e-7))
    for jf, tf, atol in pairs:
        want = np.asarray(jf(jnp.asarray(u), jnp.asarray(tau)))
        got = tf(torch.from_numpy(u), torch.from_numpy(tau)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
        assert (got <= tau * (1 + 1e-6)).all() and (got >= 0).all()


def test_streams_reproducible_and_distinct():
    k = rng.root_key(4357)
    assert rng.event_key(k, 1, 2) == rng.event_key(k, 1, 2)
    keys = [rng.event_key(k, b, e) for b in range(20) for e in range(50)]
    keys += rng.split(k, 8) + [rng.event_key(k, b) for b in range(20)]
    assert len(set(keys)) == len(keys)
    a = rng.uniform_open(rng.event_key(k, 3), (10000,), "cpu")
    b = rng.uniform_open(rng.event_key(k, 3), (10000,), "cpu")
    assert torch.equal(a, b)
    assert float(a.min()) >= 1e-7 and float(a.max()) <= 1 - 1e-7
    d = rng.isotropic_direction(k, (20000,), "cpu")
    np.testing.assert_allclose(torch.linalg.norm(d, dim=1).numpy(), 1.0,
                               rtol=1e-6)
    assert abs(float(d[:, 2].mean())) < 0.02
