"""Slice S4b-2 on the CPU: the port's VoronoiGrid and the dust system on it,
against skirt_tpu.

- The host build (native cell builder, neighbour table, the seeded Monte
  Carlo pass with its owners and padded boxes, the float32 scaled tables,
  the block-candidate and neighbour-walk locate tables) at 300 and 700
  uniform sites in [-1, 1]^3: identical, the volumes to rtol 1e-12 (the
  same source, flags and machine give the same bits).  Without the native
  builder both fall back to scipy ridges with Monte Carlo volumes, and
  the port says so.
- Device point location, mirroring tests/test_voronoi.py:141-189: the
  scan (300 sites), the block-candidate table (_SCAN_MAX_SITES = 0) and the
  neighbour walk (a direct _nearest_walk call) against skirt_tpu's on the
  same float32 points, and against the exact nearest site.  A cell may
  differ from skirt_tpu's only where the two nearest sites tie to float32
  rounding (their squared distances within 1e-5 relative).
- ray_span bit for bit; voxelize's cell_of; the measured field error and
  the refusal above a bound (tests/test_voronoi.py:243-309).
- DustSystem on the tessellation: rho64 bit for bit (the construction-time
  sample mean), the table rows the engines stage at panel midpoints.
- A skirt_tpu grid carried across by convert_grid equals the port's own
  build.
- A two-phase Cartesian grid's weights scale the gridded densities as in
  skirt_tpu (the same weights, rho64 bit for bit, carried across).
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skirt_tpu.grids.voronoi import VoronoiGrid as JaxVoronoiGrid
from skirt_tpu_torch.constants import KPC
from skirt_tpu_torch.convert import convert_grid
from skirt_tpu_torch.grids import VoronoiGrid

torch.set_num_threads(2)

EXTENT = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
HOST_TABLES = ("sites64", "extent", "centroids64", "nbrs64", "bb_lo64",
               "bb_hi64", "_mc_pts", "_mc_owner", "_sites_np", "_nbrs_np",
               "_lo_np", "_hi_np", "_bb_lo_np", "_bb_hi_np")


def _sites(n, seed=5):
    return np.random.default_rng(seed).uniform(-0.98, 0.98, size=(n, 3))


@pytest.fixture(scope="module")
def grids():
    """(skirt_tpu grid, port grid) at 300 and 700 sites."""
    out = {}
    for n in (300, 700):
        s = _sites(n)
        out[n] = (JaxVoronoiGrid(s, EXTENT, volume_samples=64),
                  VoronoiGrid(s, EXTENT, volume_samples=64))
    return out


def _assert_same_host_build(g, j):
    assert g.used_native == j.used_native
    assert (g.ncells, g.kmax, g.scale, g.max_steps) == \
        (j.ncells, j.kmax, j.scale, j.max_steps)
    np.testing.assert_allclose(g.volumes64, j.volumes64, rtol=1e-12)
    for name in HOST_TABLES:
        np.testing.assert_array_equal(getattr(g, name), getattr(j, name),
                                      err_msg=name)


@pytest.mark.parametrize("n", [300, 700])
def test_host_build_matches_skirt_tpu(grids, n):
    """Native volumes, neighbours, boxes, Monte Carlo owners and the block
    and walk locate tables."""
    j, g = grids[n]
    assert g.used_native
    _assert_same_host_build(g, j)
    assert g.cell_volumes().sum() == pytest.approx(8.0, rel=1e-6)
    for build, tables in (("_ensure_blocks", ("_blk_flat_np", "_blk_lo_np",
                                              "_blk_inv_np")),
                          ("_ensure_walk", ("_walk_rows_np", "_walk_seed_np",
                                            "_walk_lo_np", "_walk_inv_np"))):
        getattr(j, build)()
        getattr(g, build)()
        for name in tables:
            np.testing.assert_array_equal(getattr(g, name), getattr(j, name),
                                          err_msg=name)
    assert (g._blk_nb, g._blk_k, g._walk_ns, g._walk_k) == \
        (j._blk_nb, j._blk_k, j._walk_ns, j._walk_k)


def test_scipy_fallback_is_logged(monkeypatch):
    """Without the native builder the port warns and builds what skirt_tpu
    builds without it (scipy ridges, Monte Carlo volumes)."""
    from skirt_tpu_torch import native

    monkeypatch.setattr(native, "voronoi_cells", lambda *a: None)
    s = _sites(200, seed=8)
    with pytest.warns(UserWarning, match="native cell builder is "
                      "unavailable"):
        g = VoronoiGrid(s, EXTENT, volume_samples=32)
    j = JaxVoronoiGrid(s, EXTENT, volume_samples=32, use_native=False)
    assert not g.used_native
    _assert_same_host_build(g, j)


def _tie_mismatches(grid, pts, got, want):
    """Points where two cell lists differ although the two sites' squared
    distances (float64, scaled units) differ by more than 1e-5 relative."""
    p = pts.astype(np.float64) / grid.scale
    s = grid.sites64 / grid.scale
    diff = np.nonzero(got != want)[0]
    d_got = ((p[diff] - s[got[diff]]) ** 2).sum(1)
    d_want = ((p[diff] - s[want[diff]]) ** 2).sum(1)
    return diff[np.abs(d_got - d_want) > 1e-5 * np.maximum(d_got, d_want)]


@pytest.mark.parametrize("scheme", ["scan", "blocks", "walk"])
def test_locate_matches_skirt_tpu(grids, scheme):
    """locate_batched on the scan (300 sites) and the block table
    (_SCAN_MAX_SITES = 0), and the walk called directly (700 sites), against
    skirt_tpu's and the exact nearest site; outside points give -1."""
    n = 700 if scheme == "walk" else 300
    j, g = grids[n]
    rs = np.random.default_rng(7 + n)
    pts = rs.uniform(-1.02, 1.02, size=(6000, 3)).astype(np.float32)
    if scheme == "walk":
        ps = pts * np.float32(1.0 / g.scale)
        want = np.asarray(j._nearest_walk(jnp.asarray(ps)))
        got = g._nearest_walk(torch.from_numpy(ps)).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            j._nearest_scan(jnp.asarray(ps))))
    else:
        if scheme == "blocks":
            j._SCAN_MAX_SITES = g._SCAN_MAX_SITES = 0
        try:
            assert g.locate_scheme()[0] == scheme
            want = np.asarray(j.locate_batched(jnp.asarray(pts)))
            got = g.locate_batched(torch.from_numpy(pts)).numpy()
        finally:
            if scheme == "blocks":
                del j._SCAN_MAX_SITES, g._SCAN_MAX_SITES
    assert got.dtype == np.int32 and got.shape == (6000,)
    assert len(_tie_mismatches(g, pts, got, want)) == 0
    inside = np.all(np.abs(pts) <= 1.0, axis=1)
    if scheme != "walk":
        assert (got[~inside] == -1).all() and (~inside).sum() > 50
    _, exact = g._tree.query(pts.astype(np.float64))
    assert (got[inside] == exact[inside]).mean() > 0.995


def test_locate_tables_and_scheme_choice():
    """Past 2,048 sites the block table (the scheme skirt_tpu picks); the
    chunked locate gives the same cells as one unchunked pass."""
    from skirt_tpu_torch.grids import voronoi as tv

    s = _sites(2600, seed=9)
    g = VoronoiGrid(s, EXTENT, volume_samples=4)
    name, nbytes = g.locate_scheme()
    assert name == "blocks" and nbytes == g._blk_flat_np.nbytes
    pts = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (3000, 3)).astype(np.float32))
    whole = g.locate_batched(pts)
    saved = dict(tv._LOCATE_CHUNK_FLOATS)
    try:
        tv._LOCATE_CHUNK_FLOATS["cpu"] = 4 * g._blk_k * 7     # 7 points
        assert torch.equal(g.locate_batched(pts), whole)
    finally:
        tv._LOCATE_CHUNK_FLOATS.update(saved)
    _, exact = g._tree.query(pts.numpy().astype(np.float64))
    assert (whole.numpy() == exact).mean() > 0.995


def test_ray_span_and_voxelize_match(grids):
    j, g = grids[300]
    rs = np.random.default_rng(9)
    pos = rs.uniform(-1.3, 1.3, (4096, 3)).astype(np.float32)
    d = rs.normal(size=(4096, 3))
    d[:64, 0] = 0.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    for a, b in zip(g.ray_span(torch.from_numpy(pos), torch.from_numpy(d)),
                    j.ray_span(jnp.asarray(pos), jnp.asarray(d))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for kw in ({}, {"max_voxels": 20 ** 3}, {"resolution": 12}):
        (cart, cell_of), (jcart, jcell_of) = g.voxelize(**kw), \
            j.voxelize(**kw)
        np.testing.assert_array_equal(cell_of, jcell_of)
        for b in ("xb64", "yb64", "zb64"):
            np.testing.assert_array_equal(getattr(cart, b),
                                          getattr(jcart, b))


def _media(clumpy):
    """tests/test_voronoi.py's field-error model (1,500 sites in +-2 kpc, a
    uniform sphere, a random 3% of the cells at 1e3 contrast) in both
    frameworks: (skirt_tpu system, port system)."""
    from skirt_tpu.geometry import UniformSphereGeometry
    from skirt_tpu.media import (DustComponent, DustMassNormalization,
                                 DustSystem, SimpleOligoDustMix)
    from skirt_tpu.wavelengths import OligoWavelengthGrid

    wg = OligoWavelengthGrid([0.55e-6])
    half = 2.0 * KPC
    rs = np.random.default_rng(3)
    sites = rs.uniform(-0.98 * half, 0.98 * half, size=(1500, 3))
    grid = JaxVoronoiGrid(sites, (-half, -half, -half, half, half, half),
                          volume_samples=16)
    mix = SimpleOligoDustMix(wg, [2600.0], [0.5], [0.4])
    comp = DustComponent(UniformSphereGeometry(1.8 * KPC), mix,
                         DustMassNormalization(1e33))
    jds = DustSystem(grid, [comp], density_mode="gridded")
    if clumpy:
        hot = rs.random(grid.ncells) < 0.03
        jds.rho64[:, hot] *= 1e3
        jds.rho = np.asarray(jds.rho64, np.float32)
    from skirt_tpu_torch.convert import convert_dust_system
    return jds, convert_dust_system(jds, convert_grid(grid))


def test_dust_system_gridding_matches():
    """rho64 from the grid's construction-time samples, bit for bit,
    between skirt_tpu's and the port's own build."""
    from skirt_tpu_torch.geometry import UniformSphereGeometry
    from skirt_tpu_torch.media import (DustComponent, DustMassNormalization,
                                       DustSystem, SimpleOligoDustMix)
    from skirt_tpu_torch.wavelengths import OligoWavelengthGrid

    jds, _ = _media(False)
    half = 2.0 * KPC
    sites = np.random.default_rng(3).uniform(-0.98 * half, 0.98 * half,
                                             size=(1500, 3))
    grid = VoronoiGrid(sites, (-half, -half, -half, half, half, half),
                       volume_samples=16)
    wg = OligoWavelengthGrid([0.55e-6])
    comp = DustComponent(UniformSphereGeometry(1.8 * KPC),
                         SimpleOligoDustMix(wg, [2600.0], [0.5], [0.4]),
                         DustMassNormalization(1e33))
    ds = DustSystem(grid, [comp], density_mode="gridded")
    np.testing.assert_array_equal(ds.rho64, jds.rho64)
    assert ds.gridded_mass() == jds.gridded_mass()
    assert (ds.rho64 > 0).mean() > 0.3


@pytest.mark.parametrize("clumpy", [False, True], ids=["smooth", "clumpy"])
def test_field_error_and_refusal(clumpy):
    """The approximate voxel view's mass-weighted field error equals
    skirt_tpu's estimate (the same samples; the exact cells from each
    framework's locate); a bound below it refuses the view, one above
    accepts it; the voxel densities and the labs fold agree."""
    jds, ds = _media(clumpy)
    (vds, fold), (jvds, jfold) = (ds.voxelized(max_voxels=48 ** 3),
                                  jds.voxelized(max_voxels=48 ** 3))
    err, jerr = vds.voxelization_error, jvds.voxelization_error
    assert err == pytest.approx(jerr, rel=1e-6)
    assert 0.0 < err < (1.0 if clumpy else 0.1)
    if clumpy:
        assert err > 0.1
    np.testing.assert_array_equal(vds.rho64, jvds.rho64)
    # floor of the float cube root of 48^3 is 47, in both
    assert vds.grid.nx == jvds.grid.nx == 47
    labs = np.random.default_rng(5).random(47 ** 3)
    np.testing.assert_array_equal(fold(labs), jfold(labs))
    assert ds.voxelized(max_voxels=48 ** 3, max_field_error=err * 0.5) is None
    assert ds.voxelized(max_voxels=48 ** 3,
                        max_field_error=err * 2.0) is not None


def test_field_error_is_logged():
    from skirt_tpu_torch.log import Log

    _, ds = _media(True)
    lines = []

    class Capture(Log):
        def _emit(self, message):
            lines.append(message)

    assert ds.voxelized(max_voxels=24 ** 3, max_field_error=0.1,
                        log=Capture()) is None
    assert lines[0].startswith("approximate voxelization: mass-weighted "
                               "field error")
    assert lines[1].startswith("Warning: voxelization refused")


def test_table_rows_on_the_tessellation():
    """The table rows the engines stage (panel paths, the tessellation's
    locate at the panel midpoints, the rho gather) against skirt_tpu's."""
    from skirt_tpu.engine import vector_traversal as jvt
    from skirt_tpu_torch.engine import vector_traversal as tvt

    jds, tds = _media(True)
    jtab, ds = jds.as_table(), tds.as_table()
    jgrid, grid = jtab.grid, ds.grid
    assert ds.table
    rs = np.random.default_rng(6)
    pos = (rs.uniform(-1.9, 1.9, (1024, 3)) * KPC).astype(np.float32)
    d = rs.normal(size=(1024, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jdsg, _, jmid = jvt.panel_paths(jgrid, jnp.asarray(pos), jnp.asarray(d),
                                    16)
    ones = jnp.ones(1024, jnp.float32)
    jrows = np.asarray(jtab.analytic_rows(jnp.asarray(pos), jnp.asarray(d),
                                          jmid, None, [ones],
                                          want_sca=False))
    pt, dt = torch.from_numpy(pos), torch.from_numpy(d)
    _, _, mid = tvt.panel_paths(grid, pt, dt, 16)
    np.testing.assert_array_equal(mid.numpy(), np.asarray(jmid))
    rows = ds.analytic_rows(pt, dt, mid, None, [torch.ones(1024)],
                            want_sca=False).numpy()
    # a midpoint whose two nearest sites tie to float32 rounding may take
    # either cell
    assert (rows == jrows).mean() > 0.999 and (jrows > 0).mean() > 0.3


def test_converted_grid_equals_the_port_build(grids):
    """convert_grid copies skirt_tpu's host tables; the port's own build
    from the same sites gives the same tables and the same cells."""
    j, g = grids[700]
    c = convert_grid(j)
    assert type(c) is VoronoiGrid
    _assert_same_host_build(c, g)
    pts = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (2000, 3)).astype(np.float32))
    assert torch.equal(c.locate_batched(pts), g.locate_batched(pts))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        c.locate_scheme()


@pytest.mark.parametrize("samples", [1, 4])
def test_two_phase_weights_scale_the_gridding(samples):
    """A two-phase grid's cell weights scale the gridded densities
    (skirt_tpu/media/dust_system.py:122-126): the port's own grid draws
    skirt_tpu's weights bit for bit, its rho64 equals skirt_tpu's, equals
    the plain grid's times the weights, and a grid carried across keeps
    them."""
    from skirt_tpu.geometry import UniformSphereGeometry as JaxSphere
    from skirt_tpu.grids import TwoPhaseGrid as JaxTwoPhase
    from skirt_tpu.media import (DustComponent as JaxComp,
                                 DustMassNormalization as JaxNorm,
                                 DustSystem as JaxDS,
                                 SimpleOligoDustMix as JaxMix)
    from skirt_tpu.wavelengths import OligoWavelengthGrid as JaxWG
    from skirt_tpu_torch.geometry import UniformSphereGeometry
    from skirt_tpu_torch.grids import CartesianGrid, TwoPhaseGrid
    from skirt_tpu_torch.media import (DustComponent, DustMassNormalization,
                                       DustSystem, SimpleOligoDustMix)
    from skirt_tpu_torch.wavelengths import OligoWavelengthGrid

    b = np.linspace(-2.0, 2.0, 9) * KPC
    jgrid = JaxTwoPhase(b, b, b, filling_factor=0.2, contrast=10.0, seed=2)
    grid = TwoPhaseGrid(b, b, b, filling_factor=0.2, contrast=10.0, seed=2)
    np.testing.assert_array_equal(grid.cell_weights, jgrid.cell_weights)
    jcomp = JaxComp(JaxSphere(1.8 * KPC),
                    JaxMix(JaxWG([0.55e-6]), [2600.0], [0.5], [0.4]),
                    JaxNorm(1e33))
    comp = DustComponent(UniformSphereGeometry(1.8 * KPC),
                         SimpleOligoDustMix(OligoWavelengthGrid([0.55e-6]),
                                            [2600.0], [0.5], [0.4]),
                         DustMassNormalization(1e33))
    jds = JaxDS(jgrid, [jcomp], samples_per_cell=samples)
    ds = DustSystem(grid, [comp], samples_per_cell=samples)
    np.testing.assert_array_equal(ds.rho64, jds.rho64)
    plain = DustSystem(CartesianGrid(b, b, b), [comp],
                       samples_per_cell=samples)
    inside = plain.rho64[0] > 0
    assert inside.mean() > 0.3
    np.testing.assert_allclose(ds.rho64[0][inside] / plain.rho64[0][inside],
                               grid.cell_weights[inside], rtol=1e-12)
    carried = convert_grid(jgrid)
    assert isinstance(carried, TwoPhaseGrid)
    np.testing.assert_array_equal(carried.cell_weights, jgrid.cell_weights)
    np.testing.assert_array_equal(
        DustSystem(carried, [comp], samples_per_cell=samples).rho64,
        jds.rho64)
