"""Benchmark of the PyTorch / CUDA port: photon packets/s on one GPU.

Mirrors bench.py (the JAX benchmark) for the same model and the same
BENCH_* environment overrides, and prints the same one JSON line
{"metric", "value", "unit", "vs_baseline"} plus the device it ran on.
The default is the polychromatic main path: an ExpDisk stellar disc in
an ExpDisk dust disc on a 32x32x16 grid, 128 wavelengths per lane, 2^15
lanes, refill depth K = 128, 2 batches per call, an SED and a 16x16
frame instrument, absorption tallies on.  BENCH_POLY=0 runs the
monochromatic engine (kernel K3) as bench.py does, one wavelength per
lane; its flagship is BENCH_POLY=0 BENCH_NLAMBDA=4 BENCH_LOG2_PACKETS=21
BENCH_DISPATCH_BATCHES=8.  Packets counted: lanes x K x batches x reps,
times W with polychromatic lanes.

Run on a CUDA machine:  python3 bench_torch.py
(it raises without a CUDA device; a CPU rehearsal calls _build with
device="cpu" at a small size).

Timing: a warm-up call (it builds the kernels at first use), then
best-of-3 blocks of 3 calls, each block closed by torch.cuda.synchronize().

BENCH_MODEL=octree runs capability config 3 instead, as
experiments/bench_octree.py builds it (its OCTREE_* knobs, their
defaults): a point source in the AGN torus (TorusGeometry 1.0, 2.0, 0.7,
0.05-2 kpc, tau_x = 5 at the first wavelength) on an octree over +-2.2 kpc
(min_level 2, max_level 5, midpoint subdivision), gridded with 8 samples
per leaf, traced through its exact 32^3 voxel view in table mode
(kernels K4 and K6); OCTREE_NLAM log-spaced wavelengths from 0.55 to
2.2 um with power-law optics (default 2), one SED instrument at
inclination 1.2, labs on, 16 propagation panels, the exact peel,
max_scatt_events 64.  OCTREE_POLY=1 (default): W = nlambda per lane,
2^OCTREE_LOG2N lanes (17), refill OCTREE_REFILL (256); OCTREE_POLY=0:
ell = lane % W, refill 128.  Packets counted as bench_octree.py counts
them: lanes x K x W (poly), lanes x K (mono).  The host build (octree,
gridding, voxel view) is timed and printed on a line of its own, outside
the timed calls; timing as bench_octree.py: a warm-up call, then the best
of 3 calls, each closed by torch.cuda.synchronize().  The production-width
row is OCTREE_NLAM=24 OCTREE_LOG2N=15.

BENCH_MODEL=multi runs the two-component model instead (_multi_model:
tests/test_fused_table.py's TestMultiComponentFused, BASELINE.md:288-306;
kernels K5 and K7), timed and counted the same way, with the knobs
OCTREE_POLY (1: W = 2 per lane, K7; 0: ell = lane % 2, K5),
OCTREE_LOG2N (17) and OCTREE_REFILL (128).

BENCH_MODEL=voronoi runs capability config 4 instead, as
experiments/bench_voronoi.py builds it in table mode (_voronoi_model; its
VORONOI_* knobs and defaults): VORONOI_SITES sites (4096) uniform in
+-0.98 x 2 kpc (default_rng(3)) in a +-2 kpc box, volume_samples 32, a
point source in a 1.8 kpc uniform sphere, VORONOI_NLAM log-spaced
wavelengths (2) with power-law optics (kappa 2600 -> 600, albedo 0.5 ->
0.4, g 0.4 -> 0.2), one SED instrument at inclination 1.2, labs on,
VORONOI_PANELS propagation panels (16), VORONOI_PEELP peel panels (32),
VORONOI_PEELMODE (exact), max_scatt_events 64.  By default the
approximate voxel view at VORONOI_RES^3 voxels at most (47: 46^3 voxels;
0 for ~8 voxels per cell and axis) runs kernels K4 / K6; VORONOI_DIRECT=1
runs the direct table on the exact tessellation instead (kernels K4d /
K6d, the exact peel downgraded to the staged one).  VORONOI_POLY (1: W =
nlambda per lane; 0: ell = lane % W), VORONOI_LOG2N lanes (16 direct, 17
voxel view), VORONOI_REFILL (32 direct, 256 poly, 128 mono).  The host
build (tessellation, locate tables, gridding, voxel view) is timed and
printed on a line of its own with the locate scheme and its table bytes
and the field error; timing and counting as BENCH_MODEL=octree.  The
validated import-scale row is VORONOI_DIRECT=1 VORONOI_SITES=33000
VORONOI_NLAM=8 VORONOI_PEELP=64 VORONOI_REFILL=64.

BENCH_MODEL=polarized runs experiments/bench_polarized.py's polarized
chains (_polarized_model; its POL_* knobs and defaults): the Thomson
Mueller tables, a polarized FullInstrument (16x16 over 26 kpc) and an SED
instrument at inclination 1.2, POL_NLAM log-spaced wavelengths (2),
POL_LOG2N lanes (17), refill POL_REFILL (64), POL_PEELP peel panels (8),
the azimuth POL_AZ (0.7 on the table, 0 on the disc), max_scatt_events
64.  Default: the mono analytic flagship (the ExpDisk disc on 32x32x16,
32 panels, one wavelength per lane: kernel K3); POL_TABLE=1: the mono
table on config 3's torus (16 panels, the exact peel: K4); POL_TABLE=1
POL_POLY=1: the poly table (W = POL_NLAM per lane: K6p).  Packets counted
as bench_polarized.py counts them: lanes x K (x W on the poly table);
timing as BENCH_MODEL=octree.  POL_FUSED=0 (the polarized vector path)
raises: slice S5b.
"""

import json
import os
import time

import numpy as np


def _model(nlambda=2, ncells=16, n_instruments=2, store_absorption=True,
           max_scatt=64, quadrature_panels=None, refill_batches=0,
           peel_panels=None, albedo=0.6, min_weight_reduction=1e4,
           vary_lambda=False, polychromatic=True, ncomp=1):
    """The dusty-disc model of __graft_entry__._build on the port
    (analytic densities, sampled deposits, the fused engines) as
    (grid, dust system, stellar system, instruments, options).
    ncomp=2 adds the second dust component of tests/test_fused.py's
    two-component model (a thicker 2 kpc x 0.5 kpc disc, albedo 0.2 to
    0.8 and g -0.2 to 0.6 over the wavelengths, tau_z = 0.5)."""
    from skirt_tpu_torch.constants import KPC
    from skirt_tpu_torch.engine.lifecycle import LifecycleOptions
    from skirt_tpu_torch.geometry import ExpDiskGeometry
    from skirt_tpu_torch.grids import CartesianGrid
    from skirt_tpu_torch.instruments import SEDInstrument, SimpleInstrument
    from skirt_tpu_torch.media import (DustComponent, DustSystem,
                                       OpticalDepthNormalization,
                                       SimpleOligoDustMix)
    from skirt_tpu_torch.sources import (LuminosityStellarComponent,
                                         StellarSystem)
    from skirt_tpu_torch.wavelengths import OligoWavelengthGrid

    wg = OligoWavelengthGrid(list(np.linspace(0.4e-6, 1.2e-6, nlambda)))
    ss = StellarSystem([LuminosityStellarComponent(
        ExpDiskGeometry(4 * KPC, 0.35 * KPC), wg, [1e36] * nlambda)])
    half = 12 * KPC
    b = np.linspace(-half, half, ncells + 1)
    bz = np.linspace(-2 * KPC, 2 * KPC, max(ncells // 2, 2) + 1)
    grid = CartesianGrid(b, b, bz)
    if vary_lambda:
        lam_fac = np.linspace(1.0, 0.3, nlambda)
        mix = SimpleOligoDustMix(wg, list(2600.0 * lam_fac),
                                 list(albedo * np.linspace(1.0, 0.5, nlambda)),
                                 list(0.5 * np.linspace(1.0, 0.4, nlambda)))
    else:
        mix = SimpleOligoDustMix(wg, [2600.0] * nlambda, [albedo] * nlambda,
                                 [0.5] * nlambda)
    comps = [DustComponent(ExpDiskGeometry(4 * KPC, 0.2 * KPC), mix,
                           OpticalDepthNormalization("z", wg.lambdav[0],
                                                     1.0))]
    if ncomp == 2:
        mix2 = SimpleOligoDustMix(wg, list(np.linspace(1000.0, 1500.0,
                                                       nlambda)),
                                  list(np.linspace(0.2, 0.8, nlambda)),
                                  list(np.linspace(-0.2, 0.6, nlambda)))
        comps.append(DustComponent(ExpDiskGeometry(2 * KPC, 0.5 * KPC), mix2,
                                   OpticalDepthNormalization(
                                       "z", wg.lambdav[0], 0.5)))
    dsys = DustSystem(grid, comps, samples_per_cell=4,
                      density_mode="analytic")
    instruments = [
        SEDInstrument("sed", 3.08e23, nlambda, inclination=1.0),
        SimpleInstrument("img", 3.08e23, nlambda, 16, 16,
                         fov_x=24 * KPC, fov_y=24 * KPC,
                         inclination=np.pi / 2),
    ][:n_instruments]
    opts = LifecycleOptions(store_absorption=store_absorption,
                            min_weight_reduction=min_weight_reduction,
                            max_scatt_events=max_scatt,
                            deposition="sampled",
                            quadrature_panels=quadrature_panels,
                            refill_batches=refill_batches,
                            peel_panels=peel_panels, fused=True,
                            polychromatic=polychromatic)
    return grid, dsys, ss, instruments, opts


def _build(nlambda=2, ncells=16, packets=1024, refill_batches=0,
           polychromatic=True, device="cpu", **model_kw):
    """`_model` with its lifecycle built: (run_batch, zero_tallies, ell,
    L0) for `packets` lanes, polychromatic (every lane carries all
    nlambda wavelengths) or one wavelength per lane (ell = lane % W)."""
    import torch

    from skirt_tpu_torch.engine.lifecycle import make_lifecycle

    grid, dsys, ss, instruments, opts = _model(
        nlambda=nlambda, ncells=ncells, refill_batches=refill_batches,
        polychromatic=polychromatic, **model_kw)
    store_absorption = opts.store_absorption
    run_batch = make_lifecycle(grid, dsys, ss, instruments, opts, nlambda)

    def zero_tallies():
        t = {"instruments": [ins.zero_tallies(device) for ins in instruments]}
        if store_absorption:
            t["labs"] = torch.zeros((grid.ncells * nlambda,),
                                    dtype=torch.float32, device=device)
        return t

    total = packets * max(refill_batches, 1)
    if polychromatic:
        # every lane carries all nlambda wavelengths: `packets` counts
        # lanes; photon packets = packets * K * nlambda
        ell = torch.zeros((packets,), dtype=torch.int32, device=device)
        L0 = torch.full((packets, nlambda), 1e36 / total,
                        dtype=torch.float32, device=device)
        return run_batch, zero_tallies, ell, L0
    ell = torch.arange(packets, dtype=torch.int32, device=device) % nlambda
    L0 = torch.full((packets,), 1e36 / total, dtype=torch.float32,
                    device=device)
    return run_batch, zero_tallies, ell, L0


def _octree_model(nlambda=2, polychromatic=True, refill_batches=None,
                  quadrature_panels=16, peel_panels=32, table_peel="exact",
                  store_absorption=True, max_level=5, tau=5.0, grid=None,
                  voxelize=True):
    """experiments/bench_octree.py's config-3 model on the port: (grid,
    table dust system, stellar system, instruments, options, host), where
    host holds the seconds of the host build: "octree", "gridding",
    "voxelize".  `grid` reuses an octree built earlier (the same torus).
    voxelize=False returns the octree and its gridded (leaf-resolution)
    dust system instead, for OligoSimulation(voxelize="table")."""
    import time

    from skirt_tpu_torch.constants import KPC
    from skirt_tpu_torch.engine.lifecycle import LifecycleOptions
    from skirt_tpu_torch.geometry import PointGeometry, TorusGeometry
    from skirt_tpu_torch.grids import OctreeGrid
    from skirt_tpu_torch.instruments import SEDInstrument
    from skirt_tpu_torch.media import (DustComponent, DustSystem,
                                       OpticalDepthNormalization,
                                       SimpleOligoDustMix)
    from skirt_tpu_torch.sources import (LuminosityStellarComponent,
                                         StellarSystem)
    from skirt_tpu_torch.wavelengths import OligoWavelengthGrid

    lams = np.geomspace(0.55e-6, 2.2e-6, nlambda)
    fpl = np.log(lams / 0.55e-6) / np.log(2.2 / 0.55)
    wg = OligoWavelengthGrid(list(lams))
    ss = StellarSystem([LuminosityStellarComponent(PointGeometry(), wg,
                                                   [1e36] * nlambda)])
    torus = TorusGeometry(1.0, 2.0, 0.7, 0.05 * KPC, 2 * KPC)
    half = 2.2 * KPC
    host = {}
    t0 = time.perf_counter()
    if grid is None:
        grid = OctreeGrid((-half, -half, -half, half, half, half),
                          torus.density, min_level=2, max_level=max_level)
    host["octree"] = time.perf_counter() - t0
    mix = SimpleOligoDustMix(wg, list(2600.0 * (600.0 / 2600.0) ** fpl),
                             list(0.5 + (0.4 - 0.5) * fpl),
                             list(0.4 + (0.2 - 0.4) * fpl))
    comp = DustComponent(torus, mix,
                         OpticalDepthNormalization("x", wg.lambdav[0], tau))
    t0 = time.perf_counter()
    dsys = DustSystem(grid, [comp], samples_per_cell=8)
    host["gridding"] = time.perf_counter() - t0
    if voxelize:
        t0 = time.perf_counter()
        vds, _ = dsys.voxelized()
        dsys = vds.as_table()
        host["voxelize"] = time.perf_counter() - t0
    if refill_batches is None:
        refill_batches = 256 if polychromatic else 128
    ins = [SEDInstrument("sed", 3.08e23, nlambda, inclination=1.2)]
    opts = LifecycleOptions(store_absorption=store_absorption,
                            max_scatt_events=64, polychromatic=polychromatic,
                            deposition="sampled",
                            quadrature_panels=quadrature_panels,
                            peel_panels=peel_panels, table_peel=table_peel,
                            refill_batches=refill_batches, fused=True,
                            voxelize=None if voxelize else "table")
    return dsys.grid, dsys, ss, ins, opts, host


def _multi_model(polychromatic=True, refill_batches=128, max_level=4,
                 grid=None, voxelize=True, nlambda=2):
    """The two-component model of tests/test_fused_table.py's
    TestMultiComponentFused (measured at BASELINE.md:288-306) on the port:
    (grid, table dust system, stellar system, instruments, options, host).
    A point source at 0.55 and 2.2 um; the AGN torus (TorusGeometry 1.0,
    2.0, 0.7, 0.05-2 kpc; kappa_ext 2600 / 600, albedo 0.5 / 0.4, g 0.5 /
    0.3; tau_x = 2 at 0.55 um) and a uniform sphere of 1.8 kpc (kappa_ext
    1800 / 900, albedo 0.7 / 0.6, g 0.1 / 0.0, by dust mass) on an octree
    over +-2.2 kpc (min_level 2, max_level 4) gridded with 8 samples per
    leaf and traced through its exact 16^3 voxel view in table mode; one
    SED instrument at 3.08e23 m, inclination 1.2, azimuth 0.7; labs on,
    24 propagation panels, the exact peel, max_scatt_events 48.  `grid`
    reuses an octree built earlier; voxelize=False returns the octree and
    its gridded dust system, for OligoSimulation(voxelize="table").
    nlambda > 2 spreads log-spaced wavelengths from 0.55 to 2.2 um with
    each mix's optics interpolated in log lambda between the two
    (kappa_ext geometrically, albedo and g linearly; the ends exact)."""
    import time

    from skirt_tpu_torch.constants import KPC
    from skirt_tpu_torch.engine.lifecycle import LifecycleOptions
    from skirt_tpu_torch.geometry import (PointGeometry, TorusGeometry,
                                          UniformSphereGeometry)
    from skirt_tpu_torch.grids import OctreeGrid
    from skirt_tpu_torch.instruments import SEDInstrument
    from skirt_tpu_torch.media import (DustComponent, DustMassNormalization,
                                       DustSystem, OpticalDepthNormalization,
                                       SimpleOligoDustMix)
    from skirt_tpu_torch.sources import (LuminosityStellarComponent,
                                         StellarSystem)
    from skirt_tpu_torch.wavelengths import OligoWavelengthGrid

    lams = np.geomspace(0.55e-6, 2.2e-6, nlambda)
    f = np.log(lams / 0.55e-6) / np.log(4.0)

    def optics(a, b, geometric=False):
        mid = [a * (b / a) ** x if geometric else a + (b - a) * x for x in f]
        return [a] + mid[1:-1] + [b]

    wg = OligoWavelengthGrid(list(lams))
    ss = StellarSystem([LuminosityStellarComponent(PointGeometry(), wg,
                                                   [1e36] * nlambda)])
    torus = TorusGeometry(1.0, 2.0, 0.7, 0.05 * KPC, 2 * KPC)
    sphere = UniformSphereGeometry(1.8 * KPC)
    half = 2.2 * KPC
    host = {}
    t0 = time.perf_counter()
    if grid is None:
        grid = OctreeGrid((-half, -half, -half, half, half, half),
                          lambda pos: torus.density(pos) + sphere.density(pos),
                          min_level=2, max_level=max_level)
    host["octree"] = time.perf_counter() - t0
    mix1 = SimpleOligoDustMix(wg, optics(2600.0, 600.0, True),
                              optics(0.5, 0.4), optics(0.5, 0.3))
    mix2 = SimpleOligoDustMix(wg, optics(1800.0, 900.0, True),
                              optics(0.7, 0.6), optics(0.1, 0.0))
    vol = 4 / 3 * np.pi * (1.8 * KPC) ** 3
    comps = [DustComponent(torus, mix1,
                           OpticalDepthNormalization("x", 0.55e-6, 2.0)),
             DustComponent(sphere, mix2, DustMassNormalization(
                 1.0 / 1800.0 * vol / (1.8 * KPC)))]
    t0 = time.perf_counter()
    dsys = DustSystem(grid, comps, samples_per_cell=8)
    host["gridding"] = time.perf_counter() - t0
    if voxelize:
        t0 = time.perf_counter()
        dsys = dsys.voxelized()[0].as_table()
        host["voxelize"] = time.perf_counter() - t0
    ins = [SEDInstrument("sed", 3.08e23, nlambda, inclination=1.2,
                         azimuth=0.7)]
    opts = LifecycleOptions(store_absorption=True, max_scatt_events=48,
                            deposition="sampled", quadrature_panels=24,
                            peel_panels=8, table_peel="exact", fused=True,
                            polychromatic=polychromatic,
                            refill_batches=refill_batches,
                            voxelize=None if voxelize else "table")
    return dsys.grid, dsys, ss, ins, opts, host


def _voronoi_model(nsites=4096, nlambda=2, polychromatic=True, direct=False,
                   refill_batches=None, quadrature_panels=16, peel_panels=32,
                   table_peel="exact", res=47, grid=None, clumpy=False,
                   voxelize=True, site_seed=3,
                   volume_samples=32, azimuth=0.0, max_scatt=64):
    """experiments/bench_voronoi.py's config-4 model in table mode on the
    port (module docstring): (grid, table dust system, stellar system,
    instruments, options, host).  host holds the seconds of the host build
    ("voronoi", "locate_tables", "gridding" and, for the voxel view,
    "voxelize"), the "locate" scheme with its table bytes and the voxel
    view's "field_error".  direct=True keeps the exact tessellation (the
    direct table); `grid` reuses a tessellation built earlier; clumpy=True
    multiplies the density of a random 3% of the cells by 1e3 (tests/
    test_voronoi.py's clumpy import); voxelize=False returns the
    tessellation's gridded system with options.voxelize="table", for
    OligoSimulation, which makes the choice itself.  site_seed=11,
    volume_samples=16, azimuth=0.7, max_scatt=48 with 300 sites and
    table_peel="staged" give tests/test_poly.py's TestPolyDirect model."""
    import time

    from skirt_tpu_torch.constants import KPC
    from skirt_tpu_torch.engine.lifecycle import LifecycleOptions
    from skirt_tpu_torch.geometry import PointGeometry, UniformSphereGeometry
    from skirt_tpu_torch.grids import VoronoiGrid
    from skirt_tpu_torch.instruments import SEDInstrument
    from skirt_tpu_torch.media import (DustComponent, DustMassNormalization,
                                       DustSystem, SimpleOligoDustMix)
    from skirt_tpu_torch.sources import (LuminosityStellarComponent,
                                         StellarSystem)
    from skirt_tpu_torch.wavelengths import OligoWavelengthGrid

    half = 2.0 * KPC
    host = {}
    t0 = time.perf_counter()
    if grid is None:
        sites = np.random.default_rng(site_seed).uniform(
            -0.98 * half, 0.98 * half, size=(nsites, 3))
        grid = VoronoiGrid(sites, (-half, -half, -half, half, half, half),
                           volume_samples=volume_samples)
    host["voronoi"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host["locate"] = grid.locate_scheme()
    host["locate_tables"] = time.perf_counter() - t0
    lams = np.geomspace(0.55e-6, 2.2e-6, nlambda)
    f = np.log(lams / 0.55e-6) / np.log(2.2 / 0.55)
    wg = OligoWavelengthGrid(list(lams))
    ss = StellarSystem([LuminosityStellarComponent(PointGeometry(), wg,
                                                   [1e36] * nlambda)])
    mix = SimpleOligoDustMix(wg, list(2600.0 * (600.0 / 2600.0) ** f),
                             list(0.5 + (0.4 - 0.5) * f),
                             list(0.4 + (0.2 - 0.4) * f))
    mass = 2.0 / 2600.0 * (4 / 3 * np.pi * (1.8 * KPC) ** 3) / (1.8 * KPC)
    comp = DustComponent(UniformSphereGeometry(1.8 * KPC), mix,
                         DustMassNormalization(mass))
    t0 = time.perf_counter()
    dsys = DustSystem(grid, [comp], density_mode="gridded")
    if clumpy:
        hot = np.random.default_rng(3).random(grid.ncells) < 0.03
        dsys.rho64[:, hot] *= 1e3
        dsys.rho = np.asarray(dsys.rho64, np.float32)
    host["gridding"] = time.perf_counter() - t0
    if voxelize and not direct:
        t0 = time.perf_counter()
        dsys = dsys.voxelized(max_voxels=res ** 3 if res else 1 << 24)[0]
        host["voxelize"] = time.perf_counter() - t0
        host["field_error"] = dsys.voxelization_error
    if voxelize:
        dsys = dsys.as_table()
    if refill_batches is None:
        refill_batches = 32 if direct else 256 if polychromatic else 128
    ins = [SEDInstrument("sed", 3.08e23, nlambda, inclination=1.2,
                         azimuth=azimuth)]
    opts = LifecycleOptions(store_absorption=True,
                            max_scatt_events=max_scatt,
                            polychromatic=polychromatic, deposition="sampled",
                            quadrature_panels=quadrature_panels,
                            peel_panels=peel_panels, table_peel=table_peel,
                            refill_batches=refill_batches, fused=True,
                            voxelize=None if voxelize else "table")
    return dsys.grid, dsys, ss, ins, opts, host


def _polarized_model(table=False, poly=False, nlambda=2, refill_batches=64,
                     peel_panels=8, azimuth=None, electron=False, grid=None,
                     voxelize=True):
    """experiments/bench_polarized.py's polarized chains on the port:
    (grid, dust system, stellar system, instruments, options, host).

    Default (table=False): the mono analytic flagship, an ExpDisk stellar
    disc in an ExpDisk dust disc (tau_z = 1) on a 32x32x16 grid, 32
    panels (kernel K3).  table=True: the config-3 torus (a point source,
    TorusGeometry on an octree over +-2.2 kpc, levels 2-5, tau_x = 5)
    through its exact 32^3 voxel view in table mode, 16 panels, mono (K4)
    or with poly=True W = nlambda per lane (K6p).  Both: nlambda
    log-spaced wavelengths 0.55-2.2 um with power-law optics, the Thomson
    Mueller matrix, a polarized FullInstrument (16x16 over 26 kpc) and an
    SED instrument at inclination 1.2 and the azimuth (0.7 on the table,
    off the lattice planes; 0 on the disc), the exact peel, peel_panels
    panels toward the observer, max_scatt_events 64, no labs, refill
    refill_batches.  The Mueller tables (thomson_mueller, as the bench
    passes them, or an ElectronDustMix's own) are host["mueller"].
    electron=True replaces the dust by an ElectronDustMix (grey Thomson
    scattering, tau_x = 1 on the torus), whose own Mueller
    tables OligoSimulation picks up; voxelize=False keeps the octree's
    gridded system with options.voxelize="table" for OligoSimulation.
    `grid` reuses an octree built earlier."""
    import time

    from skirt_tpu_torch.constants import KPC
    from skirt_tpu_torch.engine.lifecycle import LifecycleOptions
    from skirt_tpu_torch.geometry import (ExpDiskGeometry, PointGeometry,
                                          TorusGeometry)
    from skirt_tpu_torch.grids import CartesianGrid, OctreeGrid
    from skirt_tpu_torch.instruments import FullInstrument, SEDInstrument
    from skirt_tpu_torch.media import (DustComponent, DustSystem,
                                       ElectronDustMix,
                                       OpticalDepthNormalization,
                                       SimpleOligoDustMix)
    from skirt_tpu_torch.media.polarization import thomson_mueller
    from skirt_tpu_torch.sources import (LuminosityStellarComponent,
                                         StellarSystem)
    from skirt_tpu_torch.wavelengths import OligoWavelengthGrid

    lams = np.geomspace(0.55e-6, 2.2e-6, nlambda)
    fpl = np.log(lams / 0.55e-6) / np.log(2.2 / 0.55)
    wg = OligoWavelengthGrid(list(lams))
    if electron:
        mix = ElectronDustMix(wg)
    else:
        mix = SimpleOligoDustMix(wg, list(2600.0 * (600.0 / 2600.0) ** fpl),
                                 list(0.5 + (0.4 - 0.5) * fpl),
                                 list(0.4 + (0.2 - 0.4) * fpl))
    host = {"mueller": (mix.mueller if mix.mueller is not None
                        else thomson_mueller(nlambda))}
    t0 = time.perf_counter()
    if table:
        torus = TorusGeometry(1.0, 2.0, 0.7, 0.05 * KPC, 2 * KPC)
        half = 2.2 * KPC
        if grid is None:
            grid = OctreeGrid((-half, -half, -half, half, half, half),
                              torus.density, min_level=2, max_level=5)
        ss = StellarSystem([LuminosityStellarComponent(
            PointGeometry(), wg, [1e36] * nlambda)])
        comp = DustComponent(torus, mix, OpticalDepthNormalization(
            "x", wg.lambdav[0], 1.0 if electron else 5.0))
        dsys = DustSystem(grid, [comp], samples_per_cell=8)
        if voxelize:
            dsys = dsys.voxelized()[0].as_table()
    else:
        ss = StellarSystem([LuminosityStellarComponent(
            ExpDiskGeometry(4 * KPC, 0.35 * KPC), wg, [1e36] * nlambda)])
        b = np.linspace(-12 * KPC, 12 * KPC, 33)
        bz = np.linspace(-2 * KPC, 2 * KPC, 17)
        comp = DustComponent(ExpDiskGeometry(4 * KPC, 0.2 * KPC), mix,
                             OpticalDepthNormalization("z", wg.lambdav[0],
                                                       1.0))
        dsys = DustSystem(CartesianGrid(b, b, bz), [comp],
                          density_mode="analytic")
    host["build"] = time.perf_counter() - t0
    az = azimuth if azimuth is not None else (0.7 if table else 0.0)
    ins = [FullInstrument("pol", 3.08e23, nlambda, 16, 16, fov_x=26 * KPC,
                          fov_y=26 * KPC, inclination=1.2, azimuth=az,
                          polarization=True),
           SEDInstrument("sed", 3.08e23, nlambda, inclination=1.2,
                         azimuth=az)]
    opts = LifecycleOptions(max_scatt_events=64, deposition="sampled",
                            quadrature_panels=16 if table else 32,
                            peel_panels=peel_panels, table_peel="exact",
                            polychromatic=poly and table, fused=True,
                            refill_batches=refill_batches,
                            voxelize=None if voxelize else "table")
    return dsys.grid, dsys, ss, ins, opts, host


def _polarized_build(lanes, device="cpu", **model_kw):
    """`_polarized_model` with its lifecycle built, as
    experiments/bench_polarized.py builds it: (run_batch, zero_tallies,
    ell, L0, packets per call, model); mono lanes take ell = lane % W."""
    import torch

    from skirt_tpu_torch.engine.lifecycle import make_lifecycle

    model = _polarized_model(**model_kw)
    grid, ds, ss, ins, opts, host = model
    nlam = ss.wavelength_grid.nlambda
    K = max(opts.refill_batches, 1)
    run_batch = make_lifecycle(grid, ds, ss, ins, opts, nlam,
                               mueller=host["mueller"])

    def zero_tallies():
        return {"instruments": [i.zero_tallies(device) for i in ins]}

    if opts.polychromatic:
        packets = lanes * K * nlam
        ell = torch.zeros((lanes,), dtype=torch.int32, device=device)
        L0 = torch.full((lanes, nlam), 1e36 / (lanes * K),
                        dtype=torch.float32, device=device)
    else:
        packets = lanes * K
        ell = torch.arange(lanes, dtype=torch.int32, device=device) % nlam
        L0 = torch.full((lanes,), 1e36 / packets, dtype=torch.float32,
                        device=device)
    return run_batch, zero_tallies, ell, L0, packets, model


def _octree_build(lanes, device="cpu", multi=False, voronoi=False,
                  **model_kw):
    """`_octree_model` (or with multi=True `_multi_model`, with voronoi=True
    `_voronoi_model`) with its lifecycle built: (run_batch, zero_tallies,
    ell, L0, packets per call, model) for `lanes` lanes at
    bench_octree.py's launch luminosities."""
    import torch

    from skirt_tpu_torch.engine.lifecycle import make_lifecycle

    model = (_voronoi_model if voronoi else _multi_model if multi
             else _octree_model)(**model_kw)
    grid, tds, ss, ins, opts, _ = model
    nlam = ss.wavelength_grid.nlambda
    K = max(opts.refill_batches, 1)
    run_batch = make_lifecycle(grid, tds, ss, ins, opts, nlam)

    def zero_tallies():
        t = {"instruments": [i.zero_tallies(device) for i in ins]}
        if opts.store_absorption:
            t["labs"] = torch.zeros((grid.ncells * nlam,),
                                    dtype=torch.float32, device=device)
        return t

    if opts.polychromatic:
        packets = lanes * K * nlam
        ell = torch.zeros((lanes,), dtype=torch.int32, device=device)
        L0 = torch.full((lanes, nlam), 1e36 / (lanes * K),
                        dtype=torch.float32, device=device)
    else:
        packets = lanes * K
        ell = torch.arange(lanes, dtype=torch.int32, device=device) % nlam
        L0 = torch.full((lanes,), 1e36 / packets, dtype=torch.float32,
                        device=device)
    return run_batch, zero_tallies, ell, L0, packets, model


def _voronoi_knobs():
    """experiments/bench_voronoi.py's VORONOI_* knobs with its defaults:
    (polychromatic, lanes, _voronoi_model keywords)."""
    env = os.environ.get
    direct = env("VORONOI_DIRECT", "0") == "1"
    poly = env("VORONOI_POLY", "1") == "1"
    lanes = 1 << int(env("VORONOI_LOG2N", "16" if direct else "17"))
    kw = dict(nsites=int(env("VORONOI_SITES", "4096")), direct=direct,
              nlambda=int(env("VORONOI_NLAM", "2")),
              refill_batches=int(env("VORONOI_REFILL", "32" if direct else
                                     "256" if poly else "128")),
              quadrature_panels=int(env("VORONOI_PANELS", "16")),
              peel_panels=int(env("VORONOI_PEELP", "32")),
              table_peel=env("VORONOI_PEELMODE", "exact"),
              res=int(env("VORONOI_RES", "47")))
    return poly, lanes, kw


def _octree_main(name="octree"):
    """BENCH_MODEL=octree: config 3 with experiments/bench_octree.py's
    OCTREE_* knobs; BENCH_MODEL=multi: the two-component model with
    OCTREE_POLY, OCTREE_LOG2N and OCTREE_REFILL; BENCH_MODEL=voronoi:
    config 4 with bench_voronoi.py's VORONOI_* knobs (module docstring)."""
    import torch

    from skirt_tpu_torch import rng

    env = os.environ.get
    multi = name == "multi"
    poly = env("OCTREE_POLY", "1") == "1"
    lanes = 1 << int(env("OCTREE_LOG2N", "17"))
    if name == "voronoi":
        poly, lanes, kw = _voronoi_knobs()
        kw["voronoi"] = True
    elif multi:
        kw = dict(refill_batches=int(env("OCTREE_REFILL", "128")))
    else:
        kw = dict(nlambda=int(env("OCTREE_NLAM", "2")),
                  refill_batches=int(env("OCTREE_REFILL",
                                         "256" if poly else "128")),
                  quadrature_panels=int(env("OCTREE_PANELS", "16")),
                  peel_panels=int(env("OCTREE_PEELP", "32")),
                  table_peel=env("OCTREE_PEELMODE", "exact"),
                  store_absorption=env("OCTREE_ABS", "1") == "1")
    run_batch, zero_tallies, ell, L0, packets, model = _octree_build(
        lanes, device="cuda", multi=multi, polychromatic=poly, **kw)
    grid, tds, *_, host = model
    if hasattr(grid, "nx"):
        view = {"voxels": [grid.nx, grid.ny, grid.nz]}
    else:
        view = {"direct_cells": grid.ncells}
    print(json.dumps({"host_build_s": host, **view}), flush=True)
    key = rng.root_key(4357)
    run_batch(key, ell, L0, zero_tallies())             # warm-up + build
    torch.cuda.synchronize()
    best_dt = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        out = run_batch(rng.fold_in(key, 1 + rep), ell, L0, zero_tallies())
        torch.cuda.synchronize()
        best_dt = min(best_dt, time.perf_counter() - t0)
        assert np.isfinite(float(out["instruments"][0]["Ftot"].sum()))
    pps = packets / best_dt
    print(json.dumps({
        "metric": "photon_packets_per_second_per_chip",
        "value": round(pps, 1),
        "unit": "packets/s",
        "vs_baseline": round(pps / 1.6e6, 4),
        "device": torch.cuda.get_device_name(0),
    }))


def _polarized_knobs():
    """experiments/bench_polarized.py's POL_* knobs with its defaults:
    (lanes, _polarized_model keywords).  POL_FUSED=0 (the vector path)
    belongs to slice S5b."""
    env = os.environ.get
    if env("POL_FUSED", "1") != "1":
        raise SystemExit("bench_torch: POL_FUSED=0 (the polarized vector "
                         "path) is not ported yet (slice S5b)")
    table = env("POL_TABLE", "0") == "1"
    kw = dict(table=table, poly=env("POL_POLY", "0") == "1" and table,
              nlambda=int(env("POL_NLAM", "2")),
              refill_batches=int(env("POL_REFILL", "64")),
              peel_panels=int(env("POL_PEELP", "8")))
    if "POL_AZ" in os.environ:
        kw["azimuth"] = float(env("POL_AZ"))
    return 1 << int(env("POL_LOG2N", "17")), kw


def _polarized_main():
    """BENCH_MODEL=polarized: experiments/bench_polarized.py's chains with
    its POL_* knobs (module docstring); timed as bench_polarized.py times
    them: a warm-up call, then the best of 3 calls."""
    import torch

    from skirt_tpu_torch import rng

    lanes, kw = _polarized_knobs()
    run_batch, zero_tallies, ell, L0, packets, model = _polarized_build(
        lanes, device="cuda", **kw)
    print(json.dumps({"host_build_s": model[5]["build"],
                      "chain": ("table-poly" if kw["poly"] else "table"
                                if kw["table"] else "flagship")}),
          flush=True)
    key = rng.root_key(4357)
    run_batch(key, ell, L0, zero_tallies())             # warm-up + build
    torch.cuda.synchronize()
    best_dt = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        out = run_batch(rng.fold_in(key, 1 + rep), ell, L0, zero_tallies())
        torch.cuda.synchronize()
        best_dt = min(best_dt, time.perf_counter() - t0)
        assert np.isfinite(float(out["instruments"][0]["Ftot"].sum()))
    pps = packets / best_dt
    print(json.dumps({
        "metric": "photon_packets_per_second_per_chip",
        "value": round(pps, 1),
        "unit": "packets/s",
        "vs_baseline": round(pps / 1.6e6, 4),
        "device": torch.cuda.get_device_name(0),
    }))


def main():
    import torch

    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine.lifecycle import make_multibatch

    if not torch.cuda.is_available():
        raise SystemExit("bench_torch: no CUDA device")
    bench_model = os.environ.get("BENCH_MODEL", "disc")
    if bench_model in ("octree", "multi", "voronoi"):
        return _octree_main(bench_model)
    if bench_model == "polarized":
        return _polarized_main()
    packets = 1 << int(os.environ.get("BENCH_LOG2_PACKETS", "15"))
    refill = int(os.environ.get("BENCH_REFILL", "128"))
    nlambda = int(os.environ.get("BENCH_NLAMBDA", "128"))
    poly = os.environ.get("BENCH_POLY", "1") == "1"
    run_batch, zero_tallies, ell, L0 = _build(
        nlambda=nlambda,
        ncells=int(os.environ.get("BENCH_NCELLS", "32")),
        packets=packets,
        n_instruments=int(os.environ.get("BENCH_NINSTR", "2")),
        store_absorption=os.environ.get("BENCH_ABS", "1") == "1",
        max_scatt=int(os.environ.get("BENCH_MAXSCATT", "64")),
        quadrature_panels=int(os.environ.get("BENCH_PANELS", "32")),
        refill_batches=refill,
        peel_panels=int(os.environ.get("BENCH_PEEL_PANELS", "8")) or None,
        polychromatic=poly, device="cuda")
    nbatches = int(os.environ.get("BENCH_DISPATCH_BATCHES", "2"))
    run_many = make_multibatch(run_batch, nbatches)
    key = rng.root_key(4357)

    out = run_many(key, ell, L0, zero_tallies())       # warm-up + build
    torch.cuda.synchronize()
    nrep = 3
    best_dt = float("inf")
    for block in range(3):
        t0 = time.perf_counter()
        for i in range(nrep):
            out = run_many(rng.fold_in(key, block * nrep + i), ell, L0,
                           zero_tallies())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        total = float(out["instruments"][0]["Ftot"].sum())
        assert np.isfinite(total)
        best_dt = min(best_dt, dt)

    poly_w = nlambda if poly else 1
    pps = packets * max(refill, 1) * nbatches * nrep * poly_w / best_dt
    baseline = 1.6e6
    print(json.dumps({
        "metric": "photon_packets_per_second_per_chip",
        "value": round(pps, 1),
        "unit": "packets/s",
        "vs_baseline": round(pps / baseline, 4),
        "device": torch.cuda.get_device_name(0),
    }))


if __name__ == "__main__":
    main()
