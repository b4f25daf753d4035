"""Carry a skirt_tpu model across to skirt_tpu_torch.

`from_skirt_tpu` reads the NumPy state of the JAX package's objects by
duck typing (class names and attributes; it never imports jax) and builds
the port's objects from it; `convert_simulation` does the same for an
OligoSimulation and its settings.  The discretised densities travel as they
are (`rho64`); everything else the port recomputes from the same
parameters in float64, so `lscale`, `_mass_over_L3`, the event kernel's
optical constants and the instrument frames come out identical.  An
octree travels as its frozen host tree (node boxes, levels, children), so
its leaves, cell numbers and voxel view are the JAX grid's.  A Voronoi
grid travels as its host tables (sites, volumes, centroids, neighbours,
boxes, the Monte Carlo samples and owners), not rebuilt; its float32 and
device tables derive from them as skirt_tpu derives them.  The
skirt_tpu wavelength grid object is carried across as it is: it is a
JAX-free NumPy object with the attributes of the port's own grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .engine.lifecycle import LifecycleOptions
from .geometry import (ExpDiskGeometry, PointGeometry, TorusGeometry,
                       UniformSphereGeometry)
from .grids import CartesianGrid, OctreeGrid, TwoPhaseGrid, VoronoiGrid
from .instruments import (FrameInstrument, FullInstrument, SEDInstrument,
                          SimpleInstrument)
from .media import (DustComponent, DustMassNormalization, DustMix,
                    DustSystem, ElectronDustMix, OpticalDepthNormalization)
from .media.polarization import MuellerTables
from .sources import LuminosityStellarComponent, StellarSystem


def _name(obj) -> str:
    return type(obj).__name__


def convert_geometry(g):
    kind = _name(g)
    if kind == "ExpDiskGeometry":
        return ExpDiskGeometry(g.hR, g.hz, radial_trunc=g.Rmax,
                               axial_trunc=g.zmax, inner_radius=g.Rmin)
    if kind == "PointGeometry":
        return PointGeometry()
    if kind == "TorusGeometry":
        return TorusGeometry(g.p, g.q, g.delta, g.rmin, g.rmax)
    if kind == "UniformSphereGeometry":
        return UniformSphereGeometry(g.rmax)
    raise ValueError(f"geometry {kind} is not ported yet")


def convert_grid(grid):
    kind = _name(grid)
    if kind == "CartesianGrid":
        return CartesianGrid(grid.xb64, grid.yb64, grid.zb64)
    if kind == "TwoPhaseGrid":
        # the weights carried across as they are (not redrawn)
        g = TwoPhaseGrid.__new__(TwoPhaseGrid)
        CartesianGrid.__init__(g, grid.xb64, grid.yb64, grid.zb64)
        g.filling_factor = grid.filling_factor
        g.contrast = grid.contrast
        g.cell_weights = np.asarray(grid.cell_weights, np.float64)
        return g
    if kind == "OctreeGrid":
        tree = OctreeGrid.__new__(OctreeGrid)
        tree.extent = np.asarray(grid.extent, np.float64)
        tree.subdivision = grid.subdivision
        tree.voxelize_exact = grid.voxelize_exact
        tree._finalize(grid.lo64, grid.hi64, grid.levels, grid.child64)
        return tree
    if kind == "VoronoiGrid":
        return VoronoiGrid.from_tables(
            sites64=grid.sites64, extent=grid.extent,
            volumes64=grid.volumes64, centroids64=grid.centroids64,
            nbrs64=grid.nbrs64, bb_lo64=grid.bb_lo64, bb_hi64=grid.bb_hi64,
            mc_pts=grid._mc_pts, mc_owner=grid._mc_owner,
            used_native=grid.used_native)
    raise ValueError(f"grid {kind} is not ported yet")


def _convert_normalization(norm):
    kind = _name(norm)
    if kind == "OpticalDepthNormalization":
        return OpticalDepthNormalization(norm.axis, norm.wavelength, norm.tau)
    if kind == "DustMassNormalization":
        return DustMassNormalization(norm.mass)
    raise ValueError(f"normalization {kind} is not ported yet")


def convert_mueller(m):
    """A port MuellerTables with the float32 host tables of skirt_tpu's,
    copied bit for bit (not rebuilt from the float64 angles)."""
    t = MuellerTables.__new__(MuellerTables)
    for name in ("thetav64", "ntheta", "nq", "S11", "S12", "S33", "S34",
                 "thetav", "theta_cdf", "pfnorm", "theta_quantile",
                 "S_packed", "S_theta_major"):
        v = getattr(m, name)
        t.__dict__[name] = np.array(v) if isinstance(v, np.ndarray) else v
    t._dev = {}
    return t


def convert_mix(mix):
    """A port mix with the JAX mix's float64 optics, its polarization flag
    and its Mueller tables; an ElectronDustMix stays one."""
    if _name(mix) == "ElectronDustMix":
        out = ElectronDustMix(mix.wavelength_grid)
    else:
        out = DustMix(mix.wavelength_grid, mix.kappaabs64, mix.kappasca64,
                      mix.g64)
    out.polarization = bool(getattr(mix, "polarization", False))
    m = getattr(mix, "mueller", None)
    out.mueller = convert_mueller(m) if m is not None else None
    return out


def convert_dust_system(ds, grid):
    """A port DustSystem over the JAX system's discretised (Ncomp, Ncells)
    densities, in its density mode, with every component (geometry, mix,
    normalization) carried across."""
    mode = ("table" if getattr(ds, "table", False)
            else "analytic" if ds.analytic else "gridded")
    comps = []
    for c in ds.components:
        comps.append(DustComponent(convert_geometry(c.geometry),
                                   convert_mix(c.mix),
                                   _convert_normalization(c.normalization)))
    return DustSystem.from_state(grid, comps, np.asarray(ds.rho64), mode)


def convert_stellar_system(ss):
    comps = [LuminosityStellarComponent(convert_geometry(c.geometry),
                                        c.wavelength_grid, c.luminosities)
             for c in ss.components]
    return StellarSystem(comps, emission_bias=ss.emission_bias)


def convert_instrument(ins):
    kind = _name(ins)
    angles = dict(inclination=ins.inclination, azimuth=ins.azimuth,
                  position_angle=ins.position_angle)
    if kind == "SEDInstrument":
        return SEDInstrument(ins.name, ins.distance, ins.nlambda, **angles)
    frames = {"FrameInstrument": FrameInstrument,
              "SimpleInstrument": SimpleInstrument,
              "FullInstrument": FullInstrument}
    if kind not in frames:
        raise ValueError(f"instrument {kind} is not ported yet")
    kw = dict(center_x=ins.center_x, center_y=ins.center_y, **angles)
    if kind == "FullInstrument":
        kw.update(nscatt_levels=ins.nscatt_levels,
                  polarization=ins.polarization)
    return frames[kind](ins.name, ins.distance, ins.nlambda, ins.nx, ins.ny,
                        ins.fov_x, ins.fov_y, **kw)


def convert_options(options):
    return LifecycleOptions(**{f.name: getattr(options, f.name)
                               for f in dataclasses.fields(LifecycleOptions)
                               if hasattr(options, f.name)})


def from_skirt_tpu(grid, dust_system, stellar_system, instruments, options):
    """(grid, dust_system, stellar_system, instruments, options) of the
    port, built from the corresponding skirt_tpu objects."""
    g = convert_grid(grid)
    return (g, convert_dust_system(dust_system, g),
            convert_stellar_system(stellar_system),
            [convert_instrument(i) for i in instruments],
            convert_options(options))


def convert_simulation(sim, device="cuda", log=None, **overrides):
    """A port OligoSimulation with the model and settings of a skirt_tpu
    OligoSimulation: its (original, leaf-resolution) dust system, stellar
    system, instruments and lifecycle options, and packets, seed,
    batch_size, out_dir, prefix, checkpoint_every and dispatch_batches,
    on `device` (the card unless the caller says otherwise).  `overrides`
    replace any of those keywords."""
    from .engine.simulation import OligoSimulation

    ds = getattr(sim, "dust_system_out", sim.dust_system)
    grid = dsys = None
    if ds is not None:
        grid = convert_grid(ds.grid)
        dsys = convert_dust_system(ds, grid)
    kw = dict(stellar_system=convert_stellar_system(sim.stellar_system),
              instruments=[convert_instrument(i) for i in sim.instruments],
              dust_system=dsys, packets=sim.packets, seed=sim.seed,
              options=convert_options(sim.options),
              batch_size=sim.batch_size, out_dir=sim.out_dir,
              prefix=sim.prefix, checkpoint_every=sim.checkpoint_every,
              dispatch_batches=sim.dispatch_batches, log=log, device=device)
    kw.update(overrides)
    return OligoSimulation(**kw)
