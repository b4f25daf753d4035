"""Carry a skirt_tpu model across to skirt_tpu_torch.

`from_skirt_tpu` reads the NumPy state of the JAX package's objects by
duck typing (class names and attributes; it never imports jax) and builds
the port's objects from it.  The discretised densities travel as they
are (`rho64`); everything else the port recomputes from the same
parameters in float64, so `lscale`, `_mass_over_L3`, the event kernel's
optical constants and the instrument frames come out identical.  The
skirt_tpu wavelength grid object is carried across as it is: it is a
JAX-free NumPy object with the attributes of the port's own grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .engine.lifecycle import LifecycleOptions
from .geometry import ExpDiskGeometry, PointGeometry
from .grids import CartesianGrid
from .instruments import FrameInstrument, SEDInstrument, SimpleInstrument
from .media import (DustComponent, DustMassNormalization, DustMix,
                    DustSystem, OpticalDepthNormalization)
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
    raise ValueError(f"geometry {kind} is not ported yet")


def convert_grid(grid):
    if _name(grid) != "CartesianGrid":
        raise ValueError(f"grid {_name(grid)} is not ported yet")
    return CartesianGrid(grid.xb64, grid.yb64, grid.zb64)


def _convert_normalization(norm):
    kind = _name(norm)
    if kind == "OpticalDepthNormalization":
        return OpticalDepthNormalization(norm.axis, norm.wavelength, norm.tau)
    if kind == "DustMassNormalization":
        return DustMassNormalization(norm.mass)
    raise ValueError(f"normalization {kind} is not ported yet")


def convert_dust_system(ds, grid):
    """A port DustSystem over the JAX system's discretised densities."""
    if not getattr(ds, "analytic", False) or getattr(ds, "table", False):
        raise ValueError("only analytic-mode dust systems are ported")
    comps = []
    for c in ds.components:
        mix = DustMix(c.mix.wavelength_grid, c.mix.kappaabs64,
                      c.mix.kappasca64, c.mix.g64)
        comps.append(DustComponent(convert_geometry(c.geometry), mix,
                                   _convert_normalization(c.normalization)))
    return DustSystem.from_state(grid, comps, np.asarray(ds.rho64))


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
    if kind in ("FrameInstrument", "SimpleInstrument"):
        cls = SimpleInstrument if kind == "SimpleInstrument" else FrameInstrument
        return cls(ins.name, ins.distance, ins.nlambda, ins.nx, ins.ny,
                   ins.fov_x, ins.fov_y, center_x=ins.center_x,
                   center_y=ins.center_y, **angles)
    raise ValueError(f"instrument {kind} is not ported yet")


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
