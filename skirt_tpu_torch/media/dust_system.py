"""Dust system: density field over a grid + optical properties.

Twin of skirt_tpu/media/dust_system.py, analytic mode only (slice 1).
ref: SKIRTcore/DustSystem.cpp:63-192 and the normalization family.

Setup runs on the host in NumPy float64 with the same seed and sampling
as skirt_tpu, so the discretised densities are identical.  In analytic
mode the engine evaluates each component's closed-form density at panel
midpoints; the per-cell table only feeds diagnostics.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..geometry.base import Geometry
from .mix import DustMix


@dataclass
class DustMassNormalization:
    """Total dust mass in kg (ref: DustMassDustCompNormalization)."""
    mass: float

    def mass_for(self, geometry: Geometry, mix: DustMix) -> float:
        return float(self.mass)


@dataclass
class OpticalDepthNormalization:
    """Normalize to an optical depth along a coordinate axis ('x', 'y',
    'z' full axis; 'radial' half axis) at a reference wavelength [m]."""
    axis: str
    wavelength: float
    tau: float

    def mass_for(self, geometry: Geometry, mix: DustMix) -> float:
        ell = mix.wavelength_grid.nearest(self.wavelength)
        if ell < 0:
            raise ValueError("normalization wavelength outside the grid")
        kappa = float(mix.kappaext64[ell])
        if self.axis == "x":
            sigma = geometry.sigma_x()
        elif self.axis == "y":
            sigma = geometry.sigma_y()
        elif self.axis == "z":
            sigma = geometry.sigma_z()
        elif self.axis == "radial":
            sigma = 0.5 * geometry.sigma_x()
        else:
            raise ValueError(f"unknown axis '{self.axis}'")
        if sigma <= 0 or kappa <= 0:
            raise ValueError("cannot normalize: zero surface density or opacity")
        return self.tau / (sigma * kappa)


@dataclass
class DustComponent:
    """geometry (unit total mass) + mix + normalization."""
    geometry: Geometry
    mix: DustMix
    normalization: DustMassNormalization | OpticalDepthNormalization

    def mass(self) -> float:
        return self.normalization.mass_for(self.geometry, self.mix)


class DustSystem:
    """Density field of one or more dust components over a spatial grid."""

    def __init__(self, grid, components, samples_per_cell: int = 100,
                 seed: int = 8672, density_mode: str = "gridded"):
        self._setup(grid, components, density_mode)
        ncells = grid.ncells
        rho = np.zeros((self.ncomp, ncells))
        rng_np = np.random.default_rng(seed)
        cells = np.arange(ncells)
        for h, comp in enumerate(self.components):
            m = comp.mass()
            if samples_per_cell <= 1:
                rho[h] = m * np.asarray(comp.geometry.density(grid.cell_centers()))
            else:
                acc = np.zeros(ncells)
                for _ in range(samples_per_cell):
                    pos = grid.random_positions_in_cells(rng_np, cells)
                    acc += np.asarray(comp.geometry.density(pos))
                rho[h] = m * acc / samples_per_cell
        self._set_rho(rho)

    @classmethod
    def from_state(cls, grid, components, rho64,
                   density_mode: str = "analytic") -> "DustSystem":
        """A system over an already discretised (Ncomp, Ncells) kg/m^3
        density table (the model carried across from skirt_tpu)."""
        ds = cls.__new__(cls)
        ds._setup(grid, components, density_mode)
        ds._set_rho(np.asarray(rho64, np.float64))
        return ds

    def _setup(self, grid, components, density_mode):
        if not components:
            raise ValueError("need at least one dust component")
        if density_mode != "analytic":
            raise ValueError(
                f"density_mode={density_mode!r} is not ported yet: "
                "skirt_tpu_torch has analytic mode only (gridded/table "
                "modes belong to later slices)")
        self.grid = grid
        self.components = list(components)
        self.ncomp = len(self.components)
        wg = self.components[0].mix.wavelength_grid
        for c in self.components:
            if c.mix.wavelength_grid is not wg:
                raise ValueError("all mixes must share the wavelength grid")
        self.wavelength_grid = wg
        self.volumes = grid.cell_volumes()
        self.analytic = True
        self.table = False
        for c in self.components:
            if not c.geometry.supports_analytic:
                raise ValueError(
                    f"{type(c.geometry).__name__} has no analytic device "
                    "density (density_scaled)")
        box = grid.bounding_box()
        self.lscale = float(max(box[3] - box[0], box[4] - box[1],
                                box[5] - box[2]))

    def _set_rho(self, rho):
        self.rho64 = rho
        self.masses = np.array([c.mass() for c in self.components])
        self.rho = np.asarray(rho, np.float32)
        self.kappaext = np.stack([np.asarray(c.mix.kappaext, np.float32)
                                  for c in self.components])
        self.kappasca = np.stack([np.asarray(c.mix.kappasca, np.float32)
                                  for c in self.components])
        self.kappaabs = np.stack([np.asarray(c.mix.kappaabs, np.float32)
                                  for c in self.components])
        self.g = np.stack([np.asarray(c.mix.g, np.float32)
                           for c in self.components])
        # m_h / L^3: converts density_scaled output (rho_unit * L^3) to
        # kg/m^3 (float64 host product; ~1e-26, float32-safe)
        self._mass_over_L3 = np.asarray(self.masses / self.lscale ** 3,
                                        np.float32)

    # -- diagnostics (host) -----------------------------------------------

    def gridded_mass(self) -> float:
        return float((self.rho64.sum(axis=0) * self.volumes).sum())

    # -- device side --------------------------------------------------------

    def analytic_rows(self, pos, direction, mid, ksca_pk, kext_pk,
                      want_sca=True):
        """Per-segment (kappasca*rho, kappaext*rho) from the analytic
        densities at segment midpoints.  pos, direction (N, 3) SI; mid
        (N, S) midpoint ray parameters; ksca_pk/kext_pk: per-component
        (N,) opacities.  Returns (N, S) rows."""
        invL = float(np.float32(1.0 / self.lscale))
        pos_s = pos * invL
        pmid_s = pos_s[:, None, :] + (mid * invL)[..., None] \
            * direction[:, None, :]
        mL3 = torch.as_tensor(self._mass_over_L3, device=pos.device)
        ksca = 0.0
        kext = 0.0
        for h, comp in enumerate(self.components):
            rho_h = mL3[h] * comp.geometry.density_scaled(pmid_s, self.lscale)
            if want_sca:
                ksca = ksca + ksca_pk[h][:, None] * rho_h
            kext = kext + kext_pk[h][:, None] * rho_h
        if not want_sca:
            return kext
        return ksca, kext
