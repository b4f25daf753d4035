"""Dust system: density field over a grid + optical properties.

Twin of skirt_tpu/media/dust_system.py: the components, the
normalizations, the MC gridding of the densities, analytic mode (slice
1), the gridded and table modes with the exact voxel view of tree grids
(slice S4a), and the approximate voxel view of Voronoi grids with its
measured field error (slice S4b-2).
ref: SKIRTcore/DustSystem.cpp:63-192 and the normalization family.

Setup runs on the host in NumPy float64 with the same seed and sampling
as skirt_tpu, so the discretised densities are identical.  In analytic
mode the engine evaluates each component's closed-form density at panel
midpoints; in table mode it gathers the gridded per-cell densities at the
panel midpoints of a uniform Cartesian (voxel) grid.  Gridded mode (the
per-crossing walk of the unfused lifecycle, slice S2b) is a host-side
state here: the port's engines refuse it, but it voxelizes and converts
to table mode.
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
            if hasattr(grid, "sample_cell_densities"):
                # unstructured grids give a one-pass stratified estimate
                rho[h] = m * grid.sample_cell_densities(comp.geometry.density)
            elif samples_per_cell <= 1:
                rho[h] = m * np.asarray(comp.geometry.density(grid.cell_centers()))
            else:
                acc = np.zeros(ncells)
                for _ in range(samples_per_cell):
                    pos = grid.random_positions_in_cells(rng_np, cells)
                    acc += np.asarray(comp.geometry.density(pos))
                rho[h] = m * acc / samples_per_cell
        # two-phase (clumpy) media scale each cell's density by the grid's
        # random phase weight (ref: DustSystem.cpp:159-170)
        w = getattr(grid, "cell_weights", None)
        if w is not None:
            rho *= np.asarray(w)[None, :]
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
        if density_mode not in ("gridded", "analytic", "table"):
            raise ValueError(
                "density_mode must be 'gridded', 'analytic' or 'table'")
        self.grid = grid
        self.components = list(components)
        self.ncomp = len(self.components)
        wg = self.components[0].mix.wavelength_grid
        for c in self.components:
            if c.mix.wavelength_grid is not wg:
                raise ValueError("all mixes must share the wavelength grid")
        self.wavelength_grid = wg
        self.volumes = grid.cell_volumes()
        self.analytic = density_mode in ("analytic", "table")
        self.table = density_mode == "table"
        if self.table:
            self._check_table_grid(grid)
        if self.analytic and not self.table:
            for c in self.components:
                if not c.geometry.supports_analytic:
                    raise ValueError(
                        f"{type(c.geometry).__name__} has no analytic "
                        "device density (density_scaled); use "
                        "density_mode='gridded'")
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
        self._kappas_dev = {}
        self._rho_dev = {}

    @staticmethod
    def _check_table_grid(grid):
        if not (hasattr(grid, "ray_span") and hasattr(grid, "locate_batched")):
            raise ValueError(
                f"density_mode='table' needs a grid with ray_span + "
                f"locate_batched (a Cartesian, voxelized or Voronoi grid); "
                f"the device "
                f"walk of {type(grid).__name__} is not ported yet (slice S2b)")

    def as_table(self) -> "DustSystem":
        """Copy of this system in 'table' mode: the panel quadrature gathers
        the per-cell densities at panel midpoints."""
        import copy

        self._check_table_grid(self.grid)
        t = copy.copy(self)
        t.analytic = True
        t.table = True
        return t

    def voxelized(self, max_voxels: int = 1 << 24,
                  max_field_error: float | None = None, log=None):
        """Uniform-voxel view of this system.

        Tree grids: the gridded field is piecewise constant on leaf cells
        and leaves are unions of finest-level voxels, so the view traces
        the identical field.  Voronoi grids (grid.voxelize_exact False):
        the nearest-site rasterization approximates the field; its
        mass-weighted error is measured (`voxelization_error` on the
        result, and logged), and above `max_field_error` the view is
        refused (None), so the caller keeps the exact tessellation.
        Returns (voxel_dust_system, fold_labs), where fold_labs maps a
        flat (nvox * nlambda,) absorption tally onto (ncells * nlambda,)
        cells; None when the grid has no voxelization or it would exceed
        max_voxels."""
        import copy

        if self.analytic or not hasattr(self.grid, "voxelize"):
            return None
        v = self.grid.voxelize(max_voxels=max_voxels)
        if v is None:
            return None
        cart, cell_of = v
        field_error = None
        if not getattr(self.grid, "voxelize_exact", True):
            field_error = self._voxel_field_error(cart, cell_of)
            if log is not None:
                log.info(f"approximate voxelization: mass-weighted field "
                         f"error {field_error * 100:.2f}%")
            if max_field_error is not None and field_error > max_field_error:
                if log is not None:
                    log.warning(
                        f"voxelization refused: field error "
                        f"{field_error * 100:.2f}% exceeds the "
                        f"{max_field_error * 100:.2f}% tolerance — "
                        f"falling back to the exact walk")
                return None
        vds = copy.copy(self)
        vds.grid = cart
        vds.rho64 = np.ascontiguousarray(self.rho64[:, cell_of])
        vds.rho = np.asarray(vds.rho64, np.float32)
        vds.volumes = cart.cell_volumes()
        vds.voxelization_error = field_error
        vds._rho_dev = {}
        nl = self.wavelength_grid.nlambda
        ncells = self.grid.ncells

        def fold_labs(labs_vox):
            lv = np.asarray(labs_vox, np.float64).reshape(-1, nl)
            out = np.zeros((ncells, nl))
            np.add.at(out, cell_of, lv)
            return out.reshape(-1)

        return vds, fold_labs

    def _voxel_field_error(self, cart, cell_of, n_samples: int = 200000,
                           seed: int = 31):
        """Mass-weighted relative field error of an approximate
        rasterization, E = sum |rho_vox - rho_exact| dV / sum rho dV,
        sampled at n_samples uniform points: rho_exact by the grid's own
        point location (the exact tessellation), rho_vox by the voxel
        assignment (skirt_tpu's estimate, the same draws)."""
        rs = np.random.default_rng(seed)
        lo = np.asarray([cart._lo[a] for a in range(3)])
        dxv = np.asarray([cart._dx[a] for a in range(3)])
        nv = np.asarray([cart.nx, cart.ny, cart.nz])
        pts = lo + rs.uniform(size=(n_samples, 3)) * (nv * dxv)
        exact_cells = self.grid.locate(
            torch.as_tensor(pts.astype(np.float32))).numpy()
        iv = np.clip(((pts - lo) / dxv).astype(np.int64), 0, nv - 1)
        vox_flat = (iv[:, 0] * nv[1] + iv[:, 1]) * nv[2] + iv[:, 2]
        vox_cells = np.asarray(cell_of)[vox_flat]
        rho = self.rho64.sum(axis=0)
        ok = exact_cells >= 0
        re_ = rho[exact_cells[ok]]
        rv = rho[vox_cells[ok]]
        denom = re_.sum()
        if denom <= 0:
            return 0.0
        return float(np.abs(rv - re_).sum() / denom)

    # -- polarization -------------------------------------------------------

    @property
    def muellers(self):
        """Per-component Mueller tables (None for unpolarized mixes), or
        None when no component polarizes (skirt_tpu
        dust_system.py:206-218)."""
        tables = [getattr(c.mix, "mueller", None) for c in self.components]
        if all(t is None for t in tables):
            return None
        return tables

    @property
    def mueller(self):
        """The Mueller table of a one-component system (the list of
        `muellers` with several components), or None."""
        tables = self.muellers
        if tables is None or self.ncomp != 1:
            return tables
        return tables[0]

    # -- diagnostics (host) -----------------------------------------------

    def gridded_mass(self) -> float:
        return float((self.rho64.sum(axis=0) * self.volumes).sum())

    # -- device side --------------------------------------------------------

    def packet_kappas(self, ell):
        """Per-packet opacity lookups: (ksca_pk, kext_pk), lists over
        components of (N,) tensors on ell's device."""
        dev = ell.device
        if dev not in self._kappas_dev:     # one host->device copy per device
            self._kappas_dev[dev] = (torch.as_tensor(self.kappasca, device=dev),
                                     torch.as_tensor(self.kappaext, device=dev))
        ksca, kext = self._kappas_dev[dev]
        idx = ell.long()
        return ([ksca[h, idx] for h in range(self.ncomp)],
                [kext[h, idx] for h in range(self.ncomp)])

    def rho_at(self, h, cells_safe):
        """rho_h (float32) at (clipped) flat cell ids: a plain index (the
        TPU's two-level row gather gives the same values)."""
        dev = cells_safe.device
        if dev not in self._rho_dev:        # one host->device copy per device
            self._rho_dev[dev] = torch.as_tensor(self.rho, device=dev)
        return self._rho_dev[dev][h][cells_safe.long()]

    def analytic_rows(self, pos, direction, mid, ksca_pk, kext_pk,
                      want_sca=True):
        """Per-segment (kappasca*rho, kappaext*rho) at segment midpoints.
        pos, direction (N, 3) SI; mid (N, S) midpoint ray parameters;
        ksca_pk/kext_pk: per-component (N,) opacities.  Returns (N, S)
        rows: the closed-form densities in analytic mode, the gridded ones
        gathered at the midpoint cells in table mode (zero outside)."""
        if self.table:
            pmid = pos[:, None, :] + mid[..., None] * direction[:, None, :]
            cells = self.grid.locate_batched(pmid)
            safe = torch.clamp(cells, min=0)
            valid = cells >= 0
            ksca = 0.0
            kext = 0.0
            for h in range(self.ncomp):
                rho_h = self.rho_at(h, safe)
                if want_sca:
                    ksca = ksca + ksca_pk[h][:, None] * rho_h
                kext = kext + kext_pk[h][:, None] * rho_h
            kext = torch.where(valid, kext, 0.0)
            if not want_sca:
                return kext
            return torch.where(valid, ksca, 0.0), kext
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
