"""Dust mixes: per-wavelength optical properties.

Twin of skirt_tpu/media/mix.py (slice 1: DustMix, SimpleOligoDustMix).
ref: SKIRTcore/DustMix.cpp, SimpleOligoDustMix.cpp.
"""

from __future__ import annotations

import numpy as np


class DustMix:
    """Optical properties on a wavelength grid: kappaabs/kappasca [m^2/kg]
    and the HG asymmetry g per wavelength bin (NumPy, host side)."""

    polarization = False
    mueller = None

    def __init__(self, wavelength_grid, kappaabs, kappasca, g):
        self.wavelength_grid = wavelength_grid
        self.kappaabs64 = np.asarray(kappaabs, dtype=np.float64)
        self.kappasca64 = np.asarray(kappasca, dtype=np.float64)
        self.kappaext64 = self.kappaabs64 + self.kappasca64
        with np.errstate(invalid="ignore", divide="ignore"):
            self.albedo64 = np.where(self.kappaext64 > 0,
                                     self.kappasca64 / self.kappaext64, 0.0)
        self.g64 = np.asarray(g, dtype=np.float64)
        self.kappaabs = np.asarray(self.kappaabs64, np.float32)
        self.kappasca = np.asarray(self.kappasca64, np.float32)
        self.kappaext = np.asarray(self.kappaext64, np.float32)
        self.albedo = np.asarray(self.albedo64, np.float32)
        self.g = np.asarray(self.g64, np.float32)


class SimpleOligoDustMix(DustMix):
    """User-specified opacity/albedo/asymmetry per oligochromatic wavelength
    (kappaabs = kappaext*(1-albedo), as in skirt_tpu)."""

    def __init__(self, wavelength_grid, kappaext, albedo, g=None):
        ke = np.asarray(kappaext, dtype=np.float64)
        al = np.asarray(albedo, dtype=np.float64)
        gv = np.zeros_like(ke) if g is None else np.asarray(g, dtype=np.float64)
        if not (ke.size == al.size == gv.size == wavelength_grid.nlambda):
            raise ValueError("property lists must match the wavelength grid")
        super().__init__(wavelength_grid, ke * (1.0 - al), ke * al, gv)
