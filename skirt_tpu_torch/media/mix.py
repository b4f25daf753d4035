"""Dust mixes: per-wavelength optical properties.

Twin of skirt_tpu/media/mix.py (DustMix with its HG phase function,
SimpleOligoDustMix, ElectronDustMix).  ref: SKIRTcore/DustMix.cpp,
SimpleOligoDustMix.cpp, ElectronDustMix.cpp.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import M_ELECTRON, SIGMA_THOMSON


class DustMix:
    """Optical properties on a wavelength grid: kappaabs/kappasca [m^2/kg]
    and the HG asymmetry g per wavelength bin (NumPy, host side)."""

    polarization = False
    mueller = None      # media.polarization.MuellerTables when polarized

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
        self._g_dev = {}

    def phase_function(self, ell, cosalpha):
        """HG phase function normalized to mean 1 over directions, for
        wavelength indices ell on cosalpha's device.

        ref: SKIRTcore/DustMix.cpp:648-671 phaseFunctionValue:
        (1-g^2) / (1 + g^2 - 2 g cos a)^{3/2}."""
        dev = cosalpha.device
        if dev not in self._g_dev:      # one host->device copy per device
            self._g_dev[dev] = torch.as_tensor(self.g, device=dev)
        g = self._g_dev[dev][ell.long()]
        t = 1.0 + g * g - 2.0 * g * cosalpha
        return (1.0 - g) * (1.0 + g) / torch.sqrt(t * t * t)


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


class ElectronDustMix(DustMix):
    """Thomson scattering by free electrons: grey, pure scattering, g = 0,
    kappa = sigma_T / m_e; always polarized, with the Thomson Mueller
    matrix (ref: SKIRTcore/ElectronDustMix.cpp)."""

    def __init__(self, wavelength_grid):
        from .polarization import thomson_mueller

        n = wavelength_grid.nlambda
        super().__init__(wavelength_grid, np.zeros(n),
                         np.full(n, SIGMA_THOMSON / M_ELECTRON), np.zeros(n))
        self.polarization = True
        self.mueller = thomson_mueller(n)
