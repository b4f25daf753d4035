"""Stellar systems: components with geometry + luminosities, and the launch.

Twin of skirt_tpu/sources/stellar.py (slice 1: LuminosityStellarComponent
and the single-component launch).  ref: SKIRTcore/StellarSystem.cpp:48-158,
GeometricStellarComp.cpp.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import rng


class LuminosityStellarComponent:
    """Component with explicitly given per-bin luminosities [W]."""

    def __init__(self, geometry, wavelength_grid, luminosities_w):
        self.geometry = geometry
        self.sed = None
        self._wg = wavelength_grid
        self.luminosities = np.asarray(luminosities_w, dtype=np.float64)

    @property
    def wavelength_grid(self):
        return self._wg


class StellarSystem:
    """All stellar components + the batched launch."""

    def __init__(self, components, emission_bias: float = 0.5):
        if not components:
            raise ValueError("need at least one stellar component")
        self.components = list(components)
        self.ncomp = len(self.components)
        self.emission_bias = float(emission_bias)
        self.wavelength_grid = self.components[0].wavelength_grid

    @property
    def is_isotropic(self) -> bool:
        return all(c.geometry.is_isotropic for c in self.components)

    def launch(self, key: int, ell, L):
        """Launch a batch: returns (positions, directions, luminosities, comp).

        ell: (N,) wavelength indices; L: (N,) base luminosities.  The
        device is ell's."""
        if self.ncomp != 1:
            raise ValueError(
                "multi-component launch is not ported yet (skirt_tpu_torch "
                "slice 1 launches a single stellar component)")
        n = ell.shape[0]
        kpos, kdir = rng.split(key)
        comp = torch.zeros(n, dtype=torch.int32, device=ell.device)
        geom = self.components[0].geometry
        pos = geom.generate_position(kpos, n, ell.device)
        d = geom.generate_direction(kdir, ell, pos)
        return pos, d, L, comp
