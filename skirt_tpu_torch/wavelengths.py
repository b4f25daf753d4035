"""Wavelength grids.

Twin of skirt_tpu/wavelengths.py (slice 1: the oligochromatic grid).
ref: SKIRTcore/WavelengthGrid.hpp:18-50, OligoWavelengthGrid.cpp.  All
wavelengths in SI metres; a plain host-side object holding NumPy arrays.
The port keeps its own copy so that a run imports no module of
skirt_tpu; `convert.from_skirt_tpu` carries a skirt_tpu grid across as it
is (same attributes).
"""

from __future__ import annotations

import numpy as np


class WavelengthGrid:
    """Base: characteristic wavelengths lambdav and bin widths dlambdav."""

    def __init__(self, lambdav: np.ndarray, dlambdav: np.ndarray):
        self.lambdav = np.asarray(lambdav, dtype=np.float64)
        self.dlambdav = np.asarray(dlambdav, dtype=np.float64)
        if self.lambdav.ndim != 1 or self.lambdav.shape != self.dlambdav.shape:
            raise ValueError("lambdav and dlambdav must be matching 1-D arrays")
        if np.any(np.diff(self.lambdav) <= 0):
            raise ValueError("wavelengths must be strictly increasing")

    @property
    def nlambda(self) -> int:
        return self.lambdav.size

    def nearest(self, lam: float) -> int:
        """Bin index whose (geometric) bin contains lam, or -1 outside.

        ref: SKIRTcore/WavelengthGrid.cpp:82-89.
        """
        lv = self.lambdav
        if lam < lv[0] or lam > lv[-1]:
            return -1
        ell = int(np.searchsorted(lv, lam, side="right")) - 1
        ell = min(ell, lv.size - 2)
        lambdac = np.sqrt(lv[ell] * lv[ell + 1])
        return ell if lam < lambdac else ell + 1


class OligoWavelengthGrid(WavelengthGrid):
    """Discrete wavelength list; bin width 0.001*lambda.

    ref: SKIRTcore/OligoWavelengthGrid.cpp setupSelfAfter.
    """

    def __init__(self, wavelengths):
        lv = np.sort(np.asarray(wavelengths, dtype=np.float64))
        super().__init__(lv, 0.001 * lv)
