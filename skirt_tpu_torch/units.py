"""Quantity-aware unit system of the writers.

Copy of skirt_tpu/units.py (the port imports no module of skirt_tpu), the
reference unit layer (ref: SKIRTcore/Units.hpp:35-549,
SIUnits/StellarUnits/ExtragalacticUnits): all internal computation is in SI
(m, kg, s, W); this module converts at the I/O boundary only.  Three unit
styles mirror the reference's SIUnits / StellarUnits / ExtragalacticUnits,
and a flux-output style selects neutral (λF_λ), wavelength (F_λ) or
frequency (F_ν) representations.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from . import constants as cst

# unit-name -> factor to SI (value_SI = value_unit * factor)
_UNIT_TO_SI: dict[str, dict[str, float]] = {
    "length": {
        "m": 1.0, "cm": 1e-2, "mm": 1e-3, "km": 1e3,
        "AU": cst.AU, "pc": cst.PC, "kpc": cst.KPC, "Mpc": cst.MPC,
    },
    "distance": {
        "m": 1.0, "AU": cst.AU, "pc": cst.PC, "kpc": cst.KPC, "Mpc": cst.MPC,
        "ly": cst.LY,
    },
    "wavelength": {
        "m": 1.0, "micron": cst.MICRON, "nm": cst.NANOMETER, "A": cst.ANGSTROM,
        "mm": 1e-3, "cm": 1e-2,
    },
    "grainsize": {"m": 1.0, "micron": cst.MICRON, "nm": cst.NANOMETER,
                  "A": cst.ANGSTROM, "mm": 1e-3, "cm": 1e-2},
    "section": {"m2": 1.0, "cm2": 1e-4},
    "volume": {"m3": 1.0, "cm3": 1e-6, "AU3": cst.AU**3, "pc3": cst.PC**3},
    "velocity": {"m/s": 1.0, "km/s": 1e3, "km/h": 1 / 3.6},
    "mass": {"kg": 1.0, "g": 1e-3, "Msun": cst.M_SUN},
    "bulkmass": {"kg": 1.0, "g": 1e-3},
    "bulkmassdensity": {"kg/m3": 1.0, "g/cm3": 1e3},
    "masssurfacedensity": {"kg/m2": 1.0, "g/cm2": 10.0, "Msun/AU2": cst.M_SUN / cst.AU**2,
                           "Msun/pc2": cst.M_SUN / cst.PC**2},
    "massvolumedensity": {"kg/m3": 1.0, "g/cm3": 1e3, "Msun/AU3": cst.M_SUN / cst.AU**3,
                          "Msun/pc3": cst.M_SUN / cst.PC**3},
    "opacity": {"m2/kg": 1.0, "cm2/g": 0.1},
    "energy": {"J": 1.0, "erg": 1e-7},
    "bolluminosity": {"W": 1.0, "erg/s": 1e-7, "Lsun": cst.L_SUN},
    "monluminosity": {"W/m": 1.0, "W/micron": 1.0 / cst.MICRON, "Lsun/micron": cst.L_SUN / cst.MICRON,
                      "erg/s/cm": 1e-5},
    "neutralfluxdensity": {"W/m2": 1.0, "erg/s/cm2": 1e-3},
    "neutralsurfacebrightness": {"W/m2/sr": 1.0, "W/m2/arcsec2": 1.0 / cst.ARCSEC2,
                                 "erg/s/cm2/sr": 1e-3, "erg/s/cm2/arcsec2": 1e-3 / cst.ARCSEC2},
    "wavelengthfluxdensity": {"W/m3": 1.0, "W/m2/micron": 1.0 / cst.MICRON,
                              "erg/s/cm2/micron": 1e-3 / cst.MICRON},
    "wavelengthsurfacebrightness": {"W/m3/sr": 1.0, "W/m2/micron/sr": 1.0 / cst.MICRON,
                                    "W/m2/micron/arcsec2": 1.0 / cst.MICRON / cst.ARCSEC2,
                                    "erg/s/cm2/micron/sr": 1e-3 / cst.MICRON,
                                    "erg/s/cm2/micron/arcsec2": 1e-3 / cst.MICRON / cst.ARCSEC2},
    "frequencyfluxdensity": {"W/m2/Hz": 1.0, "Jy": cst.JANSKY, "mJy": 1e-3 * cst.JANSKY,
                             "MJy": 1e6 * cst.JANSKY, "erg/s/cm2/Hz": 1e-3},
    "frequencysurfacebrightness": {"W/m2/Hz/sr": 1.0, "W/m2/Hz/arcsec2": 1.0 / cst.ARCSEC2,
                                   "Jy/sr": cst.JANSKY, "Jy/arcsec2": cst.JANSKY / cst.ARCSEC2,
                                   "MJy/sr": 1e6 * cst.JANSKY, "MJy/arcsec2": 1e6 * cst.JANSKY / cst.ARCSEC2},
    "temperature": {"K": 1.0},
    "angle": {"rad": 1.0, "deg": math.pi / 180.0, "arcsec": cst.ARCSEC},
    "posangle": {"rad": 1.0, "deg": math.pi / 180.0},
    "solidangle": {"sr": 1.0, "arcsec2": cst.ARCSEC2},
    "pressure": {"Pa": 1.0, "K/m3": cst.K_BOLTZMANN},
    "time": {"s": 1.0, "yr": 3.15569e7, "Myr": 3.15569e13, "Gyr": 3.15569e16},
    "dimless": {"1": 1.0, "": 1.0},
}

# per-style default output unit per quantity (ref: SIUnits.cpp / StellarUnits.cpp
# / ExtragalacticUnits.cpp)
_STYLE_UNITS = {
    "SI": {q: next(iter(units)) for q, units in _UNIT_TO_SI.items()},
    "stellar": {
        "length": "AU", "distance": "pc", "wavelength": "micron", "grainsize": "micron",
        "section": "m2", "volume": "AU3", "velocity": "km/s", "mass": "Msun",
        "bulkmass": "kg", "bulkmassdensity": "g/cm3",
        "masssurfacedensity": "Msun/AU2", "massvolumedensity": "Msun/AU3",
        "opacity": "m2/kg", "energy": "J",
        "bolluminosity": "Lsun", "monluminosity": "Lsun/micron",
        "neutralfluxdensity": "W/m2", "neutralsurfacebrightness": "W/m2/arcsec2",
        "wavelengthfluxdensity": "W/m2/micron",
        "wavelengthsurfacebrightness": "W/m2/micron/arcsec2",
        "frequencyfluxdensity": "Jy", "frequencysurfacebrightness": "MJy/sr",
        "temperature": "K", "angle": "deg", "posangle": "deg", "solidangle": "arcsec2",
        "pressure": "K/m3", "time": "s", "dimless": "1",
    },
    "extragalactic": {
        "length": "pc", "distance": "Mpc", "wavelength": "micron", "grainsize": "micron",
        "section": "m2", "volume": "pc3", "velocity": "km/s", "mass": "Msun",
        "bulkmass": "kg", "bulkmassdensity": "g/cm3",
        "masssurfacedensity": "Msun/pc2", "massvolumedensity": "Msun/pc3",
        "opacity": "m2/kg", "energy": "J",
        "bolluminosity": "Lsun", "monluminosity": "Lsun/micron",
        "neutralfluxdensity": "W/m2", "neutralsurfacebrightness": "W/m2/arcsec2",
        "wavelengthfluxdensity": "W/m2/micron",
        "wavelengthsurfacebrightness": "W/m2/micron/arcsec2",
        "frequencyfluxdensity": "Jy", "frequencysurfacebrightness": "MJy/sr",
        "temperature": "K", "angle": "deg", "posangle": "deg", "solidangle": "arcsec2",
        "pressure": "K/m3", "time": "s", "dimless": "1",
    },
}


def to_si(quantity: str, value: float, unit: str) -> float:
    """Convert `value` expressed in `unit` of `quantity` to SI."""
    try:
        return value * _UNIT_TO_SI[quantity][unit]
    except KeyError as e:
        raise ValueError(f"unknown unit '{unit}' for quantity '{quantity}'") from e


def parse_quantity(text: str, quantity: str) -> float:
    """Parse a 'value unit' string, e.g. '6.6 kpc' -> meters.

    ref: Discover/DoublePropertyHandler.cpp:110-165 (unit-aware parsing).
    """
    parts = text.split()
    if len(parts) == 1:
        return float(parts[0]) * _UNIT_TO_SI[quantity][_STYLE_UNITS["SI"][quantity]]
    return to_si(quantity, float(parts[0]), parts[1])


@dataclass
class Units:
    """Unit conversion at the I/O boundary (ref: SKIRTcore/Units.hpp:35-549).

    style: 'SI' | 'stellar' | 'extragalactic'
    flux_style: 'neutral' (λF_λ) | 'wavelength' (F_λ) | 'frequency' (F_ν)
    """

    style: str = "extragalactic"
    flux_style: str = "neutral"
    overrides: dict = field(default_factory=dict)

    def unit(self, quantity: str) -> str:
        if quantity in self.overrides:
            return self.overrides[quantity]
        return _STYLE_UNITS[self.style][quantity]

    def out(self, quantity: str, value):
        """SI value -> value in this style's output unit."""
        return value / _UNIT_TO_SI[quantity][self.unit(quantity)]

    def inn(self, quantity: str, value, unit: str | None = None):
        """Value in unit (default: style unit) -> SI."""
        u = unit if unit is not None else self.unit(quantity)
        return value * _UNIT_TO_SI[quantity][u]

    # -- flux-style dependent conversions (ref: Units.cpp:975-1030) ---------

    def flux_quantity(self) -> str:
        return {"neutral": "neutralfluxdensity",
                "wavelength": "wavelengthfluxdensity",
                "frequency": "frequencyfluxdensity"}[self.flux_style]

    def surface_brightness_quantity(self) -> str:
        return {"neutral": "neutralsurfacebrightness",
                "wavelength": "wavelengthsurfacebrightness",
                "frequency": "frequencysurfacebrightness"}[self.flux_style]

    def out_fluxdensity(self, lam, Flambda):
        """SI F_λ [W/m^3] at wavelength lam [m] -> output flux density."""
        if self.flux_style == "wavelength":
            return self.out("wavelengthfluxdensity", Flambda)
        if self.flux_style == "frequency":
            return self.out("frequencyfluxdensity", lam * lam * Flambda / cst.C_LIGHT)
        return self.out("neutralfluxdensity", lam * Flambda)

    def out_surfacebrightness(self, lam, flambda):
        """SI f_λ [W/m^3/sr] at wavelength lam [m] -> output surf. brightness.

        ref: SKIRTcore/Units.cpp osurfacebrightness.
        """
        if self.flux_style == "wavelength":
            return self.out("wavelengthsurfacebrightness", flambda)
        if self.flux_style == "frequency":
            return self.out("frequencysurfacebrightness", lam * lam * flambda / cst.C_LIGHT)
        return self.out("neutralsurfacebrightness", lam * flambda)

    def fluxdensity_unit(self) -> str:
        return self.unit(self.flux_quantity())

    def surfacebrightness_unit(self) -> str:
        return self.unit(self.surface_brightness_quantity())
