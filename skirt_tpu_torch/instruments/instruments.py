"""Distant instruments with parallel projection.

Twin of skirt_tpu/instruments/instruments.py (DistantInstrument,
SEDInstrument, FrameInstrument, SimpleInstrument and FullInstrument with
the monochromatic and polychromatic detects, calibration and writers).
ref: SKIRTcore/DistantInstrument.cpp, SingleFrameInstrument.cpp
(pixelondetector :119-145, calibration :151-226), SEDInstrument /
FrameInstrument / SimpleInstrument / FullInstrument.cpp:107-230.

The detects take skirt_tpu's `tags`: per-packet provenance (nscatt, 0
for direct light; is_dust), the unextincted contribution ("transparent")
and, for polarized packets, the Stokes ratios (q, u, v) in the
instrument's frame.  Only FullInstrument reads them.

Tallies are float32 tensors on the run's device, updated in place; the
frame cube goes through the K2 binned scatter-add (ops.binned_add), the
monochromatic detects' SEDs through the per-wavelength bin sum
(ops.bin_sum_add: on the card the kernel of csrc/bin_sum.cu).
Calibration and output run on the host in float64 through the port's
own FITS writer (fits.py) and unit system (units.py), copies of
skirt_tpu's: the port imports no module of skirt_tpu.
"""

from __future__ import annotations

import math
import os
from typing import TYPE_CHECKING

import numpy as np
import torch

from .. import trace
from ..devices import resolve
from ..fits import write_fits
from ..ops import bin_sum_add, binned_add

if TYPE_CHECKING:
    from ..units import Units


def _f32(v) -> float:
    return float(np.float32(v))


class DistantInstrument:
    """Base: parallel projection from (inclination, azimuth, position
    angle) at a large distance.  Angles in radians, distance in metres."""

    def __init__(self, name: str, distance: float, inclination: float = 0.0,
                 azimuth: float = 0.0, position_angle: float = 0.0):
        self.name = name
        self.distance = float(distance)
        self.inclination = float(inclination)
        self.azimuth = float(azimuth)
        self.position_angle = float(position_angle)

        ct, st = math.cos(self.inclination), math.sin(self.inclination)
        cp, sp = math.cos(self.azimuth), math.sin(self.azimuth)
        cpa, spa = math.cos(self.position_angle), math.sin(self.position_angle)
        self._trig = (ct, st, cp, sp, cpa, spa)

        # ref: DistantInstrument.cpp setupSelfBefore
        self.kobs = np.array([st * cp, st * sp, ct])
        self.kx = np.array([cp * ct * spa - sp * cpa,
                            sp * ct * spa + cp * cpa,
                            -st * spa])
        self.ky = np.array([-cp * ct * cpa - sp * spa,
                            -sp * ct * cpa + cp * spa,
                            st * cpa])

    def detect(self, tallies, pos, ell, contribution, tags=None):
        """Add the (already extincted) contributions of N packets with
        wavelength indices ell (N,) to the tallies."""
        with trace.span("detect"):
            return self._detect(tallies, pos, ell, contribution, tags)

    def detect_poly(self, tallies, pos, wls, contrib, tags=None):
        """contrib (W, N): row i carries wavelength index wls[i] (a
        (W,) int64 tensor) for the same N positions; a tag's
        "transparent" is (W, N)."""
        with trace.span("detect"):
            return self._detect_poly(tallies, pos, wls, contrib, tags)

    def project(self, pos):
        """Model position (N, 3) float32 -> detector-plane (xp, yp).

        Each trig product is formed in float64 and rounded to float32
        before it meets a coordinate, as skirt_tpu's JAX arithmetic does,
        so pixel edges agree bit for bit.  ref: pixelondetector."""
        ct, st, cp, sp, cpa, spa = self._trig
        x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
        xpp = _f32(-sp) * x + _f32(cp) * y
        ypp = _f32(-cp * ct) * x - _f32(sp * ct) * y + _f32(st) * z
        xp = _f32(cpa) * xpp - _f32(spa) * ypp
        yp = _f32(spa) * xpp + _f32(cpa) * ypp
        return xp, yp


class SEDInstrument(DistantInstrument):
    """Integrated SED only (ref: SKIRTcore/SEDInstrument.cpp)."""

    def __init__(self, name: str, distance: float, nlambda: int, **kw):
        super().__init__(name, distance, **kw)
        self.nlambda = int(nlambda)

    def zero_tallies(self, device="cuda"):
        return {"Ftot": torch.zeros((self.nlambda,), dtype=torch.float32,
                                    device=resolve(device))}

    def _detect(self, tallies, pos, ell, contribution, tags=None):
        bin_sum_add(tallies["Ftot"], contribution, ell)
        return tallies

    def _detect_poly(self, tallies, pos, wls, contrib, tags=None):
        tallies["Ftot"].index_add_(0, wls, contrib.sum(dim=1))
        return tallies

    def write(self, accumulated, wavelength_grid, units: Units, out_dir: str,
              prefix: str):
        _write_sed(self, {"total": accumulated["Ftot"]}, wavelength_grid,
                   units, out_dir, prefix)


class FrameInstrument(DistantInstrument):
    """Data cube only (ref: SKIRTcore/FrameInstrument.cpp)."""

    def __init__(self, name: str, distance: float, nlambda: int,
                 nx: int, ny: int, fov_x: float, fov_y: float,
                 center_x: float = 0.0, center_y: float = 0.0, **kw):
        super().__init__(name, distance, **kw)
        self.nlambda = int(nlambda)
        self.nx = int(nx)
        self.ny = int(ny)
        self.fov_x = float(fov_x)
        self.fov_y = float(fov_y)
        self.center_x = float(center_x)
        self.center_y = float(center_y)
        self.psize_x = self.fov_x / self.nx
        self.psize_y = self.fov_y / self.ny
        self.xmin = self.center_x - self.fov_x / 2.0
        self.ymin = self.center_y - self.fov_y / 2.0

    def pixel(self, pos):
        """Flat pixel index (iy * nx + ix), -1 outside the frame: floor of
        the float32 projection, as in skirt_tpu."""
        xp, yp = self.project(pos)
        i = torch.floor((xp - _f32(self.xmin)) / _f32(self.psize_x)).to(torch.int32)
        j = torch.floor((yp - _f32(self.ymin)) / _f32(self.psize_y)).to(torch.int32)
        ok = (i >= 0) & (i < self.nx) & (j >= 0) & (j < self.ny)
        return torch.where(ok, i + self.nx * j, -1)

    def zero_tallies(self, device="cuda"):
        return {"ftot": torch.zeros((self.nlambda * self.nx * self.ny,),
                                    dtype=torch.float32,
                                    device=resolve(device))}

    def _detect(self, tallies, pos, ell, contribution, tags=None):
        pix = self.pixel(pos)
        idx = torch.where(pix >= 0, ell * (self.nx * self.ny) + pix, -1)
        binned_add(tallies["ftot"], idx, contribution)
        return tallies

    def _poly_idx(self, pos, wls):
        """(W, N) flat cube bins sharing one pixel projection per lane."""
        pix = self.pixel(pos)
        wcol = wls.to(torch.int32)[:, None]
        return torch.where(pix[None, :] >= 0,
                           wcol * (self.nx * self.ny) + pix[None, :], -1)

    def _detect_poly(self, tallies, pos, wls, contrib, tags=None):
        idx = self._poly_idx(pos, wls)
        binned_add(tallies["ftot"], idx.reshape(-1), contrib.reshape(-1))
        return tallies

    def write(self, accumulated, wavelength_grid, units: Units, out_dir: str,
              prefix: str):
        _write_cube(self, {"total": accumulated["ftot"]}, wavelength_grid,
                    units, out_dir, prefix)


class SimpleInstrument(FrameInstrument):
    """SED + data cube (ref: SKIRTcore/SimpleInstrument.cpp)."""

    def zero_tallies(self, device="cuda"):
        t = super().zero_tallies(device)
        t["Ftot"] = torch.zeros((self.nlambda,), dtype=torch.float32,
                                device=device)
        return t

    def _detect(self, tallies, pos, ell, contribution, tags=None):
        tallies = super()._detect(tallies, pos, ell, contribution, tags)
        bin_sum_add(tallies["Ftot"], contribution, ell)
        return tallies

    def _detect_poly(self, tallies, pos, wls, contrib, tags=None):
        tallies = super()._detect_poly(tallies, pos, wls, contrib, tags)
        tallies["Ftot"].index_add_(0, wls, contrib.sum(dim=1))
        return tallies

    def write(self, accumulated, wavelength_grid, units: Units, out_dir: str,
              prefix: str):
        _write_cube(self, {"total": accumulated["ftot"]}, wavelength_grid,
                    units, out_dir, prefix)
        _write_sed(self, {"total": accumulated["Ftot"]}, wavelength_grid,
                   units, out_dir, prefix)


class FullInstrument(SimpleInstrument):
    """Decomposed tallies: direct / scattered x stellar / dust emission,
    the transparent (unextincted) direct light, per-scattering-level
    frames and, with polarization, the Stokes Q, U, V frames and SEDs
    (ref: SKIRTcore/FullInstrument.cpp:107-230).  Without tags a detect
    adds to the total frame and SED only."""

    def __init__(self, *args, nscatt_levels: int = 0,
                 polarization: bool = False, **kw):
        super().__init__(*args, **kw)
        self.nscatt_levels = int(nscatt_levels)
        self.polarization = bool(polarization)

    def zero_tallies(self, device="cuda"):
        t = super().zero_tallies(device)
        dev = resolve(device)
        npix = self.nlambda * self.nx * self.ny

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        for key in ("fdirstel", "fscastel", "fdirdust", "fscadust", "ftra"):
            t[key] = z(npix)
        for key in ("Fdirstel", "Fscastel", "Fdirdust", "Fscadust", "Ftra"):
            t[key] = z(self.nlambda)
        if self.nscatt_levels > 0:
            t["fscatlev"] = z(self.nscatt_levels, npix)
            t["Fscatlev"] = z(self.nscatt_levels, self.nlambda)
        if self.polarization:
            for key in ("fQ", "fU", "fV"):
                t[key] = z(npix)
            for key in ("FQ", "FU", "FV"):
                t[key] = z(self.nlambda)
        return t

    def _decomposed(self, tags, contrib, add):
        """The tallies both detects share: `add(key_f, key_F, mask,
        value)` adds the masked values to a frame and its SED."""
        nscatt = tags["nscatt"]
        is_dust = tags.get("is_dust")
        direct = nscatt == 0
        if is_dust is None:
            is_dust = torch.zeros_like(direct)
        add("fdirstel", "Fdirstel", direct & ~is_dust, contrib)
        add("fscastel", "Fscastel", ~direct & ~is_dust, contrib)
        add("fdirdust", "Fdirdust", direct & is_dust, contrib)
        add("fscadust", "Fscadust", ~direct & is_dust, contrib)
        if tags.get("transparent") is not None:
            add("ftra", "Ftra", direct & ~is_dust, tags["transparent"])

    def _detect(self, tallies, pos, ell, contribution, tags=None):
        t = super()._detect(tallies, pos, ell, contribution, tags)
        if tags is None:
            return t
        pix = self.pixel(pos)
        npix = self.nx * self.ny
        idx = torch.where(pix >= 0, ell * npix + pix, -1)

        def add(key_f, key_F, mask, value):
            binned_add(t[key_f], torch.where(mask, idx, -1), value)
            bin_sum_add(t[key_F], torch.where(mask, value, 0.0), ell)

        self._decomposed(tags, contribution, add)
        nscatt = tags["nscatt"]
        if self.nscatt_levels > 0:
            lev = torch.clamp(nscatt - 1, 0, self.nscatt_levels - 1)
            in_lev = (nscatt >= 1) & (nscatt <= self.nscatt_levels)
            level_idx = torch.where(in_lev,
                                    lev * (self.nlambda * npix) + idx, -1)
            binned_add(t["fscatlev"].view(-1),
                       torch.where(idx >= 0, level_idx, -1), contribution)
            binned_add(t["Fscatlev"].view(-1),
                       torch.where(in_lev, lev * self.nlambda + ell, -1),
                       contribution)
        if self.polarization and tags.get("stokes") is not None:
            for (key_f, key_F), ratio in zip(
                    (("fQ", "FQ"), ("fU", "FU"), ("fV", "FV")),
                    tags["stokes"]):
                val = contribution * ratio
                binned_add(t[key_f], idx, val)
                bin_sum_add(t[key_F], val, ell)
        return t

    def _detect_poly(self, tallies, pos, wls, contrib, tags=None):
        t = super()._detect_poly(tallies, pos, wls, contrib, tags)
        if tags is None:
            return t
        idx = self._poly_idx(pos, wls)                 # (W, N)
        npix = self.nx * self.ny

        def add(key_f, key_F, mask, value):
            binned_add(t[key_f], torch.where(mask[None], idx, -1).reshape(-1),
                       value.reshape(-1))
            t[key_F].index_add_(0, wls, torch.where(mask[None], value, 0.0)
                                .sum(dim=1))

        self._decomposed(tags, contrib, add)
        nscatt = tags["nscatt"]
        if self.nscatt_levels > 0:
            lev = torch.clamp(nscatt - 1, 0, self.nscatt_levels - 1)
            in_lev = (nscatt >= 1) & (nscatt <= self.nscatt_levels)
            level_idx = torch.where(in_lev[None] & (idx >= 0),
                                    lev[None] * (self.nlambda * npix) + idx,
                                    -1)
            binned_add(t["fscatlev"].view(-1), level_idx.reshape(-1),
                       contrib.reshape(-1))
            Fidx = torch.where(in_lev[None], lev[None] * self.nlambda
                               + wls.to(torch.int32)[:, None], -1)
            binned_add(t["Fscatlev"].view(-1), Fidx.reshape(-1),
                       contrib.reshape(-1))
        if self.polarization and tags.get("stokes") is not None:
            # the ratios are (W, N), or (N,) where the Mueller matrix is
            # the same at every wavelength
            for (key_f, key_F), ratio in zip(
                    (("fQ", "FQ"), ("fU", "FU"), ("fV", "FV")),
                    tags["stokes"]):
                val = (contrib * ratio).expand_as(contrib)
                binned_add(t[key_f], idx.reshape(-1), val.reshape(-1))
                t[key_F].index_add_(0, wls, val.sum(dim=1))
        return t

    def write(self, accumulated, wavelength_grid, units: Units, out_dir: str,
              prefix: str):
        a = accumulated
        frames = {"total": a["ftot"],
                  "direct": a["fdirstel"] + a["fdirdust"],
                  "scattered": a["fscastel"] + a["fscadust"],
                  "transparent": a["ftra"]}
        seds = {"total": a["Ftot"],
                "direct": a["Fdirstel"] + a["Fdirdust"],
                "scattered": a["Fscastel"] + a["Fscadust"],
                "transparent": a["Ftra"]}
        if self.polarization:
            for name, key in (("stokesQ", "Q"), ("stokesU", "U"),
                              ("stokesV", "V")):
                frames[name] = a["f" + key]
                seds[name] = a["F" + key]
        _write_cube(self, frames, wavelength_grid, units, out_dir, prefix)
        _write_sed(self, seds, wavelength_grid, units, out_dir, prefix)


# ---------------------------------------------------------------------------
# calibration + output (host side, float64)
# ---------------------------------------------------------------------------

def _host64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def calibrate_sed(instrument, Ftot, wavelength_grid) -> np.ndarray:
    """W per bin -> F_lambda [W/m^3] at the instrument distance.

    ref: DistantInstrument::calibrateAndWriteSEDs (DistantInstrument.cpp:131+)."""
    fourpid2 = 4.0 * np.pi * instrument.distance ** 2
    return _host64(Ftot) / wavelength_grid.dlambdav / fourpid2


def calibrate_cube(instrument, ftot, wavelength_grid) -> np.ndarray:
    """W per bin per pixel -> surface brightness f_lambda [W/m^3/sr].

    ref: SingleFrameInstrument::calibrateAndWriteDataCubes (:151-226)."""
    cube = _host64(ftot).reshape(wavelength_grid.nlambda, instrument.ny,
                                 instrument.nx)
    d = instrument.distance
    omega = (2.0 * np.arctan(instrument.psize_x / (2.0 * d))
             * 2.0 * np.arctan(instrument.psize_y / (2.0 * d)))
    fourpid2 = 4.0 * np.pi * d * d
    return cube / wavelength_grid.dlambdav[:, None, None] / omega / fourpid2


def _write_sed(instrument, seds: dict, wavelength_grid, units: Units,
               out_dir: str, prefix: str):
    lam = wavelength_grid.lambdav
    cols = [units.out("wavelength", lam)]
    header = [f"lambda ({units.unit('wavelength')})"]
    for name, F in seds.items():
        Flam = calibrate_sed(instrument, F, wavelength_grid)
        cols.append(units.out_fluxdensity(lam, Flam))
        header.append(f"{name} flux ({units.fluxdensity_unit()})")
    path = os.path.join(out_dir, f"{prefix}_{instrument.name}_sed.dat")
    np.savetxt(path, np.column_stack(cols), header="  ".join(header))


def _write_cube(instrument, frames: dict, wavelength_grid, units: Units,
                out_dir: str, prefix: str):
    lam = wavelength_grid.lambdav
    for name, f in frames.items():
        cube = calibrate_cube(instrument, f, wavelength_grid)
        out = units.out_surfacebrightness(lam[:, None, None], cube)
        path = os.path.join(out_dir, f"{prefix}_{instrument.name}_{name}.fits")
        write_fits(path, out,
                   incx=units.out("length", instrument.psize_x),
                   incy=units.out("length", instrument.psize_y),
                   xc=instrument.center_x, yc=instrument.center_y,
                   units=units.surfacebrightness_unit())
