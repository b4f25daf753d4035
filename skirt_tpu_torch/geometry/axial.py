"""Axisymmetric geometries.

Twin of skirt_tpu/geometry/axial.py (slice 1: ExpDiskGeometry).
ref: SKIRTcore/ExpDiskGeometry.cpp.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import rng
from .base import AxGeometry, _f32, build_inverse_cdf


class ExpDiskGeometry(AxGeometry):
    """Double-exponential disk: rho = rho0 exp(-R/hR) exp(-|z|/hz).

    Optional truncation: Rmax, zmax, inner hole Rmin (0 = none).
    """

    def __init__(self, radial_scale: float, axial_scale: float,
                 radial_trunc: float = 0.0, axial_trunc: float = 0.0,
                 inner_radius: float = 0.0):
        self.hR = float(radial_scale)
        self.hz = float(axial_scale)
        self.Rmax = float(radial_trunc)
        self.zmax = float(axial_trunc)
        self.Rmin = float(inner_radius)

        # central density so that total mass is 1
        intphi = 2.0 * np.pi
        intz = (-2.0 * self.hz * np.expm1(-self.zmax / self.hz)
                if self.zmax > 0 else 2.0 * self.hz)
        tmin = (np.exp(-self.Rmin / self.hR) * (1.0 + self.Rmin / self.hR)
                if self.Rmin > 0 else 1.0)
        tmax = (np.exp(-self.Rmax / self.hR) * (1.0 + self.Rmax / self.hR)
                if self.Rmax > 0 else 0.0)
        intR = self.hR * self.hR * (tmin - tmax)
        self.rho0 = 1.0 / (intR * intphi * intz)

        rhi = self.Rmax if self.Rmax > 0 else 15.0 * self.hR
        self._r_sampler = build_inverse_cdf(
            lambda R: R * np.exp(-R / self.hR), self.Rmin, rhi, n=8192)
        self._zcut = self.zmax if self.zmax > 0 else 40.0 * self.hz

    def density_rz(self, R, z):
        """Host (NumPy float64) density."""
        absz = np.abs(z)
        rho = self.rho0 * np.exp(-R / self.hR) * np.exp(-absz / self.hz)
        inside = (R >= self.Rmin)
        if self.Rmax > 0:
            inside &= R <= self.Rmax
        if self.zmax > 0:
            inside &= absz <= self.zmax
        return np.where(inside, rho, 0.0)

    def _inv_scales(self):
        """float32 reciprocals of hR, hz: the closed form multiplies by
        them, as XLA does for skirt_tpu's division by a constant and torch
        on CUDA for a division by a Python scalar, so the plain version,
        the CUDA kernel and the JAX reference round alike."""
        return (float(np.float32(1) / np.float32(self.hR)),
                float(np.float32(1) / np.float32(self.hz)))

    def shape_rz(self, R, z):
        """rho/rho0 with float32-safe torch math (analytic traversal mode)."""
        absz = torch.abs(z)
        inv_hR, inv_hz = self._inv_scales()
        shape = torch.exp(-R * inv_hR - absz * inv_hz)
        inside = R >= _f32(self.Rmin)
        if self.Rmax > 0:
            inside &= R <= _f32(self.Rmax)
        if self.zmax > 0:
            inside &= absz <= _f32(self.zmax)
        return torch.where(inside, shape, 0.0)

    def generate_position(self, key: int, n: int, device="cpu"):
        k1, k2, k3, k4 = rng.split(key, 4)
        if self.Rmin > 0 or self.Rmax > 0:
            R = self._r_sampler.sample(rng.uniform_open(k1, (n,), device))
        else:
            # R exp(-R/hR) is a Gamma(2, hR) density: R = -hR ln(u1 u2)
            u1 = rng.uniform_open(k1, (n,), device)
            u2 = rng.uniform_open(k4, (n,), device)
            R = -self.hR * torch.log(u1 * u2)
        # |z| from a truncated exponential, sign from the same deviate
        uz = rng.uniform_open(k2, (n,), device)
        cut = float(-np.expm1(-self._zcut / self.hz))
        absz = -self.hz * torch.log1p(-torch.abs(2.0 * uz - 1.0) * cut)
        z = torch.sign(uz - 0.5) * absz
        return self.cylindrical_to_cartesian(k3, R, z)

    def _sampler_consts(self):
        return (_f32(self.hR), _f32(self.hz),
                _f32(-np.expm1(-self._zcut / self.hz)))

    def device_sampler_xyz(self):
        """Closed-form (gather-free) sampler: Gamma(2) radius + truncated
        Laplace height.  Uses log(max(., 1e-37)) like the kernel sampler,
        where generate_position uses log1p."""
        if self.Rmin > 0 or self.Rmax > 0:
            return None
        hR, hz, cut = self._sampler_consts()

        def fn(u):
            u1, u2, uz, uphi = u
            R = -hR * torch.log(u1 * u2)
            absz = -hz * torch.log(torch.clamp(
                1.0 - torch.abs(2.0 * uz - 1.0) * cut, min=1e-37))
            z = torch.where(uz < 0.5, -absz, absz)
            phi = _f32(2.0 * np.pi) * uphi
            return R * torch.cos(phi), R * torch.sin(phi), z

        return 4, fn

    def cuda_density(self, lscale: float):
        return ("expdisk", [_f32(float(self.rho0) * lscale ** 3),
                            _f32(lscale), *self._inv_scales(),
                            _f32(self.Rmin), _f32(self.Rmax),
                            _f32(self.zmax)])

    def cuda_sampler(self):
        if self.device_sampler_xyz() is None:
            return None
        return ("expdisk", list(self._sampler_consts()))

    def sigma_r(self) -> float:
        if self.Rmax > 0:
            return float(self.rho0 * self.hR
                         * (np.exp(-self.Rmin / self.hR) - np.exp(-self.Rmax / self.hR)))
        return float(self.rho0 * self.hR * np.exp(-self.Rmin / self.hR))

    def sigma_x(self) -> float:
        return 2.0 * self.sigma_r()

    sigma_y = sigma_x

    def sigma_z(self) -> float:
        if self.Rmin > 0:
            return 0.0
        if self.zmax > 0:
            return float(-2.0 * self.rho0 * self.hz * np.expm1(-self.zmax / self.hz))
        return float(2.0 * self.rho0 * self.hz)
