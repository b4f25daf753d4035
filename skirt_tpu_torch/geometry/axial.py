"""Axisymmetric geometries.

Twin of skirt_tpu/geometry/axial.py: ExpDiskGeometry (slice 1) and the
host side of TorusGeometry (slice S4a).
ref: SKIRTcore/ExpDiskGeometry.cpp, TorusGeometry.cpp.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import rng
from ..devices import resolve
from ..numerics import f32
from .base import AxGeometry, build_inverse_cdf


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
        inside = R >= f32(self.Rmin)
        if self.Rmax > 0:
            inside &= R <= f32(self.Rmax)
        if self.zmax > 0:
            inside &= absz <= f32(self.zmax)
        return torch.where(inside, shape, 0.0)

    def generate_position(self, key: int, n: int, device="cuda"):
        device = resolve(device)
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
        return (f32(self.hR), f32(self.hz),
                f32(-np.expm1(-self._zcut / self.hz)))

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
            phi = f32(2.0 * np.pi) * uphi
            return R * torch.cos(phi), R * torch.sin(phi), z

        return 4, fn

    def cuda_density(self, lscale: float):
        return ("expdisk", [f32(float(self.rho0) * lscale ** 3),
                            f32(lscale), *self._inv_scales(),
                            f32(self.Rmin), f32(self.Rmax),
                            f32(self.zmax)])

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


class TorusGeometry(AxGeometry):
    """AGN torus: rho ~ r^(-p) exp(-q|cos(theta)|) within rmin < r < rmax
    and |pi/2 - theta| <= Delta (opening angle).

    Host side only (the normalisation quadrature, the float64 density the
    dust system grids, the surface densities of the normalizations): the
    table path traces its gridded densities.  Its closed-form device
    density and position sampler belong to slice S6.
    ref: SKIRTcore/TorusGeometry.cpp (Stalevski et al. 2012 flared torus).
    """

    def __init__(self, exponent_p: float, index_q: float, open_angle: float,
                 rmin: float, rmax: float):
        self.p = float(exponent_p)
        self.q = float(index_q)
        self.delta = float(open_angle)
        self.rmin = float(rmin)
        self.rmax = float(rmax)

        # normalization by 2-D quadrature over (r, theta)
        rv = np.logspace(np.log10(self.rmin), np.log10(self.rmax), 2048)
        tv = np.linspace(np.pi / 2 - self.delta, np.pi / 2 + self.delta, 1025)
        rr, tt = np.meshgrid(rv, tv, indexing="ij")
        f = rr ** (-self.p) * np.exp(-self.q * np.abs(np.cos(tt)))
        integrand = f * rr * rr * np.sin(tt)
        integral = 2.0 * np.pi * np.trapezoid(
            np.trapezoid(integrand, tv, axis=1), rv)
        self.A = 1.0 / integral

    def density_rz(self, R, z):
        """Host (NumPy float64) density."""
        r = np.sqrt(R * R + z * z)
        r_safe = np.maximum(r, 1e-30)
        costheta = z / r_safe
        rho = self.A * r_safe ** (-self.p) * np.exp(-self.q * np.abs(costheta))
        inside = ((r >= self.rmin) & (r <= self.rmax)
                  & (np.abs(costheta) <= np.sin(self.delta)))
        return np.where(inside, rho, 0.0)

    def generate_position(self, key: int, n: int, device="cuda"):
        raise NotImplementedError("TorusGeometry's position sampler is not "
                                  "ported yet (slice S6)")

    def sigma_x(self) -> float:
        rv = np.logspace(np.log10(self.rmin), np.log10(self.rmax), 65536)
        return float(2.0 * self.A * np.trapezoid(rv ** (-self.p), rv))

    sigma_y = sigma_x

    def sigma_z(self) -> float:
        return 0.0  # the z-axis is inside the opening cone
