"""General geometries.

Twin of skirt_tpu/geometry/general.py: PointGeometry (slice 1) and
UniformSphereGeometry (slice S4b, the second dust component of the
multi-component table model).  ref: SKIRTcore/PointGeometry.cpp.
"""

from __future__ import annotations

import numpy as np
import torch

from ..devices import resolve
from .. import rng
from ..numerics import f32
from .base import Geometry


class PointGeometry(Geometry):
    """All mass at the origin."""

    dimension = 1

    def density(self, pos):
        pos = np.asarray(pos)
        return np.zeros(pos.shape[:-1], dtype=pos.dtype)

    def generate_position(self, key: int, n: int, device="cuda"):
        return torch.zeros((n, 3), dtype=torch.float32,
                           device=resolve(device))

    def device_sampler_xyz(self):
        """Kernel-safe sampler: the position is the constant origin."""
        def fn(u):
            zero = u[0] * 0.0
            return zero, zero, zero
        return 1, fn

    def cuda_sampler(self):
        return ("point", [])

    def sigma_x(self) -> float:
        return 0.0

    sigma_y = sigma_x
    sigma_z = sigma_x


class UniformSphereGeometry(Geometry):
    """Uniform density inside a sphere of radius rmax.

    Its CUDA device density and sampler belong to slice S6: no ported
    kernel evaluates or samples it (the table engines gather its gridded
    densities)."""

    dimension = 1

    def __init__(self, rmax: float):
        self.rmax = float(rmax)
        self.volume = 4.0 / 3.0 * np.pi * self.rmax ** 3

    def density(self, pos):
        """Host (NumPy float64) density."""
        pos = np.asarray(pos)
        r = np.sqrt(np.sum(pos * pos, axis=-1))
        return np.where(r <= self.rmax, 1.0 / self.volume, 0.0)

    def density_scaled_xyz(self, x_s, y_s, z_s, lscale: float):
        r_s = torch.sqrt(x_s * x_s + y_s * y_s + z_s * z_s)
        pref = f32(lscale ** 3 / self.volume)
        return torch.where(r_s * f32(lscale) <= f32(self.rmax), pref, 0.0)

    def generate_position(self, key: int, n: int, device="cuda"):
        device = resolve(device)
        k1, k2 = rng.split(key)
        u = rng.uniform_open(k1, (n,), device)
        r = self.rmax * u ** (1.0 / 3.0)
        d = rng.isotropic_direction(k2, (n,), device)
        return r[:, None] * d

    def device_sampler_xyz(self):
        """Gather-free sampler: r = rmax u^(1/3), an isotropic direction
        from (cos theta, phi)."""
        rmax = f32(self.rmax)

        def fn(u):
            u1, u2, u3 = u
            r = rmax * torch.pow(u1, 1.0 / 3.0)
            ct = 1.0 - 2.0 * u2
            st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
            phi = f32(2.0 * np.pi) * u3
            return r * st * torch.cos(phi), r * st * torch.sin(phi), r * ct

        return 3, fn

    def sigma_x(self) -> float:
        return float(2.0 * self.rmax / self.volume)

    sigma_y = sigma_x
    sigma_z = sigma_x
