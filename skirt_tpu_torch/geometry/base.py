"""Geometry base classes and inverse-CDF sampling machinery.

Twin of skirt_tpu/geometry/base.py.  ref: SKIRTcore/Geometry.hpp:26-88.

Host-side evaluation (`density`, normalisation integrals) runs in NumPy
float64 — SI densities underflow float32.  Device-side evaluation
(`density_scaled_xyz`, `device_sampler_xyz`) is torch float32 on scaled
coordinates.  A geometry that the CUDA event kernel can evaluate also
names its device function and float32 constants (`cuda_density`,
`cuda_sampler`): the Pallas kernel traces the closed form into its body,
the CUDA kernel selects a `__device__` function by template parameter.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import rng


def _f32(v) -> float:
    """A constant rounded to float32, as a Python float: torch applies a
    Python scalar to a float32 tensor in float32, like JAX's weak types."""
    return float(np.float32(v))


class InverseCdf:
    """Tabulated inverse CDF: maps u in [0,1] to x by an equal-probability
    quantile table and one lerp (mirrors skirt_tpu's InverseCdf)."""

    def __init__(self, xv: np.ndarray, cdfv: np.ndarray, total: float):
        self.xv64 = np.asarray(xv)
        self.cdfv64 = np.asarray(cdfv)
        self.total = float(total)
        M = max(4096, self.xv64.size)
        self._M = M
        self.xq = np.asarray(
            np.interp(np.linspace(0.0, 1.0, M + 1), self.cdfv64, self.xv64),
            np.float32)

    def sample(self, u):
        xq = torch.as_tensor(self.xq, device=u.device)
        f = u * np.float32(self._M)
        i = torch.clamp(f.to(torch.int64), 0, self._M - 1)
        frac = f - i.to(torch.float32)
        x0 = xq[i]
        return x0 + frac * (xq[i + 1] - x0)


def build_inverse_cdf(pdf, xmin: float, xmax: float, n: int = 8192,
                      log: bool = False, log_floor: float = 0.0) -> InverseCdf:
    """Inverse-CDF table for density `pdf` (NumPy callable) on [xmin, xmax]
    by trapezoid accumulation (log-spaced abscissae when log=True)."""
    if log:
        lo = log_floor if xmin <= 0 else xmin
        xv = np.concatenate([[xmin], np.logspace(np.log10(lo), np.log10(xmax), n - 1)]) \
            if xmin <= 0 else np.logspace(np.log10(xmin), np.log10(xmax), n)
    else:
        xv = np.linspace(xmin, xmax, n)
    pv = np.clip(np.asarray(pdf(xv), dtype=np.float64), 0.0, None)
    seg = 0.5 * (pv[1:] + pv[:-1]) * np.diff(xv)
    cdf = np.concatenate([[0.0], np.cumsum(seg)])
    total = cdf[-1]
    if total <= 0:
        raise ValueError("profile has zero integral on the requested range")
    return InverseCdf(xv, cdf / total, total)


class Geometry:
    """A normalized (unit total mass) spatial density distribution.

    Subclasses implement `density(pos)` (NumPy SI positions (..., 3)) and
    `generate_position(key, n, device)`.  Directions are isotropic.
    """

    dimension = 3
    is_isotropic = True

    def density(self, pos):
        raise NotImplementedError

    def generate_position(self, key: int, n: int, device="cpu"):
        raise NotImplementedError

    def generate_direction(self, key: int, ell, pos):
        return rng.isotropic_direction(key, pos.shape[:-1], pos.device,
                                       pos.dtype)

    def sigma_x(self) -> float:
        raise NotImplementedError

    def sigma_y(self) -> float:
        raise NotImplementedError

    def sigma_z(self) -> float:
        raise NotImplementedError

    # -- analytic-density traversal support ------------------------------
    # density_scaled_xyz(x_s, y_s, z_s, lscale) returns rho(pos)*lscale**3
    # from O(1) scaled coordinates pos/lscale.  It must be float32-safe:
    # divide by scale lengths BEFORE any squaring (SI metres overflow
    # float32 when squared) and fold the rho0*lscale**3 prefactor in
    # float64 on the host (SI densities underflow float32).

    @property
    def supports_analytic(self) -> bool:
        generic = (Geometry, AxGeometry)
        if type(self).density_scaled_xyz not in (c.density_scaled_xyz
                                                 for c in generic):
            return True
        return hasattr(self, "shape_rz")

    def density_scaled(self, pos_s, lscale: float):
        return self.density_scaled_xyz(pos_s[..., 0], pos_s[..., 1],
                                       pos_s[..., 2], lscale)

    def density_scaled_xyz(self, x_s, y_s, z_s, lscale: float):
        raise NotImplementedError(
            f"{type(self).__name__} has no analytic device density")

    def device_sampler_xyz(self):
        """Gather-free position sampler, or None: (nu, fn) where fn maps a
        list of nu uniform tensors to SI coordinates (x, y, z)."""
        return None

    def cuda_density(self, lscale: float):
        """(name, float32 constants) of this geometry's `__device__`
        density in csrc/fused_poly.cu, or None."""
        return None

    def cuda_sampler(self):
        """(name, float32 constants) of this geometry's `__device__`
        sampler in csrc/fused_poly.cu, or None."""
        return None


class AxGeometry(Geometry):
    """Axisymmetric geometry rho(R, z).  ref: SKIRTcore/AxGeometry."""

    dimension = 2

    def density(self, pos):
        pos = np.asarray(pos)
        R = np.sqrt(pos[..., 0] ** 2 + pos[..., 1] ** 2)
        return self.density_rz(R, pos[..., 2])

    def density_rz(self, R, z):
        raise NotImplementedError

    def density_scaled_xyz(self, x_s, y_s, z_s, lscale: float):
        """Generic analytic-mode density for subclasses with shape_rz
        (rho/rho0 as O(1) float32-safe math in R, z [m])."""
        if not hasattr(self, "shape_rz"):
            return Geometry.density_scaled_xyz(self, x_s, y_s, z_s, lscale)
        L = _f32(lscale)
        R = torch.sqrt(x_s * x_s + y_s * y_s) * L
        z = z_s * L
        pref = _f32(float(self.rho0) * lscale ** 3)
        return pref * self.shape_rz(R, z)

    @staticmethod
    def cylindrical_to_cartesian(key: int, R, z):
        phi = rng.uniform(key, R.shape, R.device, R.dtype) * (2.0 * np.pi)
        return torch.stack([R * torch.cos(phi), R * torch.sin(phi), z], dim=-1)
