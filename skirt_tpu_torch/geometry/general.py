"""General geometries.

Twin of skirt_tpu/geometry/general.py (slice 1: PointGeometry).
ref: SKIRTcore/PointGeometry.cpp.
"""

from __future__ import annotations

import numpy as np
import torch

from ..devices import resolve
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
