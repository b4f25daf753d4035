"""Numerical helpers the port's modules share.

The twin of skirt_tpu/numerics.py by name; its grids, interpolation and
CDF sampling join this module with the panchromatic loop (slice S3).
"""

from __future__ import annotations

import numpy as np


def f32(v) -> float:
    """A constant rounded to float32, as a Python float: torch applies a
    Python scalar to a float32 tensor in float32, like JAX's weak types,
    so the constant carries the bits the float32 kernels close over."""
    return float(np.float32(v))
