"""Scatter-shaped ops (twin of skirt_tpu.ops)."""

from .bin_sum import bin_sum_add, bin_sum_plain  # noqa: F401
from .binned import binned_add, drop_add  # noqa: F401
from .binned import (bincount_blocked_plain, binned_add_lm,  # noqa: F401
                     blocked_layout, lm_to_cell_major)
