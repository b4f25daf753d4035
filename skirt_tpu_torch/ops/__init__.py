"""Scatter-shaped ops (twin of skirt_tpu.ops)."""

from .binned import binned_add, drop_add  # noqa: F401
