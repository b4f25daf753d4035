"""Dust grids (twin of skirt_tpu.grids; slice 1 subset)."""

from .cartesian import CartesianGrid  # noqa: F401
