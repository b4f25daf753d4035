"""Geometries (twin of skirt_tpu.geometry; slice 1 subset)."""

from .axial import ExpDiskGeometry  # noqa: F401
from .base import AxGeometry, Geometry  # noqa: F401
from .general import PointGeometry  # noqa: F401
