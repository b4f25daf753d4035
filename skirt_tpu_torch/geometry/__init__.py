"""Geometries (twin of skirt_tpu.geometry; ported subset)."""

from .axial import ExpDiskGeometry, TorusGeometry  # noqa: F401
from .base import AxGeometry, Geometry  # noqa: F401
from .general import PointGeometry, UniformSphereGeometry  # noqa: F401
