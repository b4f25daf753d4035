"""Dust grids (twin of skirt_tpu.grids; ported subset)."""

from .cartesian import CartesianGrid  # noqa: F401
from .octree import OctreeGrid  # noqa: F401
