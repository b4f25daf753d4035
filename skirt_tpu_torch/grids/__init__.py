"""Dust grids (twin of skirt_tpu.grids; ported subset)."""

from .cartesian import CartesianGrid, TwoPhaseGrid  # noqa: F401
from .octree import OctreeGrid  # noqa: F401
from .voronoi import VoronoiGrid  # noqa: F401
