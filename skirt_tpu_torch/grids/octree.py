"""Adaptive octree dust grid: the host build and its exact voxel view.

Twin of skirt_tpu/grids/octree.py::OctreeGrid (slice S4a: everything the
table path needs).  ref: SKIRTcore/TreeDustGrid.cpp:50-233 (BFS
subdivision with maxMassFraction / maxDensDispFraction criteria, density
estimated by uniform MC sampling per node), OctTreeDustGrid.cpp, leaf-id
<-> cell-number tables (:112-123).

Construction is host-side NumPy with the JAX package's draw order, so the
leaves, their cell numbers and the voxel view come out identical.  The
table path traces the exact uniform-voxel view (`voxelize`) through the
Cartesian panel quadrature.  The device tree walk of the unfused
lifecycle (`descend`, `enter`, `step`, `locate_batched`, the neighbor
search) belongs to slice S2b: this grid has no `ray_span` or
`locate_batched`, so the gridded walk and table mode directly on the tree
refuse it.
"""

from __future__ import annotations

import numpy as np


class OctreeGrid:
    """Octree over a rectangular domain, adaptively refined on a dust
    density field (host build; see the module docstring)."""

    dimension = 3
    voxelize_exact = True      # leaves are unions of finest-level voxels

    def __init__(self, extent, density_fn=None, *, min_level: int = 2,
                 max_level: int = 6, max_mass_fraction: float = 1e-6,
                 samples_per_node: int = 100, seed: int = 9157,
                 max_dens_disp_fraction: float = 0.0,
                 subdivision: str = "midpoint"):
        """extent: (xmin, ymin, zmin, xmax, ymax, zmax) in metres.

        density_fn(pos: (n, 3) float64) -> density (host callable); nodes
        with mass fraction above max_mass_fraction subdivide until
        max_level.  subdivision: 'midpoint' (ref: OctTreeNode) or
        'barycentric' (ref: BaryOctTreeNode.cpp; its leaves are not voxel
        unions, so voxelize() returns None).  skirt_tpu's `traversal`
        choice names the device walk of the unfused lifecycle (slice S2b)
        and is not taken here."""
        self.extent = np.asarray(extent, dtype=np.float64)
        if subdivision not in ("midpoint", "barycentric"):
            raise ValueError("subdivision must be 'midpoint' or "
                             "'barycentric'")
        self.subdivision = subdivision
        if subdivision == "barycentric":
            self.voxelize_exact = False
        lo = self.extent[:3]
        hi = self.extent[3:]
        if np.any(hi <= lo):
            raise ValueError("invalid extent")

        rng_np = np.random.default_rng(seed)

        # --- BFS subdivision (host) --------------------------------------
        boxes_lo = [lo.copy()]
        boxes_hi = [hi.copy()]
        levels = [0]
        children = [-1]  # child base index per node (-1 = leaf for now)

        def node_mass(los, his):
            """MC mass estimate for a batch of boxes: mean rho * volume,
            the samples, and the density barycentre (midpoint for empty
            nodes, clamped 5% inside the walls).
            ref: TreeDustGrid.cpp:190-229."""
            n = los.shape[0]
            s = samples_per_node
            u = rng_np.uniform(size=(n, s, 3))
            pos = los[:, None, :] + u * (his - los)[:, None, :]
            rho = np.asarray(density_fn(pos.reshape(-1, 3))).reshape(n, s)
            vol = np.prod(his - los, axis=1)
            w = rho[:, :, None]
            wsum = w.sum(axis=1)
            midp = 0.5 * (los + his)
            with np.errstate(invalid="ignore"):
                bary = (pos * w).sum(axis=1) / np.where(wsum > 0, wsum, 1.0)
            bary = np.where(wsum > 0, bary, midp)
            bary = np.clip(bary, los + 0.05 * (his - los),
                           his - 0.05 * (his - los))
            return rho.mean(axis=1) * vol, rho, bary

        # the total mass comes from the stratified min-level frontier (a
        # single root-box MC estimate badly misses compact structures)
        total_mass = None

        frontier = [0]
        while frontier:
            los = np.array([boxes_lo[i] for i in frontier])
            his = np.array([boxes_hi[i] for i in frontier])
            lvls = np.array([levels[i] for i in frontier])
            if density_fn is not None and total_mass is None \
                    and lvls.min() >= min_level:
                masses, _, _b = node_mass(los, his)
                total_mass = float(masses.sum())
                if total_mass <= 0:
                    total_mass = None
            if density_fn is not None and total_mass:
                masses, rhos, barys = node_mass(los, his)
                mass_frac = masses / total_mass
                disp_ok = np.zeros(len(frontier), dtype=bool)
                if max_dens_disp_fraction > 0:
                    mean = rhos.mean(axis=1)
                    disp = np.where(mean > 0, rhos.std(axis=1)
                                    / np.maximum(mean, 1e-300), 0.0)
                    disp_ok = disp > max_dens_disp_fraction
                needs = (lvls < min_level) | (
                    (lvls < max_level)
                    & ((mass_frac > max_mass_fraction) | disp_ok))
            else:
                needs = lvls < min_level
            next_frontier = []
            have_bary = (self.subdivision == "barycentric"
                         and density_fn is not None and total_mass)
            for idx, parent in enumerate(frontier):
                if not needs[idx]:
                    continue
                base = len(boxes_lo)
                children[parent] = base
                plo, phi = boxes_lo[parent], boxes_hi[parent]
                mid = barys[idx] if have_bary else 0.5 * (plo + phi)
                for octant in range(8):
                    sel = [octant & 1, octant & 2, octant & 4]
                    clo = np.where(sel, mid, plo)
                    chi = np.where(sel, phi, mid)
                    boxes_lo.append(clo.astype(np.float64))
                    boxes_hi.append(chi.astype(np.float64))
                    levels.append(levels[parent] + 1)
                    children.append(-1)
                    next_frontier.append(base + octant)
            frontier = next_frontier

        self._finalize(boxes_lo, boxes_hi, levels, children)

    def _finalize(self, boxes_lo, boxes_hi, levels, children):
        """Freeze the tree topology into flat arrays and number the leaves
        (ref: TreeDustGrid.cpp:112-123)."""
        self.nnodes = len(boxes_lo)
        self.lo64 = np.array(boxes_lo)
        self.hi64 = np.array(boxes_hi)
        self.child64 = np.array(children, dtype=np.int64)
        self.levels = np.array(levels)
        self.max_depth = int(self.levels.max())
        self.leaf_nodes = np.nonzero(self.child64 < 0)[0]
        self.ncells = int(self.leaf_nodes.size)
        cellnum = np.full(self.nnodes, -1, dtype=np.int64)
        cellnum[self.leaf_nodes] = np.arange(self.ncells)
        self.cellnum64 = cellnum

    # -- host metadata -----------------------------------------------------

    def voxelize(self, max_voxels: int = 1 << 24):
        """Exact uniform-voxel view: (CartesianGrid, cell_of_voxel).

        Midpoint subdivision puts every leaf wall on the lattice of the
        finest leaf size per axis, so rasterizing leaf ids onto that
        uniform grid represents the same piecewise-constant density field
        exactly.  Returns None when the voxel count would exceed
        `max_voxels` or the subdivision is barycentric (leaf walls off the
        lattice)."""
        if not self.voxelize_exact:
            return None
        from .cartesian import CartesianGrid

        lo = self.extent[:3]
        hi = self.extent[3:]
        leaf_lo = self.lo64[self.leaf_nodes]
        leaf_hi = self.hi64[self.leaf_nodes]
        widths = leaf_hi - leaf_lo
        res = np.array([int(round((hi[a] - lo[a]) / widths[:, a].min()))
                        for a in range(3)], dtype=np.int64)
        if int(np.prod(res)) > max_voxels:
            return None
        dx = (hi - lo) / res
        i0 = np.rint((leaf_lo - lo) / dx).astype(np.int64)
        i1 = np.rint((leaf_hi - lo) / dx).astype(np.int64)
        cell_of = np.empty(tuple(res), np.int32)
        for c in range(self.ncells):
            cell_of[i0[c, 0]:i1[c, 0], i0[c, 1]:i1[c, 1],
                    i0[c, 2]:i1[c, 2]] = c
        cart = CartesianGrid(np.linspace(lo[0], hi[0], res[0] + 1),
                             np.linspace(lo[1], hi[1], res[1] + 1),
                             np.linspace(lo[2], hi[2], res[2] + 1))
        return cart, cell_of.ravel()

    def bounding_box(self):
        return tuple(self.extent)

    def cell_volumes(self) -> np.ndarray:
        d = self.hi64[self.leaf_nodes] - self.lo64[self.leaf_nodes]
        return np.prod(d, axis=1)

    def cell_centers(self) -> np.ndarray:
        return 0.5 * (self.lo64[self.leaf_nodes] + self.hi64[self.leaf_nodes])

    def random_positions_in_cells(self, rng_np: np.random.Generator,
                                  cells: np.ndarray) -> np.ndarray:
        nodes = self.leaf_nodes[cells]
        u = rng_np.uniform(size=(cells.size, 3))
        return self.lo64[nodes] + u * (self.hi64[nodes] - self.lo64[nodes])
