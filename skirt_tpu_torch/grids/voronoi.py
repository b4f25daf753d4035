"""Unstructured Voronoi dust grid: the host build, the approximate voxel
view and the device point location of the table paths.

Twin of skirt_tpu/grids/voronoi.py::VoronoiGrid (slice S4b-2: everything
the table paths need).  ref: SKIRTcore/VoronoiDustGrid.cpp:37-230 and
VoronoiMesh.cpp (Camps et al. 2013): Voro++ cells with neighbour lists,
block lists for point location (:367-393, cellIndex :512-543).

The host build is skirt_tpu's, step for step: exact volumes, centroids
and neighbour lists from the native clipping builder (`native`, the
Voro++ role; scipy ridges with Monte Carlo volumes without a compiler),
the padded neighbour table, one seeded Monte Carlo pass (cKDTree owners)
for the padded bounding boxes and the cell densities, and the float32
tables in domain-scaled units.  So the tables come out identical.

Device point location (`locate_batched`) is exact nearest-site search
in scaled float32 coordinates, by skirt_tpu's three schemes: up to
_SCAN_MAX_SITES sites a chunked distance scan (|s|^2 - 2 p.s); above, a
per-block candidate-row table ([X|Y|Z|I] rows, one row per point); where
that table would exceed its byte budget, a walk down the adjacency graph
from a seed map.  Here they are plain torch: the scan's product is full
float32 and elementwise, so no TF32 setting reaches it, every argmin
takes the first minimum, and points go in chunks so a gathered row block
or distance tile stays under _LOCATE_CHUNK_FLOATS floats (512 MB on the
card; 1 MB on the CPU, where tiles that stay in cache run ~3x faster).
The walk's stop test reads the device once per step and chunk (a host
sync; a good seed converges in one to three steps).  Not here: the
bisector walk of the unfused lifecycle (`start`/`enter`/`step`, slice
S2b) and the device in-cell sampler of the import launch
(`random_position_in_cell_dev`, S3).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from scipy.spatial import Voronoi, cKDTree

from .. import trace

_BIG = 3.4e38

# bound on the floats a locate chunk gathers (rows or distance tiles), by
# device type.  The card's: chip_smoke.py's locate-chunk probe (2^22
# points on 33,000 sites, H100 80GB HBM3 at 700 W) took 52.6 ms of device
# time at 64 MB, 24.2 at 256 MB, 23.0 at 512 MB (1.5 GiB peak) and 22.4 at
# 1 GB (2.7 GiB peak)
_LOCATE_CHUNK_FLOATS = {"cuda": 1 << 27, "cpu": 1 << 18}


def _f32(v) -> float:
    return float(np.float32(v))


class VoronoiGrid:
    """Voronoi tessellation of a box from generating sites (SI metres)."""

    dimension = 3
    voxelize_exact = False     # nearest-site rasterization approximates

    # site count up to which point location scans every site (skirt_tpu's
    # threshold; above it the block-candidate table)
    _SCAN_MAX_SITES = 2048

    def __init__(self, sites: np.ndarray, extent, *,
                 volume_samples: int = 64, seed: int = 31337,
                 use_native: bool = True):
        """sites: (N, 3) generating points [m]; extent: domain box
        (xmin, ymin, zmin, xmax, ymax, zmax).  volume_samples: Monte Carlo
        samples per cell (on average) for the boxes and densities."""
        self.extent = np.asarray(extent, dtype=np.float64)
        lo, hi = self.extent[:3], self.extent[3:]
        sites = np.asarray(sites, dtype=np.float64)
        if not np.all((sites >= lo) & (sites <= hi)):
            raise ValueError("all sites must lie inside the domain extent")
        self.sites64 = sites
        ncells = sites.shape[0]

        # -- neighbour adjacency + exact volumes ---------------------------
        native_out = None
        if use_native:
            from .. import native
            native_out = native.voronoi_cells(sites, self.extent)
            if native_out is None:
                warnings.warn(
                    "VoronoiGrid: the native cell builder is unavailable ("
                    f"{native.load_error}); falling back to scipy ridges "
                    "with Monte Carlo volumes")
        self.used_native = native_out is not None
        if native_out is not None:
            volumes, centroids, nbr_data, nbr_off = native_out
            nbr_lists = [list(map(int, nbr_data[nbr_off[i]:nbr_off[i + 1]]))
                         for i in range(ncells)]
            self.volumes64 = volumes
            self.centroids64 = centroids
        else:
            vor = Voronoi(sites)
            nbr_lists = [[] for _ in range(ncells)]
            for a, b in vor.ridge_points:
                nbr_lists[a].append(int(b))
                nbr_lists[b].append(int(a))
            self.volumes64 = None  # filled by the MC pass below
            self.centroids64 = sites
        kmax = max(max(len(v) for v in nbr_lists), 1)
        nbrs = np.full((ncells, kmax), -1, dtype=np.int64)
        for i, v in enumerate(nbr_lists):
            uniq = sorted(set(v))[:kmax]
            nbrs[i, :len(uniq)] = uniq
        self.nbrs64 = nbrs

        # -- MC pass: bounding boxes + density hooks (+ volume fallback) ---
        rng_np = np.random.default_rng(seed)
        tree = cKDTree(sites)
        nsamp = int(volume_samples) * ncells
        pts = rng_np.uniform(lo, hi, size=(nsamp, 3))
        _, owner = tree.query(pts, workers=-1)
        box_vol = float(np.prod(hi - lo))
        if self.volumes64 is None:
            counts = np.bincount(owner, minlength=ncells).astype(np.float64)
            self.volumes64 = counts / nsamp * box_vol
        self._mc_pts = pts
        self._mc_owner = owner
        # cell bounding boxes from the samples, padded by the mean sample
        # spacing, for in-cell position sampling
        bb_lo = sites.copy()
        bb_hi = sites.copy()
        np.minimum.at(bb_lo, owner, pts)
        np.maximum.at(bb_hi, owner, pts)
        pad = (box_vol / nsamp) ** (1.0 / 3.0)
        self.bb_lo64 = np.maximum(bb_lo - pad, lo)
        self.bb_hi64 = np.minimum(bb_hi + pad, hi)
        self._finalize(tree)

    @classmethod
    def from_tables(cls, *, sites64, extent, volumes64, centroids64, nbrs64,
                    bb_lo64, bb_hi64, mc_pts, mc_owner, used_native):
        """A grid over already built host tables (a skirt_tpu grid carried
        across): the float32 and device tables derive from them as the
        constructor derives them."""
        g = cls.__new__(cls)
        g.extent = np.asarray(extent, np.float64)
        g.sites64 = np.asarray(sites64, np.float64)
        g.volumes64 = np.asarray(volumes64, np.float64)
        g.centroids64 = np.asarray(centroids64, np.float64)
        g.nbrs64 = np.asarray(nbrs64, np.int64)
        g.bb_lo64 = np.asarray(bb_lo64, np.float64)
        g.bb_hi64 = np.asarray(bb_hi64, np.float64)
        g._mc_pts = np.asarray(mc_pts, np.float64)
        g._mc_owner = np.asarray(mc_owner)
        g.used_native = bool(used_native)
        g._finalize(cKDTree(g.sites64))
        return g

    def _finalize(self, tree):
        """The derived state: box, scale, float32 scaled tables."""
        lo, hi = self.extent[:3], self.extent[3:]
        self.ncells = self.sites64.shape[0]
        self.kmax = self.nbrs64.shape[1]
        self.scale = float(np.max(hi - lo))
        self._lo = lo
        self._hi = hi
        self._tree = tree
        inv = 1.0 / self.scale
        self._sites_np = np.asarray(self.sites64 * inv, np.float32)
        self._nbrs_np = np.asarray(self.nbrs64, np.int32)
        self._lo_np = np.asarray(lo * inv, np.float32)
        self._hi_np = np.asarray(hi * inv, np.float32)
        self._bb_lo_np = np.asarray(self.bb_lo64 * inv, np.float32)
        self._bb_hi_np = np.asarray(self.bb_hi64 * inv, np.float32)
        self.max_steps = 8 * int(np.ceil(self.ncells ** (1.0 / 3.0))) + 16
        self._dev_tables = {}

    # -- host metadata -----------------------------------------------------

    def voxelize(self, max_voxels: int = 1 << 24,
                 resolution: int | None = None):
        """APPROXIMATE uniform-voxel view: nearest-site rasterization of
        the voxel centres.  Voronoi walls cut voxels, so the voxel field
        differs from the tessellation at the voxel scale (the dust
        system measures the difference, `DustSystem.voxelized`).  Default
        resolution ~8 voxels per cell per axis, capped by max_voxels.
        Returns (CartesianGrid, cell_of_voxel)."""
        from .cartesian import CartesianGrid

        lo, hi = self._lo, self._hi
        if resolution is None:
            resolution = int(min(8.0 * self.ncells ** (1.0 / 3.0),
                                 np.floor(max_voxels ** (1.0 / 3.0))))
        n = max(int(resolution), 8)
        if n ** 3 > max_voxels:
            n = int(np.floor(max_voxels ** (1.0 / 3.0)))
        axes = [np.linspace(lo[a], hi[a], n + 1) for a in range(3)]
        centers = [0.5 * (b[:-1] + b[1:]) for b in axes]
        X, Y, Z = np.meshgrid(*centers, indexing="ij")
        pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)
        _, cell_of = cKDTree(self.sites64).query(pts, workers=-1)
        return (CartesianGrid(axes[0], axes[1], axes[2]),
                cell_of.astype(np.int32))

    def bounding_box(self):
        return tuple(self.extent)

    def cell_volumes(self) -> np.ndarray:
        return self.volumes64

    def cell_centers(self) -> np.ndarray:
        return self.sites64

    def random_positions_in_cells(self, rng_np: np.random.Generator,
                                  cells: np.ndarray) -> np.ndarray:
        """Host-side in-cell sampling by nearest-site rejection."""
        out = np.empty((cells.size, 3))
        pending = np.arange(cells.size)
        for _ in range(200):
            if pending.size == 0:
                break
            c = cells[pending]
            u = rng_np.uniform(size=(pending.size, 3))
            p = self.bb_lo64[c] + u * (self.bb_hi64[c] - self.bb_lo64[c])
            _, owner = self._tree.query(p, workers=-1)
            ok = owner == c
            out[pending[ok]] = p[ok]
            pending = pending[~ok]
        if pending.size:
            out[pending] = self.sites64[cells[pending]]
        return out

    def sample_cell_densities(self, density_fn) -> np.ndarray:
        """Mean density per cell from the construction-time MC samples."""
        rho = np.asarray(density_fn(self._mc_pts))
        sums = np.zeros(self.ncells)
        np.add.at(sums, self._mc_owner, rho)
        counts = np.bincount(self._mc_owner, minlength=self.ncells)
        return sums / np.maximum(counts, 1)

    # -- locate tables (host builds, lazily) --------------------------------

    def _ensure_blocks(self):
        """The per-block candidate tables (skirt_tpu's build, step for
        step).  For a block with centre c and half-diagonal r, every point
        p of the block has its nearest site within min(dnn(c) + 2r,
        min_corner dnn + 3r) of c, so the candidate list of all sites
        within that radius holds the nearest site of every point of the
        block.  Rows are [X(K) | Y(K) | Z(K) | I(K)] in scaled float32,
        pads at 1e9 (never nearest); K a multiple of 32; the coarsest block
        resolution whose table fits 96 MB wins, else no table (None)."""
        if hasattr(self, "_blk_flat_np"):
            return
        if self.ncells >= (1 << 24):   # float32 cannot hold the index
            warnings.warn(
                f"{type(self).__name__}: {self.ncells} sites exceed the "
                "float32 index range of the block-candidate table; point "
                "location falls back to the O(N)-per-point distance scan")
            self._blk_flat_np = None
            return
        budget_bytes = 96 << 20
        lo, hi = self._lo, self._hi
        for mult in (3.0, 2.0, 1.5, 1.0, 0.75):
            nb = int(np.clip(round(mult * self.ncells ** (1.0 / 3.0)),
                             2, 256))
            bsize = (hi - lo) / nb
            ax = [lo[k] + (np.arange(nb) + 0.5) * bsize[k]
                  for k in range(3)]
            centers = np.stack(np.meshgrid(*ax, indexing="ij"),
                               axis=-1).reshape(-1, 3)
            r = 0.5 * float(np.linalg.norm(bsize))
            offs = np.stack(np.meshgrid(*([[-0.5, 0.5]] * 3),
                                        indexing="ij"),
                            axis=-1).reshape(-1, 3)
            corners = (centers[:, None, :]
                       + offs[None, :, :] * bsize[None, None, :])
            dcorn, _ = self._tree.query(corners.reshape(-1, 3), workers=-1)
            dnn_min = dcorn.reshape(-1, 8).min(axis=1)
            dcent, _ = self._tree.query(centers, workers=-1)
            radius = np.minimum(dcent + 2.0 * r, dnn_min + 3.0 * r)
            counts = self._tree.query_ball_point(centers, radius,
                                                 workers=-1,
                                                 return_length=True)
            kc = max(int(np.max(counts)), 1)
            kpad = -(-kc // 32) * 32
            if nb ** 3 * 4 * kpad * 4 <= budget_bytes:
                break
        else:
            warnings.warn(
                f"VoronoiGrid: block-candidate table exceeds the "
                f"{budget_bytes >> 20} MB budget at every block "
                "resolution (clustered sites); falling back to the "
                "neighbour walk for point location")
            self._blk_flat_np = None
            return
        cand = self._tree.query_ball_point(centers, radius, workers=-1)
        flat = np.empty((nb ** 3, 4 * kpad), np.float32)
        flat[:, 0 * kpad:3 * kpad] = 1e9    # pad coords: never nearest
        flat[:, 3 * kpad:] = 0.0
        sites = self._sites_np
        for i, c in enumerate(cand):
            n = len(c)
            flat[i, 0 * kpad:0 * kpad + n] = sites[c, 0]
            flat[i, 1 * kpad:1 * kpad + n] = sites[c, 1]
            flat[i, 2 * kpad:2 * kpad + n] = sites[c, 2]
            flat[i, 3 * kpad:3 * kpad + n] = np.asarray(c, np.float32)
        self._blk_nb = nb
        self._blk_k = kpad
        self._blk_flat_np = flat
        inv = 1.0 / self.scale
        self._blk_lo_np = np.asarray(lo * inv, np.float32)
        self._blk_inv_np = np.asarray(1.0 / (bsize * inv), np.float32)

    def _ensure_walk(self):
        """The neighbour-walk tables (skirt_tpu's build): a coarse voxel
        seed map (voxel -> site nearest its centre) and per-cell
        [self + neighbours] rows [X|Y|Z|I](K).  A point moves to the
        strictly closest site of its current cell's row until the cell
        itself is closest; exact, since p lies in cell(s) iff it is closer
        to s than to every neighbour of s.  None above 96 MB."""
        if hasattr(self, "_walk_rows_np"):
            return
        Kp = -(-(self.nbrs64.shape[1] + 1) // 32) * 32
        if self.ncells * 4 * Kp * 4 > (96 << 20) or self.ncells >= (1 << 24):
            self._walk_rows_np = None
            return
        rows = np.empty((self.ncells, 4 * Kp), np.float32)
        rows[:, :3 * Kp] = 1e9      # pad coords: never nearest
        rows[:, 3 * Kp:] = 0.0
        sites = self._sites_np
        # entry 0 = the cell itself (an argmin tie stays: converged)
        rows[:, 0] = sites[:, 0]
        rows[:, Kp] = sites[:, 1]
        rows[:, 2 * Kp] = sites[:, 2]
        rows[:, 3 * Kp] = np.arange(self.ncells, dtype=np.float32)
        nbrs = self.nbrs64
        for j in range(nbrs.shape[1]):
            col = nbrs[:, j]
            idx = np.nonzero(col >= 0)[0]
            c = col[idx]
            rows[idx, 1 + j] = sites[c, 0]
            rows[idx, Kp + 1 + j] = sites[c, 1]
            rows[idx, 2 * Kp + 1 + j] = sites[c, 2]
            rows[idx, 3 * Kp + 1 + j] = c.astype(np.float32)
        self._walk_rows_np = rows
        self._walk_k = Kp
        ns = int(np.clip(round(1.5 * self.ncells ** (1.0 / 3.0)), 8, 128))
        lo, hi = self._lo, self._hi
        bs = (hi - lo) / ns
        ax = [lo[k] + (np.arange(ns) + 0.5) * bs[k] for k in range(3)]
        centers = np.stack(np.meshgrid(*ax, indexing="ij"),
                           axis=-1).reshape(-1, 3)
        _, seed = self._tree.query(centers, workers=-1)
        self._walk_seed_np = seed.astype(np.int32)
        self._walk_ns = ns
        inv = 1.0 / self.scale
        self._walk_lo_np = np.asarray(lo * inv, np.float32)
        self._walk_inv_np = np.asarray(1.0 / (bs * inv), np.float32)

    def locate_scheme(self):
        """(scheme, table bytes) of `locate_batched`: 'scan', 'blocks' or
        'walk' (building the tables if needed)."""
        if self.ncells <= self._SCAN_MAX_SITES:
            return "scan", self._sites_np.nbytes
        self._ensure_blocks()
        if self._blk_flat_np is not None:
            return "blocks", self._blk_flat_np.nbytes
        self._ensure_walk()
        if self._walk_rows_np is not None:
            return "walk", (self._walk_rows_np.nbytes
                            + self._walk_seed_np.nbytes)
        return "scan", self._sites_np.nbytes

    def _ensure_scan(self):
        """The scan's tables: the scaled sites transposed (3, C) and |s|^2,
        padded to whole 512-site chunks with 1e9 coordinates."""
        if hasattr(self, "_scan_sites_np"):
            return
        npad = (-self.ncells) % 512
        sites = np.concatenate([self._sites_np,
                                np.full((npad, 3), 1e9, np.float32)])
        self._scan_s2_np = np.sum(sites.astype(np.float64) ** 2,
                                  axis=-1).astype(np.float32)
        self._scan_sites_np = np.ascontiguousarray(sites.T)

    def _dev(self, name, dev):
        """The host table `name` (a NumPy attribute) on device `dev`: one
        host->device copy per device and table."""
        key = (name, dev)
        if key not in self._dev_tables:
            self._dev_tables[key] = torch.as_tensor(getattr(self, name),
                                                    device=dev)
        return self._dev_tables[key]

    # -- device-side -------------------------------------------------------

    def _scaled(self, pos):
        return pos * _f32(1.0 / self.scale)

    def nearest_site(self, p_scaled):
        """Nearest site index (int32) for scaled points (..., 3): exact, by
        the scheme `locate_scheme` names."""
        if self.ncells <= self._SCAN_MAX_SITES:
            return self._nearest_scan(p_scaled)
        self._ensure_blocks()
        if self._blk_flat_np is not None:
            return self._nearest_blocks(p_scaled)
        return self._nearest_walk(p_scaled)

    @staticmethod
    def _chunked(p2, width, fn):
        """fn over point chunks of p2 (M, 3) such that a (chunk, width)
        float temporary stays under _LOCATE_CHUNK_FLOATS; int32 (M,)."""
        budget = _LOCATE_CHUNK_FLOATS.get(p2.device.type, 1 << 27)
        chunk = max(1, budget // max(int(width), 1))
        if p2.shape[0] <= chunk:
            return fn(p2)
        return torch.cat([fn(p2[i:i + chunk])
                          for i in range(0, p2.shape[0], chunk)])

    def _nearest_scan(self, p):
        """argmin over sites of |s|^2 - 2 p.s (the |p|^2 term cancels),
        over 512-site chunks padded with 1e9 coordinates, a strict < across
        chunks.  The product is elementwise full float32 on every device
        (a matrix product could run as TF32 on the card)."""
        shape = p.shape[:-1]
        dev = p.device
        chunk = 512
        self._ensure_scan()
        sites_t = self._dev("_scan_sites_np", dev)
        s2_t = self._dev("_scan_s2_np", dev)
        nchunks = s2_t.shape[0] // chunk

        def one(q):
            best_d = torch.full((q.shape[0],), float("inf"),
                                dtype=torch.float32, device=dev)
            best_i = torch.zeros(q.shape[0], dtype=torch.int32, device=dev)
            for c in range(nchunks):
                sl = slice(c * chunk, (c + 1) * chunk)
                dot = (q[:, 0:1] * sites_t[0, sl]
                       + q[:, 1:2] * sites_t[1, sl]
                       + q[:, 2:3] * sites_t[2, sl])
                d = s2_t[None, sl] - 2.0 * dot
                dmin, i = torch.min(d, dim=1)
                better = dmin < best_d
                best_d = torch.where(better, dmin, best_d)
                best_i = torch.where(better, (i + c * chunk).to(torch.int32),
                                     best_i)
            return best_i

        return self._chunked(p.reshape(-1, 3), chunk, one).reshape(shape)

    @staticmethod
    def _row_argmin(q, r, K):
        """Index (int32) of the site of row r (M, 4K) nearest q (M, 3):
        (q - s)^2 summed x, y, z, the first minimum."""
        dx = q[:, 0:1] - r[:, :K]
        dy = q[:, 1:2] - r[:, K:2 * K]
        dz = q[:, 2:3] - r[:, 2 * K:3 * K]
        d = dx * dx + dy * dy + dz * dz
        k = torch.argmin(d, dim=1)
        return r[:, 3 * K:].gather(1, k[:, None])[:, 0].to(torch.int32)

    def _nearest_blocks(self, p):
        self._ensure_blocks()
        if self._blk_flat_np is None:   # table over budget: exact fallback
            return self._nearest_walk(p)
        shape = p.shape[:-1]
        dev = p.device
        nb, K = self._blk_nb, self._blk_k
        flat = self._dev("_blk_flat_np", dev)
        lo = self._dev("_blk_lo_np", dev)
        inv = self._dev("_blk_inv_np", dev)

        def one(q):
            ib = torch.clamp(torch.floor((q - lo) * inv).to(torch.int32),
                             0, nb - 1)
            blk = (ib[:, 0] * nb + ib[:, 1]) * nb + ib[:, 2]
            return self._row_argmin(q, flat[blk.long()], K)

        return self._chunked(p.reshape(-1, 3), 4 * K, one).reshape(shape)

    def _nearest_walk(self, p):
        self._ensure_walk()
        if self._walk_rows_np is None:
            return self._nearest_scan(p)
        shape = p.shape[:-1]
        dev = p.device
        ns, K = self._walk_ns, self._walk_k
        rows = self._dev("_walk_rows_np", dev)
        seed = self._dev("_walk_seed_np", dev)
        lo = self._dev("_walk_lo_np", dev)
        inv = self._dev("_walk_inv_np", dev)

        def one(q):
            iv = torch.clamp(torch.floor((q - lo) * inv).to(torch.int32),
                             0, ns - 1)
            s = seed[((iv[:, 0] * ns + iv[:, 1]) * ns + iv[:, 2]).long()]
            # each move strictly decreases the distance, so the walk ends;
            # the cap of 256 steps is a safety net (skirt_tpu's)
            for _ in range(256):
                s_new = self._row_argmin(q, rows[s.long()], K)
                moved = bool((s_new != s).any())     # one host sync
                s = s_new
                if not moved:
                    break
            return s

        return self._chunked(p.reshape(-1, 3), 4 * K, one).reshape(shape)

    def locate_batched(self, points):
        """Flat cell ids (int32) of point batches (..., 3) in metres, -1
        outside the domain box."""
        with trace.span("locate"):
            p = self._scaled(points)
            lo, hi = (self._dev(n, p.device) for n in ("_lo_np", "_hi_np"))
            inside = ((p >= lo) & (p <= hi)).all(dim=-1)
            return torch.where(inside, self.nearest_site(p),
                               -1).to(torch.int32)

    def locate(self, pos):
        """The cell of each position (skirt_tpu's start().cell)."""
        return self.locate_batched(pos)

    def ray_span(self, pos, direction):
        """(t_start, t_stop) of each ray inside the domain box, in metres
        (the slab test in scaled float32 units, times the scale)."""
        p = self._scaled(pos)
        lo, hi = (self._dev(n, p.device) for n in ("_lo_np", "_hi_np"))
        moving = torch.abs(direction) > 1e-30
        inv = 1.0 / torch.where(moving, direction, 1.0)
        t1 = (lo - p) * inv
        t2 = (hi - p) * inv
        in_slab = (p >= lo) & (p <= hi)
        near = torch.where(moving, torch.minimum(t1, t2),
                           torch.where(in_slab, -_BIG, _BIG))
        far = torch.where(moving, torch.maximum(t1, t2),
                          torch.where(in_slab, _BIG, -_BIG))
        t_near = near.amax(dim=-1)
        t_far = far.amin(dim=-1)
        t_start = torch.clamp(t_near, min=0.0)
        hit = (t_start <= t_far) & (t_far > 0)
        t_start = torch.where(hit, t_start, 0.0)
        t_stop = torch.where(hit, t_far, t_start)
        return t_start * self.scale, t_stop * self.scale
