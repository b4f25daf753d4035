"""3-D rectilinear Cartesian dust grid.

Twin of skirt_tpu/grids/cartesian.py: the host metadata, the
uniform-spacing detection the event kernels' arithmetic locate relies
on, the in-domain ray span of the panel quadrature (slice 1), and the
point locates the table path gathers with (slice S4a), and the two-phase
grid whose random cell weights scale the gridded densities.
ref: SKIRTcore/CartesianDustGrid.cpp, TwoPhaseDustGrid.cpp.
"""

from __future__ import annotations

import numpy as np
import torch

from ..numerics import f32

_BIG = 3.4e38


class CartesianGrid:
    """Rectilinear grid from three border arrays (SI metres)."""

    dimension = 3

    def __init__(self, xborders, yborders, zborders):
        self.xb64 = np.asarray(xborders, dtype=np.float64)
        self.yb64 = np.asarray(yborders, dtype=np.float64)
        self.zb64 = np.asarray(zborders, dtype=np.float64)
        for b in (self.xb64, self.yb64, self.zb64):
            if b.ndim != 1 or b.size < 2 or np.any(np.diff(b) <= 0):
                raise ValueError("borders must be strictly increasing 1-D arrays")
        self.nx = self.xb64.size - 1
        self.ny = self.yb64.size - 1
        self.nz = self.zb64.size - 1
        self.ncells = self.nx * self.ny * self.nz
        self.xb = np.asarray(self.xb64, np.float32)
        self.yb = np.asarray(self.yb64, np.float32)
        self.zb = np.asarray(self.zb64, np.float32)
        self.max_steps = self.nx + self.ny + self.nz + 4

        # uniform spacing: the cell locate is arithmetic
        def uniform(b):
            d = np.diff(b)
            return np.allclose(d, d[0], rtol=1e-6)

        self._uniform = (uniform(self.xb64), uniform(self.yb64),
                         uniform(self.zb64))
        self._lo = (float(self.xb64[0]), float(self.yb64[0]),
                    float(self.zb64[0]))
        self._dx = (float(self.xb64[1] - self.xb64[0]),
                    float(self.yb64[1] - self.yb64[0]),
                    float(self.zb64[1] - self.zb64[0]))
        self._box_dev = {}        # device -> float32 (lo, hi) box corners

    # -- host-side cell metadata ------------------------------------------

    def bounding_box(self):
        return (self.xb64[0], self.yb64[0], self.zb64[0],
                self.xb64[-1], self.yb64[-1], self.zb64[-1])

    def cell_volumes(self) -> np.ndarray:
        dx = np.diff(self.xb64)
        dy = np.diff(self.yb64)
        dz = np.diff(self.zb64)
        return (dx[:, None, None] * dy[None, :, None] * dz[None, None, :]).ravel()

    def cell_centers(self) -> np.ndarray:
        cx = 0.5 * (self.xb64[:-1] + self.xb64[1:])
        cy = 0.5 * (self.yb64[:-1] + self.yb64[1:])
        cz = 0.5 * (self.zb64[:-1] + self.zb64[1:])
        g = np.stack(np.meshgrid(cx, cy, cz, indexing="ij"), axis=-1)
        return g.reshape(-1, 3)

    def random_positions_in_cells(self, rng_np: np.random.Generator,
                                  cells: np.ndarray) -> np.ndarray:
        """Uniform positions inside the given cells (host side, setup MC)."""
        ix, iy, iz = self._split_np(cells)
        u = rng_np.uniform(size=(cells.size, 3))
        x = self.xb64[ix] + u[:, 0] * (self.xb64[ix + 1] - self.xb64[ix])
        y = self.yb64[iy] + u[:, 1] * (self.yb64[iy + 1] - self.yb64[iy])
        z = self.zb64[iz] + u[:, 2] * (self.zb64[iz + 1] - self.zb64[iz])
        return np.stack([x, y, z], axis=-1)

    def _split_np(self, cells):
        iz = cells % self.nz
        iy = (cells // self.nz) % self.ny
        ix = cells // (self.ny * self.nz)
        return ix, iy, iz

    # -- device-side --------------------------------------------------------

    def ray_span(self, pos, direction):
        """(t_start, t_stop) of each ray inside the bounding box (slab test);
        rays that miss give t_start == t_stop.  pos, direction: (N, 3).
        The box corners go to a device once: a host-to-device copy of a
        host array waits for the device to catch up."""
        box = self._box_dev.get(pos.device)
        if box is None:
            box = self._box_dev[pos.device] = (
                torch.tensor([self.xb[0], self.yb[0], self.zb[0]],
                             dtype=torch.float32, device=pos.device),
                torch.tensor([self.xb[-1], self.yb[-1], self.zb[-1]],
                             dtype=torch.float32, device=pos.device))
        lo, hi = box
        moving = torch.abs(direction) > 1e-30
        inv = 1.0 / torch.where(moving, direction, 1.0)
        t1 = (lo - pos) * inv
        t2 = (hi - pos) * inv
        in_slab = (pos >= lo) & (pos <= hi)
        near = torch.where(moving, torch.minimum(t1, t2),
                           torch.where(in_slab, -_BIG, _BIG))
        far = torch.where(moving, torch.maximum(t1, t2),
                          torch.where(in_slab, _BIG, -_BIG))
        t_near = near.amax(dim=-1)
        t_far = far.amin(dim=-1)
        t_start = torch.clamp(t_near, min=0.0)
        hit = (t_start <= t_far) & (t_far > 0)
        t_start = torch.where(hit, t_start, 0.0)
        return t_start, torch.where(hit, t_far, t_start)

    def locate(self, pos):
        """Flat cell index containing pos (..., 3), -1 outside: a search of
        the float32 borders (skirt_tpu's start())."""
        idx = []
        for b, n, x in ((self.xb, self.nx, pos[..., 0]),
                        (self.yb, self.ny, pos[..., 1]),
                        (self.zb, self.nz, pos[..., 2])):
            borders = torch.as_tensor(b, device=pos.device)
            i = torch.searchsorted(borders, x.contiguous(), right=True) - 1
            idx.append(torch.where((i >= 0) & (i < n), i, -1))
        ix, iy, iz = idx
        ok = (ix >= 0) & (iy >= 0) & (iz >= 0)
        return torch.where(ok, (ix * self.ny + iy) * self.nz + iz,
                           -1).to(torch.int32)

    def locate_batched(self, points):
        """Flat cell ids for point batches (..., 3), -1 outside: on a
        uniform grid the arithmetic floor((x - lo) / dx) with float32 lo
        and 1 / dx (what the event kernels compute), else `locate`."""
        if not all(self._uniform):
            return self.locate(points)
        idx = []
        for axis, n in enumerate((self.nx, self.ny, self.nz)):
            rel = ((points[..., axis] - f32(self._lo[axis]))
                   * f32(1.0 / self._dx[axis]))
            i = torch.floor(rel).to(torch.int32)
            idx.append(torch.where((i >= 0) & (i < n), i, -1))
        ix, iy, iz = idx
        ok = (ix >= 0) & (iy >= 0) & (iz >= 0)
        return torch.where(ok, (ix * self.ny + iy) * self.nz + iz, -1)


class TwoPhaseGrid(CartesianGrid):
    """Cartesian grid carrying random two-phase density weights.

    ref: SKIRTcore/TwoPhaseDustGrid.cpp — each cell is drawn into the
    high-density phase with probability `filling_factor`; the weights
    contrast/norm (high) and 1/norm (low), with norm = contrast*ff + 1-ff,
    keep the volume-averaged weight at exactly one so normalizations are
    preserved.  `DustSystem` multiplies the sampled densities by
    `cell_weights` (ref: DustSystem.cpp:159-170 applies grid->weight(m)).
    """

    def __init__(self, xborders, yborders, zborders, filling_factor: float,
                 contrast: float, seed: int = 4357):
        super().__init__(xborders, yborders, zborders)
        if not 0.0 < filling_factor < 1.0:
            raise ValueError("the volume filling factor of the high-density "
                             "medium should be between 0 and 1")
        if contrast <= 0.0:
            raise ValueError("the density contrast should be positive")
        self.filling_factor = float(filling_factor)
        self.contrast = float(contrast)
        X = np.random.default_rng(seed).random(self.ncells)
        norm = contrast * filling_factor + 1.0 - filling_factor
        self.cell_weights = np.where(X < filling_factor,
                                     contrast / norm, 1.0 / norm)
