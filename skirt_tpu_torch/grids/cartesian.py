"""3-D rectilinear Cartesian dust grid.

Twin of skirt_tpu/grids/cartesian.py (slice 1: the host metadata, the
uniform-spacing detection the event kernel's arithmetic locate relies
on, and the in-domain ray span of the panel quadrature).
ref: SKIRTcore/CartesianDustGrid.cpp.
"""

from __future__ import annotations

import numpy as np
import torch

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
        rays that miss give t_start == t_stop.  pos, direction: (N, 3)."""
        lo = torch.tensor([self.xb[0], self.yb[0], self.zb[0]],
                          dtype=torch.float32, device=pos.device)
        hi = torch.tensor([self.xb[-1], self.yb[-1], self.zb[-1]],
                          dtype=torch.float32, device=pos.device)
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
