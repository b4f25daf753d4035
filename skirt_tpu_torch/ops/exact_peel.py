"""The exact peel's column integrals on the card (csrc/exact_peel.cu).

`peel_columns` launches the hand-written kernel on CUDA tensors, or
raises: per lane and observer direction (leader) the integral of each
dust component's density from the lane's point to the grid's wall, exact
for the voxel field, times 1 / |k_a|, or their sum weighted by the
lanes' opacities.  The plain version is
engine/fused_table.py::make_exact_peel's `leader_sums`, which
make_exact_peel runs on CPU tensors; both read a leader's constants
from `leader`, the kernel through `leader_row`.  skirt_tpu computes the
exact peel in XLA (skirt_tpu/engine/fused_table.py:395-540), not a
Pallas kernel: the kernel displaces no counterpart.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels

# floats of a leader's row (csrc/exact_peel.cu ROW): 0-2 the axes a, b, c;
# 3-5 the float32 components along them; 6-8 the float32 direction (the
# grid box's exit); 9 1 / |k_a|; 10 Kp; 11-17 and 18-24 axes b and c
# (`Crossings`, the step written twice: the first crossing's coefficient
# and the step); 25-27 lo_a, dx_a and 1 / dx_a; 28-31 unused
ROW = 32


def _f32(v) -> float:
    return float(np.float32(v))


class Crossings(NamedTuple):
    """A lateral axis's wall-crossing constants, float32 values."""
    active: bool      # |k| >= 1e-12; an inactive axis has no crossings
    positive: bool    # k > 0
    lo: float         # the grid's lower wall
    inv: float        # 1 / dx
    step: float       # |dx / k|, also the first crossing's coefficient
    thr: float        # 1e-6 step: a first crossing as near moves a step


def crossings(k, lo, dx) -> Crossings:
    active = abs(k) >= 1e-12
    step = np.float32(abs(dx / k)) if active else np.float32(0.0)
    return Crossings(active, bool(active and k > 0), _f32(lo), _f32(1.0 / dx),
                     float(step), _f32(float(1e-6 * step)))


class Leader(NamedTuple):
    """A leader's constants, made once (`leader`) and read by the plain
    walk (engine/fused_table.py::make_exact_peel) and the kernel's row
    (`leader_row`) alike."""
    k: np.ndarray     # the unit direction, float64 (3,)
    a: int            # the row axis, the largest component's
    b: int            # the lateral axes, b < c
    c: int
    k32: tuple        # the direction's float32 components
    inv_ka: float     # float32 1 / |k_a|
    Kp: int           # Kp - 1 lateral crossings are kept
    lat: tuple        # `Crossings` of axes b and c
    lo_a: float       # float32 lower wall and voxel size along a
    dx_a: float


def leader(kvec, lo, dx, nxyz) -> Leader:
    """The constants of the leader of unit direction kvec on a grid of
    corner lo, voxel sizes dx (float64, 3) and nxyz voxels."""
    k = np.asarray(kvec, np.float64)
    a = int(np.argmax(np.abs(k)))
    b, c = [i for i in range(3) if i != a]
    # max in-domain ray length along k, bounded per axis
    ext = (lo + np.asarray(nxyz) * dx) - lo
    Dk = min(float(ext[i] / abs(k[i])) for i in range(3)
             if abs(k[i]) > 1e-12)
    cb = int(np.floor(Dk * abs(k[b]) / dx[b])) + 1
    cc = int(np.floor(Dk * abs(k[c]) / dx[c])) + 1
    Kp = min(cb + cc + 1, nxyz[b] + nxyz[c] + 1)
    return Leader(k, a, b, c, tuple(_f32(v) for v in k),
                  _f32(1.0 / max(abs(k[a]), 1e-12)), Kp,
                  (crossings(float(k[b]), lo[b], dx[b]),
                   crossings(float(k[c]), lo[c], dx[c])),
                  _f32(lo[a]), _f32(dx[a]))


def leader_row(ld: Leader) -> list:
    """The kernel's row of a leader's constants."""
    k32 = ld.k32
    row = [float(ld.a), float(ld.b), float(ld.c),
           k32[ld.a], k32[ld.b], k32[ld.c], *k32, ld.inv_ka, float(ld.Kp)]
    for s in ld.lat:
        row += [float(s.active), float(s.positive), s.lo, s.inv, s.step,
                s.step, s.thr]
    row += [ld.lo_a, ld.dx_a, _f32(1.0 / ld.dx_a)]
    return row + [0.0] * (ROW - len(row))


def peel_columns(pos, rho, rows, box, kext=None):
    """The exact peel of N lanes at pos ((N, 3) float32) toward the L
    leaders of `rows` ((L, ROW) float32, `leader_row`) through the H
    density fields rho ((H, nx, ny, nz) float32) inside the grid's
    float32 box (lo x, y, z, hi x, y, z): with kext ((H, N) float32, the
    lanes' opacities) an (L, N) tensor of optical depths sum_h kext[h] *
    I_h / |k_a|, without it the (L, H, N) integrals I_h / |k_a|.

    Contiguous CUDA tensors on one device only (TypeError for another
    dtype, ValueError for anything else, before any launch); one launch,
    counted in `peel_columns.launches`."""
    ts = [pos, rho, rows] + ([] if kext is None else [kext])
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("peel_columns takes float32 tensors")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("peel_columns: contiguous tensors only")
    if pos.dim() != 2 or pos.shape[1] != 3 or rho.dim() != 4 \
            or rows.dim() != 2 or rows.shape[1] != ROW:
        raise ValueError(f"peel_columns: pos (N, 3), rho (H, nx, ny, nz) "
                         f"and rows (L, {ROW}), not {tuple(pos.shape)}, "
                         f"{tuple(rho.shape)} and {tuple(rows.shape)}")
    N, L = pos.shape[0], rows.shape[0]
    H, nx, ny, nz = rho.shape
    if kext is not None and tuple(kext.shape) != (H, N):
        raise ValueError(f"peel_columns: kext ({H}, {N}), not "
                         f"{tuple(kext.shape)}")
    dev = pos.device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("peel_columns: CUDA tensors on one device, not "
                         f"{[str(t.device) for t in ts]}")
    out = torch.empty((L, N) if kext is not None else (L, H, N),
                      dtype=torch.float32, device=dev)
    lo = (ctypes.c_float * 3)(*box[:3])
    hi = (ctypes.c_float * 3)(*box[3:])
    kernels.check(kernels.library().skirt_exact_peel(
        pos.data_ptr(), rho.data_ptr(), rows.data_ptr(),
        None if kext is None else kext.data_ptr(), out.data_ptr(), N, H, L,
        nx, ny, nz, lo, hi, kernels.stream_of(pos)), "exact_peel kernel")
    peel_columns.launches += 1
    return out


peel_columns.launches = 0
