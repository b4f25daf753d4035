"""Binned scatter-add with drop semantics (kernels K2 and K8).

Twin of skirt_tpu/ops/binned.py.  `drop_add` is the plain PyTorch version
and runs on any device; `binned_add` is the wrapper of the hand-written
CUDA kernel in csrc/binned.cu (a shared-memory-privatised histogram when
the bins fit in a block's shared memory, global atomics otherwise).  For
a CPU tensor `binned_add` takes the plain version; for a CUDA tensor it
launches the kernel or raises.

Both update `tally` in place and return it (skirt_tpu returns a new
array).  Indices < 0 or >= nbins are dropped; nothing wraps.

K8, the lambda-blocked tally: `binned_add_lm` is the wrapper of
csrc/binned_blocked.cu and `bincount_blocked_plain` its plain version;
`blocked_layout` and `lm_to_cell_major` are skirt_tpu's layout helpers.
"""

from __future__ import annotations

import torch

from .. import kernels


def drop_add(tally, idx, values):
    """Plain version: tally[idx] += values, dropping idx < 0 or >= nbins."""
    nbins = tally.shape[0]
    idx = idx.reshape(-1)
    values = values.reshape(-1)
    ok = (idx >= 0) & (idx < nbins)
    safe = torch.where(ok, idx, 0).to(torch.int64)
    tally.index_add_(0, safe, torch.where(ok, values, 0.0))
    return tally


def binned_add(tally, idx, values):
    """tally[idx] += values for flat updates, negative / >= nbins dropped.

    CPU tensors take `drop_add`; CUDA tensors launch the K2 kernel and add
    one to `binned_add.launches`."""
    if tally.device.type == "cpu":
        return drop_add(tally, idx, values)
    if tally.device.type != "cuda":
        raise ValueError(f"binned_add: unsupported device {tally.device}")
    idx = idx.reshape(-1)
    values = values.reshape(-1)
    if (tally.dtype != torch.float32 or values.dtype != torch.float32
            or idx.dtype != torch.int32):
        raise TypeError("binned_add kernel takes a float32 tally, int32 "
                        "indices and float32 values")
    if idx.shape != values.shape:
        raise ValueError("binned_add: idx and values differ in size")
    for t in (idx, values):
        if t.device != tally.device:
            raise ValueError("binned_add: tensors on different devices")
    if not tally.is_contiguous():
        raise ValueError("binned_add: tally must be contiguous")
    idx = idx.contiguous()
    values = values.contiguous()
    lib = kernels.library()
    kernels.check(lib.skirt_binned_add(
        tally.data_ptr(), idx.data_ptr(), values.data_ptr(), idx.numel(),
        tally.shape[0], kernels.stream_of(tally)), "binned_add kernel")
    binned_add.launches += 1
    return tally


binned_add.launches = 0


# -- kernel K8: the lambda-blocked tally ------------------------------------

def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def blocked_layout(nlambda: int, ncells: int, n: int):
    """Geometry of the lambda-blocked tally (skirt_tpu's gates): (Q, R,
    rows_pb), or None when the n lanes do not split into nlambda equal
    blocks of a multiple of 8 x 128 lanes.  R = 128 up to 16,384 cells,
    else 256; Q = ceil(ncells / R) rounded up to a multiple of 8; rows_pb
    = lanes per block / 128."""
    if n % nlambda:
        return None
    per = n // nlambda
    if per % (128 * 8):
        return None
    R = 128 if ncells <= 128 * 128 else 256
    Q = _ceil_to(-(-ncells // R), 8)
    return Q, R, per // 128


def lm_to_cell_major(tally_lm, *, nlambda, ncells):
    """(nlambda, Q*R) lambda-major padded tally -> flat cell-major
    (ncells * nlambda), the engine's labs layout."""
    t = tally_lm.reshape(nlambda, -1)[:, :ncells]
    return t.T.reshape(-1)


def bincount_blocked_plain(tally_lm, cell_idx, values, *, nlambda, ncells):
    """Plain version of K8: lane e of block b = e // (n / nlambda) adds
    values[e] to tally_lm[b*Q*R + cell_idx[e]]; cells < 0 or >= ncells
    are dropped.  Every block is tallied."""
    qr = tally_lm.shape[0] // nlambda
    cell = cell_idx.reshape(-1)
    values = values.reshape(-1)
    per = cell.shape[0] // nlambda
    block = torch.arange(cell.shape[0], device=cell.device) // per
    ok = (cell >= 0) & (cell < ncells)
    bins = torch.where(ok, block * qr + cell, 0)
    tally_lm.index_add_(0, bins, torch.where(ok, values, 0.0))
    return tally_lm


def binned_add_lm(tally_lm, cell_idx, values, *, nlambda, ncells):
    """Lambda-major tally update for lambda-blocked lanes, in place.

    tally_lm: flat (nlambda * Q * R) float32 tally (`blocked_layout`,
    `lm_to_cell_major`); cell_idx: (N,) int32 cell ids, the lanes in
    nlambda contiguous equal wavelength blocks; a cell < 0 or >= ncells is
    dropped.  Updates tally_lm in place and returns it (skirt_tpu returns
    a new array).  Unlike skirt_tpu's Pallas kernel, every wavelength
    block is tallied whether or not its tile size divides nlambda.

    CPU tensors take `bincount_blocked_plain`; CUDA tensors launch kernel
    K8 (csrc/binned_blocked.cu) and add one to `binned_add_lm.launches`."""
    n = cell_idx.numel()
    lay = blocked_layout(nlambda, ncells, n)
    if lay is None:
        raise ValueError(f"binned_add_lm: {n} lanes do not split into "
                         f"{nlambda} blocks of a multiple of 1,024 lanes")
    Q, R, _ = lay
    if tally_lm.shape != (nlambda * Q * R,):
        raise ValueError(f"binned_add_lm: tally of shape "
                         f"{tuple(tally_lm.shape)}, the layout needs "
                         f"({nlambda * Q * R},)")
    if values.numel() != n:
        raise ValueError("binned_add_lm: cell_idx and values differ in size")
    if tally_lm.device.type == "cpu":
        return bincount_blocked_plain(tally_lm, cell_idx, values,
                                      nlambda=nlambda, ncells=ncells)
    if tally_lm.device.type != "cuda":
        raise ValueError(f"binned_add_lm: unsupported device "
                         f"{tally_lm.device}")
    if (tally_lm.dtype != torch.float32 or values.dtype != torch.float32
            or cell_idx.dtype != torch.int32):
        raise TypeError("binned_add_lm kernel takes a float32 tally, int32 "
                        "cells and float32 values")
    for t in (cell_idx, values):
        if t.device != tally_lm.device:
            raise ValueError("binned_add_lm: tensors on different devices")
    if not tally_lm.is_contiguous():
        raise ValueError("binned_add_lm: tally_lm must be contiguous")
    cell = cell_idx.reshape(-1).contiguous()
    values = values.reshape(-1).contiguous()
    lib = kernels.library()
    kernels.check(lib.skirt_binned_blocked_add(
        tally_lm.data_ptr(), cell.data_ptr(), values.data_ptr(), n, nlambda,
        ncells, Q * R, kernels.stream_of(tally_lm)), "binned_add_lm kernel")
    binned_add_lm.launches += 1
    return tally_lm


binned_add_lm.launches = 0
