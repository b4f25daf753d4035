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
`k8_route` picks its route by lane density; `blocked_layout` and
`lm_to_cell_major` are skirt_tpu's layout helpers.
"""

from __future__ import annotations

import ctypes

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


# K8's routes (csrc/binned_blocked.cu's ROUTE_*), by lane density
K8_GLOBAL, K8_DENSE, K8_SPARSE = 0, 1, 2
K8_ROUTES = {K8_GLOBAL: "global", K8_DENSE: "dense", K8_SPARSE: "sparse"}
# lanes a bin a block needs for the dense route (the slice in shared
# memory) to beat atomics into the tally, alone and with the wavelength
# block split over several blocks (whose partial slices then go into the
# tally by atomics), and the most blocks a wavelength block splits over,
# fitted to the crossover of every route over nlambda 8-128, 1,000 and
# 16,384 cells and 1,024-65,536 lanes a wavelength block
# (experiments/sweep_probe_routes.py, which times each route through the C
# entry point; PERF.md section 6)
K8_DENSE_LANES_PER_BIN = {"alone": 0.25, "split": 2}
K8_MAX_SPLIT = 8
# an H100 SXM's SMs: k8_route's default card
SMS = 132


def k8_route(per: int, qr: int, optin_bytes: int, nlambda: int = 1,
             sms: int = SMS, aligned: bool = True) -> tuple:
    """K8's (route, split) for nlambda wavelength blocks of `per` lanes
    over slices of `qr` bins on a card of `sms` SMs whose blocks can opt
    into `optin_bytes` of shared memory.

    The dense route gives each wavelength block `split` blocks, the fewest
    (a power of two up to K8_MAX_SPLIT) that put a block on at least half
    the SMs, and runs when the slice fits, the tally sits on 16 bytes and
    each block has K8_DENSE_LANES_PER_BIN lanes a bin.  Otherwise the
    lanes go straight into the tally by atomics: global where the slice
    does not fit, sparse where it does (split 1)."""
    split = 1
    while split < K8_MAX_SPLIT and 2 * nlambda * split < sms:
        split *= 2
    need = K8_DENSE_LANES_PER_BIN["split" if split > 1 else "alone"]
    if qr * 4 > optin_bytes:
        return K8_GLOBAL, 1
    if aligned and nlambda <= 65535 and per >= need * qr * split:
        return K8_DENSE, split
    return K8_SPARSE, 1


_limits: dict = {}


def device_limits(device) -> tuple:
    """(opt-in shared memory bytes a block, SM count) of a CUDA device, as
    csrc/binned_blocked.cu reads them, once per device."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _limits:
        optin, sms = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(index):
            kernels.check(kernels.library().skirt_binned_blocked_limits(
                ctypes.byref(optin), ctypes.byref(sms)), "K8 device limits")
        _limits[index] = (optin.value, sms.value)
    return _limits[index]


def binned_add_lm(tally_lm, cell_idx, values, *, nlambda, ncells):
    """Lambda-major tally update for lambda-blocked lanes, in place.

    tally_lm: flat (nlambda * Q * R) float32 tally (`blocked_layout`,
    `lm_to_cell_major`); cell_idx: (N,) int32 cell ids, the lanes in
    nlambda contiguous equal wavelength blocks; a cell < 0 or >= ncells is
    dropped.  Updates tally_lm in place and returns it (skirt_tpu returns
    a new array).  Unlike skirt_tpu's Pallas kernel, every wavelength
    block is tallied whether or not its tile size divides nlambda.

    CPU tensors take `bincount_blocked_plain`; CUDA tensors launch kernel
    K8 (csrc/binned_blocked.cu) on the route and split `k8_route` picks
    and add one to `binned_add_lm.launches`."""
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
    return _binned_add_lm_cuda(tally_lm, cell_idx, values, nlambda, ncells,
                               Q * R, *device_limits(tally_lm.device))


def _binned_add_lm_cuda(tally_lm, cell_idx, values, nlambda, ncells, qr,
                        optin, sms):
    """The launch: k8_route's (route, split) on a card of `sms` SMs and
    `optin` opt-in bytes, handed to the C entry point."""
    n = cell_idx.numel()
    cell = kernels.aligned(cell_idx.reshape(-1), 16)
    values = kernels.aligned(values.reshape(-1), 16)
    route, split = k8_route(n // nlambda, qr, optin, nlambda, sms,
                            tally_lm.data_ptr() % 16 == 0)
    kernels.check(kernels.library().skirt_binned_blocked_add(
        tally_lm.data_ptr(), cell.data_ptr(), values.data_ptr(), n, nlambda,
        ncells, qr, route, split, kernels.stream_of(tally_lm)),
        "binned_add_lm kernel")
    binned_add_lm.launches += 1
    return tally_lm


binned_add_lm.launches = 0
