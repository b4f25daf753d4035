"""Binned scatter-add with drop semantics (kernel K2).

Twin of skirt_tpu/ops/binned.py.  `drop_add` is the plain PyTorch version
and runs on any device; `binned_add` is the wrapper of the hand-written
CUDA kernel in csrc/binned.cu (a shared-memory-privatised histogram when
the bins fit in a block's shared memory, global atomics otherwise).  For
a CPU tensor `binned_add` takes the plain version; for a CUDA tensor it
launches the kernel or raises.

Both update `tally` in place and return it (skirt_tpu returns a new
array).  Indices < 0 or >= nbins are dropped; nothing wraps.
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
