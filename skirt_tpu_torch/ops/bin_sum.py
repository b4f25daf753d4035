"""Per-wavelength bin sum of the monochromatic detects (the SED tallies).

`bin_sum_plain` is the plain PyTorch version and runs on any device;
`bin_sum_add` adds the sums into a tally in place: for CPU tensors
through the plain version, for CUDA tensors through the hand-written
kernel in csrc/bin_sum.cu (or it raises).  skirt_tpu computes the same
sums as an XLA one-hot matvec (skirt_tpu/instruments/instruments.py:98
`_bin_sum`), not a Pallas kernel: the kernel displaces no counterpart.

Indices outside [0, nlambda) are dropped on both routes, as the plain
version's comparisons drop them (the engines never send any).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import kernels
from .binned import device_limits


def bin_sum_plain(values, ell, nlambda):
    """Per-wavelength-bin sum of (N,) values with (N,) bin indices: the
    plain version of the kernel of csrc/bin_sum.cu (`bin_sum_add`).

    A pairwise reduction of masked rows, as skirt_tpu's one-hot matvec
    (error ~sqrt(N) eps): a scatter of N lanes into a handful of bins
    would be N-way contended atomics on the GPU with ~N eps error.  The
    rows are taken in chunks of at most 2^24 elements."""
    n = max(values.shape[0], 1)
    wl = torch.arange(nlambda, dtype=ell.dtype, device=ell.device)
    step = max(1, (1 << 24) // n)
    out = [torch.where(ell[None, :] == wl[i:i + step, None], values[None, :],
                       0.0).sum(dim=1)
           for i in range(0, nlambda, step)]
    return out[0] if len(out) == 1 else torch.cat(out)


# csrc/bin_sum.cu's block: THREADS threads, each a float32 column of the
# bins of a pass in shared memory (bins x 1 KB a block, at least the
# finish's 8 KB), with STATIC_SMEM bytes of static shared memory beside
# them; a block takes at least MIN_VALUES values, and at most PER_SM
# blocks share an SM
THREADS = 256
STATIC_SMEM = 16
MIN_VALUES = 8 * THREADS
PER_SM = 2
# Hopper (the library's only target, sm_90a) reserves 1 KB of an SM's
# shared memory per resident block, and an SM holds the opt-in limit of
# one block plus that reserve
RESERVED_SMEM = 1024
ROUTES = ("one_pass", "passes")


class BinSumPlan(NamedTuple):
    route: str      # "one_pass" (every bin in one pass) or "passes"
    bins: int       # bins a pass holds
    ranges: int     # passes: ranges of bins, one per blockIdx.y
    blocks: int     # blocks a range (the grid's x)


@functools.lru_cache(maxsize=256)
def bin_sum_plan(n: int, nlambda: int, optin: int, sms: int) -> BinSumPlan:
    """The kernel's parameters for n values into nlambda bins on a card
    of `sms` SMs whose blocks can opt into `optin` bytes of shared
    memory: the fewest ranges of equal size whose columns fit a block,
    then as many blocks a range as fill the card at up to PER_SM blocks
    an SM (fewer where a block would take under MIN_VALUES values).
    Cached: the detects ask for the same few shapes every iteration."""
    most = (optin - STATIC_SMEM) // (4 * THREADS)
    ranges = -(-nlambda // most)
    bins = -(-nlambda // ranges)
    smem = max(4 * THREADS * bins, 32 * THREADS) + STATIC_SMEM
    per_sm = max(1, min(PER_SM, (optin + RESERVED_SMEM)
                        // (smem + RESERVED_SMEM)))
    blocks = max(1, min(-(-n // MIN_VALUES), per_sm * sms // ranges))
    return BinSumPlan(ROUTES[ranges > 1], bins, ranges, blocks)


def row_floats(plan: BinSumPlan) -> int:
    """Floats a block's row of partials takes: the bins of a pass, padded
    to a multiple of 4 (the finish reads the rows as float4)."""
    return -(-plan.bins // 4) * 4


def bin_sum_add(tally, values, ell):
    """tally[b] += the sum of values[e] over the e with ell[e] == b, for
    a (nlambda,) float32 tally, (N,) float32 values and (N,) int32
    indices; indices outside [0, nlambda) are dropped.  Updates tally in
    place and returns it.

    CPU tensors take `bin_sum_plain`; CUDA tensors launch the kernel of
    csrc/bin_sum.cu on `bin_sum_plan`'s route (none for N = 0) and add
    one to `bin_sum_add.launches[route]`."""
    if tally.dim() != 1 or values.dim() != 1 or ell.shape != values.shape:
        raise ValueError(f"bin_sum_add: a (nlambda,) tally and (N,) values "
                         f"and indices, not {tuple(tally.shape)}, "
                         f"{tuple(values.shape)} and {tuple(ell.shape)}")
    if (tally.dtype != torch.float32 or values.dtype != torch.float32
            or ell.dtype != torch.int32):
        raise TypeError("bin_sum_add takes a float32 tally, float32 values "
                        "and int32 indices")
    for t in (values, ell):
        if t.device != tally.device:
            raise ValueError("bin_sum_add: tensors on different devices")
    if tally.device.type == "cpu":
        tally += bin_sum_plain(values, ell, tally.shape[0])
        return tally
    if tally.device.type != "cuda":
        raise ValueError(f"bin_sum_add: unsupported device {tally.device}")
    if not tally.is_contiguous():
        raise ValueError("bin_sum_add: tally must be contiguous")
    if values.numel() == 0:
        return tally
    return _bin_sum_cuda(tally, values, ell, *device_limits(tally.device))


_work: dict = {}


def _workspace(device, stream, ranges, nparts):
    """(tickets, partials) of the kernel on one stream: `ranges` int32
    tickets at zero (each call leaves them so) and nparts float32
    partials, kept and grown as calls need."""
    key = (device, stream)
    tickets, parts = _work.get(key, (None, None))
    if tickets is None or tickets.numel() < ranges:
        tickets = torch.zeros(ranges, dtype=torch.int32, device=device)
    if parts is None or parts.numel() < nparts:
        parts = torch.empty(nparts, dtype=torch.float32, device=device)
    _work[key] = (tickets, parts)
    return tickets, parts


def _bin_sum_cuda(tally, values, ell, optin, sms):
    """The launch: bin_sum_plan's parameters on a card of `sms` SMs and
    `optin` opt-in bytes, handed to the C entry point."""
    n, nlambda = values.numel(), tally.shape[0]
    values = kernels.aligned(values, 16)
    ell = kernels.aligned(ell, 16)
    plan = bin_sum_plan(n, nlambda, optin, sms)
    stream = kernels.stream_of(tally)
    tickets, parts = _workspace(tally.device, stream, plan.ranges,
                                plan.ranges * plan.blocks * row_floats(plan))
    kernels.check(kernels.library().skirt_bin_sum(
        tally.data_ptr(), values.data_ptr(), ell.data_ptr(), n, nlambda,
        plan.bins, plan.ranges, plan.blocks, parts.data_ptr(),
        tickets.data_ptr(), stream), "bin_sum kernel")
    bin_sum_add.launches[plan.route] += 1
    return tally


bin_sum_add.launches = dict.fromkeys(ROUTES, 0)

