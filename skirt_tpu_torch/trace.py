"""Spans and counters of the port's own stages, kept in memory.

Off by default: `span(name)` then returns one shared null context (no
allocation, no clock read) and the counters add nothing.  `enable(True)`
turns them on.  Each span then appends (name, start ns, end ns, parent)
to a list, stamped with `time.time_ns()`: the Unix-epoch clock that
torch.profiler stamps its host records and the device records of CUPTI
with.  A profile of the same run can so credit each device operation to
the innermost span open at the runtime call that launched it, and each
idle gap of the device to the spans it overlaps.  The host work is one
thread, so spans nest strictly; `parent` is the index of the enclosing
span in the list, -1 at the top.  `take()` hands the spans and counters
out and clears them.  Nothing is written anywhere.

Counters:
- `lane_slots`: the lanes the event kernels were launched over, added
  on the host at each launch;
- `live_lanes`: the lanes among them that did an event (alive on entry,
  or relaunched from their refill budget in that launch), added by the
  analytic kernels (K1, K3) themselves on the device (one atomic a warp,
  spread over LIVE_SLOTS counters a cache line apart), by their plain
  versions, or by the table engines' drivers (K4-K7, whose lanes
  relaunch on the torch side) from the lanes alive on entry.  `take()`
  sums it, one synchronization;
- `peel_rays`, `peel_voxels`: the work of the exact peel
  (`engine/fused_table.py::exact_peel_work`): the (live lane, observer
  direction) rays it integrated, and the voxels those rays cross with a
  positive length times the dust components H, counted from the lanes'
  geometry whatever implements the peel, and added on the device into
  one int64 pair per device with no synchronization.  `take()` reads
  them;
- `sed_peels_kernel`, `sed_peels_plain`: the instruments' scattering
  peels of the polychromatic drivers (`engine/common.py::peel_poly`),
  those taken by the SED peel (`ops/peel_sed.py`: the kernel PS on the
  card) and those left to the per-instrument loop, counted on the host.
"""

from __future__ import annotations

import time
from contextlib import nullcontext

import torch

# every span the port opens:
#   run       OligoSimulation.run(), whole
#   dispatch  one lifecycle call (one batch, or a group of batches)
#   drain     the float64 host drain of a dispatch's tallies and their reset
#   write     the SED tables and FITS cubes
#   launch    a batch's stellar launch, emission peel and loop state
#   check     the host's stop test every few event iterations (a sync)
#   event     the uniforms, the event kernel and the labs tally
#   peel      the scattering peel-off (weights, extinction, detects)
#   mueller   the torch-side Mueller block of the polarized engines
#   detect    an instrument's detect
#   stage_gather, exact_peel, staged_peel, locate: the table engines'
#             panel-row staging, their two peels, a Voronoi grid's locate
NAMES = ("run", "dispatch", "drain", "write", "launch", "check", "event",
         "peel", "mueller", "detect", "stage_gather", "exact_peel",
         "staged_peel", "locate")

_KNOWN = frozenset(NAMES)
_NULL = nullcontext()
_on = False
_spans: list = []
_open: list = []          # indices of the spans open now, innermost last
_slots = 0
_live: dict = {}          # device -> int64 live-lane counters
_peel: dict = {}          # device -> int64 (rays, voxels) counters
_sed = [0, 0]             # instrument peels by the SED peel, by the loop
# the live-lane counters a kernel adds to, LIVE_STRIDE int64 apart
# (csrc/common.cuh's LIVE_SLOTS and LIVE_STRIDE)
LIVE_SLOTS = 256
LIVE_STRIDE = 16


class _Span:
    __slots__ = ("name",)

    def __init__(self, name):
        if name not in _KNOWN:
            raise ValueError(f"trace.span: unknown span {name!r}")
        self.name = name

    def __enter__(self):
        i = len(_spans)
        _spans.append([self.name, 0, 0, _open[-1] if _open else -1])
        _open.append(i)
        _spans[i][1] = time.time_ns()

    def __exit__(self, *exc):
        end = time.time_ns()
        _spans[_open.pop()][2] = end
        return False


def span(name: str):
    """A context manager around a stage: the shared null context while
    tracing is off, else one that records the stage (a name of NAMES)."""
    if not _on:
        return _NULL
    return _Span(name)


def enable(on: bool = True):
    """Turn the spans and counters on or off (what was recorded stays
    until take())."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def count_slots(n: int):
    """Add the n lanes of one event launch to lane_slots (when on)."""
    global _slots
    if _on:
        _slots += int(n)


def live_counter(device):
    """The int64 (LIVE_SLOTS * LIVE_STRIDE,) live-lane counters on
    `device` while tracing is on, else None (the event kernels then count
    nothing)."""
    if not _on:
        return None
    dev = torch.device(device)
    t = _live.get(dev)
    if t is None:
        t = _live[dev] = torch.zeros(LIVE_SLOTS * LIVE_STRIDE,
                                     dtype=torch.int64, device=dev)
    return t


def count_live(device, did):
    """Add the lanes of the bool (N,) tensor `did` to the live-lane
    counters (the plain event versions' count; nothing while off)."""
    t = live_counter(device)
    if t is not None:
        t[0] += did.sum()


def count_peel(work):
    """Add one exact-peel pass, the int64 (2,) tensor `work` (rays,
    voxels x H), to peel_rays and peel_voxels on its device (when on)."""
    if not _on:
        return
    t = _peel.get(work.device)
    if t is None:
        t = _peel[work.device] = torch.zeros(2, dtype=torch.int64,
                                             device=work.device)
    t += work


def count_sed_peels(kernel: int, plain: int):
    """Add a scattering peel's instruments taken by the SED peel and
    those left to the loop (when on)."""
    if _on:
        _sed[0] += int(kernel)
        _sed[1] += int(plain)


def take() -> dict:
    """{"spans": [(name, start ns, end ns, parent), ...], "counters":
    {"lane_slots": n, "live_lanes": n, "peel_rays": n, "peel_voxels":
    n, "sed_peels_kernel": n, "sed_peels_plain": n}}, and clear them.
    Called outside every span."""
    global _spans, _slots
    if _open:
        raise RuntimeError("trace.take: spans are still open")
    live = sum(int(t.sum()) for t in _live.values())
    rays, voxels = (sum(v) for v in zip(
        (0, 0), *(t.tolist() for t in _peel.values())))
    out = {"spans": [tuple(s) for s in _spans],
           "counters": {"lane_slots": _slots, "live_lanes": live,
                        "peel_rays": rays, "peel_voxels": voxels,
                        "sed_peels_kernel": _sed[0],
                        "sed_peels_plain": _sed[1]}}
    _spans = []
    _slots = 0
    _sed[:] = [0, 0]
    _live.clear()
    _peel.clear()
    return out
