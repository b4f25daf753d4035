"""The program's own spans and counters read against a CUDA profile of
whole run() calls: which stage of the port launched each device
operation, which stage the device waited on in each idle gap, what
share of the event kernels' lanes were live, and how long the host
spends dispatching.

`profile_spans(pkg, call)` runs `call()` (one run()) under
torch.profiler with CUDA activity alone and the port's tracing on
(`skirt_tpu_torch/trace.py`): the device operations with their
correlation ids, the CUDA runtime calls that launched them (correlation
id, host time), the port's spans and its counters.  Both sides stamp the
same Unix-epoch clock, so each device operation is credited to the
innermost span open at its runtime call (`credit`), and each idle gap of
the device is split over the spans it overlaps, by overlap
(`idle_by_span`).  With `profiled=False` the phase keeps the spans and
counters alone, on a host that CUPTI does not slow.  A port without the
tracing module gives None.

The readers at the end (`live_lane_share` ... `host_ms_per_iter`) are
the per-layer quantities these records give; each returns None where
the trace holds nothing to read.  The benchmark's `--trace 1` run takes
the profiled phase as the second of tracing.profile_phases and the
unprofiled one as its host phase, and each reader has its
metrics/<name>.py.  By hand:

    python3 -m rtbench.spans --workload <cell> --seed <n> [--runs 3]

builds the cell as run.py does, warms up, times --runs untraced run()
calls, runs tracing.profile_phases (the benchmark's own three phases)
and prints one JSON line: the walls, the readings and the checks of
completeness of its spans phase, and the host phase's reading."""

import importlib
import time
from dataclasses import dataclass, field

from .kernel_names import classify

# the port's event dispatchers and their launch counters
EVENT_COUNTERS = (("engine.fused_poly", "poly_event"),
                  ("engine.fused", "mono_event"),
                  ("engine.fused_table", "table_event"),
                  ("engine.fused_table", "table_multi_event"),
                  ("engine.fused_table_poly", "table_poly_event"),
                  ("engine.fused_table_poly", "table_poly_multi_event"))


@dataclass
class SpanTrace:
    """One traced phase of the port's spans.  Times in ns on the
    profiler's (Unix-epoch) clock."""
    ops: list = field(default_factory=list)       # (name, start, end, corr)
    calls: dict = field(default_factory=dict)     # corr -> runtime call ns
    spans: list = field(default_factory=list)     # (name, start, end, parent)
    counters: dict = field(default_factory=dict)
    launches: int | None = None                   # event-kernel launches
    wall_s: float = 0.0                           # the phase's host wall


def launches(pkg) -> int | None:
    """The sum of the port's event-kernel launch counters, or None when
    none of them is there."""
    total, seen = 0, False
    for mod, fn in EVENT_COUNTERS:
        try:
            n = getattr(getattr(importlib.import_module(
                f"{pkg.__name__}.{mod}"), fn), "launches")
        except (ImportError, AttributeError):
            continue
        total += int(n)
        seen = True
    return total if seen else None


def tracer(pkg):
    """The port's tracing module, or None where the port has none."""
    try:
        return importlib.import_module(f"{pkg.__name__}.trace")
    except ImportError:
        return None


def profile_spans(pkg, call, cuda: bool = True, profiled: bool = True):
    """One run() phase (`call()`) with the port's tracing on, under a
    CUDA-only profile on a card when `profiled` (none on the CPU, where
    only the spans and counters are kept; without `profiled` the card's
    phase is closed by a synchronize).  None where the port has no
    tracing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tr = tracer(pkg)
    if tr is None:
        return None
    st = SpanTrace()
    if cuda:
        torch.cuda.synchronize()
    tr.take()
    n0 = launches(pkg)
    tr.enable(True)
    try:
        if cuda and profiled:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                st.wall_s = time.perf_counter() - t0
            st.ops, st.calls = _reduce(prof)
        else:
            t0 = time.perf_counter()
            call()
            if cuda:
                torch.cuda.synchronize()
            st.wall_s = time.perf_counter() - t0
    finally:
        tr.enable(False)
    got = tr.take()
    n1 = launches(pkg)
    st.launches = None if n0 is None else n1 - n0
    st.spans, st.counters = got["spans"], got["counters"]
    return st


def _reduce(prof):
    """(device operations (name, start, end, correlation id), {correlation
    id: host ns of the runtime or driver call}).  A CUDA-only profile
    holds no host records but those calls and CUPTI's own work inside
    them (module loading, buffer requests), which carry the call's
    correlation id: the earliest record of an id is the call.  Where
    torch does not tell the activity apart (no `activity_type`), every
    device record counts as an operation, as tracing._reduce takes
    them."""
    ops, calls = [], {}
    for e in prof.profiler.kineto_results.events():
        act = str(e.activity_type()) if hasattr(e, "activity_type") else ""
        s = e.start_ns()
        if str(e.device_type()).endswith("CUDA"):
            if act in ("kernel", "gpu_memcpy", "gpu_memset") or not act:
                ops.append((e.name(), s, s + e.duration_ns(),
                            e.correlation_id()))
        elif "runtime" in act or "driver" in act or not act:
            c = e.correlation_id()
            calls[c] = min(s, calls.get(c, s))
    return ops, calls


# -- where each time falls among the spans --------------------------------

def innermost(spans, times):
    """Per time, the index of the innermost span open at it, or -1.  The
    spans nest strictly (one host thread)."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][1],
                                                     -spans[i][2]))
    out = [-1] * len(times)
    stack, j = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(order) and spans[order[j]][1] <= t:
            while stack and spans[stack[-1]][2] < spans[order[j]][1]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and spans[stack[-1]][2] < t:
            stack.pop()
        out[i] = stack[-1] if stack else -1
    return out


def chain(spans, i):
    """The names of span i and of every span around it."""
    names = set()
    while i >= 0:
        names.add(spans[i][0])
        i = spans[i][3]
    return names


def credit(st: SpanTrace):
    """Per device operation, the index of the innermost span open at the
    runtime call that launched it (-1: outside every span, or no call
    recorded for it)."""
    times = [st.calls.get(corr) for *_, corr in st.ops]
    known = [i for i, t in enumerate(times) if t is not None]
    at = innermost(st.spans, [times[i] for i in known])
    out = [-1] * len(st.ops)
    for i, k in zip(known, at):
        out[i] = k
    return out


def device_ns_by_span(st: SpanTrace):
    """Device ns by the innermost span name that launched each operation
    ("(none)" for the rest), largest first."""
    by = {}
    for (_, s, e, _), k in zip(st.ops, credit(st)):
        key = st.spans[k][0] if k >= 0 else "(none)"
        by[key] = by.get(key, 0) + (e - s)
    return sorted(by.items(), key=lambda kv: -kv[1])


def _runs(st):
    return [(s, e) for name, s, e, _ in st.spans if name == "run"]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(st: SpanTrace):
    """The device's idle intervals inside the run() spans."""
    busy = _union([(s, e) for _, s, e, _ in st.ops])
    out = []
    for lo, hi in _runs(st):
        t = lo
        for s, e in busy:
            if e <= t:
                continue
            if s >= hi:
                break
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if t < hi:
            out.append((t, hi))
    return out


def _segments(spans):
    """The host timeline cut where the innermost open span changes:
    (start, end, span index or -1), in time order."""
    bounds = sorted({t for _, s, e, _ in spans for t in (s, e)})
    if len(bounds) < 2:
        return []
    mids = [(a + b) / 2 for a, b in zip(bounds, bounds[1:])]
    owner = innermost(spans, mids)
    return [(a, b, k) for (a, b), k in zip(zip(bounds, bounds[1:]), owner)]


def idle_by_span(st: SpanTrace, top: int = 20):
    """Device idle seconds split over the spans each gap overlaps, by
    overlap with the innermost span open at each instant, largest
    first: [[name, seconds], ...]."""
    segs = _segments(st.spans)
    by, j = {}, 0
    for gs, ge in gaps(st):
        while j < len(segs) and segs[j][1] <= gs:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < ge:
            a, b, i = segs[k]
            ov = min(b, ge) - max(a, gs)
            if ov > 0:
                key = st.spans[i][0] if i >= 0 else "(none)"
                by[key] = by.get(key, 0.0) + ov / 1e9
            k += 1
    return sorted(([k, v] for k, v in by.items()),
                  key=lambda kv: -kv[1])[:top]


def _overlap_ns(intervals, cover) -> int:
    """ns of the (disjoint, sorted) `intervals` that the union of
    `cover` overlaps."""
    cover = _union(cover)
    total, j = 0, 0
    for gs, ge in intervals:
        while j < len(cover) and cover[j][1] <= gs:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < ge:
            total += max(0, min(cover[k][1], ge) - max(cover[k][0], gs))
            k += 1
    return total


def _named(st: SpanTrace, name: str):
    return [(s, e) for n, s, e, _ in st.spans if n == name]


def idle_ns_in(st: SpanTrace, name: str) -> int:
    """Device idle ns that overlaps the spans called `name` (which do not
    nest in one another)."""
    return _overlap_ns(gaps(st), _named(st, name))


def busy_ns(st: SpanTrace) -> int:
    return sum(e - s for s, e in _union([(s, e) for _, s, e, _ in st.ops]))


def _credited_ms_per_iter(st, keep):
    if not st.launches or not st.ops:
        return None
    ns = 0
    for (_, s, e, _), k in zip(st.ops, credit(st)):
        if k >= 0 and keep(chain(st.spans, k)):
            ns += e - s
    return ns / 1e6 / st.launches


# -- the readers ------------------------------------------------------------

def live_lane_share(st):
    """% of the event kernels' lane slots (lanes x launches) that did an
    event: 100 x live_lanes / lane_slots.  Layer: the event kernels."""
    slots = (st.counters or {}).get("lane_slots", 0) if st else 0
    if not slots:
        return None
    return 100.0 * st.counters["live_lanes"] / slots


def detect_ms_per_iter(st):
    """Device ms of the operations launched inside `detect` spans, per
    event launch.  Layer: the instruments."""
    if st is None:
        return None
    return _credited_ms_per_iter(st, lambda names: "detect" in names)


def peel_ms_per_iter(st):
    """Device ms of the operations launched inside `peel` spans and
    outside `detect`, per event launch.  Layer: the drivers."""
    if st is None:
        return None
    return _credited_ms_per_iter(
        st, lambda names: "peel" in names and "detect" not in names)


def dispatch_idle_ms_per_run(st):
    """Device idle ms inside `dispatch` spans, per run().  Layer: the
    drivers."""
    if st is None or not st.ops or not _runs(st):
        return None
    return idle_ns_in(st, "dispatch") / 1e6 / len(_runs(st))


def entry_idle_ms_per_run(st):
    """Device idle ms inside `run` and outside `dispatch` (batch set-up,
    drain, fold, write), per run().  Layer: the entry point."""
    if st is None or not st.ops or not _runs(st):
        return None
    return (idle_ns_in(st, "run") - idle_ns_in(st, "dispatch")) / 1e6 \
        / len(_runs(st))


def host_ms_per_iter(st):
    """Host ms per event launch inside `dispatch` spans and outside
    `check` (the stop test, where the host waits for the device): the
    host's own dispatch work.  Read from a phase with no profiler, whose
    host CUPTI does not slow.  Layer: the entry point and the drivers on
    the host."""
    if st is None or not st.launches:
        return None
    dispatch = _union(_named(st, "dispatch"))
    inside = sum(e - s for s, e in dispatch)
    if not inside:
        return None
    waits = _overlap_ns(dispatch, _named(st, "check"))
    return (inside - waits) / 1e6 / st.launches


READERS = (live_lane_share, detect_ms_per_iter, peel_ms_per_iter,
           dispatch_idle_ms_per_run, entry_idle_ms_per_run)


def summary(st: SpanTrace) -> dict:
    """The readings, the breakdowns and the checks of completeness of one
    traced phase."""
    out = {f.__name__: f(st) for f in READERS}
    total = sum(e - s for _, s, e, _ in st.ops)
    credited = sum(e - s for (_, s, e, _), k in zip(st.ops, credit(st))
                   if k >= 0)
    idle_run = idle_ns_in(st, "run")
    out.update({
        "wall_s": st.wall_s, "busy_s": busy_ns(st) / 1e9,
        "runs": len(_runs(st)), "spans": len(st.spans),
        "event_launches": st.launches,
        "counters": st.counters, "device_ops": len(st.ops),
        "runtime_calls": len(st.calls),
        "credited_share": credited / total if total else None,
        "idle_in_run_s": idle_run / 1e9,
        "device_lead_us": device_lead_us(st),
        "wall_minus_busy_s": st.wall_s - busy_ns(st) / 1e9,
        "device_s_by_span": [[k, v / 1e9] for k, v in device_ns_by_span(st)],
        "idle_by_span": idle_by_span(st),
        "event_kernel_us": _event_kernel_us(st)})
    return out


def device_lead_us(st):
    """The most that a device operation's stamped start precedes the
    runtime call that launched it, in us (0 where none does): a bound
    on how far CUPTI's device stamps run behind the host clock, which
    blurs the idle gaps' split at span boundaries by as much."""
    lead = 0
    for _, s, _, corr in st.ops:
        t = st.calls.get(corr)
        if t is not None:
            lead = max(lead, t - s)
    return lead / 1e3


def _event_kernel_us(st):
    by = {}
    for name, s, e, _ in st.ops:
        k = classify(name)[1]
        if k in ("K1", "K3"):
            ns, n = by.get(k, (0, 0))
            by[k] = (ns + e - s, n + 1)
    return {k: ns / 1e3 / n for k, (ns, n) in by.items()}


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import statistics
    import tempfile

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--runs", type=int, default=3)
    a = p.parse_args(argv)

    import torch

    import skirt_tpu_torch as port
    from rtbench import cells, program, run, tracing

    run.cache_dirs()
    torch.set_num_threads(1)
    cell, cfg = cells.load(a.workload)
    dev = torch.device("cuda")
    out_dir = os.path.join(tempfile.gettempdir(), "rtbench_spans",
                           a.workload)
    sim, host_s = program.build(cell, cfg, port, dev, out_dir)
    seeds = iter(range(10 ** 6))

    def call():
        program.run_once(sim, program.call_seed(a.seed, next(seeds)))

    call()                                             # warm-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(a.runs):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    t1 = time.perf_counter()
    tr = tracing.profile_phases(port, call, True)
    t2 = time.perf_counter()
    res = summary(tr.spans)
    t3 = time.perf_counter()
    res.update({
        "host_ms_per_iter": host_ms_per_iter(tr.host_spans),
        "host_phase_wall_s": tr.host_spans.wall_s,
        "untraced_idle_s": statistics.median(walls) - tr.busy_s(),
        "workload": a.workload, "seed": a.seed, "host_build_s": host_s,
        "untraced_walls_s": walls,
        "untraced_median_s": statistics.median(walls),
        "phase1_wall_s": tr.wall_s,
        "phase1_event_kernel_us": _event_kernel_us(SpanTrace(
            ops=[(n, s, e, 0) for n, s, e in tr.ops])),
        "phases_s": t2 - t1, "read_s": t3 - t2,
        "card": torch.cuda.get_device_name(dev)})
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
