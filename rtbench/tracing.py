"""The `--trace 1` run: whole `run()` phases under torch.profiler after
the window (`profile_phases`), reduced to the device operations and the
harness's host ranges that the per-layer metrics in metrics/ and the
breakdown read.

The ranges are installed from here by wrapping attributes of the port
(as profile_torch.py does); a range whose attribute is gone is left out,
and the metrics that read it report nothing.  The device's busy time is
the union of the device operations' intervals in the first traced
phase; CUPTI's records slow the host-bound drivers, so the idle share
holds it against the median untraced run() of the window (the same
work), and the traced phase's own wall is reported beside it."""

import time
from dataclasses import dataclass, field

from .kernel_names import EVENT_KERNELS, classify

# host ranges that name the idle gaps
RANGES = ("run", "batch", "detects", "write")
# the port's event dispatchers and their launch counters
EVENT_COUNTERS = (("engine.fused_poly", "poly_event"),
                  ("engine.fused", "mono_event"),
                  ("engine.fused_table", "table_event"),
                  ("engine.fused_table", "table_multi_event"),
                  ("engine.fused_table_poly", "table_poly_event"),
                  ("engine.fused_table_poly", "table_poly_multi_event"))


@dataclass
class Trace:
    """What the metric readers read.  Times in ns on the profiler's
    clock; `ops` are the device operations (kernels, copies, fills)."""
    ops: list = field(default_factory=list)        # (name, start, end)
    wall_s: float = 0.0                            # the phase's host wall
    untraced_wall_s: float = 0.0                   # a window run()'s wall
    # the second phase, recorded with the host: its device operations
    # and host ranges
    ranged_ops: list = field(default_factory=list)
    host: list = field(default_factory=list)
    launches: int | None = None                    # event-kernel launches
    host_build_s: float | None = None

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        total, end = 0, None
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e9

    def kernel_ns(self, pred) -> tuple[int, int]:
        """(summed ns, count) of the device operations whose
        classify() result satisfies pred(layer, kernel)."""
        ns = n = 0
        for name, s, e in self.ops:
            if pred(*classify(name)):
                ns += e - s
                n += 1
        return ns, n

    def event_kernel(self):
        """The port kernel of this cell's event (K1, K3, K4 ...), the one
        with the most launches, or None."""
        counts = {}
        for name, _, _ in self.ops:
            k = classify(name)[1]
            if k in EVENT_KERNELS:
                counts[k] = counts.get(k, 0) + 1
        return max(counts, key=counts.get) if counts else None


def _module(pkg, name):
    import importlib
    return importlib.import_module(f"{pkg.__name__}.{name}")


def _ranged(name, fn):
    import torch

    def inner(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    inner.__wrapped__ = fn
    return inner


def _wrap(obj, attr, name, installed):
    fn = getattr(obj, attr, None)
    if fn is None:
        return
    setattr(obj, attr, _ranged(name, fn))
    installed.add(name)


def install_sim_ranges(sim) -> set:
    """After the build: the detects, and the host ranges of the run
    (each batch, the write).  Returns the range names installed."""
    installed = set()
    for ins in sim.instruments:
        _wrap(ins, "detect", "detects", installed)
        _wrap(ins, "detect_poly", "detects", installed)
    _wrap(sim, "_lifecycle", "batch", installed)
    _wrap(sim, "write", "write", installed)
    return installed


def launches(pkg) -> int | None:
    """The sum of the port's event-kernel launch counters, or None when
    none of them is there."""
    total, seen = 0, False
    for mod, fn in EVENT_COUNTERS:
        try:
            n = getattr(getattr(_module(pkg, mod), fn), "launches")
        except (ImportError, AttributeError):
            continue
        total += int(n)
        seen = True
    return total if seen else None


def profile_phases(pkg, call, cuda: bool = True) -> Trace:
    """Two whole run() phases (`call()` runs one) under torch.profiler.
    The first records the device alone: the device operations, the event
    launches and the phase's wall, closed by a synchronize.  The second
    records the host too, with the host ranges, for the names of the
    idle gaps; no time of the second phase is compared with a
    wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def sync():
        if cuda:
            torch.cuda.synchronize()

    tr = Trace()
    if cuda:
        sync()
        n0 = launches(pkg)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            sync()
            tr.wall_s = time.perf_counter() - t0
        n1 = launches(pkg)
        tr.launches = None if n0 is None else n1 - n0
        tr.ops = _reduce(prof)[0]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function("run"):
            call()
        sync()
    tr.ranged_ops, tr.host = _reduce(prof)
    return tr


def _reduce(prof):
    """(device operations, host ranges) of a profile, each a list of
    (name, start ns, end ns)."""
    ops, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns()
        end = s + e.duration_ns()
        dev = str(e.device_type()).endswith("CUDA")
        act = str(e.activity_type()) if hasattr(e, "activity_type") else ""
        if dev:
            if "user_annotation" in act or name in RANGES:
                continue
            if act in ("kernel", "gpu_memcpy", "gpu_memset") or not act:
                ops.append((name, s, end))
        elif name in RANGES and ("user_annotation" in act or not act):
            host.append((name, s, end))
    return ops, host


def idle_gaps(tr: Trace, top: int = 10):
    """Device idle time summed by the innermost host range open when
    each gap began ("run: drain and bookkeeping" when only the phase's
    own range is), largest first: [[name, seconds], ...]."""
    ops = sorted(tr.ranged_ops, key=lambda o: o[1])
    if not ops:
        return []
    host = sorted(tr.host, key=lambda h: h[1])
    run = [h for h in host if h[0] == "run"]
    lo = run[0][1] if run else ops[0][1]
    hi = run[0][2] if run else ops[-1][2]
    gaps, end = [], lo
    for _, s, e in ops:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if hi > end:
        gaps.append((end, hi))
    # host ranges nest (one thread): sweep the gaps in time order with a
    # stack of the ranges open at each gap's start
    by, stack, nxt = {}, [], 0
    for gs, ge in gaps:
        while nxt < len(host) and host[nxt][1] <= gs:
            while stack and stack[-1][2] <= host[nxt][1]:
                stack.pop()
            stack.append(host[nxt])
            nxt += 1
        while stack and stack[-1][2] <= gs:
            stack.pop()
        inner = [h[0] for h in stack if h[0] != "run"]
        key = inner[-1] if inner else "run: drain and bookkeeping"
        by[key] = by.get(key, 0.0) + (ge - gs) / 1e9
    return sorted(([k, v] for k, v in by.items()),
                  key=lambda kv: -kv[1])[:top]


def device_ops(tr: Trace, top: int = 10):
    """Device seconds by layer (kernel_names.classify), largest first."""
    by = {}
    for name, s, e in tr.ops:
        layer = classify(name)[0]
        by[layer] = by.get(layer, 0.0) + (e - s) / 1e9
    return sorted(([k, v] for k, v in by.items()),
                  key=lambda kv: -kv[1])[:top]
