"""The `--trace 1` run: whole `run()` phases after the window
(`profile_phases`), reduced to what the per-layer metrics in metrics/
and the breakdown read.

Before any profiler is attached, the host phase runs with the port's
spans on and nothing else (`Trace.host_spans`): the host's own time in
each stage, which CUPTI would slow.  The first traced phase records the
device alone under torch.profiler: its operations, named by kernel
(kernel_names.classify), the event launches and the phase's wall.  The
second runs with the port's own spans and counters on under a CUDA-only
profile (spans.profile_spans): which stage of the port launched each
device operation, which stage the device waited on in each idle gap, and
the event kernels' live lanes; it is kept whole as `Trace.spans`.  The
device's busy time is the union of the
first phase's operation intervals; CUPTI's records slow the host-bound
drivers, so the idle share holds it against the median untraced run()
of the window (the same work), and the second phase's idle, split over
the spans, is scaled to that untraced idle (`untraced_idle_ms`).  The
traced phases' own walls are reported beside them."""

import time
from dataclasses import dataclass, field

from .kernel_names import EVENT_KERNELS, classify
from .spans import (SpanTrace, idle_by_span, idle_ns_in, launches,
                    profile_spans)


@dataclass
class Trace:
    """What the metric readers read.  Times in ns on the profiler's
    clock; `ops` are the first phase's device operations (kernels,
    copies, fills)."""
    ops: list = field(default_factory=list)        # (name, start, end)
    wall_s: float = 0.0                            # the phase's host wall
    untraced_wall_s: float = 0.0                   # a window run()'s wall
    launches: int | None = None                    # event-kernel launches
    host_build_s: float | None = None
    spans: SpanTrace | None = None                 # the second phase
    host_spans: SpanTrace | None = None            # the host phase

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

    def untraced_idle_ms(self, ms):
        """`ms`, a share of the second phase's device idle per run(),
        scaled to the untraced run(): times (the median untraced run()'s
        wall less the first phase's busy time) over the second phase's
        idle inside run() per run().  None where a side is missing."""
        st = self.spans
        if ms is None or not self.ops or self.untraced_wall_s <= 0 \
                or st is None:
            return None
        runs = sum(1 for s in st.spans if s[0] == "run")
        traced = idle_ns_in(st, "run") / 1e6 / runs if runs else 0.0
        if traced <= 0:
            return None
        untraced = max(0.0, (self.untraced_wall_s - self.busy_s()) * 1e3)
        return ms * untraced / traced

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


def profile_phases(pkg, call, cuda: bool = True) -> Trace:
    """Whole run() phases (`call()` runs one).  On a card: the host
    phase, spans.profile_spans without a profiler, ahead of the profiled
    phases, since the host is measured slower after a CUDA profile has
    run (PERF.md section 3); then the first, the device alone under
    torch.profiler: the device operations, the event launches and the
    phase's wall, closed by a synchronize.  The second is
    spans.profile_spans: the port's spans and counters (on the CPU those
    alone, and it stands for the host phase there)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tr = Trace()
    if cuda:
        tr.host_spans = profile_spans(pkg, call, cuda, profiled=False)
        torch.cuda.synchronize()
        n0 = launches(pkg)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            tr.wall_s = time.perf_counter() - t0
        n1 = launches(pkg)
        tr.launches = None if n0 is None else n1 - n0
        tr.ops = _reduce(prof)
    tr.spans = profile_spans(pkg, call, cuda)
    if not cuda:
        tr.host_spans = tr.spans
    return tr


def _reduce(prof):
    """The device operations of a profile: (name, start ns, end ns)."""
    ops = []
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        act = str(e.activity_type()) if hasattr(e, "activity_type") else ""
        if "user_annotation" in act:
            continue
        if act in ("kernel", "gpu_memcpy", "gpu_memset") or not act:
            s = e.start_ns()
            ops.append((e.name(), s, s + e.duration_ns()))
    return ops


def idle_gaps(tr: Trace, top: int = 10):
    """The device's idle seconds in the spans phase, split over the
    port's spans each gap overlaps (spans.idle_by_span), largest first:
    [[name, seconds], ...]; empty where that phase recorded no device
    operation."""
    if tr.spans is None or not tr.spans.ops:
        return []
    return idle_by_span(tr.spans, top)


def device_ops(tr: Trace, top: int = 10):
    """Device seconds by layer (kernel_names.classify), largest first."""
    by = {}
    for name, s, e in tr.ops:
        layer = classify(name)[0]
        by[layer] = by.get(layer, 0.0) + (e - s) / 1e9
    return sorted(([k, v] for k, v in by.items()),
                  key=lambda kv: -kv[1])[:top]
