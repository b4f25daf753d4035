"""Device idle ms inside the port's `run` span and outside `dispatch`
(batch set-up, the float64 drain, the writes), per run(): the spans
phase's share of its idle, scaled to the untraced run()'s idle
(Trace.untraced_idle_ms), since CUPTI slows the host there.  Layer: the
entry point."""

from rtbench import spans


def read(trace):
    return trace.untraced_idle_ms(spans.entry_idle_ms_per_run(trace.spans))
