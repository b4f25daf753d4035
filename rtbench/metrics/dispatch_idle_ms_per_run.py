"""Device idle ms inside the port's `dispatch` spans (the host falling
behind the event loop), per run(): the spans phase's share of its idle,
scaled to the untraced run()'s idle (Trace.untraced_idle_ms), since
CUPTI slows the host there.  Layer: the drivers."""

from rtbench import spans


def read(trace):
    return trace.untraced_idle_ms(spans.dispatch_idle_ms_per_run(trace.spans))
