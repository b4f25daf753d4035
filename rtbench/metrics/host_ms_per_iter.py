"""Host ms per event iteration of the port's own dispatch work: the wall
inside its `dispatch` spans less the `check` spans (the stop test, where
the host waits for the device), over the event launches, in the host
phase (the spans on, no profiler yet).  Layer: the entry point and
the drivers on the host."""

from rtbench import spans


def read(trace):
    return spans.host_ms_per_iter(trace.host_spans)
