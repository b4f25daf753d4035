"""Device ms per event iteration of the operations launched inside the
port's `detect` spans (every instrument's detect), in the spans phase.
Layer: the instruments."""

from rtbench import spans


def read(trace):
    return spans.detect_ms_per_iter(trace.spans)
