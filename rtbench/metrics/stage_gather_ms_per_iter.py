"""Device ms per event iteration of the operations launched inside the
port's `stage_gather` spans (the table engines' panel-row staging: the
panel midpoints located and their densities gathered), in the spans
phase.  Layer: the drivers."""

from rtbench import spans


def read(trace):
    if trace.spans is None:
        return None
    return spans._credited_ms_per_iter(
        trace.spans, lambda names: "stage_gather" in names)
