"""Device ms per event iteration of the operations launched inside the
port's `exact_peel` spans (the table engines' exact column integrals
toward each observer direction), in the spans phase.  Layer: the
drivers."""

from rtbench import spans


def read(trace):
    if trace.spans is None:
        return None
    return spans._credited_ms_per_iter(
        trace.spans, lambda names: "exact_peel" in names)
