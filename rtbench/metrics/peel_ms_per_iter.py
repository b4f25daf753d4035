"""Device ms per event iteration of the operations launched inside the
port's `peel` spans and outside `detect` (the scattering peel's weights
and extinction), in the spans phase.  Layer: the drivers."""

from rtbench import spans


def read(trace):
    return spans.peel_ms_per_iter(trace.spans)
