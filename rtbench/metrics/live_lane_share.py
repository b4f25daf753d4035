"""% of the analytic event kernels' lane slots (K1, K3: lanes x
launches) that did an event, from the port's `lane_slots` and
`live_lanes` counters in the spans phase.  Layer: the event kernels."""

from rtbench import spans


def read(trace):
    return spans.live_lane_share(trace.spans)
