"""Device operations launched per event iteration of the traced phase:
every kernel, copy and fill on the device over the event-kernel launches
(the port's `event.launches` counters).  Layer: the drivers."""


def read(trace):
    if not trace.launches or not trace.ops:
        return None
    return len(trace.ops) / trace.launches
