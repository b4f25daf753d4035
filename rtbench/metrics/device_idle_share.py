"""Device idle share, in %: 1 - (the union of the device operations'
intervals in the traced run() phase) / (the median untraced run() of the
window, the same work).  The traced phase's own wall is longer by what
CUPTI's records cost the host (`device.window_s` beside `busy_s` in the
result line), so it is not the divisor.  Layer: the device."""


def read(trace):
    if not trace.ops or trace.untraced_wall_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.untraced_wall_s)
