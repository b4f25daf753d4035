"""Device us of the K2 tallies (binned_add_*) per event iteration of the
traced phase.  Layer: the K2 tallies."""


def read(trace):
    if not trace.launches:
        return None
    ns, n = trace.kernel_ns(lambda layer, kernel: kernel == "K2")
    if n == 0:
        return None
    return ns / 1e3 / trace.launches
