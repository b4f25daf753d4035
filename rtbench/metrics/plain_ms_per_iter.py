"""Device ms per event iteration of the operations that are not the
port's own kernels (csrc/): PyTorch's kernels, uniforms, copies and
fills, summed over the traced phase and divided by the event-kernel
launches.  Layer: the drivers."""


def read(trace):
    if not trace.launches:
        return None
    ns, n = trace.kernel_ns(lambda layer, kernel: kernel is None)
    if n == 0:
        return None
    return ns / 1e6 / trace.launches
