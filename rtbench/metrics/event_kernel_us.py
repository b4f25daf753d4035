"""Mean device us per launch of the cell's event kernel (K1, K3, K4 or
K6: the port kernel with the most launches in the traced phase), by
kernel name.  Layer: the event kernels."""


def read(trace):
    k = trace.event_kernel()
    if k is None:
        return None
    ns, n = trace.kernel_ns(lambda layer, kernel: kernel == k)
    return ns / 1e3 / n
