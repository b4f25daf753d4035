"""The exact peel's share of its roofline, in %: 100 x the least bytes
its integrals must move (roofline.exact_peel_bytes, from the port's
`peel_rays` and `peel_voxels` counters) over HBM bandwidth, over the
device seconds of the operations launched inside `exact_peel` spans,
all in the spans phase.  None where the port has no such counters.
Layer: the drivers."""

from rtbench import roofline, spans


def read(trace):
    st = trace.spans
    counters = (st.counters or {}) if st is not None else {}
    if not counters.get("peel_rays") or not st.launches:
        return None
    ms = spans._credited_ms_per_iter(st, lambda names: "exact_peel" in names)
    if not ms:
        return None
    seconds = ms * st.launches / 1e3
    least = roofline.exact_peel_bytes(counters["peel_rays"],
                                      counters.get("peel_voxels", 0))
    return 100.0 * least / roofline.HBM_BYTES_PER_S / seconds
