"""Which part of the port a device operation belongs to, by kernel name
(the copy of profile_torch.py's `layer_of`, with the kernels of the
port's csrc/ named by their entry points).  The first pattern that the
name contains wins, so the longer names come first."""

# (pattern in the kernel's name, layer, port kernel)
CSRC = (
    ("table_poly_multi_event", "K7 table_poly_multi_event", "K7"),
    ("table_multi_event", "K5 table_multi_event", "K5"),
    ("table_poly_event", "K6 table_poly_event", "K6"),
    ("table_event", "K4 table_event", "K4"),
    ("poly_event", "K1 poly_event", "K1"),
    ("mono_event", "K3 mono_event", "K3"),
    ("binned_add_shared", "K2 binned_add, shared route", "K2"),
    ("binned_add_global", "K2 binned_add, global route", "K2"),
    ("blocked_", "K8 blocked tally", "K8"),
    ("probe_", "probes", "probe"),
    ("mm_bf16", "probes", "probe"),
    ("mm_f32", "probes", "probe"),
)

EVENT_KERNELS = ("K1", "K3", "K4", "K5", "K6", "K7")


def classify(name: str):
    """(layer, port kernel or None) of a device operation."""
    for pattern, layer, kernel in CSRC:
        if pattern in name:
            return layer, kernel
    low = name.lower()
    if "distribution" in low or "philox" in low:
        return "plain torch: uniforms (Philox)", None
    if "memcpy" in low or "memset" in low:
        return "plain torch: copies and fills", None
    return "plain torch: the drivers' arithmetic", None
