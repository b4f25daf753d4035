"""The least bytes a layer's work must move, from the port's counters,
for the roofline shares among metrics/ (one H100's HBM bandwidth)."""

# one NVIDIA H100 SXM's HBM3 bandwidth, NVIDIA's data sheet (at 700 W)
HBM_BYTES_PER_S = 3.35e12


def exact_peel_bytes(peel_rays: int, peel_voxels: int) -> int:
    """The least traffic of the exact peel's optical depths: per (ray,
    voxel) overlap of nonzero length, times the dust components (the
    counter `peel_voxels`), one float32 density read, 4 bytes; per ray (a
    lane toward one observer direction, `peel_rays`) its float32 position
    read and its optical depth written, 16 bytes.  These are what any
    exact integral of the piecewise-constant field along those rays must
    read and write, whatever implements it, so the share reads the same
    work on every implementation.  The voxel reads are charged at HBM
    bandwidth: a walk that keeps the field in L2 could read them faster,
    and would then show above 100%."""
    return 4 * int(peel_voxels) + 16 * int(peel_rays)
