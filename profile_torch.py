"""Where one batch of the port's main paths spends its time on the GPU.

Run on a CUDA machine from the repository root:

    python3 profile_torch.py [poly|mono ...]     (default: both)
    BENCH_MODEL=octree python3 profile_torch.py [poly|mono ...]
    BENCH_MODEL=multi python3 profile_torch.py [poly|mono ...]
    BENCH_MODEL=voronoi python3 profile_torch.py [poly|mono ...]
    BENCH_MODEL=polarized [POL_TABLE=1] python3 profile_torch.py [poly|mono]

poly builds the polychromatic main path as bench_torch.py does by
default (W = 128, 2^15 lanes, K = 128); mono builds the monochromatic
flagship (bench_torch.py with BENCH_POLY=0 BENCH_NLAMBDA=4
BENCH_LOG2_PACKETS=21: one of 4 wavelengths per lane, 2^21 lanes,
K = 128).  Both use the 32x32x16 grid, 32/8 panels, both instruments and
labs.  With BENCH_MODEL=octree they build capability config 3 instead,
as `BENCH_MODEL=octree bench_torch.py` does (its OCTREE_NLAM and
OCTREE_LOG2N knobs; poly: W = 2 per lane, 2^17 lanes, K = 256, kernel
K6; mono: one of 2 wavelengths per lane, 2^17 lanes, K = 128, kernel
K4).  BENCH_MODEL=multi builds the two-component model as
`BENCH_MODEL=multi bench_torch.py` does (OCTREE_LOG2N, OCTREE_REFILL;
poly: W = 2 per lane, kernel K7; mono: kernel K5; 2^17 lanes, K = 128).
BENCH_MODEL=voronoi builds capability config 4 as `BENCH_MODEL=voronoi
bench_torch.py` does (its VORONOI_* knobs: by default the voxel view of
4,096 sites, K6 / K4; VORONOI_DIRECT=1 the direct table, K6d / K4d,
with the staged peel) and prints the host build on a line of its own.
BENCH_MODEL=polarized builds experiments/bench_polarized.py's chains as
`BENCH_MODEL=polarized bench_torch.py` does (its POL_* knobs): mono the
analytic flagship (K3), with POL_TABLE=1 the table on config 3's torus
(K4); poly (POL_TABLE=1) the poly table (K6p); with a "mueller" range
around the torch-side Mueller block (the default normals, the theta and
phi samples, the Mueller lookups, the Stokes and normal updates of the
scatter, the polarized peel's weights and frame rotations and the Stokes
carry; not the poly engine's inline reweighting arithmetic).  For each: one warm-up batch (it builds the kernels), 3 unprofiled
batches timed with torch.cuda.synchronize() while nvidia-smi samples the
SM clock and the power draw, then one batch under torch.profiler; it
prints:
  - the card, the unprofiled wall per batch, the SM clock and power draw
    under load, the event iterations of the batch (event kernel launches);
  - device time per layer (the event kernel, K2 on each route, the
    uniforms, plain torch) with its share of the busy time and its launch
    count, and the device's idle share: 1 - busy / best unprofiled wall;
  - on the table models, the device time of the table path's plain-torch
    stages, each wrapped in a profiler range for the profiled batch: the
    staging gather (panel paths, locate and rho gather of the panel rows),
    the exact column-DDA peel or the staged panel peel, the detects, and
    on a Voronoi grid the point locates (the grid's locate_batched: the
    staging locate, the deposit locate of the direct table, the staged
    peel's locates).  A kernel inside a locate range counts as locate,
    any other as the outermost range around it; the rest of the plain
    torch (refill, bookkeeping, the two-component model's torch-side
    scatter and blended phase) is what remains;
  - torch.profiler's table of the 40 largest device-time entries.
"""

import statistics
import subprocess
import time


def layer_of(name: str) -> str:
    if "table_poly_multi_event_kernel" in name:
        return "K7 table_poly_multi_event"
    if "table_multi_event_kernel" in name:
        return "K5 table_multi_event"
    if "table_poly_event_kernel" in name:
        return "K6 table_poly_event (or K6d, K6p)"
    if "table_event_kernel" in name:
        return "K4 table_event"
    if "poly_event_kernel" in name:
        return "K1 poly_event"
    if "mono_event_kernel" in name:
        return "K3 mono_event"
    if "binned_add_shared" in name:
        return "K2 binned_add, shared route (frame)"
    if "binned_add_global" in name:
        return "K2 binned_add, global route (labs)"
    if "distribution" in name:
        return "uniforms (Philox)"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "copies and fills"
    return "plain torch: detects, emission peel, bookkeeping"


# the table paths' plain-torch stages, each a profiler range in the
# profiled batch
STAGES = ("stage gather", "exact peel", "staged peel", "locate", "detects",
          "mueller")

# the torch-side Mueller block of the polarized engines
_MUELLER_FNS = ("polarization_of", "reference_normals", "scatter_stokes",
                "peel_toward", "to_instrument_frame", "carry_stokes")
_MUELLER_METHODS = ("sample_theta", "sample_phi", "lookup", "lookup_all")


def _ranged(name, fn):
    import torch

    def inner(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return inner


def _ranged_peel(taus):
    """The exact peel (and its per-component integrals) in a range."""
    inner = _ranged("exact peel", taus)
    inner.integrals = _ranged("exact peel", taus.integrals)
    return inner


def _build_octree(poly, model="octree"):
    """Config 3's (or the two-component model's, or config 4's) lifecycle
    with its stages wrapped in profiler ranges: (run_batch, zero_tallies,
    ell, L0, restore, the stages it has)."""
    import os

    from bench_torch import _octree_build, _voronoi_knobs
    from skirt_tpu_torch.engine import (fused_table, fused_table_poly,
                                        vector_traversal)

    orig_peel = fused_table.make_exact_peel
    orig_staged = fused_table.make_staged_peel
    orig_paths = vector_traversal.panel_paths
    orig_rows = fused_table_poly.component_rows
    fused_table.make_exact_peel = lambda *a, **kw: _ranged_peel(
        orig_peel(*a, **kw))
    fused_table.make_staged_peel = lambda *a, **kw: _ranged(
        "staged peel", orig_staged(*a, **kw))
    vector_traversal.panel_paths = _ranged("stage gather", orig_paths)
    fused_table_poly.component_rows = _ranged("stage gather", orig_rows)
    env = os.environ.get
    lanes = 1 << int(env("OCTREE_LOG2N", "17"))
    if model == "polarized":
        from bench_torch import _polarized_build, _polarized_knobs
        from skirt_tpu_torch.media import polarization as pol

        saved = {n: getattr(pol, n) for n in _MUELLER_FNS}
        saved.update({n: getattr(pol.MuellerTables, n)
                      for n in _MUELLER_METHODS})
        for n in _MUELLER_FNS:
            setattr(pol, n, _ranged("mueller", saved[n]))
        for n in _MUELLER_METHODS:
            setattr(pol.MuellerTables, n, _ranged("mueller", saved[n]))
        lanes, kw = _polarized_knobs()
        kw["poly"] = poly
        run_batch, zero, ell, L0, _, built = _polarized_build(
            lanes, device="cuda", **kw)
    else:
        if model == "voronoi":
            _, lanes, kw = _voronoi_knobs()
            kw["voronoi"] = True
        elif model == "multi":
            kw = dict(refill_batches=int(env("OCTREE_REFILL", "128")))
        else:
            kw = dict(nlambda=int(env("OCTREE_NLAM", "2")))
        run_batch, zero, ell, L0, _, built = _octree_build(
            lanes, device="cuda", multi=model == "multi",
            polychromatic=poly, **kw)
    grid, ds, ins = built[0], built[1], built[3]
    if ds.table:
        ds.analytic_rows = _ranged("stage gather", ds.analytic_rows)
    for i in ins:
        i.detect = _ranged("detects", i.detect)
        i.detect_poly = _ranged("detects", i.detect_poly)
    stages = ["stage gather", "detects"]
    if not ds.table:
        stages = ["detects"]            # the analytic flagship: in K3
    elif hasattr(grid, "nx"):
        stages.append("exact peel")
    else:
        grid.locate_batched = _ranged("locate", grid.locate_batched)
        stages += ["staged peel", "locate"]
    if model == "polarized":
        stages.append("mueller")
    if model == "voronoi":
        print(f"host build: {built[-1]}", flush=True)
    if model == "polarized":
        print(f"host build: {built[-1]['build']:.2f} s", flush=True)

    def restore():
        fused_table.make_exact_peel = orig_peel
        fused_table.make_staged_peel = orig_staged
        vector_traversal.panel_paths = orig_paths
        fused_table_poly.component_rows = orig_rows
        if model == "polarized":
            for n in _MUELLER_FNS:
                setattr(pol, n, saved[n])
            for n in _MUELLER_METHODS:
                setattr(pol.MuellerTables, n, saved[n])
    return run_batch, zero, ell, L0, restore, stages


def profile(path, model="disc"):
    import torch

    from bench_torch import _build
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine import (fused, fused_poly, fused_table,
                                        fused_table_poly)

    import os

    poly = path == "poly"
    octree = model in ("octree", "multi", "voronoi", "polarized")
    label = {"disc": "", "octree": "config 3 ", "voronoi": "config 4 ",
             "multi": "two-component ", "polarized": "polarized "}[model]
    print(f"== {label}{path} main path", flush=True)
    restore = None
    stages_built = ()
    if model == "polarized":
        table = os.environ.get("POL_TABLE", "0") == "1"
        if poly and not table:
            raise SystemExit("profile_torch: the polarized poly chain runs "
                             "on the table (POL_TABLE=1)")
        event = (fused_table_poly.table_poly_event if poly
                 else fused_table.table_event if table
                 else fused.mono_event)
    elif model == "multi":
        event = (fused_table_poly.table_poly_multi_event if poly
                 else fused_table.table_multi_event)
    elif octree:
        event = (fused_table_poly.table_poly_event if poly
                 else fused_table.table_event)
    if octree:
        run_batch, zero_tallies, ell, L0, restore, stages_built = \
            _build_octree(poly, model)
    else:
        event = fused_poly.poly_event if poly else fused.mono_event
        run_batch, zero_tallies, ell, L0 = _build(
            nlambda=128 if poly else 4, ncells=32,
            packets=1 << 15 if poly else 1 << 21, refill_batches=128,
            quadrature_panels=32, peel_panels=8, polychromatic=poly,
            device="cuda")
    key = rng.root_key(4357)
    run_batch(key, ell, L0, zero_tallies())              # warm-up + build
    torch.cuda.synchronize()

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        walls = []
        for i in range(3):
            t0 = time.perf_counter()
            run_batch(rng.fold_in(key, i + 1), ell, L0, zero_tallies())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        smi.terminate()
        samples = smi.communicate(timeout=30)[0].split("\n")
    clocks, power = [], []
    for line in samples:
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2:
            try:
                clocks.append(float(parts[0]))
                power.append(float(parts[1]))
            except ValueError:
                pass
    print("unprofiled wall per batch: "
          + ", ".join(f"{w:.4f} s" for w in walls), flush=True)
    if clocks:
        print(f"under load ({len(clocks)} samples): SM clock median "
              f"{statistics.median(clocks):.0f} MHz (min {min(clocks):.0f}),"
              f" power draw median {statistics.median(power):.1f} W "
              f"(max {max(power):.1f} W)", flush=True)

    event.launches = 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run_batch(rng.fold_in(key, 99), ell, L0, zero_tallies())
        torch.cuda.synchronize()
    iters = event.launches
    if restore is not None:
        restore()

    # device kernels and, on the table models, the stage ranges' spans on
    # the device timeline; a kernel belongs to a locate span that holds its
    # start, else to the outermost span that does (the spans include idle
    # gaps, the kernel sums do not)
    cuda = torch.autograd.DeviceType.CUDA
    kernels_, spans = [], []
    for e in prof.events():
        if e.device_type != cuda:
            continue
        if e.name in STAGES:
            spans.append((e.time_range.start, e.time_range.end, e.name))
        else:
            kernels_.append(e)
    spans.sort()
    if octree:
        # a stage whose hook the engines bypass would silently land in
        # "outside the stages"
        lost = [s for s in stages_built
                if not any(sp[2] == s for sp in spans)]
        if lost:
            raise SystemExit(f"profile_torch: no device range for the "
                             f"stages {lost}: a stage hook was bypassed")
    layers, stages = {}, {}
    kernels_.sort(key=lambda e: e.time_range.start)
    open_spans, nxt = [], 0
    for e in kernels_:
        ms_e = e.time_range.elapsed_us() / 1e3
        ms, n = layers.get(layer_of(e.name), (0.0, 0))
        layers[layer_of(e.name)] = (ms + ms_e, n + 1)
        t = e.time_range.start
        while nxt < len(spans) and spans[nxt][0] <= t:
            open_spans.append(spans[nxt])
            nxt += 1
        open_spans = [sp for sp in open_spans if t < sp[1]]
        if open_spans:
            names = [sp[2] for sp in open_spans]
            owner = "locate" if "locate" in names else names[0]
            stages[owner] = stages.get(owner, 0.0) + ms_e
    busy = sum(ms for ms, _ in layers.values())
    if busy == 0:
        raise SystemExit("profile_torch: the profiler saw no device time")
    best = min(walls) * 1e3
    print(f"profiled batch: {iters} event iterations; device busy "
          f"{busy:.1f} ms; idle share of the best unprofiled batch "
          f"{1 - busy / best:.3f}", flush=True)
    print(f"{'layer':52s} {'device ms':>10s} {'share':>7s} {'launches':>9s}")
    for name, (ms, n) in sorted(layers.items(), key=lambda kv: -kv[1][0]):
        print(f"{name:52s} {ms:10.1f} {ms / busy:7.1%} {n:9d}")
    if octree:
        print(f"{'table path stage (kernels inside its ranges)':52s} "
              f"{'device ms':>10s} {'share':>7s} {'ranges':>9s}")
        for name in stages_built:
            ms = stages.get(name, 0.0)
            n = sum(1 for sp in spans if sp[2] == name)
            print(f"{name:52s} {ms:10.1f} {ms / busy:7.1%} {n:9d}")
        rest = busy - sum(stages.values())
        print(f"{'outside the stages (kernels, uniforms, refill)':52s} "
              f"{rest:10.1f} {rest / busy:7.1%}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=40), flush=True)


def main():
    import os
    import sys

    import torch

    from chip_smoke import card_line

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: no CUDA device")
    print(f"card: {card_line()}", flush=True)
    paths = sys.argv[1:] or ["poly", "mono"]
    for path in paths:
        if path not in ("poly", "mono"):
            raise SystemExit(f"profile_torch: unknown path {path!r}")
    model = os.environ.get("BENCH_MODEL", "disc")
    if model not in ("disc", "octree", "multi", "voronoi", "polarized"):
        raise SystemExit(f"profile_torch: unknown BENCH_MODEL {model!r}")
    for path in paths:
        profile(path, model)


if __name__ == "__main__":
    main()
