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
(K4); poly (POL_TABLE=1) the poly table (K6p).  For each: one warm-up
batch (it builds the kernels), 3 unprofiled batches timed with
torch.cuda.synchronize() while nvidia-smi samples the SM clock and the
power draw, then one batch under torch.profiler (CUDA activity) with the
program's own spans and counters on (skirt_tpu_torch/trace.py, read by
rtbench/spans.py); it prints:
  - the card, the unprofiled wall per batch, the SM clock and power draw
    under load, the event iterations of the batch (event kernel launches)
    and, on the analytic engines (K1, K3), the share of their lanes that
    did an event;
  - device time per layer (the event kernel, K2 on each route, the
    uniforms, plain torch) with its share of the busy time and its launch
    count, and the device's idle share: 1 - busy / best unprofiled wall;
  - device time by program span: each operation under the innermost span
    open at the runtime call that launched it (launch, check, event, peel,
    detect; on the table models stage_gather, the panel-row staging;
    exact_peel or staged_peel; on a Voronoi grid locate, the grid's
    locate_batched wherever it is called; on the polarized chains mueller,
    the torch-side Mueller block, on the poly table with the polarized
    reweighting around the event).  A table model whose stage span shows
    no device time stops the script: a stage span was bypassed;
  - the 40 largest device operations by name.
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
    if "bin_sum_kernel" in name:
        return "bin sum (the mono detects' SEDs)"
    if "exact_peel_kernel" in name:
        return "exact peel (the table engines' column integrals)"
    if "peel_sed_kernel" in name:
        return "peel: the SED peel (the poly scattering peel into the SEDs)"
    if "distribution" in name:
        return "uniforms (Philox)"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "copies and fills"
    return "plain torch: detects, emission peel, bookkeeping"



def _build_octree(poly, model="octree"):
    """Config 3's (or the two-component model's, or config 4's) lifecycle:
    (run_batch, zero_tallies, ell, L0, the stage spans it opens)."""
    import os

    from bench_torch import _octree_build, _voronoi_knobs

    env = os.environ.get
    lanes = 1 << int(env("OCTREE_LOG2N", "17"))
    if model == "polarized":
        from bench_torch import _polarized_build, _polarized_knobs

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
    grid, ds = built[0], built[1]
    stages = ["stage_gather", "detect"]
    if not ds.table:
        stages = ["detect"]             # the analytic flagship: in K3
    elif hasattr(grid, "nx"):
        stages.append("exact_peel")
    else:
        stages += ["staged_peel", "locate"]
    if model == "polarized":
        stages.append("mueller")
    if model == "voronoi":
        print(f"host build: {built[-1]}", flush=True)
    if model == "polarized":
        print(f"host build: {built[-1]['build']:.2f} s", flush=True)
    return run_batch, zero, ell, L0, stages


def profile(path, model="disc"):
    import os

    import torch

    import skirt_tpu_torch
    from bench_torch import _build
    from rtbench import spans as sp
    from skirt_tpu_torch import rng

    poly = path == "poly"
    octree = model in ("octree", "multi", "voronoi", "polarized")
    label = {"disc": "", "octree": "config 3 ", "voronoi": "config 4 ",
             "multi": "two-component ", "polarized": "polarized "}[model]
    print(f"== {label}{path} main path", flush=True)
    stages_built = ()
    if (model == "polarized" and poly
            and os.environ.get("POL_TABLE", "0") != "1"):
        raise SystemExit("profile_torch: the polarized poly chain runs "
                         "on the table (POL_TABLE=1)")
    if octree:
        run_batch, zero_tallies, ell, L0, stages_built = _build_octree(
            poly, model)
    else:
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

    st = sp.profile_spans(skirt_tpu_torch, lambda: run_batch(
        rng.fold_in(key, 99), ell, L0, zero_tallies()))
    iters = st.launches

    # device operations by layer (kernel name) and by the program span
    # that launched them (the innermost span open at the runtime call)
    layers = {}
    for name, s, e, _ in st.ops:
        ms, n = layers.get(layer_of(name), (0.0, 0))
        layers[layer_of(name)] = (ms + (e - s) / 1e6, n + 1)
    by_span = {k: ns / 1e6 for k, ns in sp.device_ns_by_span(st)}
    busy = sp.busy_ns(st) / 1e6
    if busy == 0:
        raise SystemExit("profile_torch: the profiler saw no device time")
    if octree:
        # a stage the engines no longer open would silently land in its
        # caller's span
        lost = [s for s in stages_built if s not in by_span]
        if lost:
            raise SystemExit(f"profile_torch: no device time in the spans "
                             f"{lost}: a stage span was bypassed")
    best = min(walls) * 1e3
    share = sp.live_lane_share(st)
    print(f"profiled batch: {iters} event iterations; device busy "
          f"{busy:.1f} ms; idle share of the best unprofiled batch "
          f"{1 - busy / best:.3f}; live lanes "
          + ("not counted" if share is None else f"{share:.1f}%"),
          flush=True)
    total = sum(ms for ms, _ in layers.values())
    print(f"{'layer':52s} {'device ms':>10s} {'share':>7s} {'launches':>9s}")
    for name, (ms, n) in sorted(layers.items(), key=lambda kv: -kv[1][0]):
        print(f"{name:52s} {ms:10.1f} {ms / total:7.1%} {n:9d}")
    print(f"{'program span (innermost at the launch)':52s} "
          f"{'device ms':>10s} {'share':>7s} {'spans':>9s}")
    for name, ms in by_span.items():
        n = sum(1 for sp_ in st.spans if sp_[0] == name)
        print(f"{name:52s} {ms:10.1f} {ms / total:7.1%} {n:9d}")
    top = {}
    for name, s, e, _ in st.ops:
        ms, n = top.get(name, (0.0, 0))
        top[name] = (ms + (e - s) / 1e6, n + 1)
    print(f"{'device operation (40 largest)':52s} {'device ms':>10s} "
          f"{'calls':>9s}")
    for name, (ms, n) in sorted(top.items(), key=lambda kv: -kv[1][0])[:40]:
        print(f"{name[:52]:52s} {ms:10.2f} {n:9d}")
    print(flush=True)


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
