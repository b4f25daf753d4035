"""Where one batch of the port's main paths spends its time on the GPU.

Run on a CUDA machine from the repository root:

    python3 profile_torch.py [poly|mono ...]     (default: both)

poly builds the polychromatic main path as bench_torch.py does by
default (W = 128, 2^15 lanes, K = 128); mono builds the monochromatic
flagship (bench_torch.py with BENCH_POLY=0 BENCH_NLAMBDA=4
BENCH_LOG2_PACKETS=21: one of 4 wavelengths per lane, 2^21 lanes,
K = 128).  Both use the 32x32x16 grid, 32/8 panels, both instruments and
labs.  For each: one warm-up batch (it builds the kernels), 3 unprofiled
batches timed with torch.cuda.synchronize() while nvidia-smi samples the
SM clock and the power draw, then one batch under torch.profiler; it
prints:
  - the card, the unprofiled wall per batch, the SM clock and power draw
    under load, the event iterations of the batch (K1 or K3 launches);
  - device time per layer (the event kernel, K2 on each route, the
    uniforms, plain torch) with its share of the busy time and its launch
    count, and the device's idle share: 1 - busy / best unprofiled wall;
  - torch.profiler's table of the 40 largest device-time entries.
"""

import statistics
import subprocess
import time


def layer_of(name: str) -> str:
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


def profile(path):
    import torch

    from bench_torch import _build
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine import fused, fused_poly

    poly = path == "poly"
    event = fused_poly.poly_event if poly else fused.mono_event
    print(f"== {path} main path", flush=True)
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

    layers = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        ms, n = layers.get(layer_of(e.key), (0.0, 0))
        layers[layer_of(e.key)] = (ms + us / 1e3, n + e.count)
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
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=40), flush=True)


def main():
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
    for path in paths:
        profile(path)


if __name__ == "__main__":
    main()
