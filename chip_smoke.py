"""GPU smoke test of skirt_tpu_torch: kernels, parity and the main path.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each prints one line first; any failure raises and the script
exits non-zero without printing a result):
  1. the card (nvidia-smi name and power limit) and torch / CUDA versions;
     no CUDA device is an error, never a CPU fallback
  2. build the CUDA kernels with nvcc (skirt_tpu_torch/_build/)
  3. K2 binned_add kernel vs its plain version at the main path's shapes:
     the frame tally (4,194,304 updates into 32,768 bins, with dropped
     indices) and the labs tally (32,768 updates into 2,097,152 bins)
  4. K1 poly_event kernel vs its plain version on identical inputs at the
     main path's shapes (N = 32,768 lanes, W = 128, 32/8 panels, 2
     leaders, refill K = 128 from the ExpDisk sampler), chained over six
     events from each of three skirt_tpu_torch.testing.event_case states:
     about 10% dead lanes (some with the launch budget used up),
     axis-parallel directions and a weight cut that fires
  5. the main path through make_lifecycle + make_multibatch at the bench
     model's full width (bench_torch._build defaults): the launch counts
     of both kernels are reset just before and read just after, and the
     run's tallies are checked; then the same model family at a small
     size on the card against the plain path on the CPU
  6. one JSON line of per-kernel results, the card line, and last
     {"ok": true, "device": {...}}

Tolerances: K2 per bin rtol 1e-4 (float32 sums of up to a few hundred
updates taken in another order by atomics; each order is within
n * 2^-24 of the exact sum).  K1 by skirt_tpu_torch.testing's criterion:
the discrete outputs (deposit bin, alive, nscatt, bcount, fresh, the
wavelengths that survive the weight cut) agree on >= 99.9% of lanes (the
CPU test's bound), and every float output to rtol 1e-4 with atol 1e-6 x
the array's largest magnitude on every lane whose discrete outputs agree.
On the card the kernel and its plain version round alike op for op
(-fmad=false, float32 reciprocals of the scale lengths, sums over w in w
order, rsqrtf), so they agree to the bit in practice; the bounds leave
room only for a compiler that rounds one op differently.  K1's
max_abs_err is taken over the float outputs, each scaled by its array's
largest magnitude, on the lanes whose discrete outputs agree.  The
small-size cross-device check holds the CUDA run to the CPU run at the
Monte Carlo tolerances of tests/test_poly.py (per-wavelength SED 0.15,
totals 0.05): the two devices draw different random streams.
"""

import json
import subprocess
import sys
import time

import numpy as np


# K1: events chained from each of three starting states
K1_EVENTS = 6


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=10, warmup=2):
    """Mean device time of fn() over reps launches, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_k2(torch, results):
    from skirt_tpu_torch.ops import binned

    rs = np.random.default_rng(12)
    worst = 0.0
    times = {}
    shapes = {"frame": (32768, 128 * 32768), "labs": (128 * 16384, 32768)}
    for name, (nbins, n) in shapes.items():
        idx = rs.integers(0, nbins, n)
        drop = rs.random(n)
        idx = np.where(drop < 0.05, -1, idx)              # escaped lanes
        idx = np.where(drop > 0.995, nbins + 7, idx)      # out of range
        idx = torch.from_numpy(idx.astype(np.int32)).cuda()
        val = torch.from_numpy(rs.random(n).astype(np.float32)).cuda()
        got = binned.binned_add(torch.zeros(nbins, device="cuda"), idx, val)
        want = binned.drop_add(torch.zeros(nbins, device="cuda"), idx, val)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        tally = torch.zeros(nbins, device="cuda")
        ms = cuda_ms(lambda: binned.binned_add(tally, idx, val))
        plain_ms = cuda_ms(lambda: binned.drop_add(tally, idx, val))
        times[name] = (ms, plain_ms)
        route = "shared" if binned.kernels.library().skirt_binned_route(
            nbins) else "global"
        log(f"  K2 {name}: {n} updates -> {nbins} bins, route {route}, "
            f"max_abs_err {err:.3e}, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
    results["K2"] = {"max_abs_err": worst, "ms": times["frame"][0],
                     "plain_ms": times["frame"][1], "times": times}


def phase_k1(torch, results):
    from bench_torch import _build
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine import fused_poly
    from skirt_tpu_torch.testing import event_agreement, event_case

    run_batch, _, _, L0 = _build(nlambda=128, ncells=32, packets=32768,
                                 refill_batches=128, quadrature_panels=32,
                                 peel_panels=8, device="cuda")
    n = L0.shape[0]
    worst = 0.0
    for seed in (5, 6, 7):
        spec, u, oc, L, l0, state = event_case(run_batch.spec, n, seed,
                                               "cuda")
        assert spec.W == 128 and spec.npanels == 32 and spec.np_peel == 8
        assert len(spec.leaders) == 2 and spec.refill and spec.nu_pos == 4
        dead = state[6] == 0
        log(f"  K1 inputs (seed {seed}): {n} lanes, {int(dead.sum())} dead, "
            f"{int((dead & (state[8] >= spec.K)).sum())} dead with the "
            f"launch budget used up, {int((state[3] == 0).sum())} with "
            f"dx == 0, min_scatt {spec.min_scatt}")
        for it in range(K1_EVENTS):
            if it:
                u = rng.uniform_open(rng.event_key(seed, it),
                                     (spec.n_uniform, n), "cuda")
            got = fused_poly.poly_event(spec, u, oc, L, l0, state)
            want = fused_poly.poly_event_plain(spec, u, oc, L, l0, state)
            torch.cuda.synchronize()
            res = event_agreement(got, want)
            alive = got["state"][6] != 0
            cut = int(((got["Ln"] == 0) & alive[None]).sum())
            log(f"  K1 event {it}: discrete agree {res['discrete']:.6f}, "
                f"float-disagreeing lanes {res['float_bad']}, scaled max "
                f"err {res['scaled_err']:.3e}; alive "
                f"{float(alive.float().mean()):.3f}, fresh "
                f"{int(got['fresh'].sum())}, (lane, w) cut {cut}, deposits "
                f"{int((got['depi'] >= 0).sum())}")
            if res["discrete"] < 0.999 or res["float_bad"] > 0:
                raise AssertionError(f"K1 kernel disagrees with its plain "
                                     f"version at event {it}: {res}")
            worst = max(worst, res["scaled_err"])
            state = list(got["state"]) + [got["bc"]]
            L = got["Ln"]
    ms = cuda_ms(lambda: fused_poly.poly_event(spec, u, oc, L, l0, state))
    plain_ms = cuda_ms(lambda: fused_poly.poly_event_plain(
        spec, u, oc, L, l0, state), reps=5)
    log(f"  K1 N={n} W=128: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    results["K1"] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_main(torch, results):
    from bench_torch import _build
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine import fused_poly
    from skirt_tpu_torch.engine.lifecycle import make_multibatch
    from skirt_tpu_torch.ops import binned

    W, packets, K, nbatches = 128, 1 << 15, 128, 2
    run_batch, zero_tallies, ell, L0 = _build(
        nlambda=W, ncells=32, packets=packets, refill_batches=K,
        quadrature_panels=32, peel_panels=8, device="cuda")
    run_many = make_multibatch(run_batch, nbatches)
    tallies = zero_tallies()
    torch.cuda.synchronize()
    binned.binned_add.launches = 0
    fused_poly.poly_event.launches = 0
    t0 = time.perf_counter()
    out = run_many(rng.root_key(4357), ell, L0, tallies)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"K1": fused_poly.poly_event.launches,
                "K2": binned.binned_add.launches}
    results["launches"] = launches
    pps = packets * K * nbatches * W / dt
    sed = out["instruments"][0]["Ftot"].double().cpu().numpy()
    labs = float(out["labs"].double().sum())
    launched = nbatches * W * 1e36
    log(f"  main path: {nbatches} batches x {packets} lanes x K={K} x "
        f"W={W} in {dt:.3f} s = {pps:.4e} packets/s; launches {launches}; "
        f"SED total {sed.sum():.4e} W, labs {labs:.4e} W of "
        f"{launched:.4e} W launched")
    for leaf in [v for d in out["instruments"] for v in d.values()] \
            + [out["labs"]]:
        if not bool(torch.isfinite(leaf).all()):
            raise AssertionError("non-finite tally")
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if not (sed.sum() > 0 and (sed > 0).all()):
        raise AssertionError("SED Ftot not positive")
    if not 0 < labs < launched:
        raise AssertionError(f"labs {labs} outside (0, {launched})")
    results["main"] = {"seconds": dt, "packets_per_s": pps}


def phase_reference(torch):
    """The same model family at a small size: CUDA kernels vs the plain
    path on the CPU, at Monte Carlo tolerance."""
    from bench_torch import _build
    from skirt_tpu_torch import rng

    outs = {}
    for dev in ("cuda", "cpu"):
        run, zero, ell, L0 = _build(nlambda=12, ncells=16, packets=4096,
                                    refill_batches=4, quadrature_panels=16,
                                    peel_panels=8, max_scatt=32,
                                    vary_lambda=True, device=dev)
        t = run(rng.root_key(99), ell, L0, zero())
        outs[dev] = {"sed": t["instruments"][0]["Ftot"].double().cpu().numpy(),
                     "frame": float(t["instruments"][1]["ftot"].double().sum()),
                     "labs": float(t["labs"].double().sum())}
    g, c = outs["cuda"], outs["cpu"]
    np.testing.assert_allclose(g["sed"], c["sed"], rtol=0.15)
    for k in ("frame", "labs"):
        if abs(g[k] / c[k] - 1) > 0.05:
            raise AssertionError(f"{k}: cuda {g[k]} vs cpu {c[k]}")
    if abs(g["sed"].sum() / c["sed"].sum() - 1) > 0.05:
        raise AssertionError("SED total differs between cuda and cpu")
    log(f"  small model cuda/cpu: SED {g['sed'].sum() / c['sed'].sum():.4f}, "
        f"frame {g['frame'] / c['frame']:.4f}, labs {g['labs'] / c['labs']:.4f}")


def main():
    log("phase 1: device")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a GPU")
    card = card_line()
    log(f"  card: {card}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("phase 2: build kernels")
    from skirt_tpu_torch import kernels
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.library()
    log(f"  {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log.splitlines():
        if "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    results = {}
    log("phase 3: K2 binned_add kernel vs plain")
    phase_k2(torch, results)
    log("phase 4: K1 poly_event kernel vs plain")
    phase_k1(torch, results)
    log("phase 5: main path (make_lifecycle + make_multibatch, W=128)")
    phase_main(torch, results)
    phase_reference(torch)

    log("phase 6: results")
    kern = [
        {"name": "K1 poly_event", "route": "cuda",
         "source": "skirt_tpu_torch/csrc/fused_poly.cu",
         "replaces": "skirt_tpu/engine/fused_poly.py:85",
         "launches": results["launches"]["K1"],
         "max_abs_err": results["K1"]["max_abs_err"],
         "ms": results["K1"]["ms"], "plain_ms": results["K1"]["plain_ms"]},
        {"name": "K2 binned_add", "route": "cuda",
         "source": "skirt_tpu_torch/csrc/binned.cu",
         "replaces": "skirt_tpu/ops/binned.py:37",
         "launches": results["launches"]["K2"],
         "max_abs_err": results["K2"]["max_abs_err"],
         "ms": results["K2"]["ms"], "plain_ms": results["K2"]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kern,
                      "main_path_packets_per_s":
                          results["main"]["packets_per_s"]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
