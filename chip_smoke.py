"""GPU smoke test of skirt_tpu_torch: kernels, parity and the main paths.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each prints one line first; any failure raises and the script
exits non-zero without printing a result):
  1. the card (nvidia-smi name and power limit) and torch / CUDA versions;
     no CUDA device is an error, never a CPU fallback
  2. build the CUDA kernels with nvcc (skirt_tpu_torch/_build/)
  3. K2 binned_add kernel vs its plain version at both main paths' shapes,
     with the route each takes: the polychromatic frame (4,194,304
     updates into 32,768 bins, with dropped indices) and labs (32,768
     updates into 2,097,152 bins); the monochromatic frame (2,097,152
     updates into 1,024 bins) and labs (2,097,152 into 65,536)
  4. K1 poly_event kernel vs its plain version on identical inputs at the
     polychromatic path's shapes (N = 32,768 lanes, W = 128, 32/8 panels,
     2 leaders, refill K = 128 from the ExpDisk sampler), chained over six
     events from each of three skirt_tpu_torch.testing.event_case states:
     about 10% dead lanes (some with the launch budget used up),
     axis-parallel directions and a weight cut that fires
  5. K3 mono_event kernel vs its plain version, the same way, at the
     monochromatic path's shapes (N = 2,097,152 lanes, one of W = 4
     wavelengths per lane, 32/8 panels, 2 leaders, refill K = 128 from
     the ExpDisk sampler, labs on; three mono_event_case states, with
     min_scatt_events 1 and a weight cut that fires), then one two-
     component case and one 128-wavelength case (where the Pallas
     driver feeds per-lane tables, lam_inputs) at 262,144 lanes
  6. the polychromatic main path through make_lifecycle + make_multibatch
     at the bench model's full width (bench_torch._build defaults), and
     the monochromatic main path through OligoSimulation at the mono
     flagship's full width (bench.py BENCH_POLY=0 BENCH_NLAMBDA=4
     BENCH_LOG2_PACKETS=21, 2 batches instead of 8): the launch counts of
     the path's kernels are reset just before each run and read just
     after, and the run's tallies are checked; then each path at a small
     size on the card against the same run on the CPU
  7. one JSON line of per-kernel results, the card line, and last
     {"ok": true, "device": {...}}

Tolerances: K2 per bin rtol 1e-4 (float32 sums of up to a few thousand
updates taken in another order by atomics; each order is within
n * 2^-24 of the exact sum).  K1 and K3 by skirt_tpu_torch.testing's
criterion: the discrete outputs (deposit bin, alive, nscatt, bcount,
fresh, and for K1 the wavelengths that survive the weight cut) agree on
>= 99.9% of lanes (the CPU tests' bound), and no lane whose discrete
outputs agree has a float output off by more than rtol 1e-4 with atol
1e-6 x the array's largest magnitude.  On the card the kernels and their
plain versions round alike op for op (-fmad=false, float32 reciprocals
of the scale lengths, sums in one fixed order, rsqrtf), so they agree
to the bit in practice; the bounds leave room only for a compiler that
rounds one op differently.  max_abs_err is taken over the float outputs,
each scaled by its array's largest magnitude, on the lanes whose
discrete outputs agree.  The small-size cross-device checks hold the
CUDA run to the CPU run at Monte Carlo tolerances (the two devices draw
different random streams): polychromatic at tests/test_poly.py's
(per-wavelength SED 0.15, totals 0.05), monochromatic at
tests/test_fused.py's (SED per wavelength and frame total 0.03, labs
0.05).
"""

import json
import subprocess
import sys
import time

import numpy as np


# K1 and K3: events chained from each starting state
EVENTS = 6


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
    shapes = {"frame": (32768, 128 * 32768), "labs": (128 * 16384, 32768),
              "mono frame": (4 * 256, 1 << 21),
              "mono labs": (4 * 16384, 1 << 21)}
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
        for it in range(EVENTS):
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


def phase_k3(torch, results):
    from bench_torch import _build
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine import fused
    from skirt_tpu_torch.testing import event_agreement, mono_event_case

    worst = 0.0
    cases = (("W=4", 4, 1, 1 << 21, (5, 6, 7)),
             ("W=4 H=2", 4, 2, 1 << 18, (8,)),
             ("W=128", 128, 1, 1 << 18, (9,)))
    for label, nlambda, ncomp, n, seeds in cases:
        run_batch, *_ = _build(nlambda=nlambda, ncells=32, packets=n,
                               refill_batches=128, quadrature_panels=32,
                               peel_panels=8, polychromatic=False,
                               ncomp=ncomp, device="cuda")
        for seed in seeds:
            spec, u, state = mono_event_case(run_batch.spec, n, seed, "cuda")
            assert spec.npanels == 32 and spec.np_peel == 8
            assert len(spec.leaders) == 2 and spec.refill and spec.nu_pos == 4
            assert spec.want_labs and spec.H == ncomp
            dead = state[7] == 0
            log(f"  K3 {label} inputs (seed {seed}): {n} lanes, "
                f"{int(dead.sum())} dead, "
                f"{int((dead & (state[11] >= spec.K)).sum())} dead with the "
                f"launch budget used up, {int((state[3] == 0).sum())} with "
                f"dx == 0, min_scatt {spec.min_scatt}")
            for it in range(EVENTS):
                if it:
                    u = rng.uniform_open(rng.event_key(seed, it),
                                         (spec.n_uniform, n), "cuda")
                got = fused.mono_event(spec, u, state)
                want = fused.mono_event_plain(spec, u, state)
                torch.cuda.synchronize()
                res = event_agreement(got, want)
                bits = all(torch.equal(a, b) for a, b in
                           zip(got["state"], want["state"])) and all(
                    torch.equal(got[k], want[k]) for k in want
                    if k != "state")
                alive_in = state[7] != 0
                alive = got["state"][7] != 0
                log(f"  K3 {label} event {it}: discrete agree "
                    f"{res['discrete']:.6f}, float-disagreeing lanes "
                    f"{res['float_bad']}, scaled max err "
                    f"{res['scaled_err']:.3e}, bit-identical {bits}; alive "
                    f"{float(alive.float().mean()):.3f}, fresh "
                    f"{int(got['fresh'].sum())}, killed "
                    f"{int((alive_in & ~alive).sum())}, deposits "
                    f"{int((got['depi'] >= 0).sum())}")
                if res["discrete"] < 0.999 or res["float_bad"] > 0:
                    raise AssertionError(f"K3 kernel disagrees with its "
                                         f"plain version ({label}) at event "
                                         f"{it}: {res}")
                worst = max(worst, res["scaled_err"])
                state = list(got["state"]) + state[9:11] + [got["bc"]]
        if label == "W=4":
            ms = cuda_ms(lambda: fused.mono_event(spec, u, state))
            plain_ms = cuda_ms(lambda: fused.mono_event_plain(spec, u, state),
                               reps=5)
            log(f"  K3 N={n} W=4: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    results["K3"] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_main_poly(torch, results):
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
    results["launches_poly"] = launches
    pps = packets * K * nbatches * W / dt
    sed = out["instruments"][0]["Ftot"].double().cpu().numpy()
    labs = float(out["labs"].double().sum())
    launched = nbatches * W * 1e36
    log(f"  poly main path: {nbatches} batches x {packets} lanes x K={K} x "
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
    results["main_poly"] = {"seconds": dt, "packets_per_s": pps}


def phase_reference_poly(torch):
    """The polychromatic model family at a small size: CUDA kernels vs
    the plain path on the CPU, at Monte Carlo tolerance."""
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
    log(f"  small poly model cuda/cpu: SED {g['sed'].sum() / c['sed'].sum():.4f}, "
        f"frame {g['frame'] / c['frame']:.4f}, labs {g['labs'] / c['labs']:.4f}")


def _mono_simulation(device, nlambda, lanes, batches, **model_kw):
    """An OligoSimulation of the bench model with one wavelength per lane:
    `lanes` lanes per batch, `batches` batches in one dispatch."""
    from bench_torch import _model
    from skirt_tpu_torch.engine.simulation import OligoSimulation
    from skirt_tpu_torch.log import SilentLog

    grid, ds, ss, ins, opts = _model(nlambda=nlambda, polychromatic=False,
                                     **model_kw)
    K = max(opts.refill_batches, 1)
    return OligoSimulation(stellar_system=ss, instruments=ins,
                           dust_system=ds, options=opts,
                           packets=lanes // nlambda * K * batches,
                           batch_size=lanes, dispatch_batches=batches,
                           log=SilentLog(), device=device)


def _check_tallies(acc, launched, what):
    """Finite tallies, a positive SED, 0 < labs < launched (float64 host
    sums of an OligoSimulation phase)."""
    for d in acc["instruments"]:
        for v in d.values():
            if not np.isfinite(v).all():
                raise AssertionError(f"{what}: non-finite tally")
    sed = acc["instruments"][0]["Ftot"]
    if not (sed > 0).all():
        raise AssertionError(f"{what}: SED Ftot not positive")
    labs = float(acc["labs"].sum())
    if not 0 < labs < launched:
        raise AssertionError(f"{what}: labs {labs} outside (0, {launched})")
    return sed, labs


def phase_main_mono(torch, results):
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine import fused
    from skirt_tpu_torch.ops import binned

    W, lanes, K, nbatches = 4, 1 << 21, 128, 2
    sim = _mono_simulation("cuda", W, lanes, nbatches, ncells=32,
                           refill_batches=K, quadrature_panels=32,
                           peel_panels=8)
    spec = sim._lifecycle.spec
    assert isinstance(spec, fused.MonoEventSpec)
    assert len(list(sim._batches())) == nbatches
    torch.cuda.synchronize()
    binned.binned_add.launches = 0
    fused.mono_event.launches = 0
    t0 = time.perf_counter()
    acc = sim._run_phase(rng.root_key(sim.seed), 0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"K3": fused.mono_event.launches,
                "K2": binned.binned_add.launches}
    results["launches_mono"] = launches
    pps = lanes * K * nbatches / dt
    launched = float(sim.stellar_system.Lv.sum())
    sed, labs = _check_tallies(acc, launched, "mono main path")
    log(f"  mono main path (OligoSimulation): {nbatches} batches x {lanes} "
        f"lanes x K={K}, W={W} one per lane, in {dt:.3f} s = {pps:.4e} "
        f"packets/s; launches {launches} ({launches['K3'] / nbatches:.0f} "
        f"event iterations per batch); SED total {sed.sum():.4e} W, labs "
        f"{labs:.4e} W of {launched:.4e} W launched")
    if launches["K3"] <= 0 or launches["K2"] <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    results["main_mono"] = {"seconds": dt, "packets_per_s": pps}


def phase_reference_mono(torch):
    """A small OligoSimulation(fused=True) on the card against the same
    on the CPU, at tests/test_fused.py's Monte Carlo tolerances."""
    from skirt_tpu_torch import rng

    outs = {}
    for dev in ("cuda", "cpu"):
        sim = _mono_simulation(dev, 2, 1 << 13, 2, ncells=16,
                               refill_batches=4, quadrature_panels=16,
                               peel_panels=8, max_scatt=32, vary_lambda=True)
        acc = sim._run_phase(rng.root_key(sim.seed), 0)
        sed, labs = _check_tallies(acc, float(sim.stellar_system.Lv.sum()),
                                   f"small mono run on {dev}")
        outs[dev] = {"sed": sed,
                     "frame": float(acc["instruments"][1]["ftot"].sum()),
                     "labs": labs}
    g, c = outs["cuda"], outs["cpu"]
    np.testing.assert_allclose(g["sed"], c["sed"], rtol=0.03)
    for k, tol in (("frame", 0.03), ("labs", 0.05)):
        if abs(g[k] / c[k] - 1) > tol:
            raise AssertionError(f"{k}: cuda {g[k]} vs cpu {c[k]}")
    log(f"  small mono OligoSimulation cuda/cpu: SED "
        f"{', '.join(f'{r:.4f}' for r in g['sed'] / c['sed'])}, frame "
        f"{g['frame'] / c['frame']:.4f}, labs {g['labs'] / c['labs']:.4f}")


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
    log("phase 5: K3 mono_event kernel vs plain")
    phase_k3(torch, results)
    log("phase 6: main paths (poly: make_lifecycle + make_multibatch, "
        "W=128; mono: OligoSimulation, W=4)")
    phase_main_poly(torch, results)
    phase_main_mono(torch, results)
    phase_reference_poly(torch)
    phase_reference_mono(torch)

    log("phase 7: results")
    lp, lm = results["launches_poly"], results["launches_mono"]
    kern = [
        {"name": "K1 poly_event", "route": "cuda",
         "source": "skirt_tpu_torch/csrc/fused_poly.cu",
         "replaces": "skirt_tpu/engine/fused_poly.py:85",
         "launches": lp["K1"],
         "max_abs_err": results["K1"]["max_abs_err"],
         "ms": results["K1"]["ms"], "plain_ms": results["K1"]["plain_ms"]},
        {"name": "K2 binned_add", "route": "cuda",
         "source": "skirt_tpu_torch/csrc/binned.cu",
         "replaces": "skirt_tpu/ops/binned.py:37",
         "launches": lp["K2"] + lm["K2"],
         "launches_by_path": {"poly": lp["K2"], "mono": lm["K2"]},
         "max_abs_err": results["K2"]["max_abs_err"],
         "ms": results["K2"]["ms"], "plain_ms": results["K2"]["plain_ms"],
         "ms_by_shape": {k: v[0] for k, v in results["K2"]["times"].items()},
         "plain_ms_by_shape": {k: v[1] for k, v
                               in results["K2"]["times"].items()}},
        {"name": "K3 mono_event", "route": "cuda",
         "source": "skirt_tpu_torch/csrc/fused_mono.cu",
         "replaces": "skirt_tpu/engine/fused.py:199",
         "launches": lm["K3"],
         "max_abs_err": results["K3"]["max_abs_err"],
         "ms": results["K3"]["ms"], "plain_ms": results["K3"]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kern,
                      "main_path_packets_per_s": {
                          "poly": results["main_poly"]["packets_per_s"],
                          "mono": results["main_mono"]["packets_per_s"]}}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
