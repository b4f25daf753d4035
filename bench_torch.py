"""Benchmark of the PyTorch / CUDA port: photon packets/s on one GPU.

Mirrors bench.py (the JAX benchmark) for the same model and the same
BENCH_* environment overrides, and prints the same one JSON line
{"metric", "value", "unit", "vs_baseline"} plus the device it ran on.
The default is the polychromatic main path: an ExpDisk stellar disc in
an ExpDisk dust disc on a 32x32x16 grid, 128 wavelengths per lane, 2^15
lanes, refill depth K = 128, 2 batches per call, an SED and a 16x16
frame instrument, absorption tallies on.

Run on a CUDA machine:  python3 bench_torch.py
(it raises without a CUDA device; a CPU rehearsal calls _build with
device="cpu" at a small size).

Timing: a warm-up call (it builds the kernels at first use), then
best-of-3 blocks of 3 calls, each block closed by torch.cuda.synchronize().
"""

import json
import os
import time

import numpy as np


def _build(nlambda=2, ncells=16, packets=1024, n_instruments=2,
           store_absorption=True, max_scatt=64, quadrature_panels=None,
           refill_batches=0, peel_panels=None, albedo=0.6,
           min_weight_reduction=1e4, vary_lambda=False, device="cpu"):
    """The dusty-disc model of __graft_entry__._build on the port
    (polychromatic lanes, analytic densities, sampled deposits)."""
    import torch

    from skirt_tpu_torch.constants import KPC
    from skirt_tpu_torch.engine.lifecycle import (LifecycleOptions,
                                                  make_lifecycle)
    from skirt_tpu_torch.geometry import ExpDiskGeometry
    from skirt_tpu_torch.grids import CartesianGrid
    from skirt_tpu_torch.instruments import SEDInstrument, SimpleInstrument
    from skirt_tpu_torch.media import (DustComponent, DustSystem,
                                       OpticalDepthNormalization,
                                       SimpleOligoDustMix)
    from skirt_tpu_torch.sources import (LuminosityStellarComponent,
                                         StellarSystem)
    from skirt_tpu_torch.wavelengths import OligoWavelengthGrid

    wg = OligoWavelengthGrid(list(np.linspace(0.4e-6, 1.2e-6, nlambda)))
    ss = StellarSystem([LuminosityStellarComponent(
        ExpDiskGeometry(4 * KPC, 0.35 * KPC), wg, [1e36] * nlambda)])
    half = 12 * KPC
    b = np.linspace(-half, half, ncells + 1)
    bz = np.linspace(-2 * KPC, 2 * KPC, max(ncells // 2, 2) + 1)
    grid = CartesianGrid(b, b, bz)
    if vary_lambda:
        lam_fac = np.linspace(1.0, 0.3, nlambda)
        mix = SimpleOligoDustMix(wg, list(2600.0 * lam_fac),
                                 list(albedo * np.linspace(1.0, 0.5, nlambda)),
                                 list(0.5 * np.linspace(1.0, 0.4, nlambda)))
    else:
        mix = SimpleOligoDustMix(wg, [2600.0] * nlambda, [albedo] * nlambda,
                                 [0.5] * nlambda)
    comp = DustComponent(ExpDiskGeometry(4 * KPC, 0.2 * KPC), mix,
                         OpticalDepthNormalization("z", wg.lambdav[0], 1.0))
    dsys = DustSystem(grid, [comp], samples_per_cell=4,
                      density_mode="analytic")
    instruments = [
        SEDInstrument("sed", 3.08e23, nlambda, inclination=1.0),
        SimpleInstrument("img", 3.08e23, nlambda, 16, 16,
                         fov_x=24 * KPC, fov_y=24 * KPC,
                         inclination=np.pi / 2),
    ][:n_instruments]
    opts = LifecycleOptions(store_absorption=store_absorption,
                            min_weight_reduction=min_weight_reduction,
                            max_scatt_events=max_scatt,
                            deposition="sampled",
                            quadrature_panels=quadrature_panels,
                            refill_batches=refill_batches,
                            peel_panels=peel_panels, fused=True,
                            polychromatic=True)
    run_batch = make_lifecycle(grid, dsys, ss, instruments, opts, nlambda)

    def zero_tallies():
        t = {"instruments": [ins.zero_tallies(device) for ins in instruments]}
        if store_absorption:
            t["labs"] = torch.zeros((grid.ncells * nlambda,),
                                    dtype=torch.float32, device=device)
        return t

    # every lane carries all nlambda wavelengths: `packets` counts lanes;
    # photon packets = packets * K * nlambda
    total = packets * max(refill_batches, 1)
    ell = torch.zeros((packets,), dtype=torch.int32, device=device)
    L0 = torch.full((packets, nlambda), 1e36 / total, dtype=torch.float32,
                    device=device)
    return run_batch, zero_tallies, ell, L0


def main():
    import torch

    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine.lifecycle import make_multibatch

    if not torch.cuda.is_available():
        raise SystemExit("bench_torch: no CUDA device")
    packets = 1 << int(os.environ.get("BENCH_LOG2_PACKETS", "15"))
    refill = int(os.environ.get("BENCH_REFILL", "128"))
    nlambda = int(os.environ.get("BENCH_NLAMBDA", "128"))
    run_batch, zero_tallies, ell, L0 = _build(
        nlambda=nlambda,
        ncells=int(os.environ.get("BENCH_NCELLS", "32")),
        packets=packets,
        n_instruments=int(os.environ.get("BENCH_NINSTR", "2")),
        store_absorption=os.environ.get("BENCH_ABS", "1") == "1",
        max_scatt=int(os.environ.get("BENCH_MAXSCATT", "64")),
        quadrature_panels=int(os.environ.get("BENCH_PANELS", "32")),
        refill_batches=refill,
        peel_panels=int(os.environ.get("BENCH_PEEL_PANELS", "8")) or None,
        device="cuda")
    nbatches = int(os.environ.get("BENCH_DISPATCH_BATCHES", "2"))
    run_many = make_multibatch(run_batch, nbatches)
    key = rng.root_key(4357)

    out = run_many(key, ell, L0, zero_tallies())       # warm-up + build
    torch.cuda.synchronize()
    nrep = 3
    best_dt = float("inf")
    for block in range(3):
        t0 = time.perf_counter()
        for i in range(nrep):
            out = run_many(rng.fold_in(key, block * nrep + i), ell, L0,
                           zero_tallies())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        total = float(out["instruments"][0]["Ftot"].sum())
        assert np.isfinite(total)
        best_dt = min(best_dt, dt)

    pps = packets * max(refill, 1) * nbatches * nrep * nlambda / best_dt
    baseline = 1.6e6
    print(json.dumps({
        "metric": "photon_packets_per_second_per_chip",
        "value": round(pps, 1),
        "unit": "packets/s",
        "vs_baseline": round(pps / baseline, 4),
        "device": torch.cuda.get_device_name(0),
    }))


if __name__ == "__main__":
    main()
