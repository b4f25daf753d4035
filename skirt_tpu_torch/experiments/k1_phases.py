"""Where a block of K1 spends its time: timestamps at each of its barriers.

On a CUDA machine, from the repository root:

    python -m skirt_tpu_torch.experiments.k1_phases

It copies csrc/fused_poly.cu and csrc/common.cuh into a temporary
directory, adds a `prof` pointer at the end of PolyArgs and, after every
top-level __syncthreads() of the kernel (and at its start and end), has
the block's thread 0 write %globaltimer to prof[block * 16 + phase];
builds that copy with the package's nvcc flags; runs it through
`poly_event` (the wrapper, its struct and its library swapped for the
stamped ones) on the inputs chip_smoke.py's phase 4 starts from (N =
32,768, W = 128, 32 / 8 panels, refill K = 128; seed 7, three events of
the plain version chained first); checks every output bit for bit against
poly_event_plain; and prints the kernel's device ms (the stores of the
stamps included), the mean block life, the blocks resident at once
(summed block lives over the span), and each phase's mean duration in
ns with the line of the barrier that ends it.  The stamps' resolution is
that of %globaltimer (tens of ns on the H100).
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .. import kernels, rng
from ..engine import fused_poly as tfp
from ..testing import event_case
from .common import card_line, cuda_ms, require_cuda

SLOTS = 16


def stamped_source(src: str) -> tuple[str, list[int]]:
    """fused_poly.cu with the stamps, and the line in `src` of each
    barrier stamped."""
    body = src[src.index("poly_event_kernel(const PolyArgs a) {"):]
    lines = [src.count("\n", 0, len(src) - len(body)) + body[:m.start()]
             .count("\n") + 2
             for m in re.finditer(r"\n  __syncthreads\(\);\n", body)]
    src = src.replace("  Geom geo;\n};",
                      "  Geom geo;\n  unsigned long long* prof;\n};", 1)
    src = src.replace('#include "common.cuh"', '''#include "common.cuh"
__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PROF(p) if (tid == 0) a.prof[blockIdx.x * 16 + (p)] = gtimer()''', 1)
    k0 = src.index("poly_event_kernel(const PolyArgs a) {")
    k1 = src.index("template <int DENS, int SAMP, bool LABS>\nint launch(")
    body = src[k0:k1]
    parts = body.split("\n  __syncthreads();\n")
    out = parts[0]
    for i, p in enumerate(parts[1:], 1):
        out += "\n  __syncthreads();\n  PROF(%d);\n" % i + p
    out = out.replace("  const int tid = r * LANES + l;\n",
                      "  const int tid = r * LANES + l;\n  PROF(0);\n", 1)
    end = out.rindex("}\n")
    out = out[:end] + "  __syncthreads();\n  PROF(%d);\n}\n" % (SLOTS - 1) \
        + out[end + 2:]
    if len(parts) > SLOTS - 1:
        raise RuntimeError("more barriers than stamp slots")
    return src[:k0] + out + src[k1:], lines


def main():
    require_cuda()
    from bench_torch import _build

    work = Path(tempfile.mkdtemp(prefix="k1_phases_"))
    src, lines = stamped_source((kernels.CSRC / "fused_poly.cu").read_text())
    (work / "fused_poly.cu").write_text(src)
    (work / "common.cuh").write_text((kernels.CSRC / "common.cuh").read_text())
    so = work / "k1_phases.so"
    proc = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-shared",
                           "-o", str(so), str(work / "fused_poly.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(proc.stdout + proc.stderr)

    class StampedArgs(kernels.PolyArgs):
        _fields_ = [("prof", ctypes.c_void_p)]

    lib = ctypes.CDLL(str(so))
    lib.skirt_poly_event.argtypes = [ctypes.POINTER(StampedArgs),
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
    lib.skirt_poly_event.restype = ctypes.c_int

    run_batch, _, _, L0 = _build(nlambda=128, ncells=32, packets=32768,
                                 refill_batches=128, quadrature_panels=32,
                                 peel_panels=8, device="cuda")
    n = L0.shape[0]
    spec, u, oc, L, l0, state = event_case(run_batch.spec, n, 7, "cuda")
    for it in range(3):
        if it:
            u = rng.uniform_open(rng.event_key(7, it), (spec.n_uniform, n),
                                 "cuda")
        out = tfp.poly_event_plain(spec, u, oc, L, l0, state)
        state = list(out["state"]) + [out["bc"]]
        L = out["Ln"]
    want = tfp.poly_event_plain(spec, u, oc, L, l0, state)

    lanes = int(re.search(r"constexpr int LANES = (\d+);", src).group(1))
    nblk = (n + lanes - 1) // lanes
    prof = torch.zeros(nblk * SLOTS, dtype=torch.int64, device="cuda")
    saved = (kernels.PolyArgs, kernels._lib, tfp._cuda_args)
    orig_args = tfp._cuda_args

    def stamped_args(sp):
        a, t = orig_args(sp)
        a.prof = prof.data_ptr()
        return a, t

    kernels.PolyArgs, kernels._lib = StampedArgs, lib
    tfp._cuda_args = stamped_args
    try:
        got = tfp.poly_event(spec, u, oc, L, l0, state)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in
                   zip(got["state"], want["state"])) and all(
            torch.equal(got[k], want[k]) for k in want if k != "state")
        ms = cuda_ms(lambda: tfp.poly_event(spec, u, oc, L, l0, state))
        prof.zero_()
        tfp.poly_event(spec, u, oc, L, l0, state)
        torch.cuda.synchronize()
    finally:
        kernels.PolyArgs, kernels._lib, tfp._cuda_args = saved
    t = prof.view(nblk, SLOTS).cpu().numpy().astype(np.float64)
    used = [p for p in range(SLOTS) if (t[:, p] > 0).all()]
    life = t[:, used[-1]] - t[:, used[0]]
    span = t[:, used[-1]].max() - t[:, used[0]].min()
    print(f"K1 stamped, N = {n}, W = 128: bit-identical to plain {same}, "
          f"{ms:.4f} ms, mean block life {life.mean():.0f} ns, blocks "
          f"resident {life.sum() / span:.1f}")
    for a, b in zip(used[:-1], used[1:]):
        d = t[:, b] - t[:, a]
        where = (f"barrier at fused_poly.cu:{lines[b - 1]}"
                 if b - 1 < len(lines) else "kernel end")
        print(f"  phase {a}-{b} (to the {where}): mean {d.mean():.0f} ns, "
              f"p90 {np.percentile(d, 90):.0f} ns")
    print(card_line())
    if not same:
        sys.exit("the stamped kernel disagrees with poly_event_plain")


if __name__ == "__main__":
    main()
