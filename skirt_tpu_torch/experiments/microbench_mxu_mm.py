"""PM over the shapes and types of experiments/microbench_mxu_mm.py (P15).

On a CUDA card, from the repository root:

    python -m skirt_tpu_torch.experiments.microbench_mxu_mm

For each of `mm.SHAPES` it multiplies once, holds the result to the plain
version within `mm.tolerance`, and prints the kernel's device ms (the mean
over the Pallas grid's G repeats), the plain version's, torch.matmul's
(bf16 out for bf16 in) and the bound: 2 M K N inner flop over 989 TFLOP/s
for bf16 (tensor cores) or 67 TFLOP/s for float32, and over 67 TFLOP/s
beside it.  The inputs are `mm.tables_like_jax` (the script's seeds).
"""

from __future__ import annotations

import torch

from . import common
from .mm import REPLACES, SHAPES, mm, mm_plain, tables_like_jax, tolerance


def run(s, timed=True, reps=None):
    a, b = (t.cuda() for t in tables_like_jax(s.M, s.K, s.N, s.dtype))
    out = mm(a, b, inner=s.inner)
    want = mm_plain(a, b, inner=s.inner)
    err = (out - want).abs()
    tol = tolerance(a, b, s.inner)
    if not bool((err <= tol).all()):
        raise AssertionError(f"PM {s.name}: off its plain version by "
                             f"{float((err / tol).max()):.3g} x the "
                             f"tolerance")
    rec = {"name": s.name, "replaces": REPLACES,
           "shape": f"G={s.G}", "max_abs_err": float(err.max()),
           "max_err_over_tol": float((err / tol).max())}
    if timed:
        reps = reps or s.G
        common.measure(rec, lambda: mm(a, b, inner=s.inner),
                       lambda: mm_plain(a, b, inner=s.inner),
                       lambda: torch.matmul(a, b), reps=reps)
        flops = 2 * s.M * s.K * s.N * s.inner
        rate = (common.BF16_TC_OPS_PER_S if s.dtype == torch.bfloat16
                else common.FP32_OPS_PER_S)
        rec["bound_ms"], rec["bound_by"] = common.bound(
            common.nbytes(a, b, out), flops, rate)
        rec["bound_ms_fp32"] = common.bound(common.nbytes(a, b, out),
                                            flops)[0]
        rec["tflops"] = flops / rec["ms"] / 1e9
    return rec


def sweep(timed=True, reps=None):
    return [run(s, timed, reps) for s in SHAPES]


def main():
    common.require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(common.card_line(), flush=True)
    for rec in sweep():
        print(common.line(rec) + f", {rec['tflops']:.2f} TFLOP/s",
              flush=True)


if __name__ == "__main__":
    main()
