"""PO over the Pallas one-hot gather probes P11-P14 at the JAX scripts'
size (2^23 elements, the 32,768-entry table), and PG on the same table.

On a CUDA card, from the repository root:

    python -m skirt_tpu_torch.experiments.microbench_mxu_gather

For each distinct call of `onehot_gather.VARIANTS` (the Pallas variants
that differ only in a TPU schedule are one call) it runs the stage once,
holds it to the plain version bit for bit, and prints the kernel's and
the plain version's device ms, `tab[idx]`'s for the full gather, and the
bound: the larger of the bytes (indices, output, tables) over 3.35 TB/s
and the operations the stage's output keeps (`onehot_gather.kept_flops`:
the 8-row products of "matmul" and "fixed_B" over 989 TFLOP/s, bf16
tensor cores; the adds of the others over 67 TFLOP/s), with the kept
operations at 67 TFLOP/s beside it and the one-hot formulation's floor:
every group's full (256, 128) @ (128, 1024) products over 989 TFLOP/s.
Then PG gathers the float32 table directly on the same indices through
both routes: the gather that the one-hot product computes, with the
table in L2 or in shared memory.  The tables are
`onehot_gather.tables_like_jax`; the indices are drawn on the card from a
torch generator seeded 0 (the JAX scripts: jax.random key 0).
"""

from __future__ import annotations

import torch

from . import common
from . import microbench_gather
from .gather import ROUTES
from .onehot_gather import (NFLAT, T, VARIANTS, kept_flops, onehot_flops,
                            onehot_gather, onehot_gather_plain,
                            tables_like_jax)

PG_REPLACES = ("experiments/microbench_mxu_gather.py:62 (the gather the "
               "one-hot product computes)")


def inputs(device="cuda", seed=0):
    t = tables_like_jax()
    tabs = {k: torch.from_numpy(t[k]).to(device=device, dtype=torch.bfloat16)
            for k in ("tab_hi", "tab_lo", "bfix")}
    tabs["tab"] = torch.from_numpy(t["tab"]).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(0, T, (NFLAT // 128, 128), generator=gen,
                        device=device, dtype=torch.int32)
    return tabs, idx


def run(v, tabs, idx, timed=True, reps=10):
    kw = dict(stage=v.stage, js=v.js, nmm=v.nmm,
              tab_lo=tabs["tab_lo"] if v.split else None,
              bfix=tabs["bfix"] if v.stage == "fixed_B" else None)
    out = onehot_gather(tabs["tab_hi"], idx, **kw)
    want = onehot_gather_plain(tabs["tab_hi"], idx, **kw)
    if not torch.equal(out, want):
        raise AssertionError(f"PO {v.name} differs from its plain version")
    rec = {"name": f"PO {v.name}", "replaces": "; ".join(v.replaces),
           "pallas": list(v.pallas), "shape": f"T={T} idx {tuple(idx.shape)}",
           "max_abs_err": float((out - want).abs().max())}
    if timed:
        tab = tabs["tab"]
        common.measure(
            rec, lambda: onehot_gather(tabs["tab_hi"], idx, **kw),
            lambda: onehot_gather_plain(tabs["tab_hi"], idx, **kw),
            (lambda: tab[idx]) if v.stage == "full" else None, reps=reps)
        nbyte = common.nbytes(idx, out, tabs["tab_hi"], kw["tab_lo"],
                              kw["bfix"])
        ops = kept_flops(v, idx.shape[0])
        rate = (common.BF16_TC_OPS_PER_S if v.stage in ("matmul", "fixed_B")
                else common.FP32_OPS_PER_S)
        rec["bound_ms"], rec["bound_by"] = common.bound(nbyte, ops, rate)
        rec["bound_ms_fp32"] = common.bound(nbyte, ops)[0]
        rec["onehot_floor_ms"] = (onehot_flops(v, idx.shape[0])
                                  / common.BF16_TC_OPS_PER_S * 1e3)
    return rec


def sweep(timed=True, reps=10):
    """P11-P14, then PG on the same table and indices through both routes:
    (PO records, PG records)."""
    tabs, idx = inputs()
    po = [run(v, tabs, idx, timed, reps) for v in VARIANTS]
    pg = [microbench_gather.run(f"PG T={T}", PG_REPLACES, tabs["tab"], idx,
                                route, timed=timed, reps=reps)
          for route in ROUTES]
    return po, pg


def main():
    common.require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(common.card_line(), flush=True)
    po, pg = sweep()
    for rec in po + pg:
        print(common.line(rec), flush=True)


if __name__ == "__main__":
    main()
