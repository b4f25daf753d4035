"""PG over the Pallas gather probes P1-P10 at the JAX scripts' shapes.

On a CUDA card, from the repository root:

    python -m skirt_tpu_torch.experiments.microbench_gather

For each distinct call of `gather.VARIANTS` (the Pallas variants that
gather as many elements from the same table are one call) and each route (the table through
the read-only cache path, or staged in shared memory) it gathers once,
holds the result to the plain version bit for bit, and prints the
kernel's, the plain version's and `tab[idx]`'s device ms beside the bound
(8 bytes per element and the table once over 3.35 TB/s), with the card's
name and power limit.  The table is `gather.tables_like_jax`; the indices
are drawn on the card from a torch generator seeded 0 (the JAX scripts
draw theirs with jax.random key 0).
"""

from __future__ import annotations

import torch

from . import common
from .gather import (ROUTES, VARIANTS, table_gather, table_gather_plain,
                     tables_like_jax)


def inputs(T, shape, device="cuda", seed=0):
    tab = torch.from_numpy(tables_like_jax(T)).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(0, T, shape, generator=gen, device=device,
                        dtype=torch.int32)
    return tab, idx


def run(name, replaces, tab, idx, route, steps=0, timed=True, reps=10,
        pallas=()):
    """One probe call, held to the plain version bit for bit; with timed,
    the device ms of kernel, plain version and tab[idx] and the bound."""
    out = table_gather(tab, idx, steps=steps, route=route)
    want = table_gather_plain(tab, idx, steps=steps)
    if not torch.equal(out, want):
        raise AssertionError(f"PG {name} ({route}) differs from its plain "
                             f"version")
    rec = {"name": f"{name} [{route}]", "replaces": replaces,
           "pallas": list(pallas),
           "shape": f"T={tab.shape[0]} idx "
           f"{tuple(idx.shape)}" + (f" steps={steps}" if steps else ""),
           "max_abs_err": float((out - want).abs().max())}
    if timed:
        common.measure(
            rec, lambda: table_gather(tab, idx, steps=steps, route=route),
            lambda: table_gather_plain(tab, idx, steps=steps),
            None if steps else (lambda: tab[idx]), reps=reps)
        rec["bound_ms"], rec["bound_by"] = common.bound(
            common.nbytes(tab, idx, out), steps * idx.numel())
    return rec


def sweep(timed=True, reps=10):
    """P1-P10, each distinct call through both routes: a list of
    records."""
    records = []
    for v in VARIANTS:
        tab, idx = inputs(v.T, v.shape)
        for route in ROUTES:
            records.append(run(f"PG {v.name}", "; ".join(v.replaces), tab,
                               idx, route, v.steps, timed, reps, v.pallas))
        del tab, idx
    return records


def main():
    common.require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(common.card_line(), flush=True)
    for rec in sweep():
        print(common.line(rec), flush=True)


if __name__ == "__main__":
    main()
