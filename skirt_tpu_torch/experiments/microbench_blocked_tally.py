"""K8, the lambda-blocked tally, against K2 at the 128-lambda flagship
shape of experiments/microbench_blocked_tally.py (16,384 cells x 128
wavelengths, 2^17 lanes), on a layout whose Pallas tiles do not divide
nlambda, and on layouts that take K8's dense and global routes.

On a CUDA card, from the repository root:

    python -m skirt_tpu_torch.experiments.microbench_blocked_tally

Each row runs the kernel once on a random tally, holds it to its plain
version (rtol 1e-4, atol 1e-6: shared-memory atomics add in another
order), and prints the kernel's, the plain version's and one index_add_'s
device ms over the kept lanes beside the bound (lanes read once; of the
tally, K8 reads and writes once only the distinct 32-byte sectors its kept
lanes touch, K2 no more than one sector a kept lane).  The rows: K8
`binned_add_lm` at the flagship; K2 `binned_add` on the same lanes as cell-major bins cell * nl + ell
(2.1M bins: K2's global route), the JAX script's serial-scatter
yardstick; K2 on the 4-lambda bins (65,536: shared route); K8 at
nlambda = 20, 1,000 cells, 1,024 lanes per block, with dropped lanes,
where skirt_tpu's kernel leaves blocks 16-19 unwritten; K8 where lanes
are dense (nlambda 8, 1,000 cells, 16,384 lanes a block: 16 a bin) and
where a slice passes the card's opt-in shared memory (nlambda 2, 60,000
cells).  Each K8 row names the route and split `ops.binned.k8_route`
gave it.  Inputs: the script's default_rng(1) draws; the last two rows'
from default_rng(5) and (6).
"""

from __future__ import annotations

import numpy as np
import torch

from . import common
from ..ops import binned

NL, NCELLS, N = 128, 16384, 1 << 17
REPLACES = "skirt_tpu/ops/binned.py:146"


def tables_like_jax():
    """The script's draws, in its order: cells, values, the cell-major
    bins cell * 128 + ell and the 4-lambda bins cell * 4 + ell."""
    rs = np.random.default_rng(1)
    cells = rs.integers(0, NCELLS, N).astype(np.int32)
    vals = rs.uniform(0, 1, N).astype(np.float32)
    bins_cm = (cells * NL + rs.integers(0, NL, N)).astype(np.int32)
    bins4 = (cells * 4 + rs.integers(0, 4, N)).astype(np.int32)
    return cells, vals, bins_cm, bins4


def uneven_lanes(nlambda=20, ncells=1000, seed=4):
    """Lanes of a layout whose Pallas tile (bpt = 16 blocks) does not
    divide nlambda, with escaped (-1) and out-of-range cells."""
    rs = np.random.default_rng(seed)
    n = nlambda * 1024
    cells = rs.integers(-50, ncells + 50, n).astype(np.int32)
    cells[rs.random(n) < 0.05] = -1
    return cells, rs.random(n).astype(np.float32)


def dense_lanes(nlambda=8, ncells=1000, per=16384, seed=5):
    """Lanes many to a bin (per / 1,024 a bin), with dropped cells."""
    rs = np.random.default_rng(seed)
    n = nlambda * per
    cells = rs.integers(-9, ncells + 9, n).astype(np.int32)
    return cells, rs.random(n).astype(np.float32)


def _kept_bins(cells, nlambda, ncells, qr):
    n = cells.numel()
    block = torch.arange(n, device=cells.device) // (n // nlambda)
    keep = (cells >= 0) & (cells < ncells)
    return (block * qr + cells)[keep]


def run_k8(name, cells, vals, nlambda, ncells, timed=True, reps=10,
           seed=0):
    n = cells.numel()
    Q, R, _ = binned.blocked_layout(nlambda, ncells, n)
    gen = torch.Generator(device=cells.device).manual_seed(seed)
    tally0 = torch.rand(nlambda * Q * R, generator=gen, device=cells.device)
    got = binned.binned_add_lm(tally0.clone(), cells, vals,
                               nlambda=nlambda, ncells=ncells)
    want = binned.bincount_blocked_plain(tally0.clone(), cells, vals,
                                         nlambda=nlambda, ncells=ncells)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    optin, sms = binned.device_limits(cells.device)
    route, split = binned.k8_route(n // nlambda, Q * R, optin, nlambda, sms,
                                   tally0.data_ptr() % 16 == 0)
    rec = {"name": name, "replaces": REPLACES,
           "shape": f"{n} lanes, nlambda {nlambda}, {ncells} cells, Q x R = "
           f"{Q} x {R}, route {binned.K8_ROUTES[route]}"
           + (f" split {split}" if route == binned.K8_DENSE else ""),
           "route": binned.K8_ROUTES[route], "split": split,
           "max_abs_err": float((got - want).abs().max())}
    if timed:
        tally = tally0.clone()
        bins = _kept_bins(cells, nlambda, ncells, Q * R)
        kvals = vals[(cells >= 0) & (cells < ncells)]
        common.measure(
            rec, lambda: binned.binned_add_lm(tally, cells, vals,
                                              nlambda=nlambda,
                                              ncells=ncells),
            lambda: binned.bincount_blocked_plain(tally, cells, vals,
                                                  nlambda=nlambda,
                                                  ncells=ncells),
            lambda: tally.index_add_(0, bins, kvals), reps=reps)
        # the tally is freshly allocated, so its sectors start at bin 8 s
        sectors = torch.unique(bins // 8).numel()
        rec["bound_ms"], rec["bound_by"] = common.bound(
            common.nbytes(cells, vals) + 2 * 32 * sectors, bins.numel())
    return rec


def run_k2(name, bins, vals, nbins, timed=True, reps=10):
    got = binned.binned_add(torch.zeros(nbins, device=bins.device), bins,
                            vals)
    want = binned.drop_add(torch.zeros(nbins, device=bins.device), bins,
                           vals)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    rec = {"name": name, "replaces": "skirt_tpu/ops/binned.py:37",
           "shape": f"{bins.numel()} updates into {nbins} bins",
           "max_abs_err": float((got - want).abs().max())}
    if timed:
        tally = torch.zeros(nbins, device=bins.device)
        common.measure(rec, lambda: binned.binned_add(tally, bins, vals),
                       lambda: binned.drop_add(tally, bins, vals),
                       lambda: tally.index_add_(0, bins.long(), vals),
                       reps=reps)
        rec["bound_ms"], rec["bound_by"] = common.bound(
            common.nbytes(bins, vals)
            + 2 * min(common.nbytes(tally), 32 * bins.numel()), bins.numel())
    return rec


def sweep(timed=True, reps=10):
    """K8 at the flagship, K2 on the same lanes as 2.1M and 65,536 bins,
    and K8 on the uneven, dense and past-opt-in layouts: a list of
    records."""
    cells, vals, bins_cm, bins4 = (torch.from_numpy(a).cuda()
                                   for a in tables_like_jax())
    ucells, uvals = (torch.from_numpy(a).cuda() for a in uneven_lanes())
    dcells, dvals = (torch.from_numpy(a).cuda() for a in dense_lanes())
    gcells, gvals = (torch.from_numpy(a).cuda() for a in dense_lanes(
        nlambda=2, ncells=60000, per=2048, seed=6))
    return [
        run_k8("K8 binned_add_lm flagship", cells, vals, NL, NCELLS, timed,
               reps),
        run_k2("K2 binned_add cell-major 2.1M bins", bins_cm, vals,
               NCELLS * NL, timed, reps),
        run_k2("K2 binned_add 4-lambda", bins4, vals, NCELLS * 4, timed,
               reps),
        run_k8("K8 binned_add_lm nlambda=20 (bpt=16 does not divide it)",
               ucells, uvals, 20, 1000, timed, reps),
        run_k8("K8 binned_add_lm dense", dcells, dvals, 8, 1000, timed,
               reps),
        run_k8("K8 binned_add_lm past opt-in", gcells, gvals, 2, 60000,
               timed, reps)]


def main():
    common.require_cuda()
    print(common.card_line(), flush=True)
    for rec in sweep():
        print(common.line(rec), flush=True)


if __name__ == "__main__":
    main()
