"""Every tile of PM and every route of K8, timed, to check their rules.

On a CUDA card, from the repository root:

    python -m skirt_tpu_torch.experiments.sweep_probe_routes [pm] [k8]

Each route is launched through its C entry point (`skirt_probe_mm`,
`skirt_binned_blocked_add`), which takes the tile or route the wrappers'
rules would pass; these launches are not counted in the wrappers'
`launches`.  PM (`experiments/mm.py`): at each shape of P15, every tile of
the dtype's route, each held to the plain version within `mm.tolerance`
and timed beside `torch.matmul`; the tile `mm.plan` picks is marked with
`*`.  K8 (`ops.binned`): on a grid of layouts (nlambda 8, 32, 128 over
1,000 cells and 16, 128 over 16,384 cells; 1,024 to 65,536 lanes a
wavelength block, a few dropped), the sparse route and the dense route at
each split the slice allows (the global route past the opt-in limit),
each held to its plain version (rtol 1e-4) and timed beside one
`index_add_`; the (route, split) `ops.binned.k8_route` picks is marked
with `*`.  Times: device ms by
`common.cuda_ms`.  The card's line comes first, then ptxas's registers
and spills for PM's and K8's kernels when this process built the
library.
"""

from __future__ import annotations

import re
import sys

import numpy as np
import torch

from . import common, mm
from .. import kernels
from ..ops import binned

PM_SHAPES = [(s.M, s.K, s.N, s.dtype, s.inner) for s in mm.SHAPES]
K8_GRID = [(nl, 1000, per) for nl in (8, 32, 128)
           for per in (1024, 4096, 8192, 16384, 65536)] + [
    (nl, 16384, per) for nl in (16, 128)
    for per in (1024, 4096, 8192, 16384, 65536)]


def pm_tile(a, b, inner, tile):
    """C = sum_{i < inner} a @ b by PM on `tile` (bm, bn)."""
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty(M, N, dtype=torch.float32, device=a.device)
    kernels.check(kernels.library().skirt_probe_mm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N,
        int(a.dtype == torch.bfloat16), inner, tile[0], tile[1],
        kernels.stream_of(a)), "mm kernel")
    return out


def k8_route_run(tally, cells, vals, nl, ncells, route, split):
    """K8 on `route` and `split`, into `tally` in place."""
    kernels.check(kernels.library().skirt_binned_blocked_add(
        tally.data_ptr(), cells.data_ptr(), vals.data_ptr(), cells.numel(),
        nl, ncells, tally.numel() // nl, route, split,
        kernels.stream_of(tally)), "binned_add_lm kernel")
    return tally


def sweep_pm(reps=100):
    out = []
    for M, K, N, dt, inner in PM_SHAPES:
        a, b = (t.cuda() for t in mm.tables_like_jax(M, K, N, dt))
        want = mm.mm_plain(a, b, inner=inner)
        tol = mm.tolerance(a, b, inner)
        p = mm.plan(M, K, N, dt, torch.cuda.get_device_properties(
            a.device).multi_processor_count)
        lib = common.cuda_ms(lambda: torch.matmul(a, b), reps=reps)
        cells = []
        for tile in mm.TILES[p.route]:
            got = pm_tile(a, b, inner, tile)
            if not bool(((got - want).abs() <= tol).all()):
                raise AssertionError(f"PM {M},{K},{N} tile {tile} off its "
                                     f"plain version")
            ms = common.cuda_ms(lambda: pm_tile(a, b, inner, tile),
                                reps=reps)
            mark = "*" if tile == (p.bm, p.bn) else ""
            cells.append(f"{tile[0]}x{tile[1]}{mark} {ms:.4f}")
        line = (f"PM ({M},{K})@({K},{N}) {str(dt)[6:]} inner={inner}: "
                f"torch.matmul {lib:.4f} | " + " | ".join(cells))
        print(line, flush=True)
        out.append(line)
    return out


def sweep_k8(reps=100):
    optin, sms = binned.device_limits("cuda")
    out = []
    for nl, ncells, per in K8_GRID:
        rs = np.random.default_rng(nl * per + ncells)
        n = nl * per
        cells = torch.from_numpy(rs.integers(-9, ncells + 9, n)
                                 .astype(np.int32)).cuda()
        vals = torch.from_numpy(rs.random(n).astype(np.float32)).cuda()
        Q, R, _ = binned.blocked_layout(nl, ncells, n)
        qr = Q * R
        start = torch.rand(nl * qr, device="cuda")
        want = binned.bincount_blocked_plain(start.clone(), cells, vals,
                                             nlambda=nl, ncells=ncells)
        keep = (cells >= 0) & (cells < ncells)
        bins = (torch.arange(n, device="cuda") // per * qr + cells)[keep]
        kvals = vals[keep]
        t = start.clone()
        lib = common.cuda_ms(lambda: t.index_add_(0, bins, kvals), reps=reps)
        rule = binned.k8_route(per, qr, optin, nl, sms)
        cases = [(binned.K8_SPARSE, 1)]
        cases += ([(binned.K8_DENSE, s) for s in (1, 2, 4, 8)]
                  if qr * 4 <= optin else [(binned.K8_GLOBAL, 1)])
        cells_out = []
        for route, split in cases:
            got = k8_route_run(start.clone(), cells, vals, nl, ncells,
                               route, split)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
            t = start.clone()
            ms = common.cuda_ms(lambda: k8_route_run(
                t, cells, vals, nl, ncells, route, split), reps=reps)
            name = binned.K8_ROUTES[route] + (
                str(split) if route == binned.K8_DENSE else "")
            mark = "*" if (route, split) == rule else ""
            cells_out.append(f"{name}{mark} {ms:.4f}")
        line = (f"K8 nlambda {nl}, {ncells} cells, {per} lanes a block "
                f"({per / qr:.3g} a bin): index_add_ {lib:.4f} | "
                + " | ".join(cells_out))
        print(line, flush=True)
        out.append(line)
    return out


def ptxas_lines(names=("mm_bf16", "mm_f32", "blocked_")):
    """ptxas's registers and spills for the kernels whose names hold one
    of `names`, from this process's build log."""
    out, current = [], None
    for line in kernels.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1) if any(n in m.group(1) for n in names) \
                else None
        elif current and ("Used" in line or "spill" in line):
            name = re.sub(r".*_cu_[0-9a-f]{8}\d+", "", current)
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def main(argv=None):
    parts = (argv if argv is not None else sys.argv[1:]) or ["pm", "k8"]
    common.require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(common.card_line(), flush=True)
    kernels.library()
    for line in ptxas_lines():
        print(f"ptxas {line}", flush=True)
    if "pm" in parts:
        sweep_pm()
    if "k8" in parts:
        sweep_k8()


if __name__ == "__main__":
    main()
