"""Two trees on one card: kernel phases of chip_smoke.py, cells, profiles.

On a CUDA machine, from the repository root, with the other tree (for
example the parent commit: `git archive <commit> | tar -x -C
_smoke_checkout`, a directory .gitignore lists) unpacked beside it:

    python -m skirt_tpu_torch.experiments.ab_trees _smoke_checkout [OUT]
        [--smoke k2,k1] [--cells poly,mono,host] [--profile poly]
        [--pairs 2]

It copies this tree's chip_smoke.py and experiments/common.py into the
other tree, so that both run the same phase and timing code against their
own kernels, then runs --pairs pairs of turns, each pair's order the
reverse of the last (other, this, this, other, other, this, ...):
  - `chip_smoke.py <--smoke phases>` (none if empty; default k2 and k1:
    K2 on its four uniform shapes and on the frame stream the S1 poly
    path sends, K1 at N = 32,768, W = 128; k3: K3 at 2^21 lanes, W = 4,
    and its H = 2 and W = 128 cases; k4: K4 at 2^17 lanes, P = 16; k4d:
    K4d at 2^16 lanes, P = 16; k5: K5 at 2^17 lanes, P = 24, H = 2;
    k6: K6 at W = 2, 24, 128; k6d: K6d at W = 8, 128; k6p: K6p at W = 2,
    24, 128 on both routes; k7: K7 at W = 2, 24, 128);
  - each of --cells (default poly, mono, host), `bench_torch.py` (best of
    3) with the cell's environment (CELLS; PERF.md section 4 names each
    cell): poly the default poly cell; mono BENCH_POLY=0 BENCH_NLAMBDA=4
    BENCH_LOG2_PACKETS=21 BENCH_DISPATCH_BATCHES=8; multi
    BENCH_MODEL=multi (multi-poly, K7 at W = 2); multi-mono the same with
    OCTREE_POLY=0 (K5); octree-poly BENCH_MODEL=octree (K6 at W = 2);
    vor-voxel BENCH_MODEL=voronoi (K6 at W = 2 on the 4,096-site voxel
    view); vor-direct-poly BENCH_MODEL=voronoi VORONOI_DIRECT=1
    VORONOI_SITES=33000 VORONOI_NLAM=8 VORONOI_PEELP=64 VORONOI_REFILL=64
    (K6d); polarized BENCH_MODEL=polarized (pol-mono, K3);
    pol-table-poly the same with POL_TABLE=1 POL_POLY=1 (K6p); host the
    wrappers' host time per call (HOST_COST): binned_add on 4,096 updates
    into the 32,768 frame bins and poly_event on 256 lanes at W = 128,
    each 2,000 calls back to back after 50 warm-up calls, where the host
    and not the device sets the pace;
and then `profile_torch.py` once in each tree (this one first) for each
of --profile (default poly): poly and mono its own modes; a table cell of
PROFILES (octree-poly, multi-mono) with the cell's environment.
Every run's output lands in OUT/<tree>-<what>-<turn>.log (OUT the
second argument, default ab_trees_out, which .gitignore lists); the
summary, one JSON line of every number from both trees and all turns,
is printed after the card line, with each number's quartiles and median
by tree (`stats`: [first quartile, median, third quartile]).  Any run
that fails makes the command exit non-zero after the rest have run.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import statistics
import sys
from pathlib import Path

from .common import card_line

MONO = {"BENCH_POLY": "0", "BENCH_NLAMBDA": "4", "BENCH_LOG2_PACKETS": "21",
        "BENCH_DISPATCH_BATCHES": "8"}
HOST_COST = """
import json, time, torch
from bench_torch import _build
from skirt_tpu_torch.engine import fused_poly
from skirt_tpu_torch.ops import binned
from skirt_tpu_torch.testing import event_case

idx = torch.randint(0, 32768, (4096,), dtype=torch.int32, device="cuda")
val = torch.rand(4096, device="cuda")
tally = torch.zeros(32768, device="cuda")
run, *_ = _build(nlambda=128, ncells=32, packets=256, refill_batches=128,
                 quadrature_panels=32, peel_panels=8, device="cuda")
spec, u, oc, L, l0, state = event_case(run.spec, 256, 7, "cuda")


def per_call(fn, n=2000):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / n * 1e6


print(json.dumps({"host_us": {
    "binned_add": per_call(lambda: binned.binned_add(tally, idx, val)),
    "poly_event": per_call(lambda: fused_poly.poly_event(
        spec, u, oc, L, l0, state))}}))
"""
# the cells of --cells: bench_torch.py's environment, or the host-cost
# script
OCTREE_POLY = {"BENCH_MODEL": "octree"}
MULTI_MONO = {"BENCH_MODEL": "multi", "OCTREE_POLY": "0"}
CELLS = {"poly": (["bench_torch.py"], {}),
         "mono": (["bench_torch.py"], MONO),
         "multi": (["bench_torch.py"], {"BENCH_MODEL": "multi"}),
         "multi-mono": (["bench_torch.py"], MULTI_MONO),
         "octree-poly": (["bench_torch.py"], OCTREE_POLY),
         "vor-voxel": (["bench_torch.py"], {"BENCH_MODEL": "voronoi"}),
         "vor-direct-poly": (["bench_torch.py"], {
             "BENCH_MODEL": "voronoi", "VORONOI_DIRECT": "1",
             "VORONOI_SITES": "33000", "VORONOI_NLAM": "8",
             "VORONOI_PEELP": "64", "VORONOI_REFILL": "64"}),
         "polarized": (["bench_torch.py"], {"BENCH_MODEL": "polarized"}),
         "pol-table-poly": (["bench_torch.py"], {
             "BENCH_MODEL": "polarized", "POL_TABLE": "1", "POL_POLY": "1"}),
         "host": (["-c", HOST_COST], {})}
# the profiles of --profile: profile_torch.py's mode and environment
PROFILES = {"poly": ("poly", {}), "mono": ("mono", {}),
            "octree-poly": ("poly", OCTREE_POLY),
            "multi-mono": ("mono", MULTI_MONO)}


def numbers(what: str, text: str) -> dict:
    """The numbers of one run's output, by name: chip_smoke.py's results
    line (unrounded), or bench_torch.py's JSON line."""
    out = {}
    for line in text.splitlines():
        if not line.startswith("{"):
            continue
        r = json.loads(line)
        if what == "smoke" and "ok" not in r:
            for kern, rec in r.items():
                if kern == "K2":
                    for name, (ms, plain, lib, (bnd, _)) in \
                            rec["times"].items():
                        for key, v in (("ms", ms), ("plain_ms", plain),
                                       ("index_add_ms", lib),
                                       ("bound_ms", bnd)):
                            out[f"K2 {name} {key}"] = v
                    continue
                cases = {"": rec}
                cases.update({f" {c}": v for c, v in
                              rec.get("by_case", {}).items()})
                cases.update({f" W={w}": v for w, v in
                              rec.get("by_W", {}).items()})
                for c, v in cases.items():
                    for key in ("ms", "plain_ms", "bound_ms"):
                        if key in v:
                            out[f"{kern}{c} {key}"] = v[key]
        elif what == "host" and "host_us" in r:
            for name, us in r["host_us"].items():
                out[f"{name} host us per call"] = us
        elif "metric" in r:
            out[f"{what} packets/s"] = r["value"]
    return out


def run(tree: Path, what: str, argv, env_extra, log: Path) -> dict:
    env = dict(os.environ, **env_extra)
    proc = subprocess.run([sys.executable, *argv], cwd=tree, env=env,
                          capture_output=True, text=True)
    log.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} in {tree} exited {proc.returncode}; "
                           f"see {log}")
    return numbers(what, proc.stdout)


def quartiles(values: list) -> list:
    """[first quartile, median, third quartile] of the values."""
    if len(values) < 2:
        return [values[0]] * 3 if values else []
    q1, q2, q3 = statistics.quantiles(values, n=4, method="inclusive")
    return [q1, q2, q3]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("other")
    p.add_argument("out", nargs="?", default="ab_trees_out")
    p.add_argument("--smoke", default="k2,k1")
    p.add_argument("--cells", default="poly,mono,host")
    p.add_argument("--profile", default="poly")
    p.add_argument("--pairs", type=int, default=2)
    args = p.parse_args(argv)
    for what, names, known in (("cell", args.cells, CELLS),
                               ("profile", args.profile, PROFILES)):
        bad = [c for c in names.split(",") if c and c not in known]
        if bad:
            p.error(f"unknown {what} {bad}; known: {sorted(known)}")
    this = Path.cwd()
    other = Path(args.other).resolve()
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    for f in ("chip_smoke.py", "skirt_tpu_torch/experiments/common.py"):
        shutil.copy(this / f, other / f)
    card = card_line()
    trees = {"other": other, "this": this}
    runs = [("smoke", ["chip_smoke.py", *args.smoke.split(",")], {})
            ] if args.smoke else []
    runs += [(c, *CELLS[c]) for c in args.cells.split(",") if c]
    summary, failed = {}, []
    order = [t for i in range(args.pairs)
             for t in (("other", "this"), ("this", "other"))[i % 2]]
    for what, cmd, env in runs:
        for turn, name in enumerate(order):
            log = out / f"{name}-{what}-{turn}.log"
            try:
                got = run(trees[name], what, cmd, env, log)
            except RuntimeError as e:
                failed.append(str(e))
                continue
            for k, v in got.items():
                row = summary.setdefault(k, {"other": [], "this": []})
                row[name].append(v)
            print(f"{name} {what} (turn {turn}): {got}", flush=True)
    for mode in [m for m in args.profile.split(",") if m]:
        arg, env = PROFILES[mode]
        for name in ("this", "other"):
            log = out / f"{name}-profile-{mode}.log"
            try:
                run(trees[name], "profile", ["profile_torch.py", arg], env,
                    log)
            except RuntimeError as e:
                failed.append(str(e))
            print(f"{name} profile {mode}: {log}", flush=True)
    print(card, flush=True)
    stats = {k: {name: quartiles(v) for name, v in row.items()}
             for k, row in summary.items()}
    print(json.dumps({"this": str(this), "other": str(other),
                      "numbers": summary, "stats": stats}), flush=True)
    if failed:
        raise SystemExit("\n".join(failed))


if __name__ == "__main__":
    main()
