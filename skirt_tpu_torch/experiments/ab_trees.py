"""Two trees on one card: the poly path's kernels (K1, K2) and cells.

On a CUDA machine, from the repository root, with the other tree (for
example the parent commit: `git archive <commit> | tar -x -C
_smoke_checkout`, a directory .gitignore lists) unpacked beside it:

    python -m skirt_tpu_torch.experiments.ab_trees _smoke_checkout

It copies this tree's chip_smoke.py into the other tree, so that both
run the same phase code against their own kernels, then runs in turns
(other, this, this, other):
  - `chip_smoke.py k2 k1`: K2 on its four uniform shapes and on the frame
    stream the S1 poly path sends, K1 at N = 32,768, W = 128;
  - the poly cell, `bench_torch.py` (best of 3);
  - the mono cell, `bench_torch.py` with BENCH_POLY=0 BENCH_NLAMBDA=4
    BENCH_LOG2_PACKETS=21 BENCH_DISPATCH_BATCHES=8 (best of 3);
  - the wrappers' host time per call (HOST_COST): binned_add on 4,096
    updates into the 32,768 frame bins and poly_event on 256 lanes at W =
    128, each 2,000 calls back to back after 50 warm-up calls, where the
    host and not the device sets the pace;
and then `profile_torch.py poly` once in each tree (this one first).
Every run's output lands in OUT/<tree>-<what>-<turn>.log (OUT the
second argument, default ab_trees_out, which .gitignore lists); the
summary, one JSON line of every number from both trees and both turns,
is printed after the card line.  Any run that fails makes the command
exit non-zero after the rest have run.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
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
RUNS = (("smoke", ["chip_smoke.py", "k2", "k1"], {}),
        ("poly", ["bench_torch.py"], {}),
        ("mono", ["bench_torch.py"], MONO),
        ("host", ["-c", HOST_COST], {}))


def numbers(what: str, text: str) -> dict:
    """The numbers of one run's output, by name: chip_smoke.py's results
    line (unrounded), or bench_torch.py's JSON line."""
    out = {}
    for line in text.splitlines():
        if not line.startswith("{"):
            continue
        r = json.loads(line)
        if what == "smoke" and "K1" in r:
            for name, (ms, plain, lib, (bnd, _)) in r["K2"]["times"].items():
                for key, v in (("ms", ms), ("plain_ms", plain),
                               ("index_add_ms", lib), ("bound_ms", bnd)):
                    out[f"K2 {name} {key}"] = v
            for key in ("ms", "plain_ms", "bound_ms"):
                out[f"K1 {key}"] = r["K1"][key]
        elif what == "host" and "host_us" in r:
            for name, us in r["host_us"].items():
                out[f"{name} host us per call"] = us
        elif what in ("poly", "mono") and "metric" in r:
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


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        raise SystemExit("usage: python -m skirt_tpu_torch.experiments."
                         "ab_trees OTHER_TREE [OUT]")
    this = Path.cwd()
    other = Path(args[0]).resolve()
    out = Path(args[1] if len(args) > 1 else "ab_trees_out").resolve()
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(this / "chip_smoke.py", other / "chip_smoke.py")
    card = card_line()
    trees = {"other": other, "this": this}
    summary, failed = {}, []
    for what, cmd, env in RUNS:
        for turn, name in enumerate(("other", "this", "this", "other")):
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
    for name in ("this", "other"):
        log = out / f"{name}-profile.log"
        try:
            run(trees[name], "profile", ["profile_torch.py", "poly"], {}, log)
        except RuntimeError as e:
            failed.append(str(e))
        print(f"{name} profile: {log}", flush=True)
    print(card, flush=True)
    print(json.dumps({"this": str(this), "other": str(other),
                      "numbers": summary}), flush=True)
    if failed:
        raise SystemExit("\n".join(failed))


if __name__ == "__main__":
    main()
