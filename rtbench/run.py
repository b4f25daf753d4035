"""Run one cell of the benchmark once and print its result line.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell
asks for.  One `OligoSimulation` of the port is built from the cell's
files; a warm-up run() (CUDA start-up, the kernel build or load, the
first batch) closes the set-up; then run() is called again and again,
closed loop, each call with a fresh seed derived from --seed and writing
its SED and FITS files under $TMPDIR, until the first phase end after
--seconds.  --trace 1 runs three more whole run() phases after the
window (tracing.py: the port's own spans alone, then the device alone
and those spans under the profiler) and
reports the per-layer metrics instead of the end-to-end ones; the window
itself is not traced.  Then the centres of the simulation's cells are
read, and one run() of the window, drawn from the seed, is compared with
the plain reference that the configuration names (check.py), which runs
its own packets.  The last line of standard output is the result's JSON;
the last lines of standard error are the numbers compared, each beside
its limit."""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# import rtbench.* and the port from the checkout's root
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# modules that no run may load, by top-level name
BANNED = ("jax", "jaxlib", "flax", "skirt_tpu")


def cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernels into skirt_tpu_torch/_build itself)."""
    base = ROOT / ".rtbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def _spread(xs) -> str:
    xs = sorted(xs)
    return f"{xs[0]:.4f} / {xs[len(xs) // 2]:.4f} / {xs[-1]:.4f}"


def drive(workload: str, seed: int, seconds: float, trace: bool,
          device="cuda", started=None, shrink=None, fault=None,
          log=None) -> dict:
    """One run of a cell without the look for a card: the result's
    fields.  `started` is the perf_counter() reading that set-up counts
    from (the process's start).  `shrink` and `fault` (a callable given
    the built simulation, which may break it) are for the CPU tests."""
    import torch

    import skirt_tpu_torch as port

    from rtbench import cells, check, program, tracing

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell, cfg = cells.load(workload, shrink)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        # the drivers' host work is one thread's; idle pool threads only
        # take cores from it
        torch.set_num_threads(1)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    out_dir = os.path.join(tempfile.gettempdir(), "rtbench_out", workload)
    sim, host_s = program.build(cell, cfg, port, dev, out_dir)
    if fault is not None:
        fault(sim)
    per_run = program.packets_per_run(cell, cfg)
    program.run_once(sim, program.call_seed(seed, 0))     # warm-up
    sync()
    setup_s = time.perf_counter() - (_T0 if started is None else started)
    log(f"rtbench: {workload}: host build {host_s:.3f} s, set-up "
        f"{setup_s:.3f} s, {per_run} packets a run()")

    # one run() of the window is checked, drawn from the seed as the
    # window goes (reservoir sampling): only that one's tallies are kept
    draw = random.Random(f"rtbench-pick:{int(seed)}")
    kept = pick = None
    ends, cpu = [], []
    t0 = time.perf_counter()
    c0 = time.process_time()
    while True:
        acc = program.run_once(sim, program.call_seed(seed, len(ends) + 1))
        ends.append(time.perf_counter())
        cpu.append(time.process_time())
        if draw.randrange(len(ends)) == 0:
            kept, pick = acc, len(ends)
        del acc
        if ends[-1] - t0 >= seconds:
            break
    sync()
    wall = time.perf_counter() - t0
    n_runs = len(ends)
    calls = [b - a for a, b in zip([t0] + ends, ends)]
    cpus = [b - a for a, b in zip([c0] + cpu, cpu)]
    pps = n_runs * per_run / wall
    mem = torch.cuda.max_memory_allocated(dev) if cuda else 0
    log(f"rtbench: window {wall:.4f} s, {n_runs} run() calls, "
        f"{pps:.6g} packets/s, device memory peak {mem} bytes; run() "
        f"wall {_spread(calls)} s, host CPU {_spread(cpus)} s "
        "(least / median / most)")

    tr = None
    if trace:
        t1 = time.perf_counter()
        nxt = itertools.count(n_runs + 1)
        tr = tracing.profile_phases(port, lambda: program.run_once(
            sim, program.call_seed(seed, next(nxt))), cuda)
        tr.host_build_s = host_s
        tr.untraced_wall_s = sorted(calls)[n_runs // 2]
        st, hs = tr.spans, tr.host_spans
        log(f"rtbench: traced phase {tr.wall_s:.4f} s against the window's "
            f"median run() {tr.untraced_wall_s:.4f} s, {len(tr.ops)} device "
            f"operations, {tr.launches} event launches; spans phase "
            f"{st.wall_s if st else 0.0:.4f} s, "
            f"{len(st.spans) if st else 0} spans; host phase "
            f"{hs.wall_s if hs else 0.0:.4f} s; the three phases run and "
            f"read in {time.perf_counter() - t1:.1f} s")

    centers = program.cell_centers_kpc(sim, port)
    del sim
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    ells = check.compared_wavelengths(cell, cfg, seed)
    ref = check.reference(cell, cfg, seed, dev)
    found = check.gaps(check.program_view(kept, cfg, ells, centers), ref,
                       cfg)
    correct, rows = check.judge(found, cell["limits"])
    log(f"rtbench: run() {pick} against the reference at wavelengths "
        f"{ells}, {cell['reference']['packets']} packets each, in "
        f"{time.perf_counter() - t2:.1f} s")

    if trace:
        metrics = {}
        for spec in cells.metric_specs(workload, "per_layer"):
            v = cells.metric_reader(spec["name"])(tr)
            if v is not None:
                metrics[spec["name"]] = {"value": v, "unit": spec["unit"]}
    else:
        e2e = {"packets_per_s": pps, "setup_s": setup_s}
        metrics = {spec["name"]: {"value": e2e[spec["name"]],
                                  "unit": spec["unit"]}
                   for spec in cells.metric_specs(workload, "end_to_end")}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(mem)}
    out = {"correct": bool(correct), "attempted": n_runs,
           "failed": 0 if correct else 1, "metrics": metrics,
           "device": device_info}
    if trace:
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.wall_s
        out["breakdown"] = {"device_ops": tracing.device_ops(tr),
                            "idle_gaps": tracing.idle_gaps(tr)}
    out["checks"] = rows
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cache_dirs()
    from rtbench import cells

    chips = [w["chips"] for w in cells.benchmark()["workloads"]
             if w["name"] == a.workload]
    if not chips:
        print(f"rtbench: no cell {a.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips[0]:
        print(f"rtbench: {a.workload} needs {chips[0]} CUDA device(s); torch "
              f"sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = drive(a.workload, a.seed, a.seconds, bool(a.trace), started=_T0)
    bad = banned_modules()
    if bad:
        print(f"rtbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, row in out["checks"].items():
        print(f"{name} {row['value']} limit {row['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
