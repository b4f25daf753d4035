"""The readings that the limits of check.py are set from, on the card at
a cell's own size (not part of a benchmark run):

    python3 rtbench/control.py --workload <cell> --seeds <n> [<n> ...] \\
        [--program] [--control]

--program: the lower reading.  One simulation of the port is built and
warmed up; for each seed the run() of the window's first call is run
and compared with the reference for that seed, as a benchmark run
compares the call it draws.
--control: the upper reading.  For each seed the reference is run in
bfloat16 (every quantity and sum), put in the program's place and
judged against the float32 reference of the same seed.
One JSON line per seed and kind."""

import argparse
import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path[0] = str(HERE.parent)


def readings(workload, seeds, program_side, control_side, device="cuda",
             shrink=None, emit=print):
    import torch

    from rtbench import cells, check, program

    cell, cfg = cells.load(workload, shrink)
    dev = torch.device(device)
    out_dir = os.path.join(tempfile.gettempdir(), "rtbench_out",
                           workload + "_control")
    rows = []
    if program_side:
        import skirt_tpu_torch as port

        sim, _ = program.build(cell, cfg, port, dev, out_dir)
        program.run_once(sim, program.call_seed(seeds[0], 0))   # warm-up
        centers = program.cell_centers_kpc(sim, port)
        views = {}
        for s in seeds:
            acc = program.run_once(sim, program.call_seed(s, 1))
            views[s] = check.program_view(
                acc, cfg, check.compared_wavelengths(cell, cfg, s), centers)
        del sim
        gc.collect()
        for s in seeds:
            t0 = time.perf_counter()
            ref = check.reference(cell, cfg, s, dev)
            rows.append({"workload": workload, "seed": s, "kind": "program",
                         "seconds": time.perf_counter() - t0,
                         **check.gaps(views[s], ref, cfg)})
            emit(json.dumps(rows[-1]))
    if control_side:
        for s in seeds:
            t0 = time.perf_counter()
            ref = check.reference(cell, cfg, s, dev)
            low = check.reference(cell, cfg, s, dev, dtype=torch.bfloat16,
                                  acc_dtype=torch.bfloat16)
            rows.append({"workload": workload, "seed": s, "kind": "control",
                         "seconds": time.perf_counter() - t0,
                         **check.gaps(low, ref, cfg)})
            emit(json.dumps(rows[-1]))
    return rows


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    a = p.parse_args()
    readings(a.workload, a.seeds, a.program, a.control)


if __name__ == "__main__":
    main()
