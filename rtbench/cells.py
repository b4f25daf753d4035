"""A cell's files, found by name: BENCHMARK.json at the checkout root,
`workloads/<cell>.json`, `configs/<config>.json`, and the per-layer
metrics of `metrics/<metric>.py` that BENCHMARK.json gives the cell."""

import copy
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _read(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load(workload: str, shrink: dict | None = None):
    """(cell, config) for a workload name.  `shrink` holds overrides
    {"workload": {...}, "config": {...}} (nested dicts merge key by key),
    for the CPU tests only: a run at the cell's sizes takes no shrink."""
    cell = _read("workloads", workload)
    cfg = _read("configs", cell["config"])
    if shrink:
        cell = _merged(cell, shrink.get("workload", {}))
        cfg = _merged(cfg, shrink.get("config", {}))
    return cell, cfg


def _merged(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merged(out[k], v)
        else:
            out[k] = v
    return out


def metric_specs(workload: str, key: str) -> list[dict]:
    """BENCHMARK.json's `end_to_end` or `per_layer` entries that this
    cell reports: those without a `workloads` key and those listing it."""
    return [m for m in benchmark()[key]
            if workload in m.get("workloads", [workload])]


def metric_reader(name: str):
    """`read(trace)` of metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"rtbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
