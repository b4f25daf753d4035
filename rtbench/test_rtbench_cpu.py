"""CPU tests of the benchmark (python3 -m pytest rtbench -m "not gpu").

The cells run here at a tiny size (`shrink`) on the CPU, where the port
takes its plain versions and the reference runs its own packets: the
two agree to Monte Carlo noise, under limits for that size, and every
fault planted in the timed path, and the bfloat16 control, must come
out as not correct."""

import ast
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rtbench import cells, check, run, tracing
from rtbench.kernel_names import classify
from rtbench.tracing import Trace

torch.set_num_threads(2)

HERE = Path(__file__).resolve().parent
CELLS = ("disc-poly128", "disc-mono128")
SEED = 3_141_592_653          # past 2**31, as a benchmark check's seeds are
# limits at the tiny size, where both sides' Monte Carlo noise is some
# percent (sound runs here read about 0.02 / 0.04 / 0.14 at most)
TINY_LIMITS = {"sed_gap": 0.08, "frame_gap": 0.12, "labs_gap": 0.35}


def shrink(workload):
    cell, _ = cells.load(workload)
    lanes = 1024 if cell["polychromatic"] else 512
    return {"config": {"wavelengths": {"count": 8},
                       "grid": {"nx": 8, "ny": 8, "nz": 4}},
            "workload": {"batch_size": 8 * lanes, "refill_batches": 8,
                         "dispatch_batches": 1, "batches_per_run": 1,
                         "reference": {"wavelengths": 4, "packets": 20000},
                         "limits": TINY_LIMITS}}


def drive(workload, **kw):
    return run.drive(workload, SEED, 0, kw.pop("trace", False),
                     device="cpu", shrink=shrink(workload),
                     log=lambda msg: None, **kw)


# -- the files -------------------------------------------------------------

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CONFIG_KEYS = {"name", "source", "builder", "precision", "wavelengths",
               "luminosity_W", "stars", "dust", "grid", "engine",
               "instruments", "semantics", "reduced", "cuts", "assumed",
               "device_state"}
CELL_KEYS = {"name", "config", "loop", "polychromatic", "batch_size",
             "refill_batches", "dispatch_batches", "batches_per_run",
             "reference", "limits"}


def test_benchmark_json_names_files_that_exist():
    b = cells.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["rtbench"]
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert NAME.match(c["name"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (HERE.parent / c["file"]).is_file()
        assert json.load(open(HERE.parent / c["file"]))["name"] == c["name"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert cells.load(w["name"])[0]["config"] == w["config"]
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    reports = {w["name"]: {m["name"] for m in b["end_to_end"]
                           if w["name"] in m.get("workloads", [w["name"]])}
               for w in b["workloads"]}
    for w, names in reports.items():
        assert "setup_s" in names and len(names) >= 2, w
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", reports):
            assert m["moves"] in reports[w], (m["name"], w)
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= {w["name"]
                                               for w in b["workloads"]}


@pytest.mark.parametrize("workload", CELLS)
def test_cell_and_config_files_name_only_known_keys(workload):
    cell, cfg = cells.load(workload)
    assert set(cell) == CELL_KEYS and cell["name"] == workload
    assert set(cfg) == CONFIG_KEYS
    assert set(cfg["reduced"]) == set(cfg["cuts"])
    assert cfg["precision"] == "float32"
    listed = [c for c in cells.benchmark()["configs"]
              if c["name"] == cfg["name"]]
    assert listed[0]["reduced"] == cfg["reduced"]
    assert cell["loop"] == "closed"
    assert set(cell["reference"]) == {"wavelengths", "packets"}
    assert cfg["wavelengths"]["count"] % cell["reference"]["wavelengths"] == 0
    assert set(cell["limits"]) == ({"sed_gap", "labs_gap"} | (
        {"frame_gap"} if any(i["kind"] == "frame"
                             for i in cfg["instruments"]) else set()))


# -- one run, its result line and its check --------------------------------

@pytest.mark.parametrize("workload", CELLS)
def test_port_and_reference_agree_on_the_cpu(workload):
    """Other packets on the two sides: the gaps are Monte Carlo noise."""
    out = drive(workload)
    assert out["correct"] and out["failed"] == 0, out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_result_line_has_the_contract_keys(workload):
    out = drive(workload)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["metrics"]) == {"packets_per_s", "setup_s"}
    assert out["metrics"]["packets_per_s"]["unit"] == "packets/s"
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.dumps(out)


def test_refuses_a_missing_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "disc-poly128", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def _unchanged(sim):
    sim._lifecycle = lambda key, ell, L0, tallies: tallies


def _half_batch(sim):
    inner = sim._lifecycle

    def half(key, ell, L0, tallies):
        n = ell.shape[0] // 2
        return inner(key, ell[:n], L0[:n], tallies)
    sim._lifecycle = half


def _altered(sim):
    inner = sim._fold_acc

    def altered(acc):
        acc = inner(acc)
        acc["instruments"][0]["Ftot"] *= 1.2
        return acc
    sim._fold_acc = altered


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered],
                         ids=["state-unchanged", "half-batch",
                              "answer-altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault):
    out = drive(workload, fault=fault)
    assert not out["correct"] and out["failed"] == 1


@pytest.mark.parametrize("workload", CELLS)
def test_bfloat16_control_fails_a_limit(workload):
    from rtbench.control import readings

    rows = readings(workload, [SEED], False, True, device="cpu",
                    shrink=shrink(workload), emit=lambda line: None)
    found = {k: v for k, v in rows[0].items() if k.endswith("_gap")}
    assert not check.judge(found, TINY_LIMITS)[0]


def test_reference_without_dust_gives_every_packet_to_the_sed():
    from rtbench.reference import expdisk

    _, cfg = cells.load("disc-poly128", shrink("disc-poly128"))
    cfg["dust"]["tau_z_face_on"] = 0.0
    out = expdisk.simulate(cfg, [0, 5], 4096, SEED, "cpu")
    for sed in out["sed"]:
        assert sed == pytest.approx([cfg["luminosity_W"]] * 2, rel=1e-5)
    assert not out["labs"].any()


def test_trace_run_reports_its_per_layer_metrics_on_the_cpu():
    out = drive("disc-poly128", trace=True)
    assert list(out)[-1] == "checks" and "breakdown" in out
    # no device operations on the CPU: only the host build is read
    assert set(out["metrics"]) == {"host_build_s"}


# -- the gaps and the limits -----------------------------------------------

def test_gaps_and_judge():
    cfg = {"instruments": [{"kind": "sed"}, {"kind": "frame"}],
           "grid": {"nx": 8, "ny": 8, "nz": 4}}
    ref = {"sed": [np.array([1.0, 2.0]), np.array([1.0, 1.0])],
           "frame": [None, np.ones((2, 16, 16))],
           "labs": np.ones((256, 2))}
    prog = {"sed": [np.array([1.0, 2.002]), np.array([1.0, 1.0])],
            "frame": [None, np.ones((2, 16, 16))],
            "labs": np.ones((256, 2))}
    prog["frame"][1][0, 0, 0] = 1.64      # block (0, 0): 16 px x 2 wl
    prog["labs"][0] = [1.5, 1.5]          # a block of 1 cell
    g = check.gaps(prog, ref, cfg)
    assert g == pytest.approx({"sed_gap": 0.001, "frame_gap": 0.02,
                               "labs_gap": 0.5})
    limits = {"sed_gap": 0.002, "frame_gap": 0.03, "labs_gap": 0.6}
    assert check.judge(g, limits)[0]
    assert not check.judge(g, dict(limits, sed_gap=0.0005))[0]
    prog["labs"][0] = np.nan
    ok, rows = check.judge(check.gaps(prog, ref, cfg), limits)
    assert not ok and rows["labs_gap"]["value"] is None


def test_compared_wavelengths_are_drawn_from_the_seed():
    cell, cfg = cells.load("disc-poly128")
    a = check.compared_wavelengths(cell, cfg, SEED)
    assert len(a) == cell["reference"]["wavelengths"]
    assert a == check.compared_wavelengths(cell, cfg, SEED)
    assert np.all(np.diff(a) == a[1] - a[0]) and a[-1] < 128
    draws = {tuple(check.compared_wavelengths(cell, cfg, s))
             for s in range(40)}
    assert len(draws) > 1


# -- the metric readers on a synthetic trace -------------------------------

def _trace():
    ms = 1_000_000
    ops = [("void poly_event_kernel<1>(PolyArgs)", 0, 2 * ms),
           ("binned_add_shared", 2 * ms, 3 * ms),
           ("void at::native::elementwise_kernel<...>", 5 * ms, 6 * ms),
           ("void poly_event_kernel<1>(PolyArgs)", 6 * ms, 8 * ms),
           ("Memcpy DtoH (Device -> Pageable)", 9 * ms, 10 * ms)]
    return Trace(ops=ops, ranged_ops=ops,
                 host=[("run", 0, 20 * ms),
                       ("write", 9 * ms + ms // 2, 20 * ms)],
                 wall_s=0.020, untraced_wall_s=0.014, launches=2,
                 host_build_s=1.5)


@pytest.mark.parametrize("name,value", [
    ("device_idle_share", 100 * (1 - 7 / 14)),
    ("launches_per_iter", 2.5),
    ("plain_ms_per_iter", 1.0),
    ("event_kernel_us", 2000.0),
    ("tally_us_per_iter", 500.0),
    ("host_build_s", 1.5),
])
def test_metric_reader(name, value):
    assert cells.metric_reader(name)(_trace()) == pytest.approx(value)


@pytest.mark.parametrize("name", ["launches_per_iter", "plain_ms_per_iter",
                                  "event_kernel_us", "tally_us_per_iter",
                                  "device_idle_share"])
def test_metric_reader_reads_nothing_from_an_empty_trace(name):
    assert cells.metric_reader(name)(Trace()) is None


def test_breakdown_names_gaps_by_the_open_host_range():
    tr = _trace()
    gaps = dict(tracing.idle_gaps(tr))
    assert gaps["write"] == pytest.approx(0.010)
    assert gaps["run: drain and bookkeeping"] == pytest.approx(0.003)
    ops = dict(tracing.device_ops(tr))
    assert ops["K1 poly_event"] == pytest.approx(0.004)
    assert classify("binned_add_global")[1] == "K2"
    assert classify("table_poly_event_kernel")[1] == "K6"


def test_idle_share_from_a_missing_range_reads_nothing():
    assert tracing.launches(type("pkg", (), {"__name__": "no_such"})) is None


# -- what may be imported --------------------------------------------------

def _imports(path):
    tree = ast.parse(path.read_text())
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            yield from (a.name for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.level == 0:
            yield n.module


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_port_or_jax(path):
    for mod in _imports(path):
        assert mod.split(".")[0] not in ("skirt_tpu_torch", "skirt_tpu",
                                         "jax", "jaxlib", "flax", "rtbench")


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_benchmark_imports_no_jax(path):
    for mod in _imports(path):
        assert mod.split(".")[0] not in ("skirt_tpu", "jax", "jaxlib",
                                         "flax")


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "skirt_tpu_torch_x", sys)
    assert "skirt_tpu" not in run.banned_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.banned_modules() == ["jax"]
