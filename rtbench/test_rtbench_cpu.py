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

from rtbench import cells, check, program, run, spans, tracing
from rtbench.kernel_names import classify
from rtbench.spans import SpanTrace
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
CONFIG_KEYS = {"name", "source", "builder", "reference", "precision",
               "wavelengths", "luminosity_W", "stars", "dust", "grid",
               "labs_blocks", "engine", "instruments", "semantics",
               "reduced", "cuts", "assumed", "device_state"}
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
    assert (HERE / "reference" / f"{cfg['reference']}.py").is_file()
    assert set(cfg["labs_blocks"]) == {"counts", "lo_kpc", "hi_kpc"}
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
    # no device operations on the CPU: only the host build and the
    # port's own live-lane counter are read
    assert set(out["metrics"]) == {"host_build_s", "live_lane_share"}
    assert out["breakdown"]["idle_gaps"] == []


# -- the gaps and the limits -----------------------------------------------

def _unit_centers(counts):
    """Centres of unit cells over [0, counts), x-major, z fastest."""
    axes = [np.arange(n) + 0.5 for n in counts]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


def test_gaps_and_judge():
    cfg = {"instruments": [{"kind": "sed"}, {"kind": "frame"}],
           "labs_blocks": {"counts": [8, 8, 4], "lo_kpc": [0, 0, 0],
                           "hi_kpc": [8, 8, 4]}}
    ctr = _unit_centers((8, 8, 4))
    ref = {"sed": [np.array([1.0, 2.0]), np.array([1.0, 1.0])],
           "frame": [None, np.ones((2, 16, 16))],
           "labs": np.ones((256, 2)), "centers": ctr}
    prog = {"sed": [np.array([1.0, 2.002]), np.array([1.0, 1.0])],
            "frame": [None, np.ones((2, 16, 16))],
            "labs": np.ones((256, 2)), "centers": ctr}
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


# -- the reference a configuration names, the labs in blocks of space ------

def _old_labs_gap(prog_labs, ref_labs, shape, counts=(8, 8, 4)):
    """The comparison before blocks of space: each side's labs reshaped
    to the Cartesian grid and summed over equal blocks of cells."""
    return check._gap(check._blocks(prog_labs.sum(1).reshape(shape), counts),
                      check._blocks(ref_labs.sum(1).reshape(shape), counts))


def test_labs_gap_by_position_equals_the_reshape_on_the_disc(tmp_path):
    """The port's tallies and centres of one run() of the shrunk disc
    against the reference's: the same gap as the reshape gave."""
    import skirt_tpu_torch as port

    cell, cfg = cells.load("disc-poly128", shrink("disc-poly128"))
    sim, _ = program.build(cell, cfg, port, torch.device("cpu"),
                           str(tmp_path))
    acc = program.run_once(sim, program.call_seed(SEED, 1))
    centers = program.cell_centers_kpc(sim, port)
    ells = check.compared_wavelengths(cell, cfg, SEED)
    prog = check.program_view(acc, cfg, ells, centers)
    ref = check.reference(cell, cfg, SEED, "cpu")
    np.testing.assert_allclose(prog["centers"], ref["centers"], rtol=1e-12)
    g = cfg["grid"]
    old = _old_labs_gap(prog["labs"], ref["labs"], (g["nx"], g["ny"], g["nz"]))
    new = check.gaps(prog, ref, cfg)["labs_gap"]
    assert 0 < old < 1
    assert new == pytest.approx(old, rel=1e-12)


def test_labs_gap_by_position_equals_the_reshape_at_the_cells_size():
    """disc-galaxy's own grid and blocks (32 x 32 x 16 cells in 8 x 8 x 4
    blocks) on made-up tallies: the same gap as the reshape gave."""
    from rtbench.reference import expdisk

    _, cfg = cells.load("disc-poly128")
    ctr = expdisk._centers(expdisk.Model(cfg))
    rng = np.random.default_rng(SEED)
    p, r = rng.random((2, ctr.shape[0], 3))
    g = cfg["grid"]
    old = _old_labs_gap(p, r, (g["nx"], g["ny"], g["nz"]))
    spec = cfg["labs_blocks"]
    new = check._gap(check.labs_blocks(p, ctr, spec),
                     check.labs_blocks(r, ctr, spec))
    assert new == pytest.approx(old, rel=1e-12)


def _two_level_cells():
    """Octree-like boxes over [-2, 2]^3 kpc: the 8 level-1 octants, the
    first of which is split into its 8 level-2 children; (lo, hi) per
    leaf, leaves in a tree's depth-first order."""
    boxes = []
    for oct_ in range(8):
        lo = np.array([-2.0 + 2 * ((oct_ >> k) & 1) for k in (2, 1, 0)])
        if oct_ == 0:
            for ch in range(8):
                clo = lo + np.array([(ch >> k) & 1 for k in (2, 1, 0)])
                boxes.append((clo, clo + 1))
        else:
            boxes.append((lo, lo + 2))
    return boxes


def test_labs_blocks_sum_unequal_cells_into_their_blocks():
    """15 leaves of two levels into 2 x 2 x 2 blocks of 2 kpc: the
    8 children of the first octant all land in block (0, 0, 0), each
    other octant alone in its own."""
    boxes = _two_level_cells()
    ctr = np.array([(lo + hi) / 2 for lo, hi in boxes])
    labs = np.arange(1.0, 1.0 + 2 * len(boxes)).reshape(-1, 2)
    spec = {"counts": [2, 2, 2], "lo_kpc": [-2, -2, -2],
            "hi_kpc": [2, 2, 2]}
    got = check.labs_blocks(labs, ctr, spec)
    want = np.concatenate([[labs[:8].sum()], labs[8:].sum(1)])
    np.testing.assert_allclose(got, want, rtol=1e-15)
    # a finer block layout that a level-1 octant straddles still takes
    # every cell's energy once, in the block of its centre
    fine = dict(spec, counts=[4, 4, 4])
    assert check.labs_blocks(labs, ctr, fine).sum() == pytest.approx(
        labs.sum())


def test_labs_gap_is_inf_where_centres_do_not_match_the_rows():
    spec = {"counts": [2, 2, 2], "lo_kpc": [0, 0, 0], "hi_kpc": [2, 2, 2]}
    ctr = _unit_centers((2, 2, 2))
    cfg = {"instruments": [{"kind": "sed"}], "labs_blocks": spec}
    side = {"sed": [np.ones(3)], "frame": [None], "labs": np.ones((8, 3)),
            "centers": ctr}
    ok = dict(side, labs=np.ones((8, 3)) * 1.01)
    assert check.gaps(ok, side, cfg)["labs_gap"] == pytest.approx(0.01)
    for bad in (ctr[:7], ctr[:, :2], np.where(ctr > 1, np.nan, ctr),
                ctr + 1.0):          # a row short, 2D, NaN, outside
        got = check.gaps(dict(ok, centers=bad), side, cfg)["labs_gap"]
        assert got == float("inf")
    assert not check.judge({"labs_gap": float("inf")},
                           {"labs_gap": 1.0})[0]


def test_check_calls_the_reference_the_configuration_names(monkeypatch):
    """A configuration unlike the disc's (another reference module,
    octree-like cells, no frame) judged by check.py as it stands."""
    import types

    boxes = _two_level_cells()
    ctr = np.array([(lo + hi) / 2 for lo, hi in boxes])
    calls = []

    def simulate(cfg, ells, packets, seed, device, **kw):
        calls.append((cfg["name"], list(ells), packets, seed, device, kw))
        return {"sed": [np.full(len(ells), 2.0)], "frame": [None],
                "labs": np.ones((len(boxes), len(ells))), "centers": ctr}

    stub = types.ModuleType("rtbench.reference.stub_torus")
    stub.simulate = simulate
    monkeypatch.setitem(sys.modules, "rtbench.reference.stub_torus", stub)
    cfg = {"name": "stub", "reference": "stub_torus",
           "wavelengths": {"count": 24},
           "instruments": [{"kind": "sed"}],
           "labs_blocks": {"counts": [2, 2, 2], "lo_kpc": [-2, -2, -2],
                           "hi_kpc": [2, 2, 2]}}
    cell = {"reference": {"wavelengths": 4, "packets": 1000}}
    ref = check.reference(cell, cfg, SEED, "cpu", dtype="low")
    ells = check.compared_wavelengths(cell, cfg, SEED)
    assert calls == [("stub", ells, 1000, check.reference_seed(SEED), "cpu",
                      {"dtype": "low"})]
    # the program on a layout of its own: 64 equal cells of 1 kpc
    fine = np.stack(np.meshgrid(*[np.arange(4) - 1.5] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    # each of the 8 blocks holds 8 of the program's cells, which share
    # what the reference's cells in that block hold (block 0: 8 leaves)
    blk = np.ravel_multi_index(
        np.floor((fine + 2) / 2).astype(int).T, (2, 2, 2))
    ref_blocks = check.labs_blocks(ref["labs"], ctr, cfg["labs_blocks"])
    np.testing.assert_allclose(ref_blocks, [32.0] + [4.0] * 7)
    acc = {"instruments": [{"Ftot": np.full(24, 2.0)}],
           "labs": np.zeros((64, 24))}
    acc["labs"][:, ells] = (ref_blocks[blk] / 8 / len(ells))[:, None]
    found = check.gaps(check.program_view(acc, cfg, ells, fine), ref, cfg)
    assert found["sed_gap"] == 0 and "frame_gap" not in found
    assert found["labs_gap"] == pytest.approx(0, abs=1e-12)
    limits = {"sed_gap": 0.01, "labs_gap": 0.01}
    assert check.judge(found, limits)[0]
    acc["labs"][0] *= 2                   # block 0: 36 against 32
    found = check.gaps(check.program_view(acc, cfg, ells, fine), ref, cfg)
    assert found["labs_gap"] == pytest.approx(4 / 32)
    assert not check.judge(found, limits)[0]


# -- the metric readers on a synthetic trace -------------------------------

def _trace():
    from rtbench.test_rtbench_spans import _trace as span_trace

    ms = 1_000_000
    ops = [("void poly_event_kernel<1>(PolyArgs)", 0, 2 * ms),
           ("binned_add_shared", 2 * ms, 3 * ms),
           ("void at::native::elementwise_kernel<...>", 5 * ms, 6 * ms),
           ("void poly_event_kernel<1>(PolyArgs)", 6 * ms, 8 * ms),
           ("Memcpy DtoH (Device -> Pageable)", 9 * ms, 10 * ms)]
    # the host phase: a dispatch of 40 ms holding 9 ms of stop tests
    host = [("run", 0, 50, -1), ("dispatch", 5, 45, 0), ("check", 5, 9, 1),
            ("event", 9, 20, 1), ("check", 25, 30, 1), ("drain", 45, 50, 0)]
    return Trace(ops=ops, wall_s=0.020, untraced_wall_s=0.014,
                 launches=2, host_build_s=1.5, spans=span_trace(),
                 host_spans=SpanTrace(spans=[(n, s * ms, e * ms, p)
                                             for n, s, e, p in host],
                                      launches=4))


@pytest.mark.parametrize("name,value", [
    ("device_idle_share", 100 * (1 - 7 / 14)),
    ("launches_per_iter", 2.5),
    ("plain_ms_per_iter", 1.0),
    ("event_kernel_us", 2000.0),
    ("tally_us_per_iter", 500.0),
    ("host_build_s", 1.5),
    ("host_ms_per_iter", (40 - 9) / 4),
    # the spans phase's readings (test_rtbench_spans.py's trace); its
    # 54 ms of idle scaled to the untraced run()'s 14 - 7 ms
    ("live_lane_share", 75.0),
    ("detect_ms_per_iter", 14.0),
    ("peel_ms_per_iter", 8.0),
    ("dispatch_idle_ms_per_run", 28.0 * 7 / 54),
    ("entry_idle_ms_per_run", 26.0 * 7 / 54),
])
def test_metric_reader(name, value):
    assert cells.metric_reader(name)(_trace()) == pytest.approx(value)


@pytest.mark.parametrize("name", ["launches_per_iter", "plain_ms_per_iter",
                                  "event_kernel_us", "tally_us_per_iter",
                                  "device_idle_share", "host_ms_per_iter",
                                  "live_lane_share", "detect_ms_per_iter",
                                  "peel_ms_per_iter",
                                  "dispatch_idle_ms_per_run",
                                  "entry_idle_ms_per_run"])
def test_metric_reader_reads_nothing_from_an_empty_trace(name):
    assert cells.metric_reader(name)(Trace()) is None


def test_idle_readings_split_the_untraced_idle():
    """The spans phase splits the idle, the untraced run() sets how much
    there is; none where the first phase is missing, none below 0."""
    tr = _trace()
    parts = [cells.metric_reader(n)(tr) for n in
             ("dispatch_idle_ms_per_run", "entry_idle_ms_per_run")]
    assert sum(parts) == pytest.approx((0.014 - tr.busy_s()) * 1e3)
    assert tr.untraced_idle_ms(None) is None
    tr.untraced_wall_s = 0.005            # shorter than the busy 7 ms
    assert tr.untraced_idle_ms(28.0) == 0.0
    tr.ops = []
    assert tr.untraced_idle_ms(28.0) is None


def test_breakdown_names_gaps_by_the_open_host_range():
    """The idle gaps of the spans phase, by the port's span open over
    each part of a gap (test_rtbench_spans.py's trace)."""
    tr = _trace()
    gaps = dict(tracing.idle_gaps(tr))
    assert gaps == pytest.approx({"dispatch": 0.020, "run": 0.010,
                                  "write": 0.010, "drain": 0.006,
                                  "event": 0.005, "detect": 0.002,
                                  "peel": 0.001})
    assert list(gaps)[0] == "dispatch"
    assert len(tracing.idle_gaps(tr, top=3)) == 3
    assert tracing.idle_gaps(Trace()) == []
    ops = dict(tracing.device_ops(tr))
    assert ops["K1 poly_event"] == pytest.approx(0.004)
    assert classify("binned_add_global")[1] == "K2"
    assert classify("table_poly_event_kernel")[1] == "K6"


def test_idle_share_from_a_missing_range_reads_nothing():
    assert spans.launches(type("pkg", (), {"__name__": "no_such"})) is None


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
