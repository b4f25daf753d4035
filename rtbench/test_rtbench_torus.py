"""Tests of the agn-torus configuration and its cell torus-poly24
(python3 -m pytest rtbench/test_rtbench_torus.py -m "not gpu"; on the
card, -m gpu).

On the CPU the cell runs at a tiny size (`shrink`: an octree of levels
2-3, 4 wavelengths, the inclinations 0, 50 and 90 degrees) against its
plain reference (reference/torus.py), under limits for that size; every
fault planted in the timed path, and the bfloat16 control, must come out
as not correct.  At the tiny size the equatorial tau_V is 5, not 51: on
8 voxels an axis the funnel's edge cells fill with dust, and through
tau_V 51 the tiny runs' SEDs at 0.55 um would be 1e-9 of the source,
all noise.  At the cell's own level the model is checked for what
check.py relies on (no leaf straddles a labs block; the program's field
and the reference's differ by a bounded amount) and for its
normalisation (the optical depth along +x from the source).  The card
cases run the cell at its own size; they skip without a CUDA device."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rtbench import cells, check, program, run, spans
from rtbench.reference import torus as ref_torus
from rtbench.spans import SpanTrace
from rtbench.test_rtbench_cpu import _altered, _half_batch, _unchanged
from rtbench.tracing import Trace

torch.set_num_threads(2)

HERE = Path(__file__).resolve().parent
CELL = "torus-poly24"
SEED = 3_141_592_653          # past 2**31, as a benchmark check's seeds are
# limits at the tiny size, where both sides' Monte Carlo noise is some
# percent (sound runs here read about 0.025 / 0.09 at most)
TINY_LIMITS = {"sed_gap": 0.08, "labs_gap": 0.25}


def shrink():
    _, cfg = cells.load(CELL)
    return {"config": {"wavelengths": {"count": 4},
                       "grid": {"max_level": 3},
                       "dust": {"tau_v": 5.0},
                       "instruments": [cfg["instruments"][i]
                                       for i in (0, 5, 9)]},
            "workload": {"batch_size": 4 * 1024, "refill_batches": 4,
                         "dispatch_batches": 1, "batches_per_run": 1,
                         "reference": {"wavelengths": 4, "packets": 20000},
                         "limits": TINY_LIMITS}}


def drive(**kw):
    return run.drive(CELL, SEED, 0, False, device="cpu", shrink=shrink(),
                     log=lambda msg: None, **kw)


# -- the files -------------------------------------------------------------

def test_files_follow_the_disc_cells_contract():
    from rtbench.test_rtbench_cpu import CELL_KEYS, CONFIG_KEYS

    cell, cfg = cells.load(CELL)
    assert set(cell) == CELL_KEYS and cell["name"] == CELL
    assert set(cfg) == CONFIG_KEYS
    assert cfg["builder"] == "torus_octree" and cfg["reference"] == "torus"
    assert cfg["reduced"] == ["grid"] and set(cfg["cuts"]) == {"grid"}
    assert cfg["precision"] == "float32" and cell["polychromatic"]
    assert cell["batch_size"] == (1 << 15) * cfg["wavelengths"]["count"]
    assert cfg["wavelengths"]["count"] % cell["reference"]["wavelengths"] == 0
    assert set(cell["limits"]) == {"sed_gap", "labs_gap"}
    assert [round(np.degrees(i["inclination"]), 9)
            for i in cfg["instruments"]] == list(range(0, 91, 10))
    b = cells.benchmark()
    listed = [c for c in b["configs"] if c["name"] == cfg["name"]]
    assert listed[0]["reduced"] == cfg["reduced"]
    assert listed[0]["file"] == "rtbench/configs/agn-torus.json"
    w, = [w for w in b["workloads"] if w["name"] == CELL]
    assert w["config"] == "agn-torus" and w["chips"] == 1
    new = {"exact_peel_ms_per_iter", "stage_gather_ms_per_iter",
           "exact_peel_roofline"}
    for m in b["per_layer"]:
        if m["name"] in new:
            assert m["workloads"] == [CELL] and m["layer"] == "Drivers"
            assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    assert new <= {m["name"] for m in b["per_layer"]}
    # the equatorial tau_V follows from tau_9.7 as the file states
    d = cfg["dust"]
    assert d["tau_v"] == pytest.approx(d["tau_9_7"] * d["av_over_tau_9_7"]
                                       / 1.086, rel=1e-12)


def _imports(path):
    for n in ast.walk(ast.parse(path.read_text())):
        if isinstance(n, ast.Import):
            yield from (a.name for a in n.names)
        elif isinstance(n, ast.ImportFrom):
            yield "." if n.level else n.module


def test_reference_imports_only_numpy_and_torch():
    mods = {m.split(".")[0] for m in _imports(HERE / "reference" / "torus.py")}
    assert mods == {"math", "numpy", "torch"}


# -- one run, its check, the faults and the control ------------------------

def test_port_and_reference_agree_on_the_cpu():
    """Other packets on the two sides: the gaps are Monte Carlo noise."""
    out = drive()
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert set(out["checks"]) == {"sed_gap", "labs_gap"}


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered],
                         ids=["state-unchanged", "half-batch",
                              "answer-altered"])
def test_a_broken_timed_path_is_not_correct(fault):
    out = drive(fault=fault)
    assert not out["correct"] and out["failed"] == 1


def test_bfloat16_control_fails_a_limit():
    from rtbench.control import readings

    rows = readings(CELL, [SEED], False, True, device="cpu",
                    shrink=shrink(), emit=lambda line: None)
    found = {k: v for k, v in rows[0].items() if k.endswith("_gap")}
    assert not check.judge(found, TINY_LIMITS)[0]


def test_the_cell_builds_its_exact_peel_with_the_graph(monkeypatch,
                                                      tmp_path):
    """The configuration asks for the peel's CUDA graph (`peel_graph`),
    and the poly table engine builds its exact peel with it; on the CPU
    the peel then runs as it is."""
    import skirt_tpu_torch as port
    from skirt_tpu_torch.engine import fused_table

    built = []
    make = fused_table.make_exact_peel

    def spy(*a, **kw):
        built.append(kw.get("graph"))
        return make(*a, **kw)

    monkeypatch.setattr(fused_table, "make_exact_peel", spy)
    cell, cfg = cells.load(CELL, shrink())
    assert cfg["engine"]["peel_graph"] is True
    sim, _ = program.build(cell, cfg, port, torch.device("cpu"),
                           str(tmp_path))
    program.run_once(sim, program.call_seed(SEED, 0))
    assert built == [True]


def test_reference_without_dust_gives_every_packet_to_each_sed():
    cell, cfg = cells.load(CELL, shrink())
    cfg["dust"]["tau_v"] = 0.0
    out = ref_torus.simulate(cfg, [0, 3], 4096, SEED, "cpu")
    for sed in out["sed"]:
        assert sed == pytest.approx([cfg["luminosity_W"]] * 2, rel=1e-6)
    assert not out["labs"].any()
    assert out["centers"].shape == (8 ** 3, 3) and out["frame"] == [None] * 3


def test_reference_column_is_exact_on_the_voxel_field():
    """The reference's voxel walk against the column summed by hand
    along each axis, and against a fine midpoint sum along a generic
    direction."""
    _, cfg = cells.load(CELL, {"config": {"grid": {"max_level": 4}}})
    m = ref_torus.Model(cfg)
    kr = torch.as_tensor(m.kr, dtype=torch.float64)
    p = torch.tensor([[0.3, -1.1, 0.2]], dtype=torch.float64)
    k = (0.48, -0.6, 0.64)
    got = ref_torus._columns(m, kr, p[:, 0], p[:, 1], p[:, 2],
                             [(1.0, 0.0, 0.0), (0.0, 0.0, 1.0), k])[:, 0]
    cube = m.kr.reshape(m.n, m.n, m.n)
    i, j, l = (np.floor((p[0].numpy() + m.h) / m.dx)).astype(int)
    lo = -m.h + np.array([i, j, l]) * m.dx
    along_x = cube[i, j, l] * (lo[0] + m.dx - 0.3) + cube[i + 1:, j, l].sum() \
        * m.dx
    along_z = cube[i, j, l] * (lo[2] + m.dx - 0.2) + cube[i, j, l + 1:].sum() \
        * m.dx
    t_exit = min((m.h - 0.3) / k[0], (m.h - 1.1) / 0.6, (m.h - 0.2) / k[2])
    ts = (np.arange(400000) + 0.5) * t_exit / 400000
    pts = p[0].numpy() + ts[:, None] * np.array(k)
    ids = np.clip(np.floor((pts + m.h) / m.dx).astype(int), 0, m.n - 1)
    fine = cube[ids[:, 0], ids[:, 1], ids[:, 2]].sum() * t_exit / 400000
    assert got[0] == pytest.approx(along_x, rel=1e-12)
    assert got[1] == pytest.approx(along_z, rel=1e-12)
    assert got[2] == pytest.approx(fine, rel=1e-4)


# -- the model at the cell's own level -------------------------------------

@pytest.fixture(scope="module")
def level6():
    """The cell's model as the builder makes it (octree levels 2-6), its
    exact voxel view in table mode, and the reference's model."""
    import skirt_tpu_torch as port

    cell, cfg = cells.load(CELL)
    model, _ = program.builder(cfg["builder"]).build(cfg, port, True, 2)
    vds, _ = model["dust_system"].voxelized()
    return cfg, model, vds.as_table(), ref_torus.Model(cfg)


def test_no_leaf_straddles_a_labs_block(level6):
    cfg, model, _, _ = level6
    grid = model["grid"]
    from skirt_tpu_torch.constants import KPC

    spec = cfg["labs_blocks"]
    counts = np.array(spec["counts"])
    lo, hi = np.array(spec["lo_kpc"]), np.array(spec["hi_kpc"])
    leaf_lo = grid.lo64[grid.leaf_nodes] / KPC
    leaf_hi = grid.hi64[grid.leaf_nodes] / KPC
    size = (hi - lo) / counts
    first = np.floor((leaf_lo - lo) / size + 1e-9)
    last = np.ceil((leaf_hi - lo) / size - 1e-9) - 1
    assert grid.ncells > 60000 and np.all(first == last)
    # every leaf centre falls in the block that holds the whole leaf
    blocks = check.labs_blocks(np.ones((grid.ncells, 1)),
                               grid.cell_centers() / KPC, spec)
    assert blocks is not None and blocks.sum() == grid.ncells


def test_field_difference_between_program_and_reference(level6):
    """The mass-weighted |delta kappa rho| / kappa rho over the 64^3
    voxels, the program's (leaf centres, repeated over each leaf's
    voxels) against the reference's (voxel centres): 9.33e-4, all of it
    in leaves coarser than a voxel at the torus's edge, which the
    refinement's 100 samples a node found empty.  Far under labs_gap's
    limit."""
    from skirt_tpu_torch.constants import PC

    cfg, _, tds, m = level6
    prog = tds.rho64[0] * tds.kappaext[0][0] * PC       # per pc at 0.55 um
    gap = np.abs(prog - m.kr).sum() / m.kr.sum()
    assert gap == pytest.approx(9.3296e-4, rel=1e-3)
    assert gap < 0.1 * cells.load(CELL)[0]["limits"]["labs_gap"]


def test_optical_depth_along_x_from_the_source(level6):
    """Along +x from the origin at 0.55 um the program's exact peel
    (leaders along x, and edge-on at azimuth 0 with its 6e-17 z
    component) gives the reference's voxel column: 46.879, 0.917 of
    tau_V, short of it by the voxel centres' distance from the equator
    and the two edge voxels; the "x" axis (the full one) would give
    half."""
    from skirt_tpu_torch.engine.fused_table import make_exact_peel

    cfg, _, tds, m = level6
    peel = make_exact_peel(tds.grid, tds, [(1.0, 0.0, 0.0),
                                           (1.0, 0.0, 6.123233995736766e-17)])
    taus = peel(torch.zeros((1, 3)),
                [torch.tensor([float(tds.kappaext[0][0])])])
    n = m.n
    column = m.kr.reshape(n, n, n)[n // 2:, n // 2, n // 2].sum() * m.dx
    for t in taus:
        assert float(t[0]) == pytest.approx(column, rel=1e-5)
    assert column == pytest.approx(46.879, rel=1e-4)
    assert 0.9 < column / cfg["dust"]["tau_v"] < 1.0


# -- the three readings on a synthetic trace -------------------------------

def _hand_counted_peel():
    """One lane on a 4 x 4 x 4 grid of unit voxels toward three leaders:
    along +x from (0.5, 1.5, 2.5) 4 voxels, along +z from (0.5, 1.5,
    2.5) 2, along (0.6, 0.8, 0) from (0.5, 0.25, 0.5) 7 (x walls at t =
    0.833, 2.5, 4.167, y walls at 0.9375, 2.1875, 3.4375, out through
    y = 4 at 4.6875): the port's counters after the peel."""
    from types import SimpleNamespace

    from skirt_tpu_torch import trace
    from skirt_tpu_torch.engine.fused_table import make_exact_peel
    from skirt_tpu_torch.grids import CartesianGrid

    e = np.arange(5.0)
    grid = CartesianGrid(e, e, e)
    ds = SimpleNamespace(ncomp=1, rho=np.ones((1, 64)))
    trace.enable(False)
    trace.take()
    trace.enable(True)
    try:
        for start, k in (((0.5, 1.5, 2.5), (1.0, 0.0, 0.0)),
                         ((0.5, 1.5, 2.5), (0.0, 0.0, 1.0)),
                         ((0.5, 0.25, 0.5), (0.6, 0.8, 0.0))):
            make_exact_peel(grid, ds, [k])(torch.tensor([start]),
                                           [torch.ones(1)])
    finally:
        trace.enable(False)
    return trace.take()["counters"]


def _peel_trace(counters):
    """A spans phase with one event launch and one 1 ms device operation
    launched inside `exact_peel`, another of 2 ms inside `stage_gather`."""
    ms = 1_000_000
    return Trace(spans=SpanTrace(
        ops=[("elementwise", 40, 40 + ms, 1), ("gather", 50, 50 + 2 * ms, 2)],
        calls={1: 15, 2: 25},
        spans=[("run", 0, 100, -1), ("exact_peel", 10, 20, 0),
               ("stage_gather", 22, 30, 0)],
        counters=counters, launches=1))


def test_roofline_count_on_a_hand_counted_ray():
    from rtbench import roofline

    c = _hand_counted_peel()
    assert (c["peel_rays"], c["peel_voxels"]) == (3, 4 + 2 + 7)
    least = roofline.exact_peel_bytes(c["peel_rays"], c["peel_voxels"])
    assert least == 4 * 13 + 16 * 3
    tr = _peel_trace(c)
    assert cells.metric_reader("exact_peel_roofline")(tr) == pytest.approx(
        100.0 * 100 / 3.35e12 / 1e-3)
    assert cells.metric_reader("exact_peel_ms_per_iter")(tr) == \
        pytest.approx(1.0)
    assert cells.metric_reader("stage_gather_ms_per_iter")(tr) == \
        pytest.approx(2.0)
    assert spans.device_ns_by_span(tr.spans)[0] == ("stage_gather", 2_000_000)


@pytest.mark.parametrize("name", ["exact_peel_ms_per_iter",
                                  "stage_gather_ms_per_iter",
                                  "exact_peel_roofline"])
def test_new_readings_read_nothing_where_nothing_is_there(name):
    """An empty trace, and a port without the peel counters (the parent
    of the counters: its spans are there, its counters lack them)."""
    read = cells.metric_reader(name)
    assert read(Trace()) is None
    old = _peel_trace({"lane_slots": 0, "live_lanes": 0})
    if name == "exact_peel_roofline":
        assert read(old) is None
    else:
        assert read(old) is not None


# -- on the card, at the cell's own size ------------------------------------

CARD_SEED = 2_718_281_828


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_port_matches_reference_on_the_card():
    _card()
    out = run.drive(CELL, CARD_SEED, 0, False, device="cuda",
                    log=lambda msg: None)
    assert out["correct"], out["checks"]
    json.dumps(out)


@pytest.mark.gpu
def test_bfloat16_control_fails_on_the_card():
    _card()
    from rtbench.control import readings

    cell, _ = cells.load(CELL)
    rows = readings(CELL, [CARD_SEED], False, True, device="cuda",
                    emit=lambda line: None)
    found = {k: v for k, v in rows[0].items() if k.endswith("_gap")}
    assert not check.judge(found, cell["limits"])[0]
