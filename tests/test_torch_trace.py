"""The port's spans and counters (skirt_tpu_torch/trace.py).

On the CPU: with tracing off a span is the shared null context and
nothing is recorded; on a small OligoSimulation (poly and mono lanes)
every span the run opens appears and nests as the stages do; the plain
events' live-lane count equals a count taken by hand from the lanes'
state; a run's tallies are bit-identical with tracing on and off.  On
the card (`gpu`, skipped without one): K1's and K3's live-lane counter
equals the plain count on the same inputs, their outputs stay
bit-identical with the counter set, and the spans and a CUDA-only
profile share a clock (a synchronized sleep kernel, and the runtime call
that launched it, fall inside their span).

This file imports no JAX, so it also runs on a GPU machine without it:

    python3 -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_trace.py
"""

import numpy as np
import pytest
import torch

from skirt_tpu_torch import rng, trace
from skirt_tpu_torch.engine import fused as tfm
from skirt_tpu_torch.engine import fused_poly as tfp

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def tracing_off():
    """Each test starts and ends with tracing off and nothing recorded."""
    trace.enable(False)
    trace.take()
    yield
    trace.enable(False)
    trace.take()


# the drivers a small OligoSimulation reaches: (poly lanes, table engine)
ENGINES = {"poly": (True, False), "mono": (False, False),
           "K6": (True, True), "K4": (False, True)}


def _simulation(tmp_path, engine, seed=11):
    import dataclasses

    from bench_torch import _model, _octree_model
    from skirt_tpu_torch.engine.simulation import OligoSimulation
    from skirt_tpu_torch.log import SilentLog

    poly, table = ENGINES[engine]
    if table:
        # the octree torus through its exact voxel view (K6 or K4, the
        # exact peel), as OligoSimulation(voxelize="table") builds it
        _, ds, ss, ins, opts, _ = _octree_model(
            nlambda=4, polychromatic=poly, refill_batches=4, max_level=3,
            quadrature_panels=8, peel_panels=8, voxelize=False)
        opts = dataclasses.replace(opts, max_scatt_events=16)
    else:
        _, ds, ss, ins, opts = _model(
            nlambda=4, ncells=8, refill_batches=4, quadrature_panels=8,
            peel_panels=4, max_scatt=16, polychromatic=poly)
    # 3 batches of 256 poly lanes (1,024 mono lanes), K = 4: one grouped
    # dispatch of 2, then a ragged batch of half the lanes alone
    return OligoSimulation(
        stellar_system=ss, instruments=ins, dust_system=ds, options=opts,
        packets=2560, seed=seed, batch_size=1 << 10,
        dispatch_batches=2, log=SilentLog(), out_dir=str(tmp_path),
        device="cpu")


def test_span_is_the_shared_null_context_while_off():
    assert not trace.enabled()
    assert trace.span("run") is trace.span("event") is trace._NULL
    with trace.span("run"):
        with trace.span("no_such_span"):    # not checked while off
            pass
    trace.count_slots(128)
    assert trace.live_counter("cpu") is None
    trace.count_sed_peels(10, 0)
    assert trace.take() == {"spans": [],
                            "counters": {"lane_slots": 0, "live_lanes": 0,
                                         "peel_rays": 0, "peel_voxels": 0,
                                         "sed_peels_kernel": 0,
                                         "sed_peels_plain": 0}}


def test_span_records_nesting_while_on():
    trace.enable(True)
    with trace.span("run"):
        with trace.span("dispatch"):
            with trace.span("event"):
                pass
        with trace.span("write"):
            pass
    with pytest.raises(ValueError):
        trace.span("no_such_span")
    got = trace.take()["spans"]
    assert [(s[0], s[3]) for s in got] == [("run", -1), ("dispatch", 0),
                                          ("event", 1), ("write", 0)]
    for name, start, end, parent in got:
        assert start <= end
        if parent >= 0:
            assert got[parent][1] <= start and end <= got[parent][2]
    assert trace.take()["spans"] == []


def test_take_refuses_an_open_span():
    trace.enable(True)
    with trace.span("run"):
        with pytest.raises(RuntimeError):
            trace.take()


def test_live_slots_match_the_kernels():
    """The counters trace.py allocates are the slots the kernels add to."""
    import re

    from skirt_tpu_torch import kernels

    src = (kernels.CSRC / "common.cuh").read_text()
    for name in ("LIVE_SLOTS", "LIVE_STRIDE"):
        assert int(re.search(r"constexpr int %s = (\d+);" % name,
                             src).group(1)) == getattr(trace, name)
    trace.enable(True)
    assert tuple(trace.live_counter("cpu").shape) == (
        trace.LIVE_SLOTS * trace.LIVE_STRIDE,)


def _ancestors(spans, i):
    out = []
    i = spans[i][3]
    while i >= 0:
        out.append(spans[i][0])
        i = spans[i][3]
    return out


@pytest.mark.parametrize("engine", list(ENGINES))
def test_simulation_spans_nest_as_the_stages(tmp_path, engine):
    poly, table = ENGINES[engine]
    sim = _simulation(tmp_path, engine)
    assert sim._poly is poly
    trace.enable(True)
    sim.run()
    trace.enable(False)
    got = trace.take()
    spans = got["spans"]
    names = {s[0] for s in spans}
    assert names == {"run", "dispatch", "drain", "write", "launch", "check",
                     "event", "peel", "detect"} | (
                         {"stage_gather", "exact_peel"} if table else set())
    assert sum(s[0] == "run" for s in spans) == 1
    assert sum(s[0] == "dispatch" for s in spans) == 2    # 2 + 1 batches
    # one launch a batch, and the table drivers' relaunch each event
    events = sum(s[0] == "event" for s in spans)
    assert sum(s[0] == "launch" for s in spans) == 3 + (events if table
                                                        else 0)
    for i, (name, start, end, parent) in enumerate(spans):
        up = _ancestors(spans, i)
        assert start <= end
        if parent >= 0:
            assert spans[parent][1] <= start and end <= spans[parent][2]
        if name == "run":
            assert up == []
        elif name in ("dispatch", "drain", "write"):
            assert up == ["run"], (name, up)
        elif name in ("launch", "check", "event", "peel"):
            assert up == ["dispatch", "run"], (name, up)
        elif name in ("detect", "exact_peel"):
            assert up[0] in ("peel", "launch") and up[1:] == [
                "dispatch", "run"], up
        elif name == "stage_gather":
            assert up == ["event", "dispatch", "run"], up
    # every event launch counted its lanes (the first dispatch's full
    # batches, then the ragged one), live ones among them
    first = [i for i, s in enumerate(spans) if s[0] == "dispatch"][0]
    full = sum(s[0] == "event" and s[3] == first for s in spans)
    ragged = sum(s[0] == "event" for s in spans) - full
    lanes = 256 if poly else 1024
    c = got["counters"]
    assert c["lane_slots"] == lanes * full + lanes // 2 * ragged
    assert 0 < c["live_lanes"] <= c["lane_slots"]


@pytest.mark.parametrize("engine", list(ENGINES))
def test_tallies_bit_identical_with_tracing_on_and_off(tmp_path, engine):
    off = _simulation(tmp_path / "off", engine).run()
    trace.enable(True)
    on = _simulation(tmp_path / "on", engine).run()
    trace.enable(False)
    assert trace.take()["counters"]["live_lanes"] > 0
    for a, b in zip(off["instruments"], on["instruments"]):
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    assert np.array_equal(off["labs"], on["labs"])


@pytest.mark.parametrize("case", ["refill", "no-refill", "iter_cap"])
def test_event_loop_reads_its_stop_test_every_16_iterations(case):
    """engine/common.events, the four drivers' loop: the host reads the
    stop test in a `check` span at iterations 0, 16, 32, ...; the loop
    ends at the first check that finds no lane alive and (with refill) no
    lane with launches left under K, or after iter_cap iterations."""
    from skirt_tpu_torch.engine import common

    refill = case == "refill"
    cap = 40 if case == "iter_cap" else 1000
    p = common.Plan(npanels=8, np_peel=8, want_labs=False, leaders=[],
                    lead_of=[], refill=refill, K=3, iter_cap=cap,
                    count_events=False)
    alive = torch.ones(4, dtype=torch.int32)
    bc = torch.ones(4, dtype=torch.int32)
    seen, checks = [], []

    def lanes():
        checks.append(len(seen))
        return alive, bc

    trace.enable(True)
    for it in common.events(p, lanes):
        seen.append(it)
        if it == 37 and case != "iter_cap":
            alive[:] = 0                  # every lane dies in iteration 37
        if it == 50:
            bc[:] = 3                     # the last launch budget is spent
    trace.enable(False)
    spans = trace.take()["spans"]
    # no lane alive at 48; with refill budget is left until iteration 50
    last = {"refill": 64, "no-refill": 48, "iter_cap": 40}[case]
    assert seen == list(range(last))
    assert checks == list(range(0, last if case == "iter_cap" else last + 1,
                                16))
    assert [s[0] for s in spans] == ["check"] * len(checks)


def _poly_case(device, refill=True, n=1000, panels=8):
    from bench_torch import _build
    from skirt_tpu_torch.testing import event_case

    run, *_ = _build(nlambda=6, ncells=8, packets=256,
                     quadrature_panels=panels, peel_panels=4,
                     refill_batches=4 if refill else 0, device=device)
    return event_case(run.spec, n, 5, device)


def _mono_case(device, refill=True, n=1000, panels=8):
    from bench_torch import _build
    from skirt_tpu_torch.testing import mono_event_case

    run, *_ = _build(nlambda=6, ncells=8, packets=256,
                     quadrature_panels=panels, peel_panels=4,
                     refill_batches=4 if refill else 0,
                     polychromatic=False, device=device)
    return mono_event_case(run.spec, n, 5, device)


def _by_hand(alive_in, out):
    """Lanes alive on entry, plus those the event relaunched."""
    alive_in = alive_in.cpu().numpy() != 0
    fresh = (out["fresh"].cpu().numpy() != 0 if "fresh" in out
             else np.zeros_like(alive_in))
    return int(np.count_nonzero(alive_in | fresh))


@pytest.mark.parametrize("refill", [True, False], ids=["refill", "no-refill"])
@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_plain_live_lane_count_equals_a_count_by_hand(kernel, refill):
    trace.enable(True)
    if kernel == "K1":
        spec, u, oc, L, l0, state = _poly_case("cpu", refill)
        out = tfp.poly_event(spec, u, oc, L, l0, state)
        alive_in = state[6]
    else:
        spec, u, state = _mono_case("cpu", refill)
        out = tfm.mono_event(spec, u, state)
        alive_in = state[7]
    trace.enable(False)
    c = trace.take()["counters"]
    want = _by_hand(alive_in, out)
    assert c == {"lane_slots": alive_in.shape[0], "live_lanes": want,
                 "peel_rays": 0, "peel_voxels": 0, "sed_peels_kernel": 0,
                 "sed_peels_plain": 0}
    # some lanes were dead on entry; with refill some were relaunched
    assert want > int((alive_in != 0).sum()) if refill else \
        want < alive_in.shape[0]


# -- the exact peel's counters ---------------------------------------------

# observer directions: two zero components (face-on; edge-on at azimuth 0,
# whose z component is cos(pi/2) = 6.1e-17; along -y), one (azimuth 0) and
# none
PEEL_LEADERS = [(0.0, 0.0, 1.0), (1.0, 0.0, 6.123233995736766e-17),
                (0.0, -1.0, 0.0), (0.644217687237691, 0.0, 0.764842187284489),
                tuple(np.array([0.3, -0.5, 0.8]) / np.sqrt(0.98))]


def _voxel_field(H, n=60, seed=3):
    """A 6 x 5 x 7 uniform voxel grid with unequal voxel sizes per axis,
    H random density fields on it, and n points inside it (float32
    values, as the lanes hold them)."""
    from types import SimpleNamespace

    from skirt_tpu_torch.grids import CartesianGrid

    rs = np.random.default_rng(seed)
    edges = [np.linspace(-3.0, 3.0, 7), np.linspace(-2.0, 3.0, 6),
             np.linspace(-1.0, 2.5, 8)]
    grid = CartesianGrid(*edges)
    ds = SimpleNamespace(ncomp=H, rho=rs.random((H, 6 * 5 * 7)))
    lo = np.array([e[0] for e in edges])
    hi = np.array([e[-1] for e in edges])
    pos = (lo + rs.random((n, 3)) * (hi - lo)).astype(np.float32)
    return grid, ds, edges, pos.astype(np.float64)


def _overlaps_by_hand(edges, pos, k):
    """The voxels each ray from `pos` along k crosses with a positive
    length before it leaves the box, counted voxel by voxel in float64
    (slab tests)."""
    k = np.asarray(k, np.float64)
    lo = np.array([e[0] for e in edges])
    hi = np.array([e[-1] for e in edges])
    total = 0
    for p in pos:
        t_exit = min((hi[a] - p[a]) / k[a] if k[a] > 0 else
                     (lo[a] - p[a]) / k[a] for a in range(3) if k[a] != 0)
        for i in range(len(edges[0]) - 1):
            for j in range(len(edges[1]) - 1):
                for m in range(len(edges[2]) - 1):
                    t0, t1 = 0.0, t_exit
                    for a, c in enumerate((i, j, m)):
                        e0, e1 = edges[a][c], edges[a][c + 1]
                        if k[a] == 0:
                            if not e0 <= p[a] < e1:
                                t1 = -1.0
                            continue
                        u, v = (e0 - p[a]) / k[a], (e1 - p[a]) / k[a]
                        t0, t1 = max(t0, min(u, v)), min(t1, max(u, v))
                    total += t1 > t0
    return total


def _peel(grid, ds, leaders, pos, live=None):
    from skirt_tpu_torch.engine.fused_table import make_exact_peel

    peel = make_exact_peel(grid, ds, leaders)
    p = torch.as_tensor(pos, dtype=torch.float32)
    ones = [torch.ones(p.shape[0]) for _ in range(ds.ncomp)]
    return peel(p, ones, live)


def _peel_counters(grid, ds, leaders, pos, live=None):
    trace.enable(True)
    _peel(grid, ds, leaders, pos, live)
    trace.enable(False)
    return trace.take()["counters"]


@pytest.mark.parametrize("chunk", [1 << 26, 1 << 9], ids=["one-chunk",
                                                         "chunks"])
@pytest.mark.parametrize("H", [1, 2])
def test_peel_counters_equal_a_count_by_hand(H, chunk, monkeypatch):
    """peel_rays is the live lanes x leaders; peel_voxels is H x the
    voxels each live lane's ray crosses with a positive length, counted
    voxel by voxel in float64, along leaders with two, one and no zero
    components; the peel's chunks change nothing, dead lanes count
    nothing, and all leaders in one peel count as each alone."""
    from skirt_tpu_torch.engine import fused_table

    monkeypatch.setattr(fused_table, "_PEEL_CHUNK_FLOATS", chunk)
    grid, ds, edges, pos = _voxel_field(H)
    voxels = [_overlaps_by_hand(edges, pos, k) for k in PEEL_LEADERS]
    got = [_peel_counters(grid, ds, [k], pos) for k in PEEL_LEADERS]
    assert [(c["peel_rays"], c["peel_voxels"]) for c in got] == \
        [(len(pos), H * v) for v in voxels]
    # a leader along an axis crosses the voxels of one column from the
    # point's own to the wall: 7 - iz along +z, iy + 1 along -y
    iy = np.searchsorted(edges[1], pos[:, 1], side="right") - 1
    iz = np.searchsorted(edges[2], pos[:, 2], side="right") - 1
    assert voxels[0] == (7 - iz).sum() and voxels[2] == (iy + 1).sum()
    live = np.arange(len(pos)) % 3 != 1
    c = _peel_counters(grid, ds, PEEL_LEADERS, pos, torch.as_tensor(live))
    assert c["peel_rays"] == live.sum() * len(PEEL_LEADERS)
    assert c["peel_voxels"] == H * sum(_overlaps_by_hand(edges, pos[live], k)
                                       for k in PEEL_LEADERS)
    c = _peel_counters(grid, ds, PEEL_LEADERS, pos)
    assert c["peel_voxels"] == sum(b["peel_voxels"] for b in got)


def test_peel_counters_are_zero_and_allocate_nothing_while_off():
    grid, ds, _, pos = _voxel_field(1)
    _peel(grid, ds, PEEL_LEADERS, pos)
    trace.count_peel(torch.ones(2, dtype=torch.int64))
    assert trace._peel == {}
    c = trace.take()["counters"]
    assert c["peel_rays"] == 0 and c["peel_voxels"] == 0


def test_exact_peel_launches_the_same_operations_with_the_counters_off(
        monkeypatch):
    """The operations of the peel with tracing off are those with it on
    less the counting (the work count and the counter's add, once a pass
    and before the peel's own), and the optical depths are the same
    bits."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from skirt_tpu_torch.engine import fused_table

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    rec = Record()
    work, count = fused_table.exact_peel_work, trace.count_peel

    def marked_work(*a):
        rec.ops.append("<count")
        return work(*a)

    def marked_count(*a):
        count(*a)
        rec.ops.append("count>")

    monkeypatch.setattr(fused_table, "exact_peel_work", marked_work)
    monkeypatch.setattr(trace, "count_peel", marked_count)
    grid, ds, _, pos = _voxel_field(2)
    _peel(grid, ds, PEEL_LEADERS, pos)      # the grid's box to the device
    with rec:
        off = _peel(grid, ds, PEEL_LEADERS, pos)
    ops_off, rec.ops = rec.ops, []
    trace.enable(True)
    with rec:
        on = _peel(grid, ds, PEEL_LEADERS, pos)
    trace.enable(False)
    ops_on = rec.ops
    assert ops_on.count("<count") == ops_on.count("count>") == 1
    assert "<count" not in ops_off
    i, j = ops_on.index("<count"), ops_on.index("count>")
    assert ops_on[:i] + ops_on[j + 1:] == ops_off
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_exact_peel_copies_nothing_to_the_device_after_its_first_pass(
        monkeypatch):
    """A leader's direction and the grid's box (ray_span) go to a device
    once: a later pass makes no tensor from host data (on a card each
    such copy waits for the device)."""
    from skirt_tpu_torch.engine import fused_table
    from skirt_tpu_torch.grids import cartesian

    grid, ds, _, pos = _voxel_field(1)
    peel = fused_table.make_exact_peel(grid, ds, PEEL_LEADERS)
    p = torch.as_tensor(pos, dtype=torch.float32)
    first = peel(p, [torch.ones(len(p))])

    def refused(*a, **kw):
        raise AssertionError("a tensor made from host data")

    for mod in (fused_table, cartesian):
        monkeypatch.setattr(mod.torch, "tensor", refused)
        monkeypatch.setattr(mod.torch, "as_tensor", refused)
    again = peel(p, [torch.ones(len(p))])
    t0, t1 = grid.ray_span(p, p / p.norm(dim=1, keepdim=True))
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert (t1 >= t0).all()


def test_exact_peel_graph_option_changes_nothing_on_the_cpu():
    """`graph` asks for a CUDA graph on a card only: on the CPU the peel
    launches the same operations, pass after pass, and gives the same
    bits as without it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from skirt_tpu_torch.engine import fused_table

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    runs = {}
    for graph in (False, True):
        grid, ds, _, pos = _voxel_field(2)      # a grid of its own each
        p = torch.as_tensor(pos, dtype=torch.float32)
        ones = [torch.ones(len(p)), torch.ones(len(p))]
        peel = fused_table.make_exact_peel(grid, ds, PEEL_LEADERS,
                                           graph=graph)
        passes = []
        for _ in range(3):
            rec = Record()
            with rec:
                out = peel(p, ones) + peel.integrals(p)
            passes.append((rec.ops, out))
        runs[graph] = passes
    for (ops_off, off), (ops_on, on) in zip(runs[False], runs[True]):
        assert ops_on == ops_off
        for a, b in zip(on, off):
            assert torch.equal(a, b)


@pytest.mark.parametrize("poly", [True, False], ids=["K6", "K4"])
def test_table_driver_live_lane_count_equals_a_count_by_hand(poly,
                                                             monkeypatch):
    """The table drivers relaunch lanes on the torch side, so the lanes
    that did an event are those alive on entry to the kernel: counted by
    hand around each event call, with the lanes the calls were made
    over.  The exact peel counts only its live lanes meanwhile."""
    from bench_torch import _octree_model

    from skirt_tpu_torch.engine import fused_table as tft
    from skirt_tpu_torch.engine import fused_table_poly as tftp
    from skirt_tpu_torch.engine.lifecycle import make_lifecycle

    W = 2
    grid, ds, ss, ins, opts, _ = _octree_model(
        nlambda=W, polychromatic=poly, refill_batches=4, max_level=3,
        quadrature_panels=8, peel_panels=8)
    run = make_lifecycle(grid, ds, ss, ins, opts, W)
    mod, name = (tftp, "table_poly_event") if poly else (tft, "table_event")
    event = getattr(mod, name)
    seen = {"slots": 0, "live": 0}

    def by_hand(spec, u, *rest):
        state = rest[-1]
        alive = state[6] if poly else state[7]
        seen["slots"] += alive.shape[0]
        seen["live"] += int((alive != 0).sum())
        return event(spec, u, *rest)

    monkeypatch.setattr(mod, name, by_hand)
    n = 512
    tallies = {"instruments": [i.zero_tallies("cpu") for i in ins],
               "labs": torch.zeros(grid.ncells * W)}
    trace.enable(True)
    if poly:
        run(rng.root_key(5), torch.zeros(n, dtype=torch.int32),
            torch.full((n, W), 1e30), tallies)
    else:
        run(rng.root_key(5), torch.arange(n, dtype=torch.int32) % W,
            torch.full((n,), 1e30), tallies)
    trace.enable(False)
    c = trace.take()["counters"]
    assert c["lane_slots"] == seen["slots"] > 0
    assert c["live_lanes"] == seen["live"]
    assert 0 < c["live_lanes"] < c["lane_slots"]
    assert 0 < c["peel_rays"] and c["peel_voxels"] > c["peel_rays"]


# -- on the card ----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _event(kernel, refill, n, panels):
    if kernel == "K1":
        spec, u, oc, L, l0, state = _poly_case("cuda", refill, n, panels)
        return (lambda: tfp.poly_event(spec, u, oc, L, l0, state),
                lambda: tfp.poly_event_plain(spec, u, oc, L, l0, state))
    spec, u, state = _mono_case("cuda", refill, n, panels)
    return (lambda: tfm.mono_event(spec, u, state),
            lambda: tfm.mono_event_plain(spec, u, state))


@pytest.mark.gpu
@pytest.mark.parametrize("panels", [8, 40], ids=["one-pass", "chunked"])
@pytest.mark.parametrize("refill", [True, False], ids=["refill", "no-refill"])
@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_kernel_live_lane_counter_equals_the_plain_count(kernel, refill,
                                                         panels):
    """On a lane count that leaves the last block part empty, on each
    kernel's one-pass and chunked routes (past 32 panels); the outputs
    with the counter set equal those without it, and the plain ones."""
    _card()
    cuda, plain = _event(kernel, refill, 4096 + 17, panels)
    off = cuda()
    trace.enable(True)
    on = cuda()
    trace.enable(False)
    got = trace.take()["counters"]
    trace.enable(True)
    want = plain()
    trace.enable(False)
    ref = trace.take()["counters"]
    assert got["live_lanes"] == ref["live_lanes"] > 0
    for out in (on, want):
        assert sorted(out) == sorted(off)
        for a, b in zip(out["state"], off["state"]):
            assert torch.equal(a, b)
        for k in off:
            if k != "state":
                assert torch.equal(out[k], off[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("H", [1, 2])
def test_exact_peel_graph_replays_equal_its_passes_as_they_are(H):
    """On the card `graph` is accepted and ignored: pass after pass on
    other points and opacities, the depths and integrals of a peel built
    with it equal those of one built without to the bit, along leaders
    with two, one and no zero components; a result handed out stays as it
    was through later passes, and a pass dispatches the same operations
    with the option as without: csrc/exact_peel.cu's one launch, with no
    copy of its inputs or output around it."""
    _card()
    from skirt_tpu_torch.engine import fused_table

    grid, ds, _, _ = _voxel_field(H)
    dev = torch.device("cuda")
    plain = fused_table.make_exact_peel(grid, ds, PEEL_LEADERS)
    graphed = fused_table.make_exact_peel(grid, ds, PEEL_LEADERS, graph=True)
    held = []
    for seed in range(5):
        _, _, _, pos = _voxel_field(H, n=3000, seed=10 + seed)
        p = torch.as_tensor(pos, dtype=torch.float32, device=dev)
        g = torch.Generator().manual_seed(seed)
        ks = [torch.rand(len(p), generator=g).to(dev) for _ in range(H)]
        want = plain(p, ks) + plain.integrals(p)
        got = graphed(p, ks) + graphed.integrals(p)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        held.append(([x.clone() for x in got], got))
    for kept, got in held:
        for a, b in zip(got, kept):
            assert torch.equal(a, b)
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func).split(".")[1])
            return func(*args, **(kwargs or {}))

    recs = []
    for peel in (graphed, plain):
        rec = Record()
        with rec:
            peel(p, ks)
            peel.integrals(p)
        recs.append(rec.ops)
    assert recs[0] == recs[1]
    assert not {"copy_", "clone"} & set(recs[0]), recs[0]


@pytest.mark.gpu
def test_span_encloses_a_synchronized_sleep_kernel():
    """The spans and the profiler share a clock.  Around each of three
    synchronized ~1 ms sleep kernels (after a warm-up inside the profile:
    a profile's first launch waits on CUPTI's buffers), the runtime call
    that launched the kernel, which credit() reads, lies inside the span
    within 50 us of its start.  The kernel's own device stamps, which
    CUPTI maps onto the host clock with a skew of its own (up to 0.16 ms
    seen on an H100 80GB HBM3, torch 2.11: PERF.md), overlap the span
    for at least half the kernel."""
    _card()
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
        trace.enable(True)
        for _ in range(3):
            with trace.span("event"):
                torch.cuda._sleep(2_000_000)
                torch.cuda.synchronize()
        trace.enable(False)
    spans = trace.take()["spans"]
    calls, kernels = {}, {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            kernels[e.correlation_id()] = (e.start_ns(),
                                           e.start_ns() + e.duration_ns())
        elif "LaunchKernel" in e.name():
            calls[e.correlation_id()] = e.start_ns()
    assert len(spans) == 3 and len(kernels) == 6
    for _, start, end, _ in spans:
        (corr, t), = [(c, t) for c, t in calls.items() if start <= t <= end]
        assert t - start < 50_000
        ks, ke = kernels[corr]
        assert min(ke, end) - max(ks, start) > (ke - ks) / 2, (
            ks - start, end - ke)
