"""CPU tests of rtbench/spans.py: the program's spans read against a
profile (python3 -m pytest rtbench -m "not gpu").

The readers and `idle_by_span` on a hand-built trace whose every number
is worked out below, and one phase of a tiny cell on the CPU, where the
port keeps its spans and counters but no device operation is recorded."""

import pytest
import torch

from rtbench import cells, program, spans
from rtbench.spans import SpanTrace
from rtbench.test_rtbench_cpu import SEED, shrink

MS = 1_000_000


def _trace():
    """run 0-100 ms: the dispatch 10-80 (event 10-30, peel 30-60 with a
    detect 40-50), the drain 80-90, the write 90-100.  Device operations
    (start, end) launched at: 12 (15-35, K1), 35 (36-44, in the peel), 45
    (46-60, in the detect), 82 (82-85, in the drain), and one with no
    runtime call recorded (86-87)."""
    sp = [("run", 0, 100, -1), ("dispatch", 10, 80, 0), ("event", 10, 30, 1),
          ("peel", 30, 60, 1), ("detect", 40, 50, 3), ("drain", 80, 90, 0),
          ("write", 90, 100, 0)]
    ops = [("void poly_event_kernel<1>(PolyArgs)", 15, 35, 1),
           ("void at::native::elementwise_kernel<...>", 36, 44, 2),
           ("void at::native::reduce_kernel<...>", 46, 60, 3),
           ("Memcpy DtoH (Device -> Pageable)", 82, 85, 4),
           ("Memset (Device)", 86, 87, 5)]
    return SpanTrace(
        ops=[(n, s * MS, e * MS, c) for n, s, e, c in ops],
        calls={1: 12 * MS, 2: 35 * MS, 3: 45 * MS, 4: 82 * MS},
        spans=[(n, s * MS, e * MS, p) for n, s, e, p in sp],
        counters={"lane_slots": 200, "live_lanes": 150}, launches=1,
        wall_s=0.100)


def test_credit_takes_the_innermost_span_at_the_runtime_call():
    st = _trace()
    assert [st.spans[k][0] if k >= 0 else None for k in spans.credit(st)] \
        == ["event", "peel", "detect", "drain", None]
    assert dict(spans.device_ns_by_span(st)) == {
        "event": 20 * MS, "peel": 8 * MS, "detect": 14 * MS,
        "drain": 3 * MS, "(none)": 1 * MS}


def test_idle_by_span_splits_each_gap_by_overlap():
    """The gap 0-15 ms spans the run's own time (0-10) and the event
    (10-15); 60-82 the dispatch (60-80) and the drain (80-82); 87-100 the
    drain (87-90) and the write (90-100)."""
    got = dict(spans.idle_by_span(_trace()))
    assert got == pytest.approx({"run": 0.010, "event": 0.005,
                                 "peel": 0.001, "detect": 0.002,
                                 "dispatch": 0.020, "drain": 0.006,
                                 "write": 0.010})
    assert sum(got.values()) == pytest.approx(0.100 - 0.046)


@pytest.mark.parametrize("name,value", [
    ("live_lane_share", 75.0),
    ("detect_ms_per_iter", 14.0),
    ("peel_ms_per_iter", 8.0),
    ("dispatch_idle_ms_per_run", 28.0),
    ("entry_idle_ms_per_run", 26.0),
])
def test_span_reader(name, value):
    assert getattr(spans, name)(_trace()) == pytest.approx(value)


@pytest.mark.parametrize("reader", spans.READERS, ids=lambda f: f.__name__)
def test_span_reader_reads_nothing_from_an_empty_trace(reader):
    assert reader(SpanTrace()) is None
    assert reader(None) is None


def test_summary_checks_completeness():
    out = spans.summary(_trace())
    assert out["credited_share"] == pytest.approx(45 / 46)
    assert out["busy_s"] == pytest.approx(0.046)
    assert (out["dispatch_idle_ms_per_run"]
            + out["entry_idle_ms_per_run"]) / 1e3 == pytest.approx(
                out["wall_minus_busy_s"])
    assert out["event_kernel_us"] == {"K1": pytest.approx(20_000.0)}


def test_device_lead_bounds_the_clock_skew():
    st = _trace()
    assert spans.device_lead_us(st) == 0
    st.calls[2] = 37 * MS          # its operation is stamped at 36 ms
    assert spans.device_lead_us(st) == pytest.approx(1000.0)


def test_a_port_without_tracing_gives_nothing():
    pkg = type("pkg", (), {"__name__": "no_such_package"})
    assert spans.profile_spans(pkg, lambda: None, cuda=False) is None


@pytest.mark.parametrize("workload", ["disc-poly128", "disc-mono128"])
def test_cpu_phase_reads_the_spans_and_counters(workload, tmp_path):
    """On the CPU the phase keeps the spans and the plain events' counts:
    the live-lane share reads; the device readings read nothing."""
    import skirt_tpu_torch as port

    torch.set_num_threads(2)
    cell, cfg = cells.load(workload, shrink(workload))
    sim, _ = program.build(cell, cfg, port, torch.device("cpu"),
                           str(tmp_path))
    st = spans.profile_spans(port, lambda: program.run_once(sim, SEED),
                             cuda=False)
    names = {s[0] for s in st.spans}
    assert {"run", "dispatch", "drain", "write", "launch", "event", "peel",
            "detect"} <= names
    share = spans.live_lane_share(st)
    assert 0 < share <= 100
    assert st.counters["lane_slots"] > 0
    for reader in spans.READERS[1:]:
        assert reader(st) is None
    assert not port.trace.enabled()
