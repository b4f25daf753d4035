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

from skirt_tpu_torch import trace
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


def _simulation(tmp_path, poly, seed=11):
    from bench_torch import _model
    from skirt_tpu_torch.engine.simulation import OligoSimulation
    from skirt_tpu_torch.log import SilentLog

    grid, ds, ss, ins, opts = _model(
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
    assert trace.take() == {"spans": [],
                            "counters": {"lane_slots": 0, "live_lanes": 0}}


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


@pytest.mark.parametrize("poly", [True, False], ids=["poly", "mono"])
def test_simulation_spans_nest_as_the_stages(tmp_path, poly):
    sim = _simulation(tmp_path, poly)
    assert sim._poly is poly
    trace.enable(True)
    sim.run()
    trace.enable(False)
    got = trace.take()
    spans = got["spans"]
    names = {s[0] for s in spans}
    assert names == {"run", "dispatch", "drain", "write", "launch", "check",
                     "event", "peel", "detect"}
    assert sum(s[0] == "run" for s in spans) == 1
    assert sum(s[0] == "dispatch" for s in spans) == 2    # 2 + 1 batches
    assert sum(s[0] == "launch" for s in spans) == 3
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
        elif name == "detect":
            assert up[0] in ("peel", "launch") and up[1:] == [
                "dispatch", "run"], up
    # every event launch counted its lanes (the first dispatch's full
    # batches, then the ragged one), live ones among them
    first = [i for i, s in enumerate(spans) if s[0] == "dispatch"][0]
    full = sum(s[0] == "event" and s[3] == first for s in spans)
    ragged = sum(s[0] == "event" for s in spans) - full
    lanes = 256 if poly else 1024
    c = got["counters"]
    assert c["lane_slots"] == lanes * full + lanes // 2 * ragged
    assert 0 < c["live_lanes"] <= c["lane_slots"]


@pytest.mark.parametrize("poly", [True, False], ids=["poly", "mono"])
def test_tallies_bit_identical_with_tracing_on_and_off(tmp_path, poly):
    off = _simulation(tmp_path / "off", poly).run()
    trace.enable(True)
    on = _simulation(tmp_path / "on", poly).run()
    trace.enable(False)
    assert trace.take()["counters"]["live_lanes"] > 0
    for a, b in zip(off["instruments"], on["instruments"]):
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    assert np.array_equal(off["labs"], on["labs"])


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
    assert c == {"lane_slots": alive_in.shape[0], "live_lanes": want}
    # some lanes were dead on entry; with refill some were relaunched
    assert want > int((alive_in != 0).sum()) if refill else \
        want < alive_in.shape[0]


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
