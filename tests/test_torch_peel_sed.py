"""The polychromatic SED peel (ops/peel_sed.py, csrc/peel_sed.cu: PS).

On the CPU: `peel_sed_plain` equals the per-instrument loop it replaces
(engine/common.py::peel_poly before the SED peel, with
SEDInstrument._detect_poly) to the bit, on ten SEDs at SKIRTOR's leaders
with fresh and dead lanes, g near 0 and negative cosines, in both cosine
forms (the table driver's directions, K1's (L, N) rows); the wrapper
runs it on CPU tensors and launches nothing; it refuses a wrong dtype, a
non-contiguous tensor, a wrong shape or wavelengths other than 0 .. W - 1
before any launch; `peel_poly` leaves Frame, Simple and Full instruments,
the Mueller path and the multi-component blend to its loop, read from the
trace's sed_peels counters, and the drivers' runs count what each takes.
On the card (`gpu`, skipped without one): PS against the plain version
at torus-poly24's shapes (10 leaders, W = 24, 2^15 lanes) and
disc-poly128's SED (1, 128, 2^17), two launches to the same bits, and
one launch per scattering-peel iteration of the table poly driver.

This file imports no JAX, so it also runs on a GPU machine without it:

    python3 -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_peel_sed.py
"""

import numpy as np
import pytest
import torch

from skirt_tpu_torch import kernels, trace
from skirt_tpu_torch.engine import common
from skirt_tpu_torch.instruments import (FrameInstrument, FullInstrument,
                                         SEDInstrument, SimpleInstrument)
from skirt_tpu_torch.numerics import f32
from skirt_tpu_torch.ops import peel_sed
from skirt_tpu_torch.ops.peel_sed import LeaderCosines

torch.set_num_threads(2)

# SKIRTOR's ten inclinations at azimuth 0, as SEDInstrument's kobs
SKIRTOR_LEADERS = [(np.sin(i), 0.0, np.cos(i))
                   for i in np.deg2rad(np.arange(0, 91, 10))]


@pytest.fixture(autouse=True)
def _trace_off():
    trace.enable(False)
    trace.take()
    yield
    trace.enable(False)
    trace.take()


def _inputs(W, N, L, seed=0, device="cpu"):
    """Lp, Ln (W, N) at a lane's luminosity scale, a fifth of the lanes
    dead and a fifth fresh, g with 0, 1e-7 and negative values, kext,
    integrals I (L, N) and unit directions (N, 3) on both hemispheres."""
    rs = np.random.default_rng(seed)
    t = {"Lp": 1e30 * rs.random((W, N)), "Ln": 1e30 * rs.random((W, N)),
         "I": 2.0 * rs.random((L, N))}
    g = rs.uniform(-0.4, 0.9, W)
    g[:2] = 0.0, 1e-7
    d = rs.normal(size=(N, 3))
    t.update(g=g, minus_kext=-rs.uniform(0.05, 3.0, W),
             direction=d / np.linalg.norm(d, axis=1, keepdims=True))
    out = {k: torch.tensor(v, dtype=torch.float32, device=device)
           for k, v in t.items()}
    out["alive"] = torch.tensor(rs.random(N) >= 0.2, device=device)
    out["fresh"] = torch.tensor(rs.random(N) < 0.2, device=device)
    return out


def _hg_before(g, cosa):
    t = 1.0 + g * g - 2.0 * g * cosa
    return (1.0 - g) * (1.0 + g) / torch.sqrt(t * t * t)


def _leader_cosines_before(direction, leaders):
    def cos(j):
        kx, ky, kz = (f32(v) for v in leaders[j])
        return (direction[:, 0] * kx + direction[:, 1] * ky
                + direction[:, 2] * kz)

    return cos


def _loop_before(ftots, lead, wls, Lp, Ln, alive, fresh, minus_tau, cos,
                 phase):
    """peel_poly's loop as it was, each SED by SEDInstrument._detect_poly."""
    for ftot, j in zip(ftots, lead):
        cosj = cos(j)
        cw = Lp * phase(j, cosj)
        if fresh is not None:
            cw = torch.where(fresh[None], Ln, cw)
        cw = torch.where(alive[None], cw, 0.0)
        ext = cw * torch.exp(minus_tau(j))
        ftot.index_add_(0, wls, ext.sum(dim=1))


# -- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("form", ["directions", "rows"])
@pytest.mark.parametrize("relaunch", [True, False])
def test_plain_equals_the_loop_it_replaces_to_the_bit(form, relaunch):
    """Ten SEDs at SKIRTOR's leaders and an eleventh sharing the fourth's,
    as the table driver (directions, -(kext * I)) and K1's driver
    ((L, N) cosines, -kext * I) sent them to the loop."""
    W, N, L = 24, 1000, len(SKIRTOR_LEADERS)
    t = _inputs(W, N, L, seed=3)
    fresh = t["fresh"] if relaunch else None
    lead = list(range(L)) + [3]
    wls = torch.arange(W)
    g_col, mk_col = t["g"][:, None], t["minus_kext"][:, None]
    cosines = LeaderCosines(t["direction"], SKIRTOR_LEADERS)
    if form == "directions":
        cos, cos_old = cosines, _leader_cosines_before(t["direction"],
                                                      SKIRTOR_LEADERS)
        kext_col = -mk_col

        def minus_tau(j):
            return -(kext_col * t["I"][j][None])
    else:
        rows = torch.stack([cosines(j) for j in range(L)])
        cos = rows

        def cos_old(j):
            return rows[j]

        def minus_tau(j):
            return mk_col * t["I"][j][None]
    want = [torch.full((W,), 0.5) for _ in lead]
    _loop_before(want, lead, wls, t["Lp"], t["Ln"], t["alive"], fresh,
                 minus_tau, cos_old,
                 lambda j, cosj: _hg_before(g_col, cosj[None]))
    got = [torch.full((W,), 0.5) for _ in lead]
    peel_sed.peel_sed_plain(got, lead, wls, t["Lp"], t["Ln"], t["alive"],
                            fresh, t["g"], t["minus_kext"], t["I"], cos)
    assert (cosines(0) < 0).any()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[3], got[-1])
    assert all(bool((f > 0.5).all()) for f in got)


def test_wrapper_runs_the_plain_version_on_the_cpu_and_launches_nothing(
        monkeypatch):
    def refused():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(kernels, "library", refused)
    W, N, L = 8, 300, 3
    t = _inputs(W, N, L, seed=1)
    cos = LeaderCosines(t["direction"], SKIRTOR_LEADERS[:L])
    args = ([0, 2], peel_sed.wavelengths(W, "cpu"), t["Lp"], t["Ln"],
            t["alive"], t["fresh"], t["g"], t["minus_kext"], t["I"], cos)
    want = [torch.zeros(W), torch.zeros(W)]
    peel_sed.peel_sed_plain(want, *args)
    before = peel_sed.peel_sed_add.launches
    got = [torch.zeros(W), torch.zeros(W)]
    assert peel_sed.peel_sed_add(got, *args) is got
    assert peel_sed.peel_sed_add.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _bad(case):
    """peel_sed_add's arguments with one thing wrong."""
    W, N, L = 6, 64, 2
    t = _inputs(W, N, L, seed=2)
    a = {"ftots": [torch.zeros(W)], "lead": [1],
         "wls": peel_sed.wavelengths(W, "cpu"), "Lp": t["Lp"], "Ln": t["Ln"],
         "alive": t["alive"], "fresh": t["fresh"], "g": t["g"],
         "minus_kext": t["minus_kext"], "I": t["I"],
         "cos": LeaderCosines(t["direction"], SKIRTOR_LEADERS[:L])}
    if case == "float64 Lp":
        a["Lp"] = a["Lp"].double()
    elif case == "int flags":
        a["alive"] = a["alive"].to(torch.int32)
    elif case == "int32 wls":
        a["wls"] = a["wls"].to(torch.int32)
    elif case == "cos not a tensor":
        a["cos"] = lambda j: t["direction"][:, 0]
    elif case == "strided Lp":
        a["Lp"] = torch.zeros(N, W).T
    elif case == "strided I":
        a["I"] = torch.zeros(N, L).T
    elif case == "Ln shape":
        a["Ln"] = a["Ln"][:, :-1].contiguous()
    elif case == "I rows":
        a["I"] = a["I"][:1].contiguous()
    elif case == "g shape":
        a["g"] = torch.zeros(W + 1)
    elif case == "cos rows":
        a["cos"] = torch.zeros(L + 1, N)
    elif case == "tally shape":
        a["ftots"] = [torch.zeros(W + 1)]
    elif case == "leader out of range":
        a["lead"] = [L]
    elif case == "no tallies":
        a["ftots"], a["lead"] = [], []
    elif case == "wls not 0 .. W - 1":
        a["wls"] = torch.arange(W).flip(0).contiguous()
    return a


@pytest.mark.parametrize("case, error", [
    ("float64 Lp", TypeError), ("int flags", TypeError),
    ("int32 wls", TypeError), ("cos not a tensor", TypeError),
    ("strided Lp", ValueError), ("strided I", ValueError),
    ("Ln shape", ValueError), ("I rows", ValueError),
    ("g shape", ValueError), ("cos rows", ValueError),
    ("tally shape", ValueError), ("leader out of range", ValueError),
    ("no tallies", ValueError), ("wls not 0 .. W - 1", ValueError)])
def test_wrapper_refuses_bad_inputs_before_any_launch(case, error,
                                                      monkeypatch):
    def refused():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(kernels, "library", refused)
    a = _bad(case)
    keep = [f.clone() for f in a["ftots"]]
    with pytest.raises(error):
        peel_sed.peel_sed_add(**a)
    for f, k in zip(a["ftots"], keep):
        assert torch.equal(f, k)


def test_rows_of_reuses_the_rows_of_one_tensor():
    base = torch.rand(4, 10)
    assert peel_sed.rows_of(base) is base
    assert peel_sed.rows_of(list(base.unbind(0))) is base
    apart = [torch.rand(10) for _ in range(4)]
    assert torch.equal(peel_sed.rows_of(apart), torch.stack(apart))
    shuffled = list(base.unbind(0))[::-1]
    assert torch.equal(peel_sed.rows_of(shuffled), base.flip(0))


def test_the_kernel_is_named_apart_from_the_event_kernels():
    """csrc/peel_sed.cu holds one kernel; profile_torch files it under
    the peel and the benchmark's classifier under the drivers'
    arithmetic, never under an event kernel."""
    import re

    import profile_torch
    from rtbench import kernel_names

    src = (kernels.CSRC / "peel_sed.cu").read_text()
    assert re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                      r"\s+)?(\w+)\s*\(", src) == ["peel_sed_kernel"]
    name = ("void (anonymous namespace)::peel_sed_kernel<8>(PeelSedArgs)")
    assert profile_torch.layer_of(name).startswith("peel: the SED peel")
    assert kernel_names.classify(name) == (
        "plain torch: the drivers' arithmetic", None)


def _instruments(W):
    kw = dict(fov_x=2.0, fov_y=2.0)
    ins = [SEDInstrument(f"s{k}", 1e20, W, inclination=float(a))
           for k, a in enumerate(np.deg2rad([0, 30, 60, 90]))]
    ins += [FrameInstrument("f", 1e20, W, 4, 4, inclination=0.3, **kw),
            SimpleInstrument("m", 1e20, W, 4, 4, inclination=0.5, **kw),
            FullInstrument("u", 1e20, W, 4, 4, inclination=0.7,
                           nscatt_levels=1, **kw)]
    leaders, lead_of = common._group_leaders(ins)
    return ins, leaders, lead_of


@pytest.mark.parametrize("path", ["single", "polarized", "blend"])
def test_peel_poly_takes_only_sed_instruments_of_a_single_mix(path):
    """The SEDs of a SingleMix without Mueller weights go through the SED
    peel; Frame, Simple and Full instruments, the Mueller path and the
    multi-component form (PeelForm) keep the loop, which gives every
    tally the bits it gave before."""
    W, N = 4, 200
    ins, leaders, lead_of = _instruments(W)
    t = _inputs(W, N, len(leaders), seed=5)
    pos = 0.5 * t["direction"]
    tags = {"nscatt": torch.ones(N, dtype=torch.int32),
            "is_dust": torch.zeros(N, dtype=torch.bool)}
    cos = LeaderCosines(t["direction"], leaders)
    g, mk, I = t["g"], t["minus_kext"], list(t["I"].unbind(0))
    form = common.SingleMix(g, mk, I)
    polarized = None
    if path == "polarized":
        def polarized(i, j, cosj):
            return _hg_before(g[:, None], cosj[None]), None
    elif path == "blend":
        form = common.PeelForm(form.phase, form.minus_tau)
    wls = peel_sed.wavelengths(W, "cpu")

    def run(peel):
        tal = [obj.zero_tallies("cpu") for obj in ins]
        peel(tal)
        return tal

    trace.enable(True)
    got = run(lambda tal: common.peel_poly(
        ins, tal, lead_of, pos, wls, t["Lp"], t["Ln"], t["alive"], tags,
        form, cos, t["fresh"], polarized))
    trace.enable(False)
    counters = trace.take()["counters"]
    nsed = 4 if path == "single" else 0
    assert (counters["sed_peels_kernel"],
            counters["sed_peels_plain"]) == (nsed, len(ins) - nsed)

    def before(tal):
        for i, obj in enumerate(ins):
            j = lead_of[i]
            cosj = cos(j)
            tg = dict(tags)
            pw = _hg_before(g[:, None], cosj[None])
            cw = torch.where(t["fresh"][None], t["Ln"], t["Lp"] * pw)
            cw = torch.where(t["alive"][None], cw, 0.0)
            tg["transparent"] = cw
            obj.detect_poly(tal[i], pos, wls,
                            cw * torch.exp(mk[:, None] * I[j][None]), tg)

    want = run(before)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert float(got[0]["Ftot"].sum()) > 0


def _counted_run(run_batch, zero, ell, L0):
    from skirt_tpu_torch import rng

    trace.enable(True)
    run_batch(rng.root_key(11), ell, L0, zero())
    trace.enable(False)
    c = trace.take()["counters"]
    return c["sed_peels_kernel"], c["sed_peels_plain"]


def test_the_drivers_count_what_the_sed_peel_takes():
    """The table poly driver's SEDs go through the SED peel (one SED:
    every scattering peel is the SED peel's); K1's driver sends its SED
    and keeps its SimpleInstrument in the loop (half); the two-component
    table model keeps its blend in the loop."""
    from bench_torch import _build, _octree_build

    small = dict(refill_batches=2, max_level=3, quadrature_panels=8,
                 peel_panels=8)
    run, zero, ell, L0, _, _ = _octree_build(256, polychromatic=True,
                                             **small)
    k, p = _counted_run(run, zero, ell, L0)
    assert k > 0 and p == 0
    run, zero, ell, L0, _, _ = _octree_build(256, polychromatic=True,
                                             multi=True, refill_batches=2)
    k, p = _counted_run(run, zero, ell, L0)
    assert k == 0 and p > 0
    run, zero, ell, L0 = _build(nlambda=4, ncells=8, packets=256,
                                refill_batches=2, quadrature_panels=8,
                                peel_panels=4, max_scatt=8)
    k, p = _counted_run(run, zero, ell, L0)
    assert k > 0 and k == p


# -- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["directions", "rows"])
@pytest.mark.parametrize("L, W, N", [(10, 24, 1 << 15), (1, 128, 1 << 17)])
def test_kernel_matches_the_plain_version(L, W, N, form):
    """At torus-poly24's shapes and disc-poly128's SED, with fresh and
    dead lanes: each tally within rtol 1e-5 of the plain version on the
    card.  The two sum their N terms in different orders (the plain
    version's float32 reduction; the kernel's float32 sums a thread, a
    warp and a block, its blocks in float64), each relative error a few
    float32 roundings times log2 N (~1e-6 for these positive terms), and
    the kernel's HG takes rsqrt where the plain version divides by a sqrt
    (2 ulp)."""
    _card()
    dev = torch.device("cuda")
    t = _inputs(W, N, L, seed=L + W, device=dev)
    leaders = SKIRTOR_LEADERS[:L]
    cos = LeaderCosines(t["direction"], leaders)
    if form == "rows":
        cos = torch.stack([cos(j) for j in range(L)])
    lead = list(range(L)) + [L - 1]
    wls = peel_sed.wavelengths(W, dev)
    args = (lead, wls, t["Lp"], t["Ln"], t["alive"], t["fresh"], t["g"],
            t["minus_kext"], t["I"], cos)
    want = [torch.full((W,), 1e20, device=dev) for _ in lead]
    peel_sed.peel_sed_plain(want, *args)
    got = [torch.full((W,), 1e20, device=dev) for _ in lead]
    before = peel_sed.peel_sed_add.launches
    peel_sed.peel_sed_add(got, *args)
    assert peel_sed.peel_sed_add.launches == before + 1
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.double().cpu().numpy(),
                                   b.double().cpu().numpy(), rtol=1e-5)
    assert torch.equal(got[-1], got[-2])


@pytest.mark.gpu
@pytest.mark.parametrize("relaunch", [True, False])
def test_kernel_launches_twice_to_the_same_bits(relaunch):
    _card()
    dev = torch.device("cuda")
    L, W, N = 10, 24, 1 << 15
    t = _inputs(W, N, L, seed=9, device=dev)
    fresh = t["fresh"] if relaunch else None
    args = (list(range(L)), peel_sed.wavelengths(W, dev), t["Lp"],
            t["Ln"] if relaunch else None, t["alive"], fresh, t["g"],
            t["minus_kext"], t["I"],
            LeaderCosines(t["direction"], SKIRTOR_LEADERS))
    first = [torch.zeros(W, device=dev) for _ in range(L)]
    again = [torch.zeros(W, device=dev) for _ in range(L)]
    peel_sed.peel_sed_add(first, *args)
    peel_sed.peel_sed_add(again, *args)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_a_table_poly_scattering_peel_is_one_launch():
    """One batch of the table poly driver on the card: its SED's
    scattering peel is one PS launch an event iteration, the K6 launches
    (the emission peels take the loop)."""
    _card()
    from bench_torch import _octree_build
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine import fused_table_poly

    run, zero, ell, L0, _, _ = _octree_build(
        1 << 12, device="cuda", polychromatic=True, refill_batches=2,
        max_level=3)
    event = fused_table_poly.table_poly_event
    k6, ps = event.launches, peel_sed.peel_sed_add.launches
    out = run(rng.root_key(5), ell, L0, zero())
    torch.cuda.synchronize()
    assert event.launches - k6 > 0
    assert peel_sed.peel_sed_add.launches - ps == event.launches - k6
    assert float(out["instruments"][0]["Ftot"].sum()) > 0
