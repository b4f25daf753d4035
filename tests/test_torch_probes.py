"""The probes PG, PO and PM against the Pallas probes of experiments/.

The JAX probe scripts run their TPU benchmarks when imported, so this file
never imports them: `_lift` compiles only the named function definitions
(at any depth) and module-level assignments of a script from its source,
with the size constants overridden, into a namespace of its own; the
scripts' timing helpers are replaced by a stub that records what the
kernel returned and the arguments it got.  No file under experiments/
changes.  Every pallas_call runs in interpret mode (as tests/test_ops.py
runs them) at a cut size, 2^14-2^16 elements (the tables keep their size);
the port's wrapper, which takes its plain version on CPU tensors, gets the
same numpy inputs.  PG and PO must agree bit for bit; PM within
`mm.tolerance` (two float32 sums of the same products in other orders).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from skirt_tpu_torch.experiments import gather as PG
from skirt_tpu_torch.experiments import mm as PM
from skirt_tpu_torch.experiments import onehot_gather as PO

torch.set_num_threads(2)

EXP = Path(__file__).resolve().parents[1] / "experiments"


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp)


class _Timeit:
    """Stands in for a script's timeit(fn, *args): calls fn once and keeps
    (output, args)."""

    def __init__(self):
        self.calls = []

    def __call__(self, fn, *args, **kw):
        self.calls.append((np.asarray(fn(*args)), [np.asarray(a)
                                                   for a in args]))
        return 1.0


def _lift(script, names, **env):
    """The named function definitions and module-level assignments of
    experiments/<script>, compiled (not the rest of the script) into a
    namespace with jax, jnp, np, pl, pltpu and env."""
    path = EXP / script
    tree = ast.parse(path.read_text(), str(path))
    found = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id in names:
                    found.setdefault(t.id, node)
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in names:
            found.setdefault(node.name, node)
    missing = [n for n in names if n not in found]
    assert not missing, f"{script} has no {missing}"
    ns = dict(jax=jax, jnp=jnp, np=np, pl=pl, pltpu=pltpu)
    ns.update(env)
    body = [found[n] for n in names]
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"),
         ns)
    return ns


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _pg(tab, idx, steps=0):
    return PG.table_gather(_t(tab), _t(idx), steps=steps).numpy()


# -- PG: P1-P10 -------------------------------------------------------------

@pytest.mark.parametrize("fn", ["gather_pallas", "gather_pallas2"])
def test_p1_p2_chained_gather(fn):
    """P1 pk (microbench_gather.py:101) and P2 pk2 (:128): 64 chained
    gathers tab[(idx + i) % C] summed in order, 1-D and (N / 1024, 1024)."""
    N, C = 1 << 14, 16384
    ns = _lift("microbench_gather.py",
               ["pk", "gather_pallas", "pk2", "gather_pallas2"],
               N=N, C=C, STEPS=64, N2=(N // 1024, 1024))
    tab = PG.tables_like_jax(C)
    idx = np.random.default_rng(2).integers(0, C, N).astype(np.int32)
    got = np.asarray(ns[fn](jnp.asarray(tab), jnp.asarray(idx)))
    want = _pg(tab, idx.reshape(got.shape), steps=64)
    assert np.array_equal(got, want)


def test_p3_take():
    """P3 (microbench_gather2.py:85): tab[idx], idx tiles (256, 88)."""
    n, S, ncells = 512, 88, 32 * 32 * 16
    rho = PG.tables_like_jax(ncells)
    ns = _lift("microbench_gather2.py", ["kern", "pallas_take"], TN=256,
               n=n, S=S, ncells=ncells, rho_np=rho)
    idx = np.random.default_rng(3).integers(0, ncells, (n, S)).astype(
        np.int32)
    got = np.asarray(ns["pallas_take"](jnp.asarray(idx)))
    assert np.array_equal(got, _pg(rho, idx))


@pytest.mark.parametrize("fn", ["build_a", "build_a2", "build_b"])
def test_p4_p5_p6_broadcast_take(fn):
    """P4, P5 (microbench_pallas_gather.py:65, :91: take_along_axis of the
    table broadcast to (8, T) and (128, T)) and P6 (:117: take on (1, T))."""
    T, S, N = 16384, 128, 256
    tab = PG.tables_like_jax(T)
    ns = _lift("microbench_pallas_gather.py", [fn], T=T, S=S, N=N,
               tab_np=tab)
    idx = np.random.default_rng(4).integers(0, T, (N, S)).astype(np.int32)
    got = np.asarray(ns[fn]()(jnp.asarray(idx)))
    assert np.array_equal(got, _pg(tab, idx))


@pytest.mark.parametrize("fn", ["build_c", "build_c2"])
def test_p7_equal_shape_tiles(fn):
    """P7 (microbench_pallas_gather2.py:60 build_c, :96 build_c2): the
    table broadcast to (8 or 32, T) tiles of indices (T cut to 2,048)."""
    T, nflat = 2048, 1 << 16
    tab = PG.tables_like_jax(T)
    ns = _lift("microbench_pallas_gather2.py", ["build_c", "build_c2"],
               T=T, NFLAT=nflat, R=8, tab_np=tab)
    idx = np.random.default_rng(5).integers(0, T, (nflat // T, T)).astype(
        np.int32)
    f, _ = ns[fn]()
    got = np.asarray(f(jnp.asarray(idx)))
    assert np.array_equal(got, _pg(tab, idx))


@pytest.mark.parametrize("W", [128, 256, 512])
def test_p8_width_sweep(W):
    """P8 (microbench_pallas_gather3.py:42): table (W,), idx (rows, W)."""
    rows = (1 << 15) // W
    tab = PG.tables_like_jax(W)
    ns = _lift("microbench_pallas_gather3.py", ["kern", "f"], W=W, R=8,
               rows=rows, tab_np=tab)
    idx = np.random.default_rng(6).integers(0, W, (rows, W)).astype(
        np.int32)
    got = np.asarray(ns["f"](jnp.asarray(idx)))
    assert np.array_equal(got, _pg(tab, idx))


@pytest.mark.parametrize("fn, T", [("raw_dg", 128), ("full_table", 16384)])
def test_p9_p10_chunked(fn, T):
    """P9 raw_dg (microbench_pallas_gather4.py:45) and P10 full_table
    (:88, 128 chunks of 128 entries); 2^14 elements, BR = 128 rows a step;
    the indices are the script's own jax.random draws."""
    timeit = _Timeit()
    ns = _lift("microbench_pallas_gather4.py", [fn], NFLAT=1 << 14, BR=128,
               key=jax.random.key(0), timeit=timeit)
    ns[fn]()
    (got, (idx,)), = timeit.calls
    assert np.array_equal(got, _pg(PG.tables_like_jax(T), idx))


def test_pg_variants_cover_p1_to_p10():
    """Every Pallas gather site is computed by one distinct call, and no
    two calls are the same (table size, element count, steps)."""
    sites = {s.rsplit("/", 1)[1] for v in PG.VARIANTS for s in v.replaces}
    assert sites == {
        "microbench_gather.py:101", "microbench_gather.py:128",
        "microbench_gather2.py:85", "microbench_pallas_gather.py:65",
        "microbench_pallas_gather.py:91", "microbench_pallas_gather.py:117",
        "microbench_pallas_gather2.py:60", "microbench_pallas_gather2.py:96",
        "microbench_pallas_gather3.py:42", "microbench_pallas_gather4.py:45",
        "microbench_pallas_gather4.py:88"}
    pallas = [p for v in PG.VARIANTS for p in v.pallas]
    assert sorted({p.split()[0] for p in pallas}) == sorted(
        f"P{i}" for i in range(1, 11))
    assert len(pallas) == len(set(pallas))
    calls = {(v.T, int(np.prod(v.shape)), v.steps) for v in PG.VARIANTS}
    assert len(calls) == len(PG.VARIANTS)


# -- PO: P11-P14 ------------------------------------------------------------

NF = 1 << 15       # elements: 256 rows of 128, one Pallas grid step


@pytest.fixture(scope="module")
def mxu():
    """The port's MXU tables, the indices, and the scripts' own arrays."""
    t = PO.tables_like_jax()
    idx = np.random.default_rng(7).integers(0, PO.T, (NF // 128, 128))
    return t, idx.astype(np.int32)


def test_mxu_tables_like_jax(mxu):
    """The port's tables are the arrays the scripts build (their own
    module-level expressions, microbench_mxu_gather3.py:45-51)."""
    t, _ = mxu
    ns = _lift("microbench_mxu_gather3.py",
               ["tab_np", "tabT", "tab_hi_np", "Bfix"], T=PO.T)
    assert np.array_equal(ns["tab_np"], t["tab"])
    assert np.array_equal(ns["tabT"], t["tabT"])
    assert np.array_equal(np.asarray(ns["tab_hi_np"], np.float32),
                          t["tab_hi"])
    assert np.array_equal(np.asarray(ns["Bfix"], np.float32), t["bfix"])
    # the split of microbench_mxu_gather.py:57-59
    lo = (t["tabT"] - np.asarray(ns["tab_hi_np"], np.float32)).astype(
        jnp.bfloat16)
    assert np.array_equal(np.asarray(lo, np.float32), t["tab_lo"])


def _po(t, idx, v):
    return PO.onehot_gather(
        _bf16(t["tab_hi"]), _t(idx), stage=v.stage,
        tab_lo=_bf16(t["tab_lo"]) if v.split else None,
        bfix=_bf16(t["bfix"]) if v.stage == "fixed_B" else None, js=v.js,
        nmm=v.nmm).numpy()


def _variant(name):
    return PO.variant(name)


@pytest.mark.parametrize("split, group8", [(False, True), (False, False),
                                           (True, True), (True, False)])
def test_p11_onehot_gather(mxu, split, group8):
    """P11 (microbench_mxu_gather.py:62): the full one-hot gather, with and
    without the bf16 hi / lo split, 8 rows or 1 row a product."""
    t, idx = mxu
    ns = _lift("microbench_mxu_gather.py", ["make_f"], NFLAT=NF, BR=256,
               T=PO.T)
    f, tab_np = ns["make_f"](split, group8)
    assert np.array_equal(tab_np, t["tab"])
    got = np.asarray(f(jnp.asarray(idx)))
    want = _po(t, idx, _variant(f"P11 split={split} group8={group8}"))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("stage", ["onehot", "matmul", "select"])
def test_p12_stages(mxu, stage):
    """P12 (microbench_mxu_gather2.py:48): each stage's partial output."""
    t, idx = mxu
    ns = _lift("microbench_mxu_gather2.py", ["make_f"],
               tab_hi_np=np.asarray(t["tab_hi"], jnp.bfloat16),
               rows=NF // 128, BR=256)
    got = np.asarray(ns["make_f"](stage)(jnp.asarray(idx)))
    assert np.array_equal(got, _po(t, idx, _variant(f"P12 {stage}")))


@pytest.mark.parametrize("stage", ["mm_pure", "oh_slice", "oh_bidim",
                                   "oh_mxu", "full_slice"])
def test_p13_stage_variants(mxu, stage):
    """P13 (microbench_mxu_gather3.py:55): the fixed-B product, the three
    one-hot builds and the full gather without concatenation."""
    t, idx = mxu
    ns = _lift("microbench_mxu_gather3.py", ["make_f"],
               tab_hi_np=np.asarray(t["tab_hi"], jnp.bfloat16),
               Bfix=np.asarray(t["bfix"], jnp.bfloat16), rows=NF // 128,
               BR=256)
    got = np.asarray(ns["make_f"](stage)(jnp.asarray(idx)))
    assert np.array_equal(got, _po(t, idx, _variant(f"P13 {stage}")))


@pytest.mark.parametrize("unroll, nmm", [(1, 1), (4, 1), (1, 4), (4, 4)])
def test_p14_kern_shape(mxu, unroll, nmm):
    """P14 (microbench_mxu_gather4.py:91 kern_shape): nmm fixed-B products
    per 8-row body, unroll bodies per loop step."""
    t, idx = mxu
    timeit = _Timeit()
    ns = _lift("microbench_mxu_gather4.py", ["kern_shape"], NFLAT=NF,
               tab_np=t["tab"], idx=jnp.asarray(idx.reshape(-1)),
               timeit=timeit)
    ns["kern_shape"](unroll, nmm)
    (got, _), = timeit.calls
    want = _po(t, idx, _variant(f"P14 kern_unroll{unroll}_mm{nmm}"))
    assert np.array_equal(got, want)


def test_po_variants_cover_p11_to_p14():
    """Every Pallas MXU-gather variant is computed by one distinct call,
    and no two calls take the same arguments."""
    sites = {s.rsplit("/", 1)[1] for v in PO.VARIANTS for s in v.replaces}
    assert sites == {"microbench_mxu_gather.py:62",
                     "microbench_mxu_gather2.py:48",
                     "microbench_mxu_gather3.py:55",
                     "microbench_mxu_gather4.py:91"}
    assert {v.stage for v in PO.VARIANTS} == set(PO.STAGES)
    pallas = [p for v in PO.VARIANTS for p in v.pallas]
    assert len(pallas) == len(set(pallas)) == 16
    calls = {(v.stage, v.split, v.js, v.nmm) for v in PO.VARIANTS}
    assert len(calls) == len(PO.VARIANTS)


# -- PM: P15 ----------------------------------------------------------------

@pytest.mark.parametrize("shape", PM.SHAPES, ids=lambda s: s.name)
def test_p15_matmul(shape):
    """P15 (microbench_mxu_mm.py:34, its run at :313): A @ B with float32
    accumulation and the inner chain, one grid step (the G steps write the
    same block), the script's own inputs."""
    timeit = _Timeit()
    ns = _lift("microbench_mxu_mm.py", ["run"], timeit=timeit)
    dt = jnp.bfloat16 if shape.dtype == torch.bfloat16 else jnp.float32
    ns["run"](shape.M, shape.K, shape.N, dt, G=1, inner=shape.inner)
    (got, (a_np, b_np)), = timeit.calls
    a, b = PM.tables_like_jax(shape.M, shape.K, shape.N, shape.dtype)
    assert np.array_equal(a.float().numpy(), np.asarray(a_np, np.float32))
    assert np.array_equal(b.float().numpy(), np.asarray(b_np, np.float32))
    port = PM.mm(a, b, inner=shape.inner)
    err = np.abs(port.numpy() - got)
    tol = PM.tolerance(a, b, shape.inner).numpy()
    assert (err <= tol).all(), float((err / tol).max())


@pytest.mark.parametrize("shape", [s for s in PM.SHAPES if s.inner > 1],
                         ids=lambda s: s.name)
def test_p15_inner_chain_is_repeated_product(shape):
    """The chain's perturbation a + acc[:, :K] * 1e-20
    (microbench_mxu_mm.py:321-325) leaves a unchanged at every step on the
    seeded inputs, so the chain is `inner` sums of one product."""
    a, b = PM.tables_like_jax(shape.M, shape.K, shape.N, shape.dtype)
    a32 = a.float().numpy()
    p = a32 @ b.float().numpy()
    acc = p
    for _ in range(1, shape.inner):
        assert shape.N >= shape.K
        assert np.array_equal(a32 + acc[:, :shape.K] * np.float32(1e-20),
                              a32)
        acc = acc + p


# -- the wrappers' refusals on the CPU --------------------------------------

def test_wrappers_refuse_bad_arguments():
    tab = torch.zeros(16)
    idx = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="route"):
        PG.table_gather(tab, idx, route="vmem")
    th = torch.zeros(256, 128, dtype=torch.bfloat16)
    rows = torch.zeros(8, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="stage"):
        PO.onehot_gather(th, rows, stage="diagmm")
    with pytest.raises(ValueError, match="js"):
        PO.onehot_gather(th, rows, stage="matmul", js=(8,))
    with pytest.raises(ValueError, match="8k, 128"):
        PO.onehot_gather(th, rows[:5], stage="full")
    with pytest.raises(ValueError, match="bfix"):
        PO.onehot_gather(th, rows, stage="fixed_B", js=(0,))
    with pytest.raises(ValueError, match="split"):
        PO.onehot_gather(th, rows, stage="onehot", js=(0,), tab_lo=th)
    with pytest.raises(ValueError, match="shapes"):
        PM.mm(torch.zeros(64, 32), torch.zeros(64, 64))
    with pytest.raises(ValueError, match="inner"):
        PM.mm(torch.zeros(64, 32), torch.zeros(32, 64), inner=0)
