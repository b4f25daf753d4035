"""The exact peel's kernel (csrc/exact_peel.cu, ops/exact_peel.py).

On the CPU: make_exact_peel runs its plain version on CPU tensors and
launches nothing, with and without `graph`; the wrapper refuses a wrong
dtype, a non-contiguous tensor, a wrong shape or a CPU tensor before any
launch; the kernel's device name is filed under the exact peel by
profile_torch and under no event kernel by the benchmark's classifier.
On the card (`gpu`, skipped without one): the kernel against the plain
version on the same points (CPU tensors) for the optical depths and the
integrals, H = 1 and 2, along leaders with two, one and no zero
components and SKIRTOR's ten inclinations, from points inside the grid,
on its voxel walls and outside its box; two launches give the same bits;
each pass is one launch, with `graph` (accepted and ignored) or not.

This file imports no JAX, so it also runs on a GPU machine without it:

    python3 -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_exact_peel.py
"""

import re

import numpy as np
import pytest
import torch

from skirt_tpu_torch import kernels
from skirt_tpu_torch.engine import fused_table
from skirt_tpu_torch.ops import exact_peel
from test_torch_trace import PEEL_LEADERS, _voxel_field

torch.set_num_threads(2)

# SKIRTOR's ten inclinations at azimuth 0, as SEDInstrument's kobs: 0 deg
# has two zero components, 90 deg one zero and one of 6.1e-17
SKIRTOR_LEADERS = [(np.sin(i), 0.0, np.cos(i))
                   for i in np.deg2rad(np.arange(0, 91, 10))]


def _cube_field(H, n=400, size=24, seed=5):
    """A size^3 uniform grid over +-1 with H random density fields, and
    n points inside it (float64 values of float32 points)."""
    from types import SimpleNamespace

    from skirt_tpu_torch.grids import CartesianGrid

    rs = np.random.default_rng(seed)
    e = np.linspace(-1.0, 1.0, size + 1)
    grid = CartesianGrid(e, e, e)
    ds = SimpleNamespace(ncomp=H, rho=rs.random((H, size ** 3)))
    pos = (-1.0 + 2.0 * rs.random((n, 3))).astype(np.float32)
    return grid, ds, [e, e, e], pos.astype(np.float64)


def _points(field, H, seed=0):
    """The field's grid, densities and float32 points: those inside it,
    a fifth moved onto voxel walls (one coordinate on an edge), some
    outside the box (scaled by 1.8, or past a face)."""
    grid, ds, edges, pos = field(H, seed=seed)
    rs = np.random.default_rng(seed + 100)
    n = len(pos)
    for i in range(3):
        rows = rs.choice(n, n // 15, replace=False)
        pos[rows, i] = np.asarray(edges[i], np.float32)[
            rs.integers(0, len(edges[i]), len(rows))]
    out = rs.choice(n, n // 10, replace=False)
    pos[out] *= 1.8
    pos[out[:5], 2] = edges[2][-1] + 0.25
    return grid, ds, torch.as_tensor(pos, dtype=torch.float32)


def _opacities(n, H, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand(n, generator=g) for _ in range(H)]


# -- on the CPU -----------------------------------------------------------

@pytest.mark.parametrize("graph", [False, True], ids=["plain", "graph"])
def test_cpu_tensors_take_the_plain_path(graph, monkeypatch):
    """CPU tensors run leader_sums: the wrapper is never called and the
    launch counter stays."""
    def refused(*a, **kw):
        raise AssertionError("the kernel's wrapper was called")

    grid, ds, pos = _points(_voxel_field, 2)
    peel = fused_table.make_exact_peel(grid, ds, PEEL_LEADERS, graph=graph)
    want = peel(pos, _opacities(len(pos), 2)) + peel.integrals(pos)
    before = exact_peel.peel_columns.launches
    monkeypatch.setattr(exact_peel, "peel_columns", refused)
    for _ in range(3):
        got = peel(pos, _opacities(len(pos), 2)) + peel.integrals(pos)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    monkeypatch.undo()
    assert exact_peel.peel_columns.launches == before
    assert len(got) == 2 * len(PEEL_LEADERS)
    assert got[0].shape == (len(pos),) and got[-1].shape == (2, len(pos))


def _wrapper_args(H=2, n=16, L=3):
    pos = torch.zeros(n, 3)
    rho = torch.zeros(H, 4, 5, 6)
    rows = torch.zeros(L, exact_peel.ROW)
    kext = torch.zeros(H, n)
    return pos, rho, rows, kext


def _bad(case):
    pos, rho, rows, kext = _wrapper_args()
    if case == "float64":
        return (pos.double(), rho, rows, kext), TypeError, "float32"
    if case == "int32 opacities":
        return (pos, rho, rows, kext.int()), TypeError, "float32"
    if case == "non-contiguous":
        return ((torch.zeros(3, 16).T, rho, rows, kext), ValueError,
                "contiguous")
    if case == "pos shape":
        return (pos[:, :2].contiguous(), rho, rows, kext), ValueError, "pos"
    if case == "row width":
        return (pos, rho, rows[:, :8].contiguous(), kext), ValueError, "rows"
    if case == "kext shape":
        return (pos, rho, rows, kext[:1].contiguous()), ValueError, "kext"
    return (pos, rho, rows, kext), ValueError, "CUDA"


@pytest.mark.parametrize("case", ["float64", "int32 opacities",
                                  "non-contiguous", "pos shape", "row width",
                                  "kext shape", "cpu"])
def test_wrapper_refuses_bad_inputs_before_any_launch(case, monkeypatch):
    def refused():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(kernels, "library", refused)
    (pos, rho, rows, kext), err, match = _bad(case)
    before = exact_peel.peel_columns.launches
    with pytest.raises(err, match=match):
        exact_peel.peel_columns(pos, rho, rows, (0.0,) * 6, kext)
    assert exact_peel.peel_columns.launches == before


def test_leader_rows_hold_the_plain_versions_constants():
    """A row holds the leader's axes (a the largest component), its
    float32 components, Kp and 1 / |k_a|, and each lateral axis's
    crossing constants as the plain walk reads them; an axis below 1e-12
    is inactive, as leader_sums takes it."""
    lo, dx = np.array([-3.0, -2.0, -1.0]), np.array([1.0, 1.0, 0.5])
    nxyz = (6, 4, 8)
    for k in PEEL_LEADERS + SKIRTOR_LEADERS:
        k = np.asarray(k, np.float64)
        a = int(np.argmax(np.abs(k)))
        b, c = [i for i in range(3) if i != a]
        ld = exact_peel.leader(k, lo, dx, nxyz)
        assert (ld.a, ld.b, ld.c) == (a, b, c)
        assert 2 <= ld.Kp <= nxyz[b] + nxyz[c] + 1
        row = np.asarray(exact_peel.leader_row(ld), np.float32)
        assert row.shape == (exact_peel.ROW,)
        assert list(row[:3]) == [a, b, c] and row[10] == ld.Kp
        assert list(row[6:9]) == list(k.astype(np.float32))
        assert row[9] == np.float32(1.0 / abs(k[a]))
        for axis, s, r in ((b, ld.lat[0], row[11:18]),
                           (c, ld.lat[1], row[18:25])):
            assert r[0] == s.active == (abs(k[axis]) >= 1e-12)
            assert list(r[2:4]) == [np.float32(lo[axis]),
                                    np.float32(1.0 / dx[axis])]
            if r[0]:
                assert r[5] == s.step == np.float32(abs(dx[axis] / k[axis]))
                assert r[4] == r[5] and r[6] == s.thr > 0


def test_the_kernel_is_named_apart_from_the_event_kernels():
    """csrc/exact_peel.cu holds one kernel; profile_torch files it under
    the exact peel and the benchmark's classifier under the drivers'
    arithmetic, never under an event kernel."""
    import profile_torch
    from rtbench import kernel_names

    src = (kernels.CSRC / "exact_peel.cu").read_text()
    assert re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                      r"\s+)?(\w+)\s*\(", src) == ["exact_peel_kernel"]
    name = ("void (anonymous namespace)::exact_peel_kernel<1>(const float *,"
            " const float *, const float *, const float *, float *, int, "
            "int, int, int, int, <unnamed>::Box)")
    assert profile_torch.layer_of(name) == \
        "exact peel (the table engines' column integrals)"
    assert kernel_names.classify(name) == (
        "plain torch: the drivers' arithmetic", None)


# -- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("field", ["uneven", "cube"])
@pytest.mark.parametrize("H", [1, 2])
@pytest.mark.parametrize("what", ["taus", "integrals"])
def test_kernel_matches_the_plain_peel(what, H, field):
    """Within the plain version's float32 sums (rtol 1e-5, atol 1e-6 x
    the largest), on the 6 x 5 x 7 grid of unequal voxel sizes and a
    24^3 cube, from points inside, on walls and outside the box."""
    _card()
    make = {"uneven": _voxel_field, "cube": _cube_field}[field]
    grid, ds, pos = _points(make, H, seed=H)
    leaders = PEEL_LEADERS + SKIRTOR_LEADERS
    peel = fused_table.make_exact_peel(grid, ds, leaders)
    ks = _opacities(len(pos), H, seed=H)
    dev = torch.device("cuda")
    if what == "taus":
        want = peel(pos, ks)
        got = peel(pos.to(dev), [k.to(dev) for k in ks])
    else:
        want = peel.integrals(pos)
        got = peel.integrals(pos.to(dev))
    want = torch.stack(want).numpy()
    got = torch.stack(got).cpu().numpy()
    assert got.shape == want.shape
    assert (want > 0).mean() > 0.5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * want.max())


@pytest.mark.gpu
@pytest.mark.parametrize("H", [1, 2])
def test_kernel_launches_twice_to_the_same_bits(H):
    _card()
    grid, ds, pos = _points(_cube_field, H, seed=7)
    dev = torch.device("cuda")
    peel = fused_table.make_exact_peel(grid, ds, PEEL_LEADERS
                                       + SKIRTOR_LEADERS)
    pos = pos.to(dev)
    ks = [k.to(dev) for k in _opacities(len(pos), H)]
    first = peel(pos, ks) + peel.integrals(pos)
    again = peel(pos, ks) + peel.integrals(pos)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("graph", [False, True], ids=["plain", "graph"])
def test_each_pass_is_one_launch_on_the_card(graph):
    """Each pass of the optical depths and of the integrals adds one
    launch, with `graph` or without."""
    _card()
    grid, ds, pos = _points(_voxel_field, 2)
    dev = torch.device("cuda")
    pos = pos.to(dev)
    ks = [k.to(dev) for k in _opacities(len(pos), 2)]
    peel = fused_table.make_exact_peel(grid, ds, PEEL_LEADERS, graph=graph)
    for _ in range(4):
        before = exact_peel.peel_columns.launches
        peel(pos, ks)
        peel.integrals(pos)
        assert exact_peel.peel_columns.launches == before + 2
