"""Monochromatic fused table events (kernels K4 and K5), the exact
column-DDA peel and the table-mode lifecycle driver.

Twin of skirt_tpu/engine/fused_table.py: models without closed-form
densities, on a uniform Cartesian (voxel) grid (an octree torus traced
through its exact voxel view, `DustSystem.voxelized().as_table()`) or
directly on a grid with device point location (the exact Voronoi
tessellation, an uneven Cartesian grid: the direct table).  The event
splits at the gather: torch stages the (P, N) panel-midpoint
kappa * rho rows each iteration (`vector_traversal.panel_paths` +
`DustSystem.analytic_rows`), and the event kernel consumes them:
cumulative optical depth, sampled absorption deposit, forced propagation
with the composite bias weight, weight cut, position update.  Relaunch
(refill) and the peel-off run torch-side after the kernel; the peel
optical depth toward each observer direction is the exact integral of
the piecewise-constant voxel field along the ray (`make_exact_peel`).

One dust component runs kernel K4, which also scatters (Henyey-
Greenstein).  Several components run kernel K5 on the staged
kappa_ext * rho and kappa_sca * rho panel sums: per-panel albedo
blending, a deposit panel drawn by absorbed energy, and the interaction
cell out; the component selection at that cell (by kappa_sca,h * rho_h),
the HG scatter and the blended peel phase weight run torch-side.

On a direct-table grid K4 runs as K4d (skirt_tpu's arith_locate=False):
the kernel cannot locate the deposit cell, so it emits the deposit's
distance along the pre-event ray instead of a bin, and the lifecycle locates
pos + mid_dep * dir with one `grid.locate_batched` per iteration
(`direct_deposits`).  The column-DDA peel needs a uniform grid, so
table_peel='exact' downgrades to the staged panel peel with skirt_tpu's
warning.  Several components need the uniform voxel view.

Each event has two implementations with one input/output contract:
- `table_event_plain` / `table_multi_event_plain`: plain PyTorch on (N,)
  tensors, any device.  They are the specs the CPU tests hold against the
  Pallas bodies (interpret mode) and the references `chip_smoke.py` holds
  the CUDA kernels against.
- csrc/fused_table.cu (K4) and csrc/fused_table_multi.cu (K5): the
  hand-written CUDA kernels, one thread per lane.
`table_event` / `table_multi_event` take the plain version for CPU
tensors and launch the kernel (or raise) for CUDA tensors.

Layouts (N lanes, no padding: the kernels bounds-check).  K4: u (5, N);
kr (P, N); state px, py, pz, dx, dy, dz, L float32, alive, ns, ell int32,
L0, t0, dt, albedo, g float32, each (N,); outputs state (7 float32 +
alive, ns) and depi int32 / depv float32 (N,); K4d depd float32 (the
deposit distance, -1 for none) in place of depi.  K5: u (3, N); kr, ks
(P, N); state px, py, pz, dx, dy, dz, L, alive, ns, ell, L0, t0, dt;
outputs state px, py, pz, L, alive and the interaction cell, depi / depv.

With a Mueller table (one dust component) K4 and K4d run unchanged: the
driver carries the Stokes ratios and the reference normal, overrides the
kernel's HG direction with the Mueller sample and peels with the Mueller
phase weights and Stokes tags, torch-side (make_fused_table_lifecycle).

Not ported here, each refusing with its slice: table_peel='taumap'
(density-path maps, S2b), the dust-emission launch (S3).

ref: SKIRTcore/MonteCarloSimulation.cpp:438-549 event chain.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from functools import partial

import numpy as np
import torch

from .. import kernels, rng, trace
from ..media import polarization as pol
from ..numerics import f32
from ..ops import exact_peel
from . import vector_traversal as vt
from .common import (EventCount, Stokes, _TINY, _check_tensors, _expon_cutoff,
                     _forced, _hg_costheta, _hit_point, _locate_args,
                     _make_locate, _moved, _on_device, _scattered, _set_ptrs,
                     _uniform_grid, batch_keys, check_shared, chunk_rows,
                     count_entry_lanes, deposit, emit_mono, events,
                     lane_columns, leader_cosines, make_peel_off, panel_taus,
                     peel_mono, plan, relaunch, table_peel_mode, uniforms)
# the direct table's deposits (K4d, K6d), placed here beside the exact peel
# the direct table's deposits (K4d, K6d), placed here as skirt_tpu places
# its peels
from .common import direct_deposits  # noqa: F401

# lanes per chunk of the exact peel: its (lanes, Kp, n_a) gathers and
# overlaps stay under ~2^26 floats (256 MB) each
_PEEL_CHUNK_FLOATS = 1 << 26


def _validate(grid, ds, stellar_system, instruments, options, mueller,
              io_state, launch_fn):
    def bail(msg):
        raise ValueError(f"fused table lifecycle: {msg}")

    if ds is None or not getattr(ds, "table", False):
        bail("requires density_mode='table' (voxelized().as_table())")
    if not (hasattr(grid, "ray_span") and hasattr(grid, "locate_batched")):
        bail("requires a grid with ray_span + locate_batched (uniform "
             "Cartesian voxel view, or Voronoi with device point location)")
    if ds.ncomp > 1 and not _uniform_grid(grid):
        bail("multi-component mode needs the uniform Cartesian voxel view")
    if ds.ncomp > 1 and mueller is not None:
        bail("polarized mode is single-component only")
    peel_mode = getattr(options, "table_peel", "exact")
    if peel_mode == "taumap":
        bail("table_peel='taumap' (compute_rho_path_maps) is not ported yet "
             "(slice S2b)")
    if peel_mode not in ("staged", "exact"):
        bail("table_peel must be 'exact', 'taumap' or 'staged'")
    check_shared(bail, stellar_system, instruments, options, io_state,
                 launch_fn)


# ---------------------------------------------------------------------------
# kernel K4: the monochromatic table event
# ---------------------------------------------------------------------------

@dataclass
class TableEventSpec:
    """The constants the K4 event closes over (skirt_tpu
    fused_table._build_kernel): float32 values as Python floats, and the
    grid: with arith_locate its uniform voxels are located in the kernel,
    without (K4d) the deposit distance goes out instead."""
    npanels: int
    nlambda: int
    want_labs: bool
    min_scatt: int
    xi: float
    one_m_xi: float
    inv_minred: float
    grid: object
    n_uniform: int = 5
    arith_locate: bool = True
    locate: object = field(default=None, repr=False)


def _build_kernel(grid, options, nlambda, npanels, want_labs,
                  arith_locate=True, spec=None):
    """The event's constants (mirrors skirt_tpu
    fused_table._build_kernel; arith_locate=False is K4d; `spec` the
    class, TableEventSpec by default)."""
    xi = float(options.scatt_bias)
    return (spec or TableEventSpec)(
        npanels=int(npanels), nlambda=int(nlambda), want_labs=bool(want_labs),
        min_scatt=int(options.min_scatt_events), xi=f32(xi),
        one_m_xi=f32(1.0 - xi),
        inv_minred=f32(1.0 / options.min_weight_reduction), grid=grid,
        arith_locate=bool(arith_locate),
        locate=_make_locate(grid) if arith_locate else None)


def table_event_plain(spec: TableEventSpec, u, kr, state):
    """One monochromatic table event for every lane, plain PyTorch.

    Mirrors the Pallas body (skirt_tpu/engine/fused_table.py:110-243)
    operation for operation.  kr: (P, N) staged kappa_ext * rho panels.
    Returns a dict: "state" (px, py, pz, dx, dy, dz, L, alive, ns) and
    with labs "depi"/"depv", or for K4d (arith_locate False) "depd"/"depv":
    the deposit's distance along the pre-event ray, -1 for none."""
    P = spec.npanels
    X, Y, Z, DX, DY, DZ, L = state[:7]
    alive = state[7] != 0
    nscatt = state[8]
    ell = state[9]
    Lth = state[10] * spec.inv_minred
    t0, delta, albedo, g = state[11:15]
    out = {}

    # -- cumulative optical depth from the staged panels ------------------
    cum = torch.zeros_like(L)
    cums = []
    for kk in range(P):
        cum = cum + kr[kk] * delta
        cums.append(cum)
    taupath = cum
    one_m_e = 1.0 - torch.exp(-taupath)
    Lm = torch.where(alive, L, 0.0)

    # -- sampled absorption deposit ----------------------------------------
    if spec.want_labs:
        D = (1.0 - albedo) * Lm * one_m_e
        tau_dep = _expon_cutoff(u[2], taupath)
        i_dep = (torch.stack(cums[:P - 1]) < tau_dep[None]).sum(0) \
            .to(torch.int32) if P > 1 else torch.zeros_like(nscatt)
        mid_dep = t0 + (i_dep.to(torch.float32) + 0.5) * delta
        okd = (D > 0) & alive
        if spec.arith_locate:
            cell = spec.locate(X + mid_dep * DX, Y + mid_dep * DY,
                               Z + mid_dep * DZ)
            okd = okd & (cell >= 0)
            out["depi"] = torch.where(okd, cell * spec.nlambda + ell, -1)
        else:
            # the caller locates pos + mid_dep * dir (direct_deposits)
            out["depd"] = torch.where(okd, mid_dep, -1.0)
        out["depv"] = torch.where(okd, D, 0.0)

    # -- scattered-luminosity update + termination -------------------------
    L = torch.where(alive, albedo * Lm * one_m_e, L)
    alive = alive & (L > 0) & torch.logical_not(
        (L <= Lth) & (nscatt >= spec.min_scatt)) & (taupath > 0)

    # -- forced propagation ------------------------------------------------
    tau, L = _forced(spec, u[0], u[1], taupath, one_m_e, alive, L)
    s = _hit_point(cums, P, tau, t0, delta)
    X, Y, Z = _moved(alive, s, X, Y, Z, DX, DY, DZ)

    # -- Henyey-Greenstein scatter -----------------------------------------
    DX, DY, DZ, nscatt = _scattered(alive, _hg_costheta(g, u[3]), u[4],
                                    DX, DY, DZ, nscatt)

    out["state"] = (X, Y, Z, DX, DY, DZ, L, alive.to(torch.int32), nscatt)
    return out


def _table_event_cuda(spec, u, kr, state):
    N = state[0].shape[0]
    P = spec.npanels
    if len(state) != 15:
        raise ValueError("table_event: expected 15 state arrays")
    dts = [torch.float32] * 7 + [torch.int32] * 3 + [torch.float32] * 5
    _check_tensors("table_event",
                   [(u, (spec.n_uniform, N), torch.float32),
                    (kr, (P, N), torch.float32)]
                   + [(s, (N,), dt) for s, dt in zip(state, dts)])
    dev = u.device
    a = kernels.TableArgs()
    a.N = N
    a.nlambda = spec.nlambda
    a.npanels = P
    a.min_scatt = spec.min_scatt
    a.xi = spec.xi
    a.one_m_xi = spec.one_m_xi
    a.inv_minred = spec.inv_minred
    a.direct = int(not spec.arith_locate)
    if spec.arith_locate:
        _locate_args(a.geo, spec.grid)
    f32_kw = dict(dtype=torch.float32, device=dev)
    i32_kw = dict(dtype=torch.int32, device=dev)
    st_out = [torch.empty(N, **f32_kw) for _ in range(7)] \
        + [torch.empty(N, **i32_kw) for _ in range(2)]
    out = {"state": tuple(st_out)}
    depi = depv = depd = None
    if spec.want_labs:
        if spec.arith_locate:
            depi = out["depi"] = torch.empty(N, **i32_kw)
        else:
            depd = out["depd"] = torch.empty(N, **f32_kw)
        depv = out["depv"] = torch.empty(N, **f32_kw)
    _set_ptrs(a, "u kr px py pz dx dy dz L alive ns ell L0 t0 dt alb g",
              [u, kr, *state])
    _set_ptrs(a, "opx opy opz odx ody odz oL oalive ons odepi odepv odepd",
              [*st_out, depi, depv, depd])
    rows = chunk_rows(P)
    if rows:
        cend = torch.empty((rows, N), dtype=torch.float32, device=dev)
        a.cend = cend.data_ptr()
    lib = kernels.library()
    kernels.check(lib.skirt_table_event(ctypes.byref(a), int(spec.want_labs),
                                        kernels.stream_of(u)),
                  "table_event kernel")
    table_event.launches += 1
    if not spec.arith_locate:
        table_event.direct_launches += 1
    return out


def table_event(spec: TableEventSpec, u, kr, state):
    """The event on CPU tensors (plain version) or CUDA tensors (the K4
    kernel, or K4d without arith_locate, counted in `table_event.launches`
    and with K4d also in `table_event.direct_launches`)."""
    return _on_device("table_event", table_event_plain, _table_event_cuda,
                      spec, u, kr, state)


table_event.launches = 0
table_event.direct_launches = 0


# ---------------------------------------------------------------------------
# kernel K5: the monochromatic multi-component table event
# ---------------------------------------------------------------------------

@dataclass
class TableMultiEventSpec(TableEventSpec):
    """The constants the K5 event closes over (skirt_tpu
    fused_table._build_kernel_multi): K4's, with three uniforms."""
    n_uniform: int = 3


def _build_kernel_multi(grid, options, nlambda, npanels, want_labs):
    """The K5 event's constants (mirrors skirt_tpu
    fused_table._build_kernel_multi)."""
    return _build_kernel(grid, options, nlambda, npanels, want_labs,
                         spec=TableMultiEventSpec)


def table_multi_event_plain(spec: TableMultiEventSpec, u, kr, ks, state):
    """One monochromatic multi-component table event for every lane, plain
    PyTorch.

    Mirrors the Pallas body (skirt_tpu/engine/fused_table.py:280-390)
    operation for operation.  kr, ks: (P, N) staged kappa_ext * rho and
    kappa_sca * rho panel sums over the components.  Returns a dict:
    "state" (px, py, pz, L, alive), "cell" (the interaction cell at the
    hit panel's midpoint from the pre-event position, -1 for lanes that
    end) and "depi"/"depv" with labs."""
    P = spec.npanels
    X, Y, Z, DX, DY, DZ, L = state[:7]
    alive = state[7] != 0
    nscatt = state[8]
    ell = state[9]
    Lth = state[10] * spec.inv_minred
    t0, delta = state[11], state[12]
    out = {}

    # -- cumulative optical depth and the per-panel absorbed energy -------
    cum = torch.zeros_like(L)
    e_prev = torch.ones_like(L)
    Lm = torch.where(alive, L, 0.0)
    Lsca = torch.zeros_like(L)
    cw = torch.zeros_like(L)
    cums, cws = [], []
    for kk in range(P):
        cum = cum + kr[kk] * delta
        cums.append(cum)
        e_cur = torch.exp(-cum)
        dE = Lm * (e_prev - e_cur)            # energy interacting here
        alb = ks[kk] / torch.clamp(kr[kk], min=_TINY)
        Lsca = Lsca + alb * dE
        cw = cw + (1.0 - alb) * dE
        cws.append(cw)
        e_prev = e_cur
    taupath = cum

    def count_below(sums, x):
        # panel pick: number of running sums (all but the last) below x
        if P == 1:
            return torch.zeros_like(nscatt)
        return (torch.stack(sums[:P - 1]) < x[None]).sum(0).to(torch.int32)

    # -- sampled absorption deposit: the panel drawn by absorbed energy ---
    if spec.want_labs:
        D = cw
        i_dep = count_below(cws, u[2] * D)
        mid_dep = t0 + (i_dep.to(torch.float32) + 0.5) * delta
        cell = spec.locate(X + mid_dep * DX, Y + mid_dep * DY,
                           Z + mid_dep * DZ)
        okd = (D > 0) & alive & (cell >= 0)
        out["depi"] = torch.where(okd, cell * spec.nlambda + ell, -1)
        out["depv"] = torch.where(okd, D, 0.0)

    # -- scattered-luminosity update + termination -------------------------
    L = torch.where(alive, Lsca, L)
    alive = alive & (L > 0) & torch.logical_not(
        (L <= Lth) & (nscatt >= spec.min_scatt)) & (taupath > 0)

    # -- forced propagation ------------------------------------------------
    one_m_e = 1.0 - torch.exp(-taupath)
    tau, L = _forced(spec, u[0], u[1], taupath, one_m_e, alive, L)
    s = _hit_point(cums, P, tau, t0, delta)
    mid_h = t0 + (count_below(cums, tau).to(torch.float32) + 0.5) * delta
    # the interaction cell for the torch-side component selection and
    # blended peel: the hit panel's midpoint from the pre-event position
    out["cell"] = torch.where(alive, spec.locate(X + mid_h * DX,
                                                 Y + mid_h * DY,
                                                 Z + mid_h * DZ), -1)
    X, Y, Z = _moved(alive, s, X, Y, Z, DX, DY, DZ)
    out["state"] = (X, Y, Z, L, alive.to(torch.int32))
    return out


def _table_multi_event_cuda(spec, u, kr, ks, state):
    N = state[0].shape[0]
    P = spec.npanels
    if len(state) != 13:
        raise ValueError("table_multi_event: expected 13 state arrays")
    dts = [torch.float32] * 7 + [torch.int32] * 3 + [torch.float32] * 3
    _check_tensors("table_multi_event",
                   [(u, (spec.n_uniform, N), torch.float32),
                    (kr, (P, N), torch.float32), (ks, (P, N), torch.float32)]
                   + [(s, (N,), dt) for s, dt in zip(state, dts)])
    dev = u.device
    a = kernels.TableMultiArgs()
    a.N = N
    a.nlambda = spec.nlambda
    a.npanels = P
    a.min_scatt = spec.min_scatt
    a.xi = spec.xi
    a.one_m_xi = spec.one_m_xi
    a.inv_minred = spec.inv_minred
    _locate_args(a.geo, spec.grid)
    f32_kw = dict(dtype=torch.float32, device=dev)
    i32_kw = dict(dtype=torch.int32, device=dev)
    st_out = [torch.empty(N, **f32_kw) for _ in range(4)] \
        + [torch.empty(N, **i32_kw)]
    cell = torch.empty(N, **i32_kw)
    out = {"state": tuple(st_out), "cell": cell}
    depi = depv = None
    if spec.want_labs:
        depi = out["depi"] = torch.empty(N, **i32_kw)
        depv = out["depv"] = torch.empty(N, **f32_kw)
    _set_ptrs(a, "u kr ks px py pz dx dy dz L alive ns ell L0 t0 dt",
              [u, kr, ks, *state])
    _set_ptrs(a, "opx opy opz oL oalive ocell odepi odepv",
              [*st_out, cell, depi, depv])
    rows = 2 * chunk_rows(P)
    if rows:
        cend = torch.empty((rows, N), dtype=torch.float32, device=dev)
        a.cend = cend.data_ptr()
    lib = kernels.library()
    kernels.check(lib.skirt_table_multi_event(ctypes.byref(a),
                                              int(spec.want_labs),
                                              kernels.stream_of(u)),
                  "table_multi_event kernel")
    table_multi_event.launches += 1
    return out


def table_multi_event(spec: TableMultiEventSpec, u, kr, ks, state):
    """The K5 event on CPU tensors (plain version) or CUDA tensors (the
    kernel, counted in `table_multi_event.launches`)."""
    return _on_device("table_multi_event", table_multi_event_plain,
                      _table_multi_event_cuda, spec, u, kr, ks, state)


table_multi_event.launches = 0


# ---------------------------------------------------------------------------
# the exact peel: column-DDA optical depths toward constant directions
# ---------------------------------------------------------------------------

def exact_peel_work(grid, pos, live, kdirs, ncomp: int = 1):
    """The work of an exact peel from the lanes `live` (bool (N,), None
    for all) at `pos` (N, 3) toward the unit directions `kdirs` (L, 3) on
    a uniform grid: an int64 (2,) tensor of the rays (live lanes x
    directions) and the voxels those rays cross with a positive length
    from the lane's point to where they leave the grid, times `ncomp`.

    Counted from the geometry alone, in float64: a ray crosses one voxel
    more than the walls it passes inside the grid, and along axis i it
    passes the whole numbers strictly between its start and its end in
    voxel units, none along a zero component.  Any implementation of the
    exact peel reads the same work from the same lanes.  The trace's
    peel_rays and peel_voxels counters (rtbench's exact_peel_roofline)."""
    n = (grid.nx, grid.ny, grid.nz)
    p = pos.to(torch.float64)
    # start and direction per axis in voxel units: (1, N) and (L, 1)
    s = [((p[:, i] - grid._lo[i]) / grid._dx[i])[None] for i in range(3)]
    kv = [kdirs[:, i].to(torch.float64)[:, None] / grid._dx[i]
          for i in range(3)]
    inside = torch.ones_like(s[0][0], dtype=torch.bool)
    t_exit = None
    for i in range(3):
        inside = inside & (s[i][0] >= 0) & (s[i][0] < n[i])
        wall = torch.where(kv[i] > 0, float(n[i]), 0.0)
        t_i = torch.where(kv[i] != 0, (wall - s[i])
                          / torch.where(kv[i] != 0, kv[i], 1.0),
                          float("inf"))
        t_exit = t_i if t_exit is None else torch.minimum(t_exit, t_i)
    voxels = 1.0
    for i in range(3):
        end = torch.clamp(s[i] + t_exit * kv[i], 0.0, float(n[i]))
        lo, hi = torch.minimum(s[i], end), torch.maximum(s[i], end)
        walls = torch.clamp(torch.ceil(hi) - torch.floor(lo) - 1.0, min=0.0)
        voxels = voxels + torch.where(kv[i] != 0, walls, 0.0)
    ok = inside if live is None else inside & live
    voxels = torch.where(ok[None] & (t_exit > 0), voxels, 0.0)
    return torch.stack([ok.sum() * kdirs.shape[0],
                        voxels.sum().to(torch.int64) * int(ncomp)])


def make_exact_peel(grid, ds, leaders, graph=False):
    """Exact peel-off column densities toward static leader directions.

    Twin of skirt_tpu/engine/fused_table.py:395-540.  Per leader the
    dominant axis a of the direction is the row axis: every lateral
    (b, c) column the ray crosses contributes the exact overlap integral
    of its piecewise-constant a-profile, so the result is exact for the
    voxel field.  The column crossings are the merged arithmetic
    sequences of the two lateral axes' wall crossings (one sequence when a
    lateral component is zero); the merge is a sort (the TPU's two-pointer
    merge gives the same sequence).  Lanes go in chunks so the (lanes,
    Kp, n_a) gathers stay bounded.  A leader's direction and row tables
    go to a device once (a host-to-device copy of a host array waits for
    the device).

    That plain version (`leader_sums`) runs on CPU tensors.  CUDA tensors
    take the hand-written kernel of csrc/exact_peel.cu
    (`ops.exact_peel.peel_columns`): one launch a pass for all leaders and
    components, walking the same crossings in the same float32 arithmetic
    through the (H, nx, ny, nz) densities, which go to a device once with
    the leaders' constant rows.

    Returns taus(pos, kext_pk, live=None) -> list over leaders of (N,)
    tau = sum_h kext_pk[h] * integral rho_h, with taus.integrals(pos,
    live=None) -> list over leaders of the (H, N) raw integrals of rho_h,
    and the plain version on any device, taus.plain(pos, kext_pk) and
    taus.plain_integrals(pos) (no counters, no span).
    Every lane is integrated; `live` (bool (N,), None for all) names the
    lanes whose depths are used, and only while tracing is on does it
    count: `exact_peel_work` of those lanes goes to the trace's peel
    counters, launched before the `exact_peel` span opens.  skirt_tpu's
    polychromatic multi-component driver gets those by running its peel
    once per component with unit opacities; here one pass over the shared
    crossings gives the same values (each 0 * S + 1 * S is exact).

    `graph` (LifecycleOptions.peel_graph) is accepted and ignored: a
    pass is the kernel's one launch, which a CUDA graph would only wrap
    in copies of its inputs and output."""
    nxyz = (grid.nx, grid.ny, grid.nz)
    lo = np.asarray(grid._lo, np.float64)
    dx = np.asarray(grid._dx, np.float64)
    H = ds.ncomp
    rho3 = [np.asarray(ds.rho[h], np.float32).reshape(nxyz) for h in range(H)]

    per_leader = []           # (the leader's constants, its rows)
    for kvec in leaders:
        ld = exact_peel.leader(kvec, lo, dx, nxyz)
        # rows along axis a, indexed by ib * n_c + ic
        rows = [np.ascontiguousarray(np.moveaxis(r, ld.a, 2).reshape(
            -1, nxyz[ld.a])) for r in rho3]
        per_leader.append((ld, rows))
    on_dev = {}               # (device, leader) -> (rows, direction)
    # the kernel's inputs: the densities (H, nx, ny, nz), the leaders'
    # constants and the grid's float32 box
    lead_rows = np.array([exact_peel.leader_row(ld) for ld, _ in per_leader],
                         np.float32)
    box = tuple(float(e[i]) for i in (0, -1)
                for e in (grid.xb, grid.yb, grid.zb))
    field_dev = {}            # device -> (densities, leader rows)
    kdirs = torch.from_numpy(np.array([ld.k for ld, _ in per_leader]))
    kdirs_dev = {}            # device -> kdirs, the (L, 3) directions

    def cross_seq(p0, s, count):
        """Ray parameters of the wall crossings along one lateral axis
        (`s`, its exact_peel.Crossings)."""
        if not s.active:
            return torch.full(p0.shape[:1] + (count,), float("inf"),
                              dtype=torch.float32, device=p0.device)
        i0 = (p0 - s.lo) * s.inv
        if s.positive:
            first = (torch.ceil(i0) - i0) * s.step
        else:
            first = (i0 - torch.floor(i0)) * s.step
        first = torch.where(first <= s.thr, first + s.step, first)
        m = torch.arange(count, dtype=torch.float32, device=p0.device)[None, :]
        return first[:, None] + m * s.step

    def leader_sums(pos, j):
        """Per component the integral of rho_h along the ray, times
        |k_a| (the a-extent of each column crossing)."""
        ld, rows = per_leader[j]
        a, b, c, Kp = ld.a, ld.b, ld.c, ld.Kp
        sb, sc = ld.lat
        ka, kb, kc = ld.k32[a], ld.k32[b], ld.k32[c]
        dev = pos.device
        key = (dev, j)
        if key not in on_dev:
            on_dev[key] = ([torch.as_tensor(r, device=dev) for r in rows],
                           torch.tensor(ld.k32, dtype=torch.float32,
                                        device=dev))
        rows_t, kdir = on_dev[key]
        pa, pb, pc = pos[:, a], pos[:, b], pos[:, c]
        _, t_exit = grid.ray_span(pos, kdir.expand(pos.shape[0], 3))
        tb = cross_seq(pb, sb, Kp)
        tc = cross_seq(pc, sc, Kp)
        tb = torch.where(tb < t_exit[:, None], tb, float("inf"))
        tc = torch.where(tc < t_exit[:, None], tc, float("inf"))
        if not (sb.active and sc.active):
            # one lateral axis is inactive (e.g. azimuth-0 leaders): the
            # crossing sequence is already sorted
            tall = (tb if sb.active else tc)[:, :Kp - 1]
        else:
            tall = torch.sort(torch.cat([tb, tc], 1), 1).values[:, :Kp - 1]
        zeros = torch.zeros_like(t_exit)[:, None]
        tbnd = torch.cat([zeros, torch.minimum(tall, t_exit[:, None]),
                          t_exit[:, None]], 1)               # (N, Kp + 1)
        t_in = tbnd[:, :-1]
        t_out = tbnd[:, 1:]
        valid = t_out > t_in
        tmid = 0.5 * (t_in + t_out)
        nb_, nc_, na = nxyz[b], nxyz[c], nxyz[a]
        ib = torch.floor((pb[:, None] + tmid * kb - sb.lo)
                         * sb.inv).to(torch.int32)
        ic = torch.floor((pc[:, None] + tmid * kc - sc.lo)
                         * sc.inv).to(torch.int32)
        okc = valid & (ib >= 0) & (ib < nb_) & (ic >= 0) & (ic < nc_)
        col = torch.where(okc, ib * nc_ + ic, 0).long()
        # exact in-column integral over the a-profile
        a_in = pa[:, None] + t_in * ka
        a_out = pa[:, None] + t_out * ka
        a_nearc = torch.minimum(a_in, a_out)
        a_farc = torch.maximum(a_in, a_out)
        edges = ld.lo_a + ld.dx_a * torch.arange(
            na + 1, dtype=torch.float32, device=dev)
        ov = torch.clamp(
            torch.minimum(a_farc[..., None], edges[1:])
            - torch.maximum(a_nearc[..., None], edges[:-1]),
            min=0.0)                                       # (N, Kp, na)
        return [torch.where(okc, (rows_t[h][col] * ov).sum(2), 0.0).sum(1)
                for h in range(H)]

    def inv_ka(j):
        return per_leader[j][0].inv_ka

    def leader_tau(pos, kext_pk, j):
        tau = 0.0
        for kp, sm in zip(kext_pk, leader_sums(pos, j)):
            tau = tau + kp * sm
        return tau * inv_ka(j)

    def chunked(pos, j, fn):
        """fn(pos slice, lane slice) over lanes in chunks, joined on the
        last axis."""
        ld = per_leader[j][0]
        chunk = max(1, _PEEL_CHUNK_FLOATS // (ld.Kp * nxyz[ld.a]))
        if pos.shape[0] <= chunk:
            return fn(pos, slice(None))
        return torch.cat([fn(pos[i:i + chunk], slice(i, i + chunk))
                          for i in range(0, pos.shape[0], chunk)], dim=-1)

    def count(pos, live):
        if not trace.enabled():
            return
        kd = kdirs_dev.get(pos.device)
        if kd is None:
            kd = kdirs_dev[pos.device] = kdirs.to(pos.device)
        trace.count_peel(exact_peel_work(grid, pos, live, kd, H))

    def columns(pos, kext):
        """The kernel's (L, N) optical depths (kext, a list of H (N,)
        opacities) or (L, H, N) integrals (kext None)."""
        f = field_dev.get(pos.device)
        if f is None:
            f = field_dev[pos.device] = (
                torch.from_numpy(np.stack(rho3)).to(pos.device),
                torch.from_numpy(lead_rows).to(pos.device))
        if kext is not None:
            kext = (torch.stack(kext) if H > 1 else kext[0][None])
            kext = kext.contiguous()
        return exact_peel.peel_columns(pos.contiguous(), *f, box, kext)

    def plain_taus(pos, kext_pk):
        return [chunked(pos, j, lambda p, sl, j=j: leader_tau(
            p, [kp[sl] for kp in kext_pk], j))
            for j in range(len(per_leader))]

    def plain_integrals(pos):
        return [chunked(pos, j, lambda p, sl, j=j: torch.stack(
            leader_sums(p, j)) * inv_ka(j))
            for j in range(len(per_leader))]

    def taus(pos, kext_pk, live=None):
        count(pos, live)
        with trace.span("exact_peel"):
            if pos.device.type == "cpu":
                return plain_taus(pos, kext_pk)
            return list(columns(pos, list(kext_pk)).unbind(0))

    def integrals(pos, live=None):
        count(pos, live)
        with trace.span("exact_peel"):
            if pos.device.type == "cpu":
                return plain_integrals(pos)
            return list(columns(pos, None).unbind(0))

    taus.integrals = integrals
    taus.plain, taus.plain_integrals = plain_taus, plain_integrals
    return taus


# ---------------------------------------------------------------------------
# the lifecycle driver
# ---------------------------------------------------------------------------

def make_table_peel(grid, ds, leaders, peel_mode, np_peel, graph=False):
    """The table engines' peel optical depths toward each leader: the exact
    column DDA (make_exact_peel, looked up here at each build; `graph`
    accepted and ignored), or the np_peel-panel quadrature of the staged
    rows ('staged', make_staged_peel)."""
    if peel_mode == "exact":
        return make_exact_peel(grid, ds, leaders, graph=bool(graph))
    return make_staged_peel(grid, ds, leaders, np_peel)


def make_staged_peel(grid, ds, leaders, np_peel):
    """Peel optical depths toward each leader by the np_peel-panel
    quadrature of the table rows (one locate of every panel midpoint per
    leader): taus(pos, kext_pk) -> list over leaders of (N,) tau."""

    def staged(pos, kext_pk, live=None):
        del live                  # the exact peel's work counter only
        with trace.span("staged_peel"):
            return panel_taus(grid, ds, leaders, np_peel, pos, kext_pk)

    return staged


def make_fused_table_lifecycle(grid, dust_system, stellar_system,
                               instruments, options, nlambda: int,
                               launch_fn=None, emission_peeloff: bool = True,
                               scattering_peeloff: bool = True,
                               is_dust_emission=False, mueller=None,
                               io_state: bool = False,
                               max_iterations: int | None = None):
    """Build run_batch(key, ell, L0, tallies) for table densities with the
    event in kernel K4 (one dust component) or K5 (several); polarized
    with a Mueller table `mueller` (one component, skirt_tpu
    fused_table.py:623-635, :774-1046).

    ell (N,) int32 wavelength indices and L0 (N,) float32 launch
    luminosities on the run's device; the tallies (float32 tensors on the
    same device) are updated in place and returned.  Labs bins are
    voxel * nlambda + ell.  With options.count_events the tallies gain
    "nevents": the events run, one per lane alive at an iteration's start
    (scatterings plus the final event of each packet).  The event loop and
    its stop test are common.events'."""
    ds = dust_system
    _validate(grid, ds, stellar_system, instruments, options, mueller,
              io_state, launch_fn)
    p = plan(grid, instruments, options, max_iterations)
    mt = pol.first_table(mueller)
    arith_locate, peel_mode = table_peel_mode(grid, options, p.np_peel)
    H = ds.ncomp
    multi = H > 1
    if multi:
        spec = _build_kernel_multi(grid, options, nlambda, p.npanels,
                                   p.want_labs)
    else:
        spec = _build_kernel(grid, options, nlambda, p.npanels, p.want_labs,
                             arith_locate)
    peels = [make_peel_off(grid, ds, ins) for ins in instruments]
    staged_taus = make_table_peel(grid, ds, p.leaders, peel_mode, p.np_peel,
                                  getattr(options, "peel_graph", False))
    mixes = [c.mix for c in ds.components]

    def run_batch(key, ell, L0, tallies):
        def component_scatter(it, cell, alive_b, dir_old):
            """K5's scatter, torch-side: the component drawn by
            kappa_sca,h * rho_h at the interaction cell, its HG cosine, a
            direction about the incoming one.  Returns the per-component
            weights kappa_sca,h * rho_h and the new directions."""
            safe = torch.clamp(cell, min=0)
            wv_h = [ksca_pk[h] * ds.rho_at(h, safe) for h in range(H)]
            ksc = rng.event_key(k_cycle, it, 11)
            usel = rng.uniform(rng.fold_in(ksc, 0), (n,), dev) \
                * torch.clamp(sum(wv_h), min=1e-30)
            g_sel = g_pk[0]
            acc = wv_h[0]
            for h in range(1, H):
                g_sel = torch.where(usel > acc, g_pk[h], g_sel)
                acc = acc + wv_h[h]
            costh = _hg_costheta(g_sel, rng.uniform_open(
                rng.fold_in(ksc, 1), (n,), dev))
            d = rng.direction_about_axis(rng.fold_in(ksc, 2), dir_old, costh)
            return wv_h, torch.where(alive_b[:, None], d, dir_old)

        def phase_weight(j, cosj):
            """The peel phase weight at the incoming direction: the mix's
            HG, or with several components their blend by
            kappa_sca,h * rho_h at the interaction cell."""
            if not multi:
                return mixes[0].phase_function(ell, cosj)
            total = sum(wv_h)
            w = 0.0
            for h in range(H):
                w = w + wv_h[h] * mixes[h].phase_function(ell, cosj)
            return torch.where(total > 0, w / torch.clamp(total, min=1e-30),
                               0.0)

        def emission_peel(pos_p, contribution, ns_p, live):
            taus0 = staged_taus(pos_p, kext_pk, live)
            emit_mono(peels, ins, p.lead_of, pos_p, ell, contribution,
                      {"nscatt": ns_p, "is_dust": dust}, taus0)

        with trace.span("launch"):
            n = ell.shape[0]
            dev = ell.device
            k_launch, k_cycle = batch_keys(key)
            ell = ell.to(torch.int32).contiguous()
            L0 = L0.to(torch.float32).contiguous()
            pos, direction, L, _ = stellar_system.launch(k_launch, ell, L0)
            alive = L > 0
            ksca_pk, kext_pk = ds.packet_kappas(ell)
            albedo_pk = (ksca_pk[0] / torch.clamp(kext_pk[0], min=1e-37)) \
                .contiguous()
            g_pk = [torch.as_tensor(m.g, device=dev)[ell.long()]
                    .contiguous() for m in mixes]
            ins = tallies["instruments"]
            labs = tallies.get("labs")
            dust = torch.full((n,), bool(is_dust_emission), device=dev)
            ns = torch.zeros(n, dtype=torch.int32, device=dev)
            if emission_peeloff:
                emission_peel(pos, torch.where(alive, L, 0.0), ns, alive)

            pos = pos.contiguous()
            direction = direction.contiguous()
            L = L.to(torch.float32).contiguous()
            alive = alive.to(torch.int32)
            sk = (Stokes(mt, p.leaders, instruments, n, dev, ell=ell)
                  if mt is not None else None)
            bc = torch.ones(n, dtype=torch.int32, device=dev)
            nev = EventCount(p.count_events, dev)

        for it in events(p, lambda: (alive, bc)):
            with trace.span("event"):
                u = uniforms(k_cycle, it, spec.n_uniform, n, dev)
                # -- stage the kappa * rho panel rows (the gather) --------
                with trace.span("stage_gather"):
                    dsg, _, mid = vt.panel_paths(grid, pos, direction,
                                                 p.npanels)
                    t0 = mid[:, 0] - 0.5 * dsg[:, 0]
                    if multi:
                        ks, kr = (r.T.contiguous()
                                  for r in ds.analytic_rows(
                                      pos, direction, mid, ksca_pk, kext_pk))
                    else:
                        kr = ds.analytic_rows(pos, direction, mid, None,
                                              kext_pk, want_sca=False) \
                            .T.contiguous()
                state = lane_columns(pos, direction) + [
                    L, alive, ns, ell, L0, t0.contiguous(),
                    dsg[:, 0].contiguous()]
                if multi:
                    out = table_multi_event(spec, u, kr, ks, state)
                else:
                    out = table_event(spec, u, kr,
                                      state + [albedo_pk, g_pk[0]])
                deposit(labs, out, None if arith_locate
                        else (grid, pos, direction, ell, nlambda))
                count_entry_lanes(alive)
                st = out["state"]
                nev.add(alive)
                dir_old = direction
                pos = torch.stack(st[:3], dim=-1)
                wv_h = None
                if multi:
                    L, alive = st[3], st[4]
                    alive_b = alive != 0
                    wv_h, direction = component_scatter(it, out["cell"],
                                                        alive_b, dir_old)
                    ns = torch.where(alive_b, ns + 1, ns)
                else:
                    direction = torch.stack(st[3:6], dim=-1)
                    L, alive, ns = st[6], st[7], st[8]

            if sk is not None:
                # -- the Mueller scatter overriding the kernel's HG
                # direction; the pre-event Stokes ratios and direction feed
                # both the scatter and the peel (ref: DustMix.cpp:584-620)
                with trace.span("mueller"):
                    pdeg, pang, nrm0, new, nd = pol.mueller_scatter(
                        mt, rng.event_key(k_cycle, it, 13), ell, sk.state,
                        dir_old)
                    scat = alive != 0
                    direction = torch.where(scat[:, None], nd, direction)

            fresh = None
            if p.refill:
                fresh, pos, direction, L, ns, bc, alive = relaunch(
                    stellar_system, rng.event_key(k_cycle, it, 7), p.K, pos,
                    direction, L, ns, bc, alive, ell, L0)

            if scattering_peeloff:
                with trace.span("peel"):
                    alive_b = alive != 0
                    taus0 = staged_taus(pos, kext_pk, alive_b)
                    polarized = (sk.peel(partial(mt.lookup, ell), pdeg, pang,
                                         nrm0, dir_old, fresh)
                                 if sk is not None else None)
                    peel_mono(peels, ins, p.lead_of, pos, ell, L, alive_b,
                              {"nscatt": ns, "is_dust": dust}, taus0,
                              leader_cosines(dir_old, p.leaders),
                              phase_weight, fresh, polarized)
            elif p.refill and emission_peeloff:
                with trace.span("peel"):
                    emission_peel(pos, torch.where(fresh, L, 0.0), ns,
                                  fresh)

            if sk is not None:
                sk.carry(new, scat, fresh)
        nev.into(tallies)
        return tallies

    run_batch.spec = spec
    return run_batch
