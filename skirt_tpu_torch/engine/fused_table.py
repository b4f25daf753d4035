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

from .. import kernels, rng
from ..media import polarization as pol
from ..ops import binned_add
from . import vector_traversal as vt
from .fused import (_CHECK_EVERY, _CUDA_MAXP, _TINY, _expon_cutoff, _f32,
                    _group_leaders, _hg_costheta, _hit_point, _make_locate,
                    _ptr, _scatter_direction)

# lanes per chunk of the exact peel: its (lanes, Kp, n_a) gathers and
# overlaps stay under ~2^26 floats (256 MB) each
_PEEL_CHUNK_FLOATS = 1 << 26


def _uniform_grid(grid) -> bool:
    return bool(hasattr(grid, "_uniform") and all(grid._uniform))


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
    if launch_fn is not None:
        bail("launch_fn (the dust-emission launch) is not ported yet "
             "(slice S3)")
    if io_state:
        bail("io_state not supported")
    if options.continuous_scattering:
        bail("continuous_scattering not supported")
    if options.store_absorption and options.deposition != "sampled":
        bail("absorption tallies require deposition='sampled'")
    peel_mode = getattr(options, "table_peel", "exact")
    if peel_mode == "taumap":
        bail("table_peel='taumap' (compute_rho_path_maps) is not ported yet "
             "(slice S2b)")
    if peel_mode not in ("staged", "exact"):
        bail("table_peel must be 'exact', 'taumap' or 'staged'")
    for ins in instruments:
        if hasattr(ins, "observer_distance") or not hasattr(ins, "kobs"):
            bail("requires distant (constant-direction) instruments")
    if stellar_system is None or stellar_system.ncomp != 1 \
            or not stellar_system.is_isotropic:
        bail("requires a single isotropic stellar component (the others "
             "launch through slice S6)")


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
                  arith_locate=True):
    """The event's constants (mirrors skirt_tpu
    fused_table._build_kernel; arith_locate=False is K4d)."""
    xi = float(options.scatt_bias)
    return TableEventSpec(
        npanels=int(npanels), nlambda=int(nlambda), want_labs=bool(want_labs),
        min_scatt=int(options.min_scatt_events), xi=_f32(xi),
        one_m_xi=_f32(1.0 - xi),
        inv_minred=_f32(1.0 / options.min_weight_reduction), grid=grid,
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
    xi = spec.xi
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
    tau_exp = _expon_cutoff(u[1], taupath)
    if xi == 0.0:
        tau = tau_exp
    else:
        tau = torch.where(u[0] < xi, u[1] * taupath, tau_exp)
        p = torch.exp(-tau) / torch.clamp(one_m_e, min=_TINY)
        # a true division (torch evaluates `scalar / tensor` as
        # reciprocal(tensor) * scalar, which rounds twice)
        qq = spec.one_m_xi * p + (torch.full_like(taupath, xi)
                                  / torch.clamp(taupath, min=_TINY))
        L = torch.where(alive, L * (p / torch.clamp(qq, min=1e-37)), L)
    s = _hit_point(cums, P, tau, t0, delta)
    X = torch.where(alive, X + s * DX, X)
    Y = torch.where(alive, Y + s * DY, Y)
    Z = torch.where(alive, Z + s * DZ, Z)

    # -- Henyey-Greenstein scatter -----------------------------------------
    nx, ny, nz = _scatter_direction(_hg_costheta(g, u[3]), u[4], DX, DY, DZ)
    DX = torch.where(alive, nx, DX)
    DY = torch.where(alive, ny, DY)
    DZ = torch.where(alive, nz, DZ)
    nscatt = torch.where(alive, nscatt + 1, nscatt)

    out["state"] = (X, Y, Z, DX, DY, DZ, L, alive.to(torch.int32), nscatt)
    return out


def direct_deposits(grid, pos, direction, mid_dep, value, wl, width):
    """Absorption bins and values of the deposits of a direct-table event
    (K4d, K6d): the point pos + mid_dep * dir of the PRE-event position
    and direction located with one grid.locate_batched, bins cell * width
    + wl; none (-1, 0) where mid_dep < 0, wl < 0 or the point lies outside
    the grid (skirt_tpu fused_table.py:868-879, fused_table_poly.py:
    977-988)."""
    cell = grid.locate_batched((pos + mid_dep[:, None] * direction)
                               [:, None, :])[:, 0]
    okd = (mid_dep >= 0) & (wl >= 0) & (cell >= 0)
    return (torch.where(okd, cell * width + wl, -1),
            torch.where(okd, value, 0.0))


def _locate_args(a, grid):
    """Fill the arithmetic-locate fields of a kernels.Geom."""
    a.nx, a.ny, a.nz = grid.nx, grid.ny, grid.nz
    for i in range(3):
        a.loc_lo[i] = _f32(grid._lo[i])
        a.loc_inv[i] = _f32(1.0 / grid._dx[i])


def _check_tensors(what, checks):
    dev = checks[0][0].device
    for t, shape, dt in checks:
        if (t.device != dev or tuple(t.shape) != shape or t.dtype != dt
                or not t.is_contiguous()):
            raise ValueError(f"{what} kernel: expected a contiguous {dt} "
                             f"tensor of shape {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def chunk_rows(P: int) -> int:
    """Scratch rows a table kernel's chunked route needs per running sum
    (each panel chunk's last value), 0 on the one-pass route (at most
    MAXP panels): K4, K4d, K6, K6d and K6p keep one sum, K5 two, K7 one."""
    return kernels.nchunks(P) if P > _CUDA_MAXP else 0


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
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    st_out = [torch.empty(N, **f32) for _ in range(7)] \
        + [torch.empty(N, **i32) for _ in range(2)]
    out = {"state": tuple(st_out)}
    depi = depv = depd = None
    if spec.want_labs:
        if spec.arith_locate:
            depi = out["depi"] = torch.empty(N, **i32)
        else:
            depd = out["depd"] = torch.empty(N, **f32)
        depv = out["depv"] = torch.empty(N, **f32)
    for name, t in zip(("u", "kr", "px", "py", "pz", "dx", "dy", "dz", "L",
                        "alive", "ns", "ell", "L0", "t0", "dt", "alb", "g"),
                       [u, kr, *state]):
        setattr(a, name, _ptr(t))
    for name, t in zip(("opx", "opy", "opz", "odx", "ody", "odz", "oL",
                        "oalive", "ons", "odepi", "odepv", "odepd"),
                       [*st_out, depi, depv, depd]):
        setattr(a, name, _ptr(t))
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
    if u.device.type == "cpu":
        return table_event_plain(spec, u, kr, state)
    if u.device.type != "cuda":
        raise ValueError(f"table_event: unsupported device {u.device}")
    return _table_event_cuda(spec, u, kr, state)


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
    xi = float(options.scatt_bias)
    return TableMultiEventSpec(
        npanels=int(npanels), nlambda=int(nlambda), want_labs=bool(want_labs),
        min_scatt=int(options.min_scatt_events), xi=_f32(xi),
        one_m_xi=_f32(1.0 - xi),
        inv_minred=_f32(1.0 / options.min_weight_reduction), grid=grid,
        locate=_make_locate(grid))


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
    xi = spec.xi
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
    tau_exp = _expon_cutoff(u[1], taupath)
    if xi == 0.0:
        tau = tau_exp
    else:
        tau = torch.where(u[0] < xi, u[1] * taupath, tau_exp)
        p = torch.exp(-tau) / torch.clamp(one_m_e, min=_TINY)
        qq = spec.one_m_xi * p + (torch.full_like(taupath, xi)
                                  / torch.clamp(taupath, min=_TINY))
        L = torch.where(alive, L * (p / torch.clamp(qq, min=1e-37)), L)
    s = _hit_point(cums, P, tau, t0, delta)
    mid_h = t0 + (count_below(cums, tau).to(torch.float32) + 0.5) * delta
    # the interaction cell for the torch-side component selection and
    # blended peel: the hit panel's midpoint from the pre-event position
    out["cell"] = torch.where(alive, spec.locate(X + mid_h * DX,
                                                 Y + mid_h * DY,
                                                 Z + mid_h * DZ), -1)
    X = torch.where(alive, X + s * DX, X)
    Y = torch.where(alive, Y + s * DY, Y)
    Z = torch.where(alive, Z + s * DZ, Z)
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
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    st_out = [torch.empty(N, **f32) for _ in range(4)] \
        + [torch.empty(N, **i32)]
    cell = torch.empty(N, **i32)
    out = {"state": tuple(st_out), "cell": cell}
    depi = depv = None
    if spec.want_labs:
        depi = out["depi"] = torch.empty(N, **i32)
        depv = out["depv"] = torch.empty(N, **f32)
    for name, t in zip(("u", "kr", "ks", "px", "py", "pz", "dx", "dy", "dz",
                        "L", "alive", "ns", "ell", "L0", "t0", "dt"),
                       [u, kr, ks, *state]):
        setattr(a, name, _ptr(t))
    for name, t in zip(("opx", "opy", "opz", "oL", "oalive", "ocell",
                        "odepi", "odepv"), [*st_out, cell, depi, depv]):
        setattr(a, name, _ptr(t))
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
    if u.device.type == "cpu":
        return table_multi_event_plain(spec, u, kr, ks, state)
    if u.device.type != "cuda":
        raise ValueError(f"table_multi_event: unsupported device {u.device}")
    return _table_multi_event_cuda(spec, u, kr, ks, state)


table_multi_event.launches = 0


# ---------------------------------------------------------------------------
# the exact peel: column-DDA optical depths toward constant directions
# ---------------------------------------------------------------------------

def make_exact_peel(grid, ds, leaders):
    """Exact peel-off column densities toward static leader directions.

    Twin of skirt_tpu/engine/fused_table.py:395-540.  Per leader the
    dominant axis a of the direction is the row axis: every lateral
    (b, c) column the ray crosses contributes the exact overlap integral
    of its piecewise-constant a-profile, so the result is exact for the
    voxel field.  The column crossings are the merged arithmetic
    sequences of the two lateral axes' wall crossings (one sequence when a
    lateral component is zero); the merge is a sort (the TPU's two-pointer
    merge gives the same sequence).  Lanes go in chunks so the (lanes,
    Kp, n_a) gathers stay bounded.

    Returns taus(pos, kext_pk) -> list over leaders of (N,) tau =
    sum_h kext_pk[h] * integral rho_h, with taus.integrals(pos) -> list
    over leaders of the (H, N) raw integrals of rho_h.  skirt_tpu's
    polychromatic multi-component driver gets those by running its peel
    once per component with unit opacities; here one pass over the shared
    crossings gives the same values (each 0 * S + 1 * S is exact)."""
    nxyz = (grid.nx, grid.ny, grid.nz)
    lo = np.asarray(grid._lo, np.float64)
    dx = np.asarray(grid._dx, np.float64)
    hi = lo + np.asarray(nxyz) * dx
    H = ds.ncomp
    rho3 = [np.asarray(ds.rho[h], np.float32).reshape(nxyz) for h in range(H)]

    per_leader = []
    for kvec in leaders:
        k = np.asarray(kvec, np.float64)
        a = int(np.argmax(np.abs(k)))
        b, c = [i for i in range(3) if i != a]
        # rows along axis a, indexed by ib * n_c + ic
        rows = [np.ascontiguousarray(np.moveaxis(r, a, 2).reshape(-1, nxyz[a]))
                for r in rho3]
        # max in-domain ray length along k, bounded per axis
        ext = hi - lo
        Dk = min(float(ext[i] / abs(k[i])) for i in range(3)
                 if abs(k[i]) > 1e-12)
        cb = int(np.floor(Dk * abs(k[b]) / dx[b])) + 1
        cc = int(np.floor(Dk * abs(k[c]) / dx[c])) + 1
        Kp = min(cb + cc + 1, nxyz[b] + nxyz[c] + 1)
        per_leader.append((k, a, b, c, rows, Kp))
    rows_dev = {}

    def cross_seq(p0, kk, loi, dxi, count):
        """Ray parameters of the wall crossings along one lateral axis."""
        if abs(kk) < 1e-12:
            return torch.full(p0.shape[:1] + (count,), float("inf"),
                              dtype=torch.float32, device=p0.device)
        i0 = (p0 - _f32(loi)) * _f32(1.0 / dxi)
        step = np.float32(abs(dxi / kk))
        if kk > 0:
            first = (torch.ceil(i0) - i0) * _f32(dxi / kk)
        else:
            first = (i0 - torch.floor(i0)) * _f32(-dxi / kk)
        first = torch.where(first <= float(1e-6 * step), first + float(step),
                            first)
        m = torch.arange(count, dtype=torch.float32, device=p0.device)[None, :]
        return first[:, None] + m * float(step)

    def leader_sums(pos, j):
        """Per component the integral of rho_h along the ray, times
        |k_a| (the a-extent of each column crossing)."""
        k, a, b, c, rows, Kp = per_leader[j]
        ka, kb, kc = float(k[a]), float(k[b]), float(k[c])
        dev = pos.device
        key = (dev, j)
        if key not in rows_dev:          # one host->device copy per device
            rows_dev[key] = [torch.as_tensor(r, device=dev) for r in rows]
        rows_t = rows_dev[key]
        pa, pb, pc = pos[:, a], pos[:, b], pos[:, c]
        kdir = torch.as_tensor(np.asarray(k, np.float32),
                               device=dev).expand(pos.shape[0], 3)
        _, t_exit = grid.ray_span(pos, kdir)
        tb = cross_seq(pb, kb, lo[b], dx[b], Kp)
        tc = cross_seq(pc, kc, lo[c], dx[c], Kp)
        tb = torch.where(tb < t_exit[:, None], tb, float("inf"))
        tc = torch.where(tc < t_exit[:, None], tc, float("inf"))
        if abs(kb) < 1e-12 or abs(kc) < 1e-12:
            # one lateral axis is inactive (e.g. azimuth-0 leaders): the
            # crossing sequence is already sorted
            tall = (tc if abs(kb) < 1e-12 else tb)[:, :Kp - 1]
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
        ib = torch.floor((pb[:, None] + tmid * _f32(kb) - _f32(lo[b]))
                         * _f32(1.0 / dx[b])).to(torch.int32)
        ic = torch.floor((pc[:, None] + tmid * _f32(kc) - _f32(lo[c]))
                         * _f32(1.0 / dx[c])).to(torch.int32)
        okc = valid & (ib >= 0) & (ib < nb_) & (ic >= 0) & (ic < nc_)
        col = torch.where(okc, ib * nc_ + ic, 0).long()
        # exact in-column integral over the a-profile
        a_in = pa[:, None] + t_in * _f32(ka)
        a_out = pa[:, None] + t_out * _f32(ka)
        a_nearc = torch.minimum(a_in, a_out)
        a_farc = torch.maximum(a_in, a_out)
        edges = _f32(lo[a]) + _f32(dx[a]) * torch.arange(
            na + 1, dtype=torch.float32, device=dev)
        ov = torch.clamp(
            torch.minimum(a_farc[..., None], edges[1:])
            - torch.maximum(a_nearc[..., None], edges[:-1]),
            min=0.0)                                       # (N, Kp, na)
        return [torch.where(okc, (rows_t[h][col] * ov).sum(2), 0.0).sum(1)
                for h in range(H)]

    def inv_ka(j):
        return _f32(1.0 / max(abs(per_leader[j][0][per_leader[j][1]]),
                              1e-12))

    def leader_tau(pos, kext_pk, j):
        tau = 0.0
        for kp, sm in zip(kext_pk, leader_sums(pos, j)):
            tau = tau + kp * sm
        return tau * inv_ka(j)

    def chunked(pos, j, fn):
        """fn(pos slice, lane slice) over lanes in chunks, joined on the
        last axis."""
        _, a, _, _, _, Kp = per_leader[j]
        chunk = max(1, _PEEL_CHUNK_FLOATS // (Kp * nxyz[a]))
        if pos.shape[0] <= chunk:
            return fn(pos, slice(None))
        return torch.cat([fn(pos[i:i + chunk], slice(i, i + chunk))
                          for i in range(0, pos.shape[0], chunk)], dim=-1)

    def taus(pos, kext_pk):
        return [chunked(pos, j, lambda p, sl, j=j: leader_tau(
            p, [kp[sl] for kp in kext_pk], j))
            for j in range(len(per_leader))]

    def integrals(pos):
        return [chunked(pos, j, lambda p, sl, j=j: torch.stack(
            leader_sums(p, j)) * inv_ka(j)) for j in range(len(per_leader))]

    taus.integrals = integrals
    return taus


# ---------------------------------------------------------------------------
# the lifecycle driver
# ---------------------------------------------------------------------------

def _warn_staged_peel(grid, np_peel=None):
    """skirt_tpu's warning when table_peel='exact' meets a grid without the
    column DDA (a direct-table grid) and the peel runs staged."""
    import warnings

    warnings.warn(
        "table_peel='exact' needs a uniform Cartesian (voxel) grid; "
        "downgrading to 'staged' "
        + (f"({np_peel} panels) " if np_peel is not None else "")
        + f"on {type(grid).__name__} — peel "
        "flux carries a panel quadrature bias (use >=32 panels)",
        stacklevel=3)


def _staged_taus_fn(grid, ds, leaders, peel_mode, np_peel):
    """Peel optical depths toward each leader: the exact column DDA, or the
    P_peel panel quadrature of the staged rows ('staged')."""
    if peel_mode == "exact":
        return make_exact_peel(grid, ds, leaders)
    return make_staged_peel(grid, ds, leaders, np_peel)


def make_staged_peel(grid, ds, leaders, np_peel):
    """Peel optical depths toward each leader by the np_peel-panel
    quadrature of the table rows (one locate of every panel midpoint per
    leader): taus(pos, kext_pk) -> list over leaders of (N,) tau."""

    def staged(pos, kext_pk):
        taus = []
        for kvec in leaders:
            kobs = torch.as_tensor(np.asarray(kvec, np.float32),
                                   device=pos.device).expand(pos.shape[0], 3)
            dsg, _, mid = vt.panel_paths(grid, pos, kobs, np_peel)
            rows = ds.analytic_rows(pos, kobs, mid, None, kext_pk,
                                    want_sca=False)
            taus.append((rows * dsg).sum(1))
        return taus

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
    (scatterings plus the final event of each packet).

    The event loop runs at most max_scatt_events * K iterations and stops
    when no lane is alive and no lane has launch budget left; the host
    reads that condition every _CHECK_EVERY iterations (an iteration over
    finished lanes changes nothing)."""
    from .lifecycle import hg_costheta, make_peel_off

    ds = dust_system
    _validate(grid, ds, stellar_system, instruments, options, mueller,
              io_state, launch_fn)
    npanels = int(options.quadrature_panels
                  or getattr(grid, "max_steps", 96))
    np_peel = int(options.peel_panels or npanels)
    want_labs = bool(options.store_absorption)
    leaders, lead_of = _group_leaders(instruments)
    mt = pol.first_table(mueller)
    peel_mode = getattr(options, "table_peel", "exact")
    arith_locate = _uniform_grid(grid)
    if peel_mode == "exact" and not arith_locate:
        _warn_staged_peel(grid, np_peel)
        peel_mode = "staged"
    refill = options.refill_batches > 1
    K = int(options.refill_batches) if refill else 1
    H = ds.ncomp
    multi = H > 1
    if multi:
        spec = _build_kernel_multi(grid, options, nlambda, npanels, want_labs)
    else:
        spec = _build_kernel(grid, options, nlambda, npanels, want_labs,
                             arith_locate)
    peels = [make_peel_off(grid, ds, ins) for ins in instruments]
    staged_taus = _staged_taus_fn(grid, ds, leaders, peel_mode, np_peel)
    mixes = [c.mix for c in ds.components]
    iter_cap = int(max_iterations if max_iterations is not None
                   else options.max_scatt_events) * K
    count_events = bool(getattr(options, "count_events", False))

    def run_batch(key, ell, L0, tallies):
        n = ell.shape[0]
        dev = ell.device
        k_launch, k_cycle = rng.split(rng.event_key(key, 1))
        ell = ell.to(torch.int32).contiguous()
        L0 = L0.to(torch.float32).contiguous()
        pos, direction, L, _ = stellar_system.launch(k_launch, ell, L0)
        alive = L > 0
        ksca_pk, kext_pk = ds.packet_kappas(ell)
        albedo_pk = (ksca_pk[0] / torch.clamp(kext_pk[0], min=1e-37)) \
            .contiguous()
        g_pk = [torch.as_tensor(m.g, device=dev)[ell.long()].contiguous()
                for m in mixes]
        ins = tallies["instruments"]
        labs = tallies.get("labs")
        dust = torch.full((n,), bool(is_dust_emission), device=dev)

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
            costh = hg_costheta(g_sel, rng.uniform_open(rng.fold_in(ksc, 1),
                                                        (n,), dev))
            d = rng.direction_about_axis(rng.fold_in(ksc, 2), dir_old, costh)
            return wv_h, torch.where(alive_b[:, None], d, dir_old)

        def phase_weight(cosj, wv_h):
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

        def emission_peel(pos_p, contribution, ns_p):
            taus0 = staged_taus(pos_p, kext_pk)
            tags = {"nscatt": ns_p, "is_dust": dust}
            for i, peel in enumerate(peels):
                peel(ins[i], pos_p, ell, contribution, tags,
                     tau=taus0[lead_of[i]])

        ns = torch.zeros(n, dtype=torch.int32, device=dev)
        if emission_peeloff:
            emission_peel(pos, torch.where(alive, L, 0.0), ns)

        pos = pos.contiguous()
        direction = direction.contiguous()
        L = L.to(torch.float32).contiguous()
        alive = alive.to(torch.int32)
        if mt is not None:
            # normalized Stokes ratios and the reference normal; packets
            # launch unpolarized (a zero normal: no reference yet)
            stokes = (torch.zeros(n, device=dev), torch.zeros(n, device=dev),
                      torch.zeros(n, device=dev),
                      torch.zeros((n, 3), device=dev))
            pf = mt.table("pfnorm", dev)[ell.long()]
            kobs_lead = pol.observer_rows(leaders, n, dev)
            ky_ins = pol.frame_axes(instruments, n, dev)
        bc = torch.ones(n, dtype=torch.int32, device=dev)
        nev = torch.zeros((), dtype=torch.float32, device=dev)

        for it in range(iter_cap):
            if it % _CHECK_EVERY == 0:
                go = alive.any()
                if refill:
                    go = go | (bc < K).any()
                if not bool(go):
                    break
            u = rng.uniform_open(rng.event_key(k_cycle, it),
                                 (spec.n_uniform, n), dev)
            # -- stage the kappa * rho panel rows (the gather) ------------
            dsg, _, mid = vt.panel_paths(grid, pos, direction, npanels)
            t0 = mid[:, 0] - 0.5 * dsg[:, 0]
            state = [pos[:, 0].contiguous(), pos[:, 1].contiguous(),
                     pos[:, 2].contiguous(), direction[:, 0].contiguous(),
                     direction[:, 1].contiguous(),
                     direction[:, 2].contiguous(), L, alive, ns, ell, L0,
                     t0.contiguous(), dsg[:, 0].contiguous()]
            if multi:
                ks, kr = (r.T.contiguous() for r in ds.analytic_rows(
                    pos, direction, mid, ksca_pk, kext_pk))
                out = table_multi_event(spec, u, kr, ks, state)
            else:
                kr = ds.analytic_rows(pos, direction, mid, None, kext_pk,
                                      want_sca=False).T.contiguous()
                out = table_event(spec, u, kr,
                                  state + [albedo_pk, g_pk[0]])
            if want_labs and labs is not None:
                if arith_locate:
                    binned_add(labs, out["depi"], out["depv"])
                else:
                    binned_add(labs, *direct_deposits(
                        grid, pos, direction, out["depd"], out["depv"], ell,
                        nlambda))
            st = out["state"]
            if count_events:
                nev = nev + alive.sum().to(torch.float32)
            dir_old = direction
            pos = torch.stack(st[:3], dim=-1)
            wv_h = None
            if multi:
                L, alive = st[3], st[4]
                alive_b = alive != 0
                wv_h, direction = component_scatter(it, out["cell"], alive_b,
                                                    dir_old)
                ns = torch.where(alive_b, ns + 1, ns)
            else:
                direction = torch.stack(st[3:6], dim=-1)
                L, alive, ns = st[6], st[7], st[8]

            if mt is not None:
                # -- the Mueller scatter overriding the kernel's HG
                # direction; the pre-event Stokes ratios and direction feed
                # both the scatter and the peel (ref: DustMix.cpp:584-620)
                pdeg, pang, nrm0, new, nd = pol.mueller_scatter(
                    mt, rng.event_key(k_cycle, it, 13), ell, stokes, dir_old)
                scat = alive != 0
                direction = torch.where(scat[:, None], nd, direction)

            # -- torch-side relaunch (refill) ------------------------------
            fresh = None
            if refill:
                fresh = (alive == 0) & (bc < K)
                kre = rng.event_key(k_cycle, it, 7)
                pos_l, dir_l, L_l, _ = stellar_system.launch(kre, ell, L0)
                f3 = fresh[:, None]
                pos = torch.where(f3, pos_l, pos)
                direction = torch.where(f3, dir_l, direction)
                L = torch.where(fresh, L_l, L)
                ns = torch.where(fresh, 0, ns)
                bc = bc + fresh.to(torch.int32)
                alive = alive | fresh.to(torch.int32)

            # -- merged peel-off: scattered lanes with the phase weight at
            # the incoming direction, fresh lanes with the (isotropic)
            # emission weight ---------------------------------------------
            alive_b = alive != 0
            if scattering_peeloff:
                taus0 = staged_taus(pos, kext_pk)
                tags = {"nscatt": ns, "is_dust": dust}
                if mt is not None:
                    speel = pol.StokesPeel(partial(mt.lookup, ell), pf,
                                           stokes, pdeg, pang, nrm0, dir_old,
                                           fresh)
                for i, peel in enumerate(peels):
                    j = lead_of[i]
                    kx, ky, kz = (_f32(v) for v in leaders[j])
                    cosj = (dir_old[:, 0] * kx + dir_old[:, 1] * ky
                            + dir_old[:, 2] * kz)
                    tg = tags
                    if mt is not None:
                        # the Mueller peel toward the leader, in this
                        # instrument's frame
                        w, stk = speel(j, cosj, kobs_lead[j], ky_ins[i])
                        tg = dict(tags, stokes=stk)
                    else:
                        w = phase_weight(cosj, wv_h)
                    if refill:
                        w = torch.where(fresh, 1.0, w)
                    con = torch.where(alive_b, L * w, 0.0)
                    peel(ins[i], pos, ell, con, tg, tau=taus0[j])
            elif refill and emission_peeloff:
                emission_peel(pos, torch.where(fresh, L, 0.0), ns)

            if mt is not None:
                stokes = pol.carry_stokes(stokes, new, scat, fresh)
        if count_events:
            tallies["nevents"] = tallies.get("nevents", 0.0) + nev
        return tallies

    run_batch.spec = spec
    return run_batch
