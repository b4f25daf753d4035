"""Polychromatic fused table events (kernels K6 and K7) and their
lifecycle driver.

Twin of skirt_tpu/engine/fused_table_poly.py on a uniform Cartesian
(voxel) grid or, with one dust component, directly on a grid with device
point location (the exact Voronoi tessellation, an uneven Cartesian
grid).  Every lane carries the full W-wavelength vector on one
mixture-sampled geometric path: the staged rho panels and the exact
column-DDA peel integrals are wavelength-independent, so one gather
serves all W wavelengths.  The estimator is the defensive-mixture
importance sampling derived in the module docstring of
skirt_tpu/engine/fused_table_poly.py (the same as the analytic K1's).
One dust component runs kernel K6 on (P, N) raw rho panels; H > 1
components run kernel K7 on H raw rho row sets (one locate, H gathers)
with the per-(component, wavelength) opacities and g blended in the
kernel: the interaction point is drawn in path length from the
uniform-driver mixture, the deposit at a second forced-pdf point, and
the scatter from the driver wavelength's component-blended HG.  The peel
then weights each wavelength by the components' blended phase function at
the located new cell.

On a direct-table grid K6 runs as K6d (skirt_tpu's arith_locate=False):
the kernel emits the sampled deposit wavelength, the deposit total and its
distance along the pre-event ray, and the lifecycle locates pos + mid_dep *
dir with one `grid.locate_batched` per iteration and forms the bin cell *
W + wsel (fused_table.direct_deposits).  table_peel='exact' downgrades to
the staged panel peel there, with skirt_tpu's warning.

Each event has two implementations with one input/output contract:
- `table_poly_event_plain` / `table_poly_multi_event_plain`: plain
  PyTorch on (W, N) tensors, any device.  They are the specs the CPU
  tests hold against the Pallas bodies (interpret mode) and the
  references `chip_smoke.py` holds the CUDA kernels against.
- csrc/fused_table_poly.cu (K6) and csrc/fused_table_poly_multi.cu (K7):
  the hand-written CUDA kernels, one thread per lane.
`table_poly_event` / `table_poly_multi_event` take the plain version for
CPU tensors and launch the kernel (or raise) for CUDA tensors.

Layouts (N lanes, no padding).  K6: u (7, N); r (P, N) raw rho panels; oc
(3, W) = kext, albedo, g.  K7: u (8, N); r (H * P, N) raw rho panels,
h-major; oc (3H, W) = kext rows, ksca rows, g rows.  Both: L, L0, Ln, Lp
(W, N); state px, py, pz, dx, dy, dz float32, alive, ns int32, t0, dt
float32, each (N,); depi int32 / depv float32 (N,); K6d: depi is the
deposit wavelength, plus depd float32 (N,), the deposit distance (-1 for
none); K6p: I_s and I_tot float32 (N,), on every lane.

With a Mueller table K6 runs as K6p (skirt_tpu's want_pol): it also
emits the raw column densities at the sampled interaction point and over
the whole path, and the driver carries the Stokes state and runs the
Mueller scatter and the polarized peel torch-side (see
make_fused_table_poly_lifecycle).

Not ported here, refusing with its slice: the dust-emission launch (S3).

ref: SKIRTcore/MonteCarloSimulation.cpp:438-549 event chain.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels, rng, trace
from ..media import polarization as pol
from ..numerics import f32
from ..ops.peel_sed import LeaderCosines, wavelengths
from . import vector_traversal as vt
from .common import (EventCount, PeelForm, SingleMix, Stokes, _CUDA_MAXP,
                     _TINY, _check_tensors, _expon_cutoff, _hg, _hg_costheta,
                     _invert, _locate_args, _make_locate, _moved, _on_device,
                     _scattered, _set_ptrs, _uniform_grid, batch_keys,
                     check_shared, chunk_rows, count_entry_lanes, deposit,
                     emit_poly, events, lane_columns, peel_poly, plan,
                     relaunch, table_peel_mode, uniforms)
from .fused_table import make_table_peel


def _validate(grid, ds, stellar_system, instruments, options, nlambda,
              mueller, io_state, launch_fn):
    def bail(msg):
        raise ValueError(f"polychromatic table lifecycle: {msg}")

    if ds is None or not getattr(ds, "table", False):
        bail("requires density_mode='table' (voxelized().as_table())")
    if not (hasattr(grid, "ray_span") and hasattr(grid, "locate_batched")):
        bail("requires a grid with ray_span + locate_batched (uniform "
             "Cartesian voxel view, or a direct-table grid such as the "
             "exact Voronoi tessellation)")
    if ds.ncomp != 1 and not _uniform_grid(grid):
        bail("multi-component mode needs the uniform Cartesian voxel "
             "view (per-component raw rows + in-kernel blending)")
    polarized = pol.first_table(mueller) is not None
    if polarized and ds.ncomp != 1:
        bail("polarization supports a single dust component")
    if polarized and launch_fn is not None:
        bail("polarization with launch_fn (dust phases) not supported (dust "
             "re-emission launches unpolarized; use the monochromatic "
             "kernel)")
    if getattr(options, "table_peel", "exact") == "taumap":
        bail("table_peel='taumap' is per-wavelength; use 'exact'")
    if nlambda > 128:
        bail("nlambda <= 128 (split wider grids into blocks of <= 128 "
             "wavelengths)")
    if polarized and not stellar_system.is_isotropic:
        bail("polarized mode with anisotropic stellar emission is not "
             "supported")
    check_shared(bail, stellar_system, instruments, options, io_state,
                 launch_fn)


def _sum_block(W: int) -> int:
    """Block length of XLA's CPU reduction over W wavelengths: the largest
    divisor of W not above 32 (see _wsum)."""
    return max(d for d in range(1, min(W, 32) + 1) if W % d == 0)


def _wsum(x):
    """Sum over the wavelength axis in the order XLA's CPU backend takes for
    the Pallas body's jnp.sum(., axis=0), which the CPU tests run: blocks
    of _sum_block(W) consecutive wavelengths each summed in order, then
    the block sums in order (found on the CPU: exact for every W <= 32,
    every even W <= 64, and W = 96 and 128; other W differ there).  The
    CUDA kernel sums in the same order."""
    W = x.shape[0]
    B = _sum_block(W)
    total = None
    for j in range(0, W, B):
        part = x[j]
        for w in range(j + 1, j + B):
            part = part + x[w]
        total = part if total is None else total + part
    return total


def _cumsum_w(x):
    """Inclusive prefix sum over the wavelength axis as the Pallas body
    forms it: log2(W) shifted adds (Hillis-Steele), not a running sum."""
    W = x.shape[0]
    s = 1
    while s < W:
        x = x + torch.cat([torch.zeros_like(x[:s]), x[:-s]])
        s *= 2
    return x


@dataclass
class TablePolyEventSpec:
    """The constants the K6 event closes over (skirt_tpu
    fused_table_poly._build_kernel): float32 values as Python floats, the
    (3, W) optical constants, the grid: with arith_locate its uniform
    voxels are located in the kernel, without (K6d) the deposit distance
    goes out instead."""
    W: int
    npanels: int
    want_labs: bool
    min_scatt: int
    xi: float
    one_m_xi: float
    inv_W: float
    inv_minred: float
    oc: np.ndarray                   # (3, W) float32
    grid: object
    n_uniform: int = 7
    arith_locate: bool = True
    locate: object = field(default=None, repr=False)
    want_pol: bool = False


def _build_kernel(grid, ds, options, W, npanels, want_labs,
                  arith_locate=True, want_pol=False):
    """The event's constants (mirrors skirt_tpu
    fused_table_poly._build_kernel; arith_locate=False is K6d, want_pol
    K6p): oc = the float32 kappa_ext, albedo and g of the mix per
    wavelength."""
    mix = ds.components[0].mix
    oc = np.stack([np.asarray(ds.kappaext[0][:W], np.float32),
                   np.asarray(mix.albedo[:W], np.float32),
                   np.asarray(mix.g[:W], np.float32)])
    xi = float(options.scatt_bias)
    return TablePolyEventSpec(
        W=int(W), npanels=int(npanels), want_labs=bool(want_labs),
        min_scatt=int(options.min_scatt_events), xi=f32(xi),
        one_m_xi=f32(1.0 - xi), inv_W=f32(1.0 / W),
        inv_minred=f32(1.0 / options.min_weight_reduction),
        oc=np.ascontiguousarray(oc), grid=grid,
        arith_locate=bool(arith_locate),
        locate=_make_locate(grid) if arith_locate else None,
        want_pol=bool(want_pol))


def table_poly_event_plain(spec: TablePolyEventSpec, u, r, oc, L, L0, state):
    """One polychromatic table event for every lane, plain PyTorch.

    Mirrors the Pallas body (skirt_tpu/engine/fused_table_poly.py:160-350)
    operation for operation.  Returns a dict: "state" (px, py, pz, dx, dy,
    dz, alive, ns), "Ln", "Lp" and with labs "depi"/"depv"; for K6d
    (arith_locate False) depi is the deposit wavelength and "depd" the
    deposit's distance along the pre-event ray (-1 for none); for K6p
    (want_pol) "I_s" and "I_tot", the raw column densities at the sampled
    interaction point and over the whole path, on every lane."""
    W = spec.W
    P = spec.npanels
    X, Y, Z, DX, DY, DZ = state[:6]
    alive = state[6] != 0
    nscatt = state[7]
    t0, delta = state[8], state[9]
    xi = spec.xi
    out = {}

    # -- cumulative column density I_k (lambda-independent) -------------
    cum = torch.zeros_like(delta)
    cums = []
    for kk in range(P):
        cum = cum + r[kk] * delta
        cums.append(cum)
    I_tot = cum
    cums_t = torch.stack(cums)

    kext = oc[0][:, None]
    alb = oc[1][:, None]
    gw = oc[2][:, None]
    tau = kext * I_tot[None]
    ome = 1.0 - torch.exp(-tau)
    Lm = torch.where(alive[None], L, 0.0)

    def count_below(x):
        # panel pick: number of cumulative sums (all but the last) < x
        return (cums_t[:P - 1] < x[None]).sum(0).to(torch.int32)

    # -- absorption deposit: one sampled wavelength per event ------------
    if spec.want_labs:
        D = (1.0 - alb) * Lm * ome
        Dsum = _wsum(D)
        target = u[6] * Dsum
        if W > 1:
            wsel = (_cumsum_w(D)[:W - 1] <= target[None]).sum(0) \
                .to(torch.int32)
        else:
            wsel = torch.zeros_like(nscatt)
        w64 = wsel.long()
        tau_sel = tau.gather(0, w64[None])[0]
        kinv_sel = 1.0 / oc[0][w64]
        I_dep = _expon_cutoff(u[2], tau_sel) * kinv_sel
        i_dep = count_below(I_dep)
        mid_dep = t0 + (i_dep.to(torch.float32) + 0.5) * delta
        okd = (Dsum > 0) & alive
        if spec.arith_locate:
            cell = spec.locate(X + mid_dep * DX, Y + mid_dep * DY,
                               Z + mid_dep * DZ)
            okd = okd & (cell >= 0)
            out["depi"] = torch.where(okd, cell * W + wsel, -1)
        else:
            # the bin cell * W + wsel is finished after a locate of
            # pos + mid_dep * dir (direct_deposits)
            out["depi"] = torch.where(okd, wsel, -1)
            out["depd"] = torch.where(okd, mid_dep, -1.0)
        out["depv"] = torch.where(okd, Dsum, 0.0)

    Lab = alb * Lm * ome

    # -- mixture-driver forced propagation -------------------------------
    c = torch.clamp((u[5] * float(W)).to(torch.int32), max=W - 1)
    c64 = c.long()
    tau_c = tau.gather(0, c64[None])[0]
    kinv_cc = 1.0 / oc[0][c64]
    g_cc = oc[2][c64]
    tau_exp = _expon_cutoff(u[1], tau_c)
    if xi == 0.0:
        tau_smp = tau_exp
    else:
        tau_smp = torch.where(u[0] < xi, u[1] * tau_c, tau_exp)
    I_s = tau_smp * kinv_cc

    i_hit, frac = _invert(cums_t, P, I_s)
    s = t0 + (i_hit.to(torch.float32) + frac) * delta
    X, Y, Z = _moved(alive, s, X, Y, Z, DX, DY, DZ)

    # -- per-wavelength mixture ratios (arithmetic in I_s) ---------------
    F = kext * torch.exp(-kext * I_s[None]) / torch.clamp(ome, min=_TINY)
    if xi == 0.0:
        Q = F
    else:
        Q = spec.one_m_xi * F + xi * kext / torch.clamp(tau, min=_TINY)
    Qmix = _wsum(Q) * spec.inv_W

    # -- Henyey-Greenstein scatter with the driver's g -------------------
    costheta = _hg_costheta(g_cc, u[3])
    HG = _hg(gw, costheta[None])
    QHmix = _wsum(Q * HG) * spec.inv_W

    # peel luminosity: s-marginal weight; onward: joint weight
    Lp = Lab * F / torch.clamp(Qmix[None], min=_TINY)
    Ln = Lab * F * HG / torch.clamp(QHmix[None], min=_TINY)

    # per-wavelength termination (ref: MonteCarloSimulation.cpp:44-50)
    past_min = nscatt >= spec.min_scatt
    kill = (Ln <= L0 * spec.inv_minred) & past_min[None]
    Lp = torch.where(kill, 0.0, Lp)
    Ln = torch.where(kill, 0.0, Ln)
    alive = alive & (Ln > 0).any(0) & (I_tot > _TINY)

    DX, DY, DZ, nscatt = _scattered(alive, costheta, u[4], DX, DY, DZ,
                                    nscatt)

    out["state"] = (X, Y, Z, DX, DY, DZ, alive.to(torch.int32), nscatt)
    out["Ln"] = torch.where(alive[None], Ln, 0.0)
    out["Lp"] = torch.where(alive[None], Lp, 0.0)
    if spec.want_pol:
        out["I_s"] = I_s
        out["I_tot"] = I_tot
    return out


def _table_poly_event_cuda(spec, u, r, oc, L, L0, state):
    N = state[0].shape[0]
    W = spec.W
    P = spec.npanels
    if W > kernels.TablePolyArgs.MAX_W:
        raise ValueError("table_poly_event kernel: nlambda <= 128 (split "
                         "wider grids into blocks of <= 128 wavelengths)")
    if len(state) != 10:
        raise ValueError("table_poly_event: expected 10 state arrays")
    dts = [torch.float32] * 6 + [torch.int32] * 2 + [torch.float32] * 2
    _check_tensors("table_poly_event",
                   [(u, (spec.n_uniform, N), torch.float32),
                    (r, (P, N), torch.float32), (oc, (3, W), torch.float32),
                    (L, (W, N), torch.float32), (L0, (W, N), torch.float32)]
                   + [(s, (N,), dt) for s, dt in zip(state, dts)])
    dev = u.device
    a = kernels.TablePolyArgs()
    a.N = N
    a.W = W
    a.npanels = P
    a.min_scatt = spec.min_scatt
    a.sum_block = _sum_block(W)
    a.xi = spec.xi
    a.one_m_xi = spec.one_m_xi
    a.inv_W = spec.inv_W
    a.inv_minred = spec.inv_minred
    a.direct = int(not spec.arith_locate)
    a.pol = int(spec.want_pol)
    if spec.arith_locate:
        _locate_args(a.geo, spec.grid)
    f32_kw = dict(dtype=torch.float32, device=dev)
    i32_kw = dict(dtype=torch.int32, device=dev)
    st_out = [torch.empty(N, **f32_kw) for _ in range(6)] \
        + [torch.empty(N, **i32_kw) for _ in range(2)]
    Ln = torch.empty((W, N), **f32_kw)
    Lp = torch.empty((W, N), **f32_kw)
    out = {"state": tuple(st_out), "Ln": Ln, "Lp": Lp}
    depi = depv = depd = None
    if spec.want_labs:
        depi = out["depi"] = torch.empty(N, **i32_kw)
        depv = out["depv"] = torch.empty(N, **f32_kw)
        if not spec.arith_locate:
            depd = out["depd"] = torch.empty(N, **f32_kw)
    Is = It = None
    if spec.want_pol:
        Is = out["I_s"] = torch.empty(N, **f32_kw)
        It = out["I_tot"] = torch.empty(N, **f32_kw)
    _set_ptrs(a, "u r oc L L0 px py pz dx dy dz alive ns t0 dt",
              [u, r, oc, L, L0, *state])
    _set_ptrs(a, "opx opy opz odx ody odz oalive ons oLn oLp odepi odepv "
              "odepd oIs oIt", [*st_out, Ln, Lp, depi, depv, depd, Is, It])
    rows = chunk_rows(P)
    if rows:
        cend = torch.empty((rows, N), dtype=torch.float32, device=dev)
        a.cend = cend.data_ptr()
    lib = kernels.library()
    kernels.check(lib.skirt_table_poly_event(ctypes.byref(a),
                                             int(spec.want_labs),
                                             kernels.stream_of(u)),
                  "table_poly_event kernel")
    table_poly_event.launches += 1
    if not spec.arith_locate:
        table_poly_event.direct_launches += 1
    if spec.want_pol:
        table_poly_event.pol_launches += 1
    return out


def table_poly_event(spec: TablePolyEventSpec, u, r, oc, L, L0, state):
    """The event on CPU tensors (plain version) or CUDA tensors (the K6
    kernel, K6d without arith_locate, K6p with want_pol, counted in
    `table_poly_event.launches`, K6d also in
    `table_poly_event.direct_launches` and K6p also in
    `table_poly_event.pol_launches`)."""
    return _on_device("table_poly_event", table_poly_event_plain,
                      _table_poly_event_cuda, spec, u, r, oc, L, L0, state)


table_poly_event.launches = 0
table_poly_event.direct_launches = 0
table_poly_event.pol_launches = 0


# ---------------------------------------------------------------------------
# kernel K7: the polychromatic multi-component table event
# ---------------------------------------------------------------------------

# the most dust components K7's one-pass route takes (a template parameter
# of csrc/fused_table_poly_multi.cu); the chunked route takes any
_CUDA_MAX_H = 3


def k7_route(P: int, H: int):
    """(chunked, scratch rows) of K7: the one-pass route up to MAXP panels
    and _CUDA_MAX_H components, else the chunked route, whose scratch
    holds each panel chunk's last driver optical depth."""
    chunked = P > _CUDA_MAXP or H > _CUDA_MAX_H
    return chunked, kernels.nchunks(P) if chunked else 0


@dataclass
class TablePolyMultiEventSpec(TablePolyEventSpec):
    """The constants the K7 event closes over (skirt_tpu
    fused_table_poly._build_kernel_multi): K6's, with H components, the
    (3H, W) float32 constants oc = kappa_ext rows, then kappa_sca rows,
    then g rows, and eight uniforms."""
    H: int = 2
    n_uniform: int = 8


def _build_kernel_multi(grid, ds, options, W, npanels, want_labs):
    """The K7 event's constants (mirrors skirt_tpu
    fused_table_poly._build_kernel_multi and its (3H, W) constants)."""
    g_hw = np.stack([np.asarray(c.mix.g, np.float32)[:W]
                     for c in ds.components])
    oc = np.concatenate([np.asarray(ds.kappaext, np.float32)[:, :W],
                         np.asarray(ds.kappasca, np.float32)[:, :W], g_hw])
    xi = float(options.scatt_bias)
    return TablePolyMultiEventSpec(
        W=int(W), npanels=int(npanels), want_labs=bool(want_labs),
        min_scatt=int(options.min_scatt_events), xi=f32(xi),
        one_m_xi=f32(1.0 - xi), inv_W=f32(1.0 / W),
        inv_minred=f32(1.0 / options.min_weight_reduction),
        oc=np.ascontiguousarray(oc), grid=grid, locate=_make_locate(grid),
        H=ds.ncomp)


def component_rows(grid, ds, pos, direction, midp):
    """K7's staged panels: the raw rho_h of every component at the panel
    midpoints (N, P) of rays pos, direction (N, 3), as (H * P, N) rows,
    h-major, zero outside the grid; one locate and H gathers."""
    cells = grid.locate_batched(pos[:, None, :]
                                + midp[..., None] * direction[:, None])
    safe = torch.clamp(cells, min=0)
    return torch.cat([torch.where(cells >= 0, ds.rho_at(h, safe), 0.0)
                      for h in range(ds.ncomp)], dim=1).T.contiguous()


def table_poly_multi_event_plain(spec: TablePolyMultiEventSpec, u, r, oc, L,
                                 L0, state):
    """One polychromatic multi-component table event for every lane, plain
    PyTorch.

    Mirrors the Pallas body (skirt_tpu/engine/fused_table_poly.py:423-657)
    operation for operation.  r: (H * P, N) raw rho panels, h-major.
    Returns a dict: "state" (px, py, pz, dx, dy, dz, alive, ns), "Ln",
    "Lp" and "depi"/"depv" with labs."""
    W, P, H = spec.W, spec.npanels, spec.H
    X, Y, Z, DX, DY, DZ = state[:6]
    alive = state[6] != 0
    nscatt = state[7]
    t0, delta = state[8], state[9]
    xi = spec.xi
    out = {}
    kext_h = [oc[h][:, None] for h in range(H)]                 # (W, 1)
    ksca_h = [oc[H + h][:, None] for h in range(H)]
    g_h = [oc[2 * H + h][:, None] for h in range(H)]
    Lm = torch.where(alive[None], L, 0.0)

    # -- driver wavelength and its per-component kappas (exact reads) -----
    c = torch.clamp((u[5] * float(W)).to(torch.int32), max=W - 1).long()
    kextc_h = [oc[h][c] for h in range(H)]
    kscac_h = [oc[H + h][c] for h in range(H)]

    # -- pass A: driver cumulative optical depth, per-component integrals -
    cumc = torch.zeros_like(delta)
    cums_c = []
    I_h = [torch.zeros_like(delta) for _ in range(H)]
    for kk in range(P):
        dk = 0.0
        for h in range(H):
            rho_hk = r[h * P + kk]
            dk = dk + kextc_h[h] * rho_hk
            I_h[h] = I_h[h] + rho_hk * delta
        cumc = cumc + dk * delta
        cums_c.append(cumc)
    tau_c = cumc
    cums_t = torch.stack(cums_c)
    tau = kext_h[0] * I_h[0][None]
    for h in range(1, H):
        tau = tau + kext_h[h] * I_h[h][None]
    ome = 1.0 - torch.exp(-tau)

    # -- interaction and deposit samples in driver-tau space --------------
    tau_exp = _expon_cutoff(u[1], tau_c)
    if xi == 0.0:
        tau_smp = tau_exp
    else:
        tau_smp = torch.where(u[0] < xi, u[1] * tau_c, tau_exp)
    tau_dep = _expon_cutoff(u[2], tau_c)
    ks_i, ks_f = _invert(cums_t, P, tau_smp)
    kd_i, kd_f = _invert(cums_t, P, tau_dep)
    s = t0 + (ks_i.to(torch.float32) + ks_f) * delta
    s_dep = t0 + (kd_i.to(torch.float32) + kd_f) * delta

    # -- pass B: per-wavelength prefixes and point kappas -----------------
    zW = torch.zeros_like(Lm)
    cum_w_s, cum_w_d = zW, zW
    kmix_s, kscam_s, kmix_d, kscam_d = zW, zW, zW, zW
    rho_s_h = [torch.zeros_like(delta) for _ in range(H)]
    for kk in range(P):
        rho_k = [r[h * P + kk] for h in range(H)]
        dtau_wk = kext_h[0] * rho_k[0][None]
        ksca_wk = ksca_h[0] * rho_k[0][None]
        for h in range(1, H):
            dtau_wk = dtau_wk + kext_h[h] * rho_k[h][None]
            ksca_wk = ksca_wk + ksca_h[h] * rho_k[h][None]
        m_s = torch.where(ks_i > kk, 1.0,
                          torch.where(ks_i == kk, ks_f, 0.0)) * delta
        m_d = torch.where(kd_i > kk, 1.0,
                          torch.where(kd_i == kk, kd_f, 0.0)) * delta
        cum_w_s = cum_w_s + dtau_wk * m_s[None]
        cum_w_d = cum_w_d + dtau_wk * m_d[None]
        sel_s = (ks_i == kk)[None]
        sel_d = (kd_i == kk)[None]
        kmix_s = torch.where(sel_s, dtau_wk, kmix_s)
        kscam_s = torch.where(sel_s, ksca_wk, kscam_s)
        kmix_d = torch.where(sel_d, dtau_wk, kmix_d)
        kscam_d = torch.where(sel_d, ksca_wk, kscam_d)
        for h in range(H):
            rho_s_h[h] = torch.where(sel_s[0], rho_k[h], rho_s_h[h])

    # -- deposit: per-wavelength absorbed estimate at s_dep ---------------
    if spec.want_labs:
        e_d = torch.exp(-cum_w_d)
        qd = _wsum(kmix_d * e_d / torch.clamp(ome, min=_TINY)) * spec.inv_W
        D = Lm * (kmix_d - kscam_d) * e_d / torch.clamp(qd[None], min=_TINY)
        D = torch.where(((tau_c > _TINY) & alive)[None], D, 0.0)
        Dsum = _wsum(D)
        target = u[6] * Dsum
        if W > 1:
            wsel = (_cumsum_w(D)[:W - 1] <= target[None]).sum(0) \
                .to(torch.int32)
        else:
            wsel = torch.zeros_like(nscatt)
        cell = spec.locate(X + s_dep * DX, Y + s_dep * DY, Z + s_dep * DZ)
        okd = (Dsum > 0) & alive & (cell >= 0)
        out["depi"] = torch.where(okd, cell * W + wsel, -1)
        out["depv"] = torch.where(okd, Dsum, 0.0)

    # -- per-wavelength mixture ratios at s -------------------------------
    e_s = torch.exp(-cum_w_s)
    F = kmix_s * e_s / torch.clamp(ome, min=_TINY)
    if xi == 0.0:
        Q = F
    else:
        Q = spec.one_m_xi * F + xi * kmix_s / torch.clamp(tau, min=_TINY)
    Qmix = _wsum(Q) * spec.inv_W

    # -- scatter: the component drawn at the driver wavelength ------------
    wv_h = [kscac_h[h] * rho_s_h[h] for h in range(H)]
    total_wv = wv_h[0]
    for h in range(1, H):
        total_wv = total_wv + wv_h[h]
    u_comp = u[7] * torch.clamp(total_wv, min=_TINY)
    g_sel = oc[2 * H][c]
    acc = wv_h[0]
    for h in range(1, H):
        g_sel = torch.where(u_comp > acc, oc[2 * H + h][c], g_sel)
        acc = acc + wv_h[h]
    costheta = _hg_costheta(g_sel, u[3])

    # the blended phase numerators per wavelength at the sampled cosine
    num = ksca_h[0] * rho_s_h[0][None] * _hg(g_h[0], costheta[None])
    for h in range(1, H):
        num = num + ksca_h[h] * rho_s_h[h][None] * _hg(g_h[h], costheta[None])
    p_w = num / torch.clamp(kscam_s, min=_TINY)
    QHmix = _wsum(Q * p_w) * spec.inv_W

    Lp = Lm * kscam_s * e_s / torch.clamp(Qmix[None], min=_TINY)
    Ln = Lm * num * e_s / torch.clamp(QHmix[None], min=_TINY)
    past_min = nscatt >= spec.min_scatt
    kill = (Ln <= L0 * spec.inv_minred) & past_min[None]
    Lp = torch.where(kill, 0.0, Lp)
    Ln = torch.where(kill, 0.0, Ln)
    alive = alive & (Ln > 0).any(0) & (tau_c > _TINY)

    X, Y, Z = _moved(alive, s, X, Y, Z, DX, DY, DZ)
    DX, DY, DZ, nscatt = _scattered(alive, costheta, u[4], DX, DY, DZ,
                                    nscatt)
    out["state"] = (X, Y, Z, DX, DY, DZ, alive.to(torch.int32), nscatt)
    out["Ln"] = torch.where(alive[None], Ln, 0.0)
    out["Lp"] = torch.where(alive[None], Lp, 0.0)
    return out


def _table_poly_multi_event_cuda(spec, u, r, oc, L, L0, state):
    N = state[0].shape[0]
    W, P, H = spec.W, spec.npanels, spec.H
    if W > kernels.TablePolyMultiArgs.MAX_W:
        raise ValueError("table_poly_multi_event kernel: nlambda <= 128 "
                         "(split wider grids into blocks of <= 128 "
                         "wavelengths)")
    if H < 2:
        raise ValueError("table_poly_multi_event kernel: two or more dust "
                         "components (one takes table_poly_event)")
    if len(state) != 10:
        raise ValueError("table_poly_multi_event: expected 10 state arrays")
    dts = [torch.float32] * 6 + [torch.int32] * 2 + [torch.float32] * 2
    _check_tensors("table_poly_multi_event",
                   [(u, (spec.n_uniform, N), torch.float32),
                    (r, (H * P, N), torch.float32),
                    (oc, (3 * H, W), torch.float32),
                    (L, (W, N), torch.float32), (L0, (W, N), torch.float32)]
                   + [(s, (N,), dt) for s, dt in zip(state, dts)])
    dev = u.device
    a = kernels.TablePolyMultiArgs()
    a.N = N
    a.W = W
    a.H = H
    a.npanels = P
    a.min_scatt = spec.min_scatt
    a.sum_block = _sum_block(W)
    a.xi = spec.xi
    a.one_m_xi = spec.one_m_xi
    a.inv_W = spec.inv_W
    a.inv_minred = spec.inv_minred
    _locate_args(a.geo, spec.grid)
    f32_kw = dict(dtype=torch.float32, device=dev)
    i32_kw = dict(dtype=torch.int32, device=dev)
    st_out = [torch.empty(N, **f32_kw) for _ in range(6)] \
        + [torch.empty(N, **i32_kw) for _ in range(2)]
    Ln = torch.empty((W, N), **f32_kw)
    Lp = torch.empty((W, N), **f32_kw)
    out = {"state": tuple(st_out), "Ln": Ln, "Lp": Lp}
    depi = depv = None
    if spec.want_labs:
        depi = out["depi"] = torch.empty(N, **i32_kw)
        depv = out["depv"] = torch.empty(N, **f32_kw)
    _set_ptrs(a, "u r oc L L0 px py pz dx dy dz alive ns t0 dt",
              [u, r, oc, L, L0, *state])
    _set_ptrs(a, "opx opy opz odx ody odz oalive ons oLn oLp odepi odepv",
              [*st_out, Ln, Lp, depi, depv])
    chunked, rows = k7_route(P, H)
    if chunked:
        cend = torch.empty((rows, N), dtype=torch.float32, device=dev)
        a.cend = cend.data_ptr()
    lib = kernels.library()
    kernels.check(lib.skirt_table_poly_multi_event(ctypes.byref(a),
                                                   int(spec.want_labs),
                                                   kernels.stream_of(u)),
                  "table_poly_multi_event kernel")
    table_poly_multi_event.launches += 1
    return out


def table_poly_multi_event(spec: TablePolyMultiEventSpec, u, r, oc, L, L0,
                           state):
    """The K7 event on CPU tensors (plain version) or CUDA tensors (the
    kernel, counted in `table_poly_multi_event.launches`)."""
    return _on_device("table_poly_multi_event",
                      table_poly_multi_event_plain,
                      _table_poly_multi_event_cuda, spec, u, r, oc, L, L0,
                      state)


table_poly_multi_event.launches = 0


def make_fused_table_poly_lifecycle(grid, dust_system, stellar_system,
                                    instruments, options, nlambda: int,
                                    launch_fn=None,
                                    emission_peeloff: bool = True,
                                    scattering_peeloff: bool = True,
                                    is_dust_emission=False, mueller=None,
                                    io_state: bool = False,
                                    max_iterations: int | None = None):
    """Build run_batch(key, ell, L0, tallies) for polychromatic table lanes
    (kernel K6 with one dust component, K7 with several; K6p with a
    Mueller table).

    `L0` must be (N, nlambda) per-lane launch luminosities on the run's
    device; `ell` is ignored.  A batch covers N * refill_batches * nlambda
    packets.  Labs bins are voxel * nlambda + w.  With options.count_events
    the tallies gain "nevents" (events run: lanes alive at an iteration's
    start).  The tallies are updated in place and returned; the event loop
    and its stop test are common.events'.

    Polarized (one component, a Mueller table `mueller`): every lane
    carries per-wavelength Stokes ratios (W, N) and one reference normal
    (N, 3), launched unpolarized.  K6p adds the column densities I_s and
    I_tot to K6's outputs; torch-side the driver rebuilds the mixture
    ratios from them, samples the scatter at the driver wavelength from
    the Mueller tables (overriding the kernel's HG direction), replaces
    Ln and Lp by the defensive-mixture Mueller weights with their
    per-wavelength cut, and peels with the Mueller phase weights and the
    Stokes ratios rotated into each instrument's frame (skirt_tpu
    fused_table_poly.py:866-874, :1000-1080, :1127-1172, :1220-1235)."""
    ds = dust_system
    W = int(nlambda)
    _validate(grid, ds, stellar_system, instruments, options, W, mueller,
              io_state, launch_fn)
    p = plan(grid, instruments, options, max_iterations)
    arith_locate, peel_mode = table_peel_mode(grid, options)
    H = ds.ncomp
    multi = H > 1
    mt = pol.first_table(mueller)
    if multi:
        spec = _build_kernel_multi(grid, ds, options, W, p.npanels,
                                   p.want_labs)
    else:
        spec = _build_kernel(grid, ds, options, W, p.npanels, p.want_labs,
                             arith_locate, want_pol=mt is not None)
    # one wavelength-independent peel integral per leader (per component
    # with several) serves all W.  With several components the peel is the
    # exact one whatever table_peel says: skirt_tpu's multi branch sets
    # peel_mode = "exact" before it builds its peel
    # (skirt_tpu/engine/fused_table_poly.py:726-740), and the uniform grid
    # it needs is checked in _validate
    peel_I_fn = make_table_peel(grid, ds, p.leaders,
                                "exact" if multi else peel_mode, p.np_peel,
                                getattr(options, "peel_graph", False))

    def run_batch(key, ell, L0, tallies):
        del ell
        if L0.ndim != 2 or L0.shape[1] != W:
            raise ValueError("polychromatic run_batch needs L0 of shape "
                             f"(N, {W})")

        def peel_I(pos_p, live):
            """Per leader the raw rho integral (N,), or with several
            components the (H, N) integrals of each; `live` the lanes
            whose integrals are used."""
            if multi:
                return peel_I_fn.integrals(pos_p, live)
            return peel_I_fn(pos_p, [ones], live)

        def minus_tau(Ipeel):
            """minus_tau(j): minus the per-wavelength peel optical depths
            (W, N) toward leader j, kext_w * I, or kext_hw^T @ I_h with
            several components."""
            if multi:
                return lambda j: -torch.matmul(oc[:H].T, Ipeel[j])
            return lambda j: -(kext_col * Ipeel[j][None])

        def stage(pos, direction, midp):
            """The raw rho panel rows: (P, N), or with several components
            (H * P, N) h-major."""
            if not multi:
                return ds.analytic_rows(pos, direction, midp, None, [ones],
                                        want_sca=False).T.contiguous()
            return component_rows(grid, ds, pos, direction, midp)

        def peel_form(Ipeel):
            """The scattering peel's phase weights and depths: the mix's
            HG and kext_w * I (common.SingleMix), or with several
            components the blend of their HG weights by kappa_sca,hw *
            rho_h at the new position's cell and kext_hw^T @ I_h."""
            if not multi:
                return SingleMix(oc[2], minus_kext, Ipeel)
            return PeelForm(phase_weights, minus_tau(Ipeel))

        def phase_weights(j, cosj):
            """The components' per-wavelength HG weights (W, N) toward
            leader j, blended by kappa_sca,hw * rho_h."""
            num = den = 0.0
            for h in range(H):
                kr = oc[H + h][:, None] * rho_n_h[h][None]
                num = num + kr * _hg(oc[2 * H + h][:, None], cosj[None])
                den = den + kr
            return num / torch.clamp(den, min=1e-30)

        def detect_all(pos_p, contrib, Ipeel, ns_p):
            emit_poly(instruments, ins, p.lead_of, pos_p, wls, contrib,
                      minus_tau(Ipeel), {"nscatt": ns_p, "is_dust": dust})

        with trace.span("launch"):
            n = L0.shape[0]
            dev = L0.device
            k_launch, k_cycle = batch_keys(key)
            ell0 = torch.zeros(n, dtype=torch.int32, device=dev)
            ones = torch.ones(n, dtype=torch.float32, device=dev)
            pos, direction, _, _ = stellar_system.launch(k_launch, ell0, ones)
            l0 = L0.T.to(torch.float32).contiguous()              # (W, N)
            L = l0
            alive = (L > 0).any(0)
            wls = wavelengths(W, dev)
            oc = torch.as_tensor(spec.oc, device=dev)
            kext_col = oc[0][:, None]
            minus_kext = -oc[0]
            dust = torch.full((n,), bool(is_dust_emission), device=dev)
            ins = tallies["instruments"]
            labs = tallies.get("labs")
            ns = torch.zeros(n, dtype=torch.int32, device=dev)
            if emission_peeloff:
                detect_all(pos, torch.where(alive[None], L, 0.0),
                           peel_I(pos, alive), ns)

            pos = pos.contiguous()
            direction = direction.contiguous()
            alive = alive.to(torch.int32)
            bc = torch.ones(n, dtype=torch.int32, device=dev)
            nev = EventCount(p.count_events, dev)
            sk = None
            if mt is not None:
                # per-wavelength Stokes ratios (each wavelength's Mueller
                # chain differs) and one geometric reference normal (the
                # rotations are wavelength-free)
                alb_col = oc[1][:, None]
                sk = Stokes(mt, p.leaders, instruments, n, dev, W=W)

        for it in events(p, lambda: (alive, bc)):
            with trace.span("event"):
                u = uniforms(k_cycle, it, spec.n_uniform, n, dev)
                # -- stage the rho panel rows (the gather) ----------------
                with trace.span("stage_gather"):
                    dsg, _, midp = vt.panel_paths(grid, pos, direction,
                                                  p.npanels)
                    t0 = midp[:, 0] - 0.5 * dsg[:, 0]
                    r = stage(pos, direction, midp)
                state = lane_columns(pos, direction) + [
                    alive, ns, t0.contiguous(), dsg[:, 0].contiguous()]
                event = table_poly_multi_event if multi else table_poly_event
                out = event(spec, u, r, oc, L, l0, state)
                deposit(labs, out, None if arith_locate
                        else (grid, pos, direction, None, W))
                nev.add(alive)
                st = out["state"]
                dir_old = direction
                if sk is not None:
                    alive_in, ns_in = alive != 0, ns
                count_entry_lanes(alive if sk is None else alive_in)
                pos = torch.stack(st[:3], dim=-1)
                direction = torch.stack(st[3:6], dim=-1)
                alive, ns = st[6], st[7]
                Ln, Lp = out["Ln"], out["Lp"]

            if sk is not None:
                with trace.span("mueller"):
                    # -- the Mueller scatter and the polarized reweighting
                    # around the unchanged event: the mixture ratios rebuilt
                    # from K6p's column densities, the HG direction and its
                    # HG weights in Ln replaced by the driver wavelength's
                    # polarized sample and its defensive-mixture weights
                    # (ref: DustMix.cpp:584-620).  As in skirt_tpu, the
                    # lane's alive bit stays the kernel's (decided on the HG
                    # weights; ROADMAP.md's watch list): the port is held to
                    # skirt_tpu
                    I_s, I_tot = out["I_s"], out["I_tot"]
                    tau_wv = kext_col * I_tot[None]
                    ome_v = 1.0 - torch.exp(-tau_wv)
                    Lab_v = alb_col * torch.where(alive_in[None], L, 0.0) \
                        * ome_v
                    F_v = kext_col * torch.exp(-kext_col * I_s[None]) \
                        / torch.clamp(ome_v, min=1e-30)
                    if spec.xi == 0.0:
                        Q_v = F_v
                    else:
                        Q_v = spec.one_m_xi * F_v + spec.xi * kext_col \
                            / torch.clamp(tau_wv, min=1e-30)
                    Qmix_v = Q_v.sum(0) * spec.inv_W
                    # the driver wavelength the kernel drew, from the same
                    # uniform row u[5]
                    c_drv = torch.clamp((u[5] * float(W)).to(torch.int32),
                                        max=W - 1)
                    pdeg_w, pang_w = pol.polarization_of(*sk.state[:2])
                    cix = c_drv.long()[None]
                    pdeg_c = pdeg_w.gather(0, cix)[0]
                    pang_c = pang_w.gather(0, cix)[0]
                    kpol = rng.event_key(k_cycle, it, 13)
                    nrm0 = pol.reference_normals(rng.fold_in(kpol, 2),
                                                 sk.state[3], dir_old)
                    theta_s = mt.sample_theta(rng.fold_in(kpol, 0), c_drv)
                    phi_s = mt.sample_phi(rng.fold_in(kpol, 1), c_drv, theta_s,
                                          pdeg_c, pang_c)
                    S_s = mt.lookup_all(theta_s)
                    wpol = sk.pf * (S_s[0] + pdeg_w * S_s[1] * torch.cos(
                        2.0 * (phi_s[None] - pang_w)))
                    QHpol = (Q_v * wpol).sum(0) * spec.inv_W
                    Lp = Lab_v * F_v / torch.clamp(Qmix_v[None], min=1e-30)
                    Ln = Lab_v * F_v * wpol / torch.clamp(QHpol[None],
                                                          min=1e-30)
                    # the per-wavelength cut with the polarized weights
                    kill = (Ln <= l0 * spec.inv_minred) \
                        & (ns_in >= spec.min_scatt)[None]
                    gone = kill | (alive == 0)[None]
                    Lp = torch.where(gone, 0.0, Lp)
                    Ln = torch.where(gone, 0.0, Ln)
                    *new, nd = pol.scatter_stokes(*sk.state[:3], S_s,
                                                  theta_s, phi_s, nrm0,
                                                  dir_old)
                    scat = alive != 0
                    direction = torch.where(scat[:, None], nd, direction)

            fresh = None
            if p.refill:
                fresh, pos, direction, Ln, ns, bc, alive = relaunch(
                    stellar_system, rng.event_key(k_cycle, it, 7), p.K, pos,
                    direction, Ln, ns, bc, alive, ell0, ones, l0=l0)

            if scattering_peeloff:
                with trace.span("peel"):
                    alive_b = alive != 0
                    Ipeel = peel_I(pos, alive_b)
                    if multi:
                        # per-component densities at the new position's cell
                        # (one locate and H gathers, shared by every leader)
                        cell_n = grid.locate_batched(pos[:, None, :])[:, 0]
                        safe_n = torch.clamp(cell_n, min=0)
                        rho_n_h = [torch.where(cell_n >= 0,
                                               ds.rho_at(h, safe_n), 0.0)
                                   for h in range(H)]
                    # the Mueller phase weights at the incoming direction
                    # (one theta-major row per lane for all W)
                    polarized = (sk.peel(mt.lookup_all, pdeg_w, pang_w, nrm0,
                                         dir_old, fresh)
                                 if sk is not None else None)
                    peel_poly(instruments, ins, p.lead_of, pos, wls, Lp, Ln,
                              alive_b, {"nscatt": ns, "is_dust": dust},
                              peel_form(Ipeel),
                              LeaderCosines(dir_old, p.leaders), fresh,
                              polarized)
            elif p.refill and emission_peeloff:
                with trace.span("peel"):
                    detect_all(pos, torch.where(fresh[None], Ln, 0.0),
                               peel_I(pos, fresh), ns)

            if sk is not None:
                sk.carry(new, scat, fresh)
            L = Ln.contiguous()
        nev.into(tallies)
        return tallies

    run_batch.spec = spec
    return run_batch
