"""Polychromatic fused analytic event (kernel K1) and its lifecycle driver.

Twin of skirt_tpu/engine/fused_poly.py.  Every lane carries the full
W-wavelength vector on one mixture-sampled geometric path: one set of
closed-form panel density evaluations (propagation + per-leader peel
quadrature) serves all W wavelengths.  The estimator is the
defensive-mixture importance sampling derived in the module docstring of
skirt_tpu/engine/fused_table_poly.py.

The event has two implementations with one input/output contract:
- `poly_event_plain`: plain PyTorch on (W, N) tensors, any device.  It is
  the spec the CPU tests hold against the Pallas kernel (interpret mode)
  and the reference `chip_smoke.py` holds the CUDA kernel against.
- csrc/fused_poly.cu: the hand-written CUDA kernel, one thread per lane.

`poly_event` takes the plain version for CPU tensors and launches the
kernel (or raises) for CUDA tensors.  Neither draws random numbers: the
(n_uniform, N) uniforms come in as an input, so both versions (and the
Pallas kernel) see identical inputs.

Layouts (N lanes, no padding: the kernel bounds-checks):
  u (n_uniform, N); oc (3, W) = kext*m/L^3, albedo, g; L, L0, Ln, Lp
  (W, N); state px, py, pz, dx, dy, dz float32 (N,), alive, ns (and bc
  with refill) int32 (N,); Ip, cos (nlead, N); depi int32 / depv (N,).

ref: SKIRTcore/MonteCarloSimulation.cpp:438-549 event chain.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels, trace
from ..numerics import f32
from ..ops.peel_sed import wavelengths
from .common import (SingleMix, _CUDA_DENSITY, _CUDA_MAXP, _CUDA_SAMPLER,
                     _TINY, _check_tensors, _expon_cutoff, _geom_args, _hg,
                     _hg_costheta, _invert, _launch_in_event, _make_locate,
                     _make_span, _moved, _on_device, _ptr, _scattered,
                     _set_ptrs, _uniform_grid, batch_keys, check_shared,
                     deposit, emit_poly, events, lane_columns, panel_taus,
                     peel_poly, plan, uniforms)


def _validate(grid, ds, stellar_system, instruments, options, nlambda,
              mueller, io_state, launch_fn):
    def bail(msg):
        raise ValueError(f"polychromatic fused lifecycle: {msg}")

    if ds is None or not getattr(ds, "analytic", False) \
            or getattr(ds, "table", False):
        bail("requires density_mode='analytic' (closed-form densities)")
    if ds.ncomp != 1:
        bail("single dust component only")
    if mueller is not None:
        bail("polarization not supported (vector/fused-mono paths carry "
             "the Stokes machinery)")
    if options.store_absorption and not _uniform_grid(grid):
        bail("absorption tallies require a uniform Cartesian grid "
             "(in-kernel arithmetic locate)")
    if nlambda > 128:
        bail("nlambda <= 128 (split wider grids into blocks of <= 128 "
             "wavelengths)")
    check_shared(bail, stellar_system, instruments, options, io_state,
                 launch_fn)
    if options.refill_batches > 1:
        geom = stellar_system.components[0].geometry
        if geom.device_sampler_xyz() is None:
            bail(f"refill: {type(geom).__name__} has no closed-form "
                 "device sampler")


@dataclass
class PolyEventSpec:
    """Everything the event needs besides its tensor inputs: the float32
    constants the Pallas kernel closes over, the geometry closed forms
    (torch callables for the plain version, `__device__` function names
    and constants for the CUDA kernel)."""
    W: int
    npanels: int
    np_peel: int
    want_labs: bool
    scattering_peeloff: bool
    refill: bool
    K: int
    nu_pos: int
    n_uniform: int
    min_scatt: int
    xi: float
    inv_np: float
    inv_pp: float
    inv_minred: float
    invL: float
    lscale: float
    leaders: list
    box: tuple
    oc: np.ndarray                   # (3, W) float32
    density_geometry: object
    sampler_geometry: object = None  # refill's closed-form sampler
    grid: object = None
    span: object = field(default=None, repr=False)
    locate: object = field(default=None, repr=False)

    def rho_s(self, X, Y, Z):
        return self.density_geometry.density_scaled_xyz(
            X * self.invL, Y * self.invL, Z * self.invL, self.lscale)


def _build_kernel(grid, ds, leaders, npanels, np_peel, options, W,
                  want_labs, scattering_peeloff, sampler_geometry=None):
    """The event's constants (mirrors skirt_tpu fused_poly._build_kernel).

    sampler_geometry: the stellar geometry whose closed-form sampler
    relaunches dead lanes in the event (refill), or None."""
    geom = ds.components[0].geometry
    lscale = ds.lscale
    mL3 = float(np.asarray(ds._mass_over_L3).ravel()[0])
    kextm_w = [np.float32(float(v) * mL3) for v in ds.kappaext[0][:W]]
    albedo_w = [np.float32(float(s) / max(float(e), 1e-37))
                for s, e in zip(ds.kappasca[0][:W], ds.kappaext[0][:W])]
    g_w = [np.float32(float(v)) for v in ds.g[0][:W]]
    refill = sampler_geometry is not None
    nu_pos = sampler_geometry.device_sampler_xyz()[0] if refill else 0
    oc = np.stack([np.asarray(kextm_w, np.float32),
                   np.asarray(albedo_w, np.float32),
                   np.asarray(g_w, np.float32)])
    return PolyEventSpec(
        W=W, npanels=int(npanels), np_peel=int(np_peel),
        want_labs=bool(want_labs),
        scattering_peeloff=bool(scattering_peeloff), refill=refill,
        K=int(options.refill_batches) if refill else 1, nu_pos=nu_pos,
        n_uniform=7 + (nu_pos + 2 if refill else 0),
        min_scatt=int(options.min_scatt_events),
        xi=float(options.scatt_bias), inv_np=f32(1.0 / npanels),
        inv_pp=f32(1.0 / np_peel),
        inv_minred=f32(1.0 / options.min_weight_reduction),
        invL=f32(1.0 / lscale), lscale=lscale, leaders=list(leaders),
        box=tuple(float(v) for v in grid.bounding_box()), oc=oc,
        density_geometry=geom, sampler_geometry=sampler_geometry, grid=grid,
        span=_make_span(grid.bounding_box()),
        locate=_make_locate(grid) if want_labs else None)


def _wsum(x):
    """Sum over the wavelength axis in w order (a cumulative sum's last
    entry): the CUDA kernel sums each lane's wavelengths in that order,
    and a reduction kernel would round differently."""
    return torch.cumsum(x, 0)[-1]


def poly_event_plain(spec: PolyEventSpec, u, oc, L, L0, state):
    """One polychromatic scattering event for every lane, plain PyTorch.

    Mirrors the Pallas body (skirt_tpu/engine/fused_poly.py:137-361)
    operation for operation.  Returns a dict: "state" (px, py, pz, dx,
    dy, dz, alive, ns), "Ln", "Lp", "Ip", "cos", and "depi"/"depv" with
    labs, "bc"/"fresh" with refill."""
    W = spec.W
    npanels = spec.npanels
    X, Y, Z, DX, DY, DZ = state[:6]
    alive = state[6] != 0
    nscatt = state[7]
    span = spec.span
    xi = spec.xi
    out = {}

    # -- panel quadrature of the lambda-independent column density ------
    t0, t1 = span(X, Y, Z, DX, DY, DZ)
    delta = (t1 - t0) * spec.inv_np
    cum = torch.zeros_like(delta)
    cums = []
    for kk in range(npanels):
        midk = t0 + f32(kk + 0.5) * delta
        rho = spec.rho_s(X + midk * DX, Y + midk * DY, Z + midk * DZ)
        cum = cum + rho * delta
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
        return (cums_t[:npanels - 1] < x[None]).sum(0).to(torch.int32)

    # -- absorption deposit: one sampled wavelength per event -----------
    if spec.want_labs:
        D = (1.0 - alb) * Lm * ome
        cumD = torch.cumsum(D, 0)
        Dsum = cumD[W - 1]
        target = u[6] * Dsum
        wsel = (cumD[:W - 1] <= target[None]).sum(0).to(torch.int32)
        w64 = wsel.to(torch.int64)
        tau_sel = tau.gather(0, w64[None])[0]
        kinv_sel = 1.0 / oc[0][w64]
        tau_dep = _expon_cutoff(u[2], tau_sel)
        I_dep = tau_dep * kinv_sel
        i_dep = count_below(I_dep)
        mid_dep = t0 + (i_dep.to(torch.float32) + 0.5) * delta
        cell = spec.locate(X + mid_dep * DX, Y + mid_dep * DY,
                           Z + mid_dep * DZ)
        okd = (Dsum > 0) & alive & (cell >= 0)
        out["depi"] = torch.where(okd, cell * W + wsel, -1)
        out["depv"] = torch.where(okd, Dsum, 0.0)

    Lab = alb * Lm * ome

    # -- mixture-driver forced propagation -------------------------------
    c = torch.clamp((u[5] * float(W)).to(torch.int32), max=W - 1)
    c64 = c.to(torch.int64)
    tau_c = tau.gather(0, c64[None])[0]
    kinv_cc = 1.0 / oc[0][c64]
    g_cc = oc[2][c64]
    u1 = u[0]
    u2 = u[1]
    tau_exp = _expon_cutoff(u2, tau_c)
    if xi == 0.0:
        tau_smp = tau_exp
    else:
        tau_smp = torch.where(u1 < xi, u2 * tau_c, tau_exp)
    I_s = tau_smp * kinv_cc

    i_hit, frac = _invert(cums_t, npanels, I_s)
    s = t0 + (i_hit.to(torch.float32) + frac) * delta
    X, Y, Z = _moved(alive, s, X, Y, Z, DX, DY, DZ)

    # -- per-wavelength mixture ratios -----------------------------------
    F = kext * torch.exp(-kext * I_s[None]) / torch.clamp(ome, min=_TINY)
    if xi == 0.0:
        Q = F
    else:
        Q = ((1.0 - xi) * F
             + f32(xi) * kext / torch.clamp(tau, min=_TINY))
    Qmix = _wsum(Q) * f32(1.0 / W)

    costheta = _hg_costheta(g_cc, u[3])
    HG = _hg(gw, costheta[None])
    QHmix = _wsum(Q * HG) * f32(1.0 / W)

    Lp = Lab * F / torch.clamp(Qmix[None], min=_TINY)
    Ln = Lab * F * HG / torch.clamp(QHmix[None], min=_TINY)

    past_min = nscatt >= spec.min_scatt
    kill = (Ln <= L0 * spec.inv_minred) & past_min[None]
    Lp = torch.where(kill, 0.0, Lp)
    Ln = torch.where(kill, 0.0, Ln)
    alive = alive & (Ln > 0).any(0) & (I_tot > _TINY)

    # -- persistent-lane relaunch ----------------------------------------
    fresh = torch.zeros_like(alive)
    if spec.refill:
        bcount = state[8]
        eligible = torch.logical_not(alive) & (bcount < spec.K)
        X, Y, Z, DX, DY, DZ = _launch_in_event(spec, u, 7, eligible,
                                               X, Y, Z, DX, DY, DZ)
        Ln = torch.where(eligible[None], L0, Ln)
        Lp = torch.where(eligible[None], 0.0, Lp)
        nscatt = torch.where(eligible, 0, nscatt)
        bcount = bcount + eligible.to(torch.int32)
        fresh = eligible
        alive = alive | eligible
        out["bc"] = bcount
        out["fresh"] = fresh.to(torch.int32)

    # -- peel quadrature toward each leader (lambda-independent) ---------
    Ips, coss = [], []
    for kx, ky, kz in spec.leaders:
        if not spec.scattering_peeloff:
            coss.append(torch.zeros_like(I_tot))
            Ips.append(torch.zeros_like(I_tot))
            continue
        fx, fy, fz = f32(kx), f32(ky), f32(kz)
        coss.append(DX * fx + DY * fy + DZ * fz)
        pt0, pt1 = span(X, Y, Z, kx, ky, kz, const_d=True)
        pd = (pt1 - pt0) * spec.inv_pp
        rsum = torch.zeros_like(I_tot)
        for kk in range(spec.np_peel):
            mk = pt0 + f32(kk + 0.5) * pd
            rsum = rsum + spec.rho_s(X + mk * fx, Y + mk * fy, Z + mk * fz)
        Ips.append(rsum * pd)
    out["Ip"] = torch.stack(Ips)
    out["cos"] = torch.stack(coss)

    # -- HG scatter about the old direction (driver g) -------------------
    DX, DY, DZ, nscatt = _scattered(alive, costheta, u[4], DX, DY, DZ,
                                    nscatt, fresh)

    if trace.enabled():
        # the lanes that did an event: alive on entry, or relaunched
        trace.count_live(u.device, (state[6] != 0) | fresh)
    out["state"] = (X, Y, Z, DX, DY, DZ, alive.to(torch.int32), nscatt)
    out["Ln"] = torch.where(alive[None], Ln, 0.0)
    out["Lp"] = torch.where(alive[None], Lp, 0.0)
    return out


def cuda_route(spec: PolyEventSpec):
    """(chunked, scratch rows) of K1 for a spec: the one-pass route up to
    MAXP panels and MAX_LEAD observers, else the chunked route
    (csrc/fused_poly.cu), whose scratch holds each panel chunk's last
    column density."""
    chunked = (spec.npanels > _CUDA_MAXP
               or len(spec.leaders) > kernels.PolyArgs.MAX_LEAD)
    return chunked, kernels.nchunks(spec.npanels) if chunked else 0


def _cuda_args(spec: PolyEventSpec):
    """The kernel's constant arguments and template choices for a spec."""
    if spec.W > kernels.PolyArgs.MAX_W:
        raise ValueError("poly_event kernel: nlambda <= 128 (split wider "
                         "grids into blocks of <= 128 wavelengths)")
    dens = spec.density_geometry.cuda_density(spec.lscale)
    if dens is None or dens[0] not in _CUDA_DENSITY:
        raise ValueError(f"poly_event kernel: no CUDA device density for "
                         f"{type(spec.density_geometry).__name__}")
    samp = None
    if spec.refill:
        samp = spec.sampler_geometry.cuda_sampler()
        if samp is None or samp[0] not in _CUDA_SAMPLER:
            raise ValueError(f"poly_event kernel: no CUDA device sampler "
                             f"for {type(spec.sampler_geometry).__name__}")
    a = kernels.PolyArgs()
    a.W = spec.W
    a.npanels = spec.npanels
    a.np_peel = spec.np_peel
    a.nlead = len(spec.leaders)
    a.min_scatt = spec.min_scatt
    a.K = spec.K
    a.scattering_peeloff = int(spec.scattering_peeloff)
    a.xi = spec.xi
    a.inv_np = spec.inv_np
    a.inv_pp = spec.inv_pp
    a.inv_minred = spec.inv_minred
    _geom_args(a, spec.box, spec.grid, spec.want_labs, spec.leaders,
               spec.invL, dens[1], samp[1] if samp else None)
    return a, (_CUDA_DENSITY[dens[0]], _CUDA_SAMPLER[samp[0] if samp
                                                      else None])


def _poly_event_cuda(spec, u, oc, L, L0, state):
    N = state[0].shape[0]
    W = spec.W
    nlead = len(spec.leaders)
    dev = u.device
    n_state = 9 if spec.refill else 8
    if len(state) != n_state:
        raise ValueError(f"poly_event: expected {n_state} state arrays")
    _check_tensors("poly_event",
                   [(u, (spec.n_uniform, N), torch.float32),
                    (oc, (3, W), torch.float32), (L, (W, N), torch.float32),
                    (L0, (W, N), torch.float32)]
                   + [(s, (N,), torch.float32) for s in state[:6]]
                   + [(s, (N,), torch.int32) for s in state[6:]])
    a, (dens, samp) = _cuda_args(spec)
    f32_kw = dict(dtype=torch.float32, device=dev)
    i32_kw = dict(dtype=torch.int32, device=dev)
    st_out = [torch.empty(N, **f32_kw) for _ in range(6)] \
        + [torch.empty(N, **i32_kw) for _ in range(2)]
    Ln = torch.empty((W, N), **f32_kw)
    Lp = torch.empty((W, N), **f32_kw)
    Ip = torch.empty((nlead, N), **f32_kw)
    cos = torch.empty((nlead, N), **f32_kw)
    out = {"state": tuple(st_out), "Ln": Ln, "Lp": Lp, "Ip": Ip, "cos": cos}
    depi = depv = bc = fresh = None
    if spec.want_labs:
        depi = out["depi"] = torch.empty(N, **i32_kw)
        depv = out["depv"] = torch.empty(N, **f32_kw)
    if spec.refill:
        bc = out["bc"] = torch.empty(N, **i32_kw)
        fresh = out["fresh"] = torch.empty(N, **i32_kw)
    a.N = N
    ins = [u, oc, L, L0, *state[:8], state[8] if spec.refill else None]
    _set_ptrs(a, "u oc L L0 px py pz dx dy dz alive ns bc", ins)
    outs = [*st_out, Ln, Lp, depi, depv, Ip, cos, bc, fresh]
    _set_ptrs(a, "opx opy opz odx ody odz oalive ons oLn oLp odepi odepv oIp "
              "ocos obc ofresh", outs)
    chunked, rows = cuda_route(spec)
    if chunked:
        cend = torch.empty((rows, N), dtype=torch.float32, device=dev)
        a.cend = cend.data_ptr()
        if nlead:
            a.lead = kernels.device_floats(kernels.lead_rows(spec.leaders),
                                           dev).data_ptr()
    a.live = _ptr(trace.live_counter(dev))
    lib = kernels.library()
    kernels.check(lib.skirt_poly_event(ctypes.byref(a), dens, samp,
                                       int(spec.want_labs),
                                       kernels.stream_of(u)),
                  "poly_event kernel")
    poly_event.launches += 1
    return out


def poly_event(spec: PolyEventSpec, u, oc, L, L0, state):
    """The event on CPU tensors (plain version) or CUDA tensors (the K1
    kernel, counted in `poly_event.launches`).  Same contract as
    poly_event_plain.  While tracing, both count the lanes in
    `trace`'s lane_slots and live_lanes."""
    trace.count_slots(state[0].shape[0])
    return _on_device("poly_event", poly_event_plain, _poly_event_cuda, spec,
                      u, oc, L, L0, state)


poly_event.launches = 0


def make_fused_poly_lifecycle(grid, dust_system, stellar_system,
                              instruments, options, nlambda: int,
                              launch_fn=None, emission_peeloff: bool = True,
                              scattering_peeloff: bool = True,
                              is_dust_emission=False, mueller=None,
                              io_state: bool = False,
                              max_iterations: int | None = None):
    """Build run_batch(key, ell, L0, tallies) — polychromatic analytic.

    `L0` must be (N, nlambda) per-lane launch luminosities on the run's
    device; `ell` is ignored.  A batch covers N * refill_batches * nlambda
    packets.  Labs bins are cell * nlambda + w.  The tallies (float32
    tensors on the same device) are updated in place and returned.  The
    event loop and its stop test are common.events'.
    """
    ds = dust_system
    W = int(nlambda)
    _validate(grid, ds, stellar_system, instruments, options, W,
              mueller, io_state, launch_fn)
    p = plan(grid, instruments, options, max_iterations)
    sampler_geom = stellar_system.components[0].geometry if p.refill else None
    spec = _build_kernel(grid, ds, p.leaders, p.npanels, p.np_peel, options,
                         W, p.want_labs, scattering_peeloff, sampler_geom)

    def run_batch(key, ell, L0, tallies):
        del ell
        if L0.ndim != 2 or L0.shape[1] != W:
            raise ValueError("polychromatic run_batch needs L0 of shape "
                             f"(N, {W})")
        with trace.span("launch"):
            n = L0.shape[0]
            dev = L0.device
            k_launch, k_cycle = batch_keys(key)
            ell0 = torch.zeros(n, dtype=torch.int32, device=dev)
            pos, direction, _, _ = stellar_system.launch(
                k_launch, ell0,
                torch.ones(n, dtype=torch.float32, device=dev))
            L = L0.T.contiguous()
            l0 = L
            alive = (L > 0).any(0)
            wls = wavelengths(W, dev)
            oc = torch.as_tensor(spec.oc, device=dev)
            minus_kext = -oc[0]
            kext_t_col = torch.as_tensor(
                np.asarray(ds.kappaext, np.float32)[0, :W],
                device=dev)[:, None]
            ins = tallies["instruments"]
            labs = tallies.get("labs")
            dust = torch.full((n,), bool(is_dust_emission), device=dev)

            if emission_peeloff:
                # emission peel: panel quadrature toward each leader once
                Lw = torch.where(alive[None], L, 0.0)
                ones = [torch.ones(n, dtype=torch.float32, device=dev)]
                # with unit weights the depths are the density integrals
                # -> tau_w = kappaext_w * integral
                Ipe = panel_taus(grid, ds, p.leaders, p.np_peel, pos, ones)
                emit_poly(instruments, ins, p.lead_of, pos, wls, Lw,
                          lambda j: -kext_t_col * Ipe[j][None],
                          {"nscatt": torch.zeros(n, dtype=torch.int32,
                                                 device=dev),
                           "is_dust": dust})

            state = lane_columns(pos, direction) + [
                alive.to(torch.int32),
                torch.zeros(n, dtype=torch.int32, device=dev)]
            if p.refill:
                state.append(torch.ones(n, dtype=torch.int32, device=dev))

        for it in events(p, lambda: (state[6],
                                      state[8] if p.refill else None)):
            with trace.span("event"):
                u = uniforms(k_cycle, it, spec.n_uniform, n, dev)
                out = poly_event(spec, u, oc, L, l0, state)
                deposit(labs, out)
            st = out["state"]
            Ln, Lp = out["Ln"], out["Lp"]
            if scattering_peeloff:
                with trace.span("peel"):
                    alive_new = st[6] != 0
                    pos_new = torch.stack(st[:3], dim=-1)
                    # the in-kernel relaunch happens BEFORE the peel
                    # quadrature, so the depths and cosines of fresh lanes
                    # are at their fresh position
                    fresh = out["fresh"] != 0 if p.refill else None
                    peel_poly(instruments, ins, p.lead_of, pos_new, wls, Lp,
                              Ln, alive_new,
                              {"nscatt": st[7], "is_dust": dust},
                              SingleMix(oc[2], minus_kext, out["Ip"]),
                              out["cos"], fresh)
            state = list(st)
            if p.refill:
                state.append(out["bc"])
            L = Ln
        return tallies

    run_batch.spec = spec
    return run_batch
