"""Monochromatic fused analytic event (kernel K3), its lifecycle driver,
and the elementwise helpers the fused event kernels share.

Twin of skirt_tpu/engine/fused.py.  One wavelength per lane; the whole
scattering event (panel quadrature of the closed-form densities, sampled
absorption deposit, forced propagation with the composite bias weight,
weight cut, in-kernel relaunch, per-leader peel optical depth and cosine,
Henyey-Greenstein scatter) runs in one kernel; single- or two-component
dust (H = 2: per-panel albedo blending, a deposit drawn by absorbed
energy, the component picked at the interaction point, a blended peel
phase).  With a Mueller table (one component) the kernel runs unchanged
and the driver adds polarization torch-side: the Stokes state, the
Mueller scatter overriding the kernel's direction and the polarized peel
from the kernel's per-leader cosines.

The event has two implementations with one input/output contract:
- `mono_event_plain`: plain PyTorch on (N,) tensors, any device.  It is
  the spec the CPU tests hold against the Pallas kernel (interpret mode)
  and the reference `chip_smoke.py` holds the CUDA kernel against.
- csrc/fused_mono.cu: the hand-written CUDA kernel, one thread per lane.

`mono_event` takes the plain version for CPU tensors and launches the
kernel (or raises) for CUDA tensors.  Neither draws random numbers: the
(n_uniform, N) uniforms come in as an input.

The per-wavelength tables carry the Pallas body's bits in both of its
branches (`_lambda_table`); both versions here read the one table the
spec holds.

Layouts (N lanes, no padding: the kernel bounds-checks):
  u (n_uniform, N); state px, py, pz, dx, dy, dz, L float32, alive, ns,
  ell int32, L0 float32 (and bc int32 with refill), each (N,); outputs
  state (7 float32 + alive, ns), depi int32 / depv (N,), tau, cos (and
  phase with H > 1) (nlead, N), bc / fresh (N,).

The helpers below (:_expon_cutoff to :_group_leaders, _hit_point,
_hg_costheta, _scatter_direction) twin skirt_tpu/engine/fused.py:55-144
and the event bodies' shared steps, and serve the polychromatic and the
table events (engine/fused_poly.py, fused_table.py, fused_table_poly.py)
too; csrc/common.cuh carries the same arithmetic as `__device__`
functions.

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
from ..ops import binned_add

_BIG = 3.4e38
_TINY = 1e-30
_CUDA_MAXP = kernels.MAXP   # panels of the kernels' one-pass routes
_CUDA_DENSITY = {"expdisk": 1}
_CUDA_SAMPLER = {None: 0, "point": 1, "expdisk": 2}
_CHECK_EVERY = 16        # event iterations between host reads of the stop test


def _f32(v) -> float:
    return float(np.float32(v))


def _expon_cutoff(u, taumax):
    """Truncated-exponential optical-depth sample, the in-kernel form:
    no expm1/log1p, and a small-taumax branch below 1e-4 (the driver-side
    rng.expon_cutoff switches below 1e-6)."""
    tau = -torch.log(torch.clamp(1.0 - u * (1.0 - torch.exp(-taumax)),
                                 min=1e-37))
    return torch.where(taumax < 1e-4, u * taumax, torch.minimum(tau, taumax))


def _axis_span(o, d, lo, hi, tn, tf, const_d):
    """Slab-test update for one axis; const_d means d is a Python float."""
    lo32 = _f32(lo)
    hi32 = _f32(hi)
    if const_d:
        if abs(d) > 1e-30:
            inv = _f32(1.0 / d)
            ta = (lo32 - o) * inv
            tb = (hi32 - o) * inv
            near = torch.minimum(ta, tb)
            far = torch.maximum(ta, tb)
        else:
            in_slab = (o >= lo32) & (o <= hi32)
            near = torch.where(in_slab, -_BIG, _BIG)
            far = torch.where(in_slab, _BIG, -_BIG)
    else:
        moving = torch.abs(d) > 1e-30
        inv = 1.0 / torch.where(moving, d, 1.0)
        ta = (lo32 - o) * inv
        tb = (hi32 - o) * inv
        in_slab = (o >= lo32) & (o <= hi32)
        near = torch.where(moving, torch.minimum(ta, tb),
                           torch.where(in_slab, -_BIG, _BIG))
        far = torch.where(moving, torch.maximum(ta, tb),
                          torch.where(in_slab, _BIG, -_BIG))
    return torch.maximum(tn, near), torch.minimum(tf, far)


def _make_span(box):
    """Elementwise in-domain ray span (mirrors CartesianGrid.ray_span)."""
    lo = (box[0], box[1], box[2])
    hi = (box[3], box[4], box[5])

    def span(X, Y, Z, DX, DY, DZ, const_d=False):
        tn = torch.full_like(X, -_BIG)
        tf = torch.full_like(X, _BIG)
        for o, d, lo_a, hi_a in ((X, DX, lo[0], hi[0]), (Y, DY, lo[1], hi[1]),
                                 (Z, DZ, lo[2], hi[2])):
            tn, tf = _axis_span(o, d, lo_a, hi_a, tn, tf, const_d)
        t0 = torch.clamp(tn, min=0.0)
        hit = (t0 <= tf) & (tf > 0)
        t0 = torch.where(hit, t0, 0.0)
        return t0, torch.where(hit, tf, t0)

    return span


def _make_locate(grid):
    """Arithmetic point location for uniform-spacing Cartesian grids."""
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    lo = [_f32(v) for v in grid._lo]
    inv = [_f32(1.0 / d) for d in grid._dx]

    def locate(X, Y, Z):
        ix = torch.floor((X - lo[0]) * inv[0]).to(torch.int32)
        iy = torch.floor((Y - lo[1]) * inv[1]).to(torch.int32)
        iz = torch.floor((Z - lo[2]) * inv[2]).to(torch.int32)
        ok = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
              & (iz >= 0) & (iz < nz))
        return torch.where(ok, (ix * ny + iy) * nz + iz, -1)

    return locate


def _group_leaders(instruments):
    """Group instruments by observer direction; returns (leaders, lead_of)
    where leaders is a list of unit-direction tuples and lead_of[i]
    indexes into it."""
    groups = {}
    lead_of = []
    leaders = []
    for ins in instruments:
        key = tuple(np.round(np.asarray(ins.kobs, np.float64), 12))
        if key not in groups:
            groups[key] = len(leaders)
            leaders.append(tuple(float(v) for v in
                                 np.asarray(ins.kobs, np.float64)))
        lead_of.append(groups[key])
    return leaders, lead_of


def _geom_args(a, box, grid, want_labs, leaders, invL, dens, samp):
    """Fill the Geom fields of a kernel argument struct (kernels.Geom):
    the box, the arithmetic locate (with labs), the leaders' directions
    and inverse components, the density and sampler constants."""
    a.invL = invL
    for i in range(3):
        a.box_lo[i] = _f32(box[i])
        a.box_hi[i] = _f32(box[3 + i])
    if want_labs:
        a.nx, a.ny, a.nz = grid.nx, grid.ny, grid.nz
        for i in range(3):
            a.loc_lo[i] = _f32(grid._lo[i])
            a.loc_inv[i] = _f32(1.0 / grid._dx[i])
    # the one-pass routes' observers (the chunked routes read them all from
    # a device buffer, kernels.lead_rows)
    for j, kvec in enumerate(leaders[:kernels.MAX_LEAD]):
        for i, d in enumerate(kvec):
            a.lead_k[j][i] = _f32(d)
            moving = abs(d) > 1e-30
            a.lead_moving[j][i] = int(moving)
            a.lead_inv[j][i] = _f32(1.0 / d) if moving else 0.0
    for i, v in enumerate(dens):
        a.dens[i] = v
    for i, v in enumerate(samp or ()):
        a.samp[i] = v


# ---------------------------------------------------------------------------
# kernel K3: the monochromatic event
# ---------------------------------------------------------------------------

def _validate(grid, ds, instruments, options, nlambda, mueller, io_state,
              stellar_system, launch_fn):
    def bail(msg):
        raise ValueError(f"fused lifecycle: {msg}")

    if ds is None or not getattr(ds, "analytic", False):
        bail("requires density_mode='analytic'")
    if getattr(ds, "table", False):
        bail("table (gathered) densities are not supported in-kernel; "
             "use the XLA panel path (fused=False)")
    if mueller is not None:
        if ds.ncomp != 1:
            bail("polarized fused path supports a single dust component "
                 "(multi-component polarization runs the vector path)")
        if pol.first_table(mueller) is None:
            bail("polarized fused path needs a Mueller table")
        if max(int(getattr(options, "tally_flush", 1) or 1), 1) != 1:
            bail("polarized fused path requires tally_flush=1")
    if launch_fn is not None:
        bail("launch_fn (the dust-emission launch of the panchromatic loop) "
             "is not ported yet (slice S3)")
    if io_state:
        bail("io_state not supported")
    if max(int(getattr(options, "tally_flush", 1) or 1), 1) != 1:
        bail("tally_flush > 1 (buffered tally streams) is not ported yet "
             "(slice S2b)")
    if options.fused_hw_rng:
        bail("fused_hw_rng is the TPU's on-core generator; the port draws "
             "counter-based Philox uniforms only")
    if options.continuous_scattering:
        bail("continuous_scattering not supported")
    if options.store_absorption and options.deposition != "sampled":
        bail("absorption tallies require deposition='sampled'")
    if options.store_absorption:
        if not (hasattr(grid, "_uniform") and all(grid._uniform)):
            bail("absorption tallies require a uniform-spacing Cartesian "
                 "grid (in-kernel arithmetic locate); disable "
                 "store_absorption for other grids")
    elif not hasattr(grid, "bounding_box"):
        bail("grid must expose bounding_box()")
    for ins in instruments:
        if hasattr(ins, "observer_distance") or not hasattr(ins, "kobs"):
            bail("requires distant (constant-direction) instruments")
    if stellar_system is None:
        bail("requires a stellar system (its launch)")
    if not stellar_system.is_isotropic:
        bail("anisotropic stellar emission is not ported yet (slice S6)")
    if options.refill_batches > 1:
        if stellar_system.ncomp != 1:
            bail("refill requires a single isotropic stellar component")
        geom = stellar_system.components[0].geometry
        if geom.device_sampler_xyz() is None:
            bail(f"refill: {type(geom).__name__} has no closed-form "
                 "device sampler (device_sampler_xyz)")
    if ds.kappaext.shape[1] < nlambda:
        bail(f"the dust mixes cover {ds.kappaext.shape[1]} wavelengths, "
             f"fewer than nlambda = {nlambda}")


def _lambda_table(ds, nlambda):
    """The (3, nlambda) or (3H, nlambda) float32 wavelength tables with
    the bits the Pallas body reads.

    Rows: (kext*m/L^3, albedo, g) for one component; (kext_h*m_h/L^3 for
    h < H, ksca_h*m_h/L^3 for h < H, g_h for h < H) for H > 1.  Up to 16
    wavelengths the Pallas body closes over float64 products and
    quotients of the float32 optics rounded once to float32
    (fused.py:207-216); above that its driver computes them in float32
    (fused.py:650-658).  The two agree to the bit: a float64 product of
    two float32 numbers is exact, and a float64 quotient rounded to
    float32 is the correctly rounded float32 quotient (53 >= 2 x 24 + 2
    bits), so the float32 form below serves both."""
    H = ds.ncomp
    kext = np.asarray(ds.kappaext, np.float32)
    ksca = np.asarray(ds.kappasca, np.float32)
    g = np.asarray(ds.g, np.float32)
    mL3 = np.asarray(np.asarray(ds._mass_over_L3).ravel(), np.float32)
    kextm = kext * mL3[:, None]
    kscam = ksca * mL3[:, None]
    alb = ksca[0] / np.maximum(kext[0], np.float32(1e-37))
    if H == 1:
        rows = np.stack([kextm[0], alb, g[0]])
    else:
        rows = np.concatenate([kextm, kscam, g])
    return np.ascontiguousarray(rows[:, :nlambda], np.float32)


@dataclass
class MonoEventSpec:
    """Everything the K3 event needs besides its tensor inputs: the twin
    of the constants the Pallas body closes over (fused.py:199-238), the
    wavelength table, and the geometry closed forms (torch callables for
    the plain version, `__device__` function names and constants for the
    CUDA kernel)."""
    H: int
    nlambda: int
    npanels: int
    np_peel: int
    want_labs: bool
    scattering_peeloff: bool
    refill: bool
    K: int
    nu_pos: int
    n_uniform: int
    u_comp: int
    min_scatt: int
    xi: float
    one_m_xi: float
    inv_np: float
    inv_pp: float
    inv_minred: float
    invL: float
    lscale: float
    leaders: list
    box: tuple
    tab: np.ndarray                  # (3 or 3H, nlambda) float32
    density_geometries: list
    sampler_geometry: object = None  # refill's closed-form sampler
    grid: object = None
    span: object = field(default=None, repr=False)
    locate: object = field(default=None, repr=False)
    _tab_dev: dict = field(default_factory=dict, repr=False)

    def rho_s(self, h, X, Y, Z):
        return self.density_geometries[h].density_scaled_xyz(
            X * self.invL, Y * self.invL, Z * self.invL, self.lscale)

    def table(self, device):
        """The wavelength table as a tensor on `device` (copied once)."""
        dev = torch.device(device)
        if dev not in self._tab_dev:
            self._tab_dev[dev] = torch.as_tensor(self.tab, device=dev)
        return self._tab_dev[dev]

    def lane_tables(self, ell):
        """The table's rows at each lane's wavelength: 3 or 3H (N,)
        tensors (an out-of-range index reads the first column, as the
        Pallas select chain does)."""
        tab = self.table(ell.device)
        ok = (ell >= 0) & (ell < self.nlambda)
        idx = torch.where(ok, ell, 0).long()
        return list(tab[:, idx])


def _build_kernel(grid, ds, leaders, npanels, np_peel, options, nlambda,
                  want_labs, scattering_peeloff, sampler_geometry=None):
    """The event's constants (mirrors skirt_tpu fused._build_kernel).

    sampler_geometry: the stellar geometry whose closed-form sampler
    relaunches dead lanes in the event (refill), or None."""
    H = ds.ncomp
    lscale = ds.lscale
    refill = sampler_geometry is not None
    nu_pos = sampler_geometry.device_sampler_xyz()[0] if refill else 0
    xi = float(options.scatt_bias)
    return MonoEventSpec(
        H=H, nlambda=int(nlambda), npanels=int(npanels),
        np_peel=int(np_peel), want_labs=bool(want_labs),
        scattering_peeloff=bool(scattering_peeloff), refill=refill,
        K=int(options.refill_batches) if refill else 1, nu_pos=nu_pos,
        n_uniform=5 + (nu_pos + 2 if refill else 0) + (1 if H > 1 else 0),
        u_comp=5 + (nu_pos + 2 if refill else 0),
        min_scatt=int(options.min_scatt_events), xi=_f32(xi),
        one_m_xi=_f32(1.0 - xi), inv_np=_f32(1.0 / npanels),
        inv_pp=_f32(1.0 / np_peel),
        inv_minred=_f32(1.0 / options.min_weight_reduction),
        invL=_f32(1.0 / lscale), lscale=lscale, leaders=list(leaders),
        box=tuple(float(v) for v in grid.bounding_box()),
        tab=_lambda_table(ds, int(nlambda)),
        density_geometries=[c.geometry for c in ds.components],
        sampler_geometry=sampler_geometry, grid=grid,
        span=_make_span(grid.bounding_box()),
        locate=_make_locate(grid) if want_labs else None)


def _hit_point(cums, npanels, tau, t0, delta):
    """Panel of the cumulative optical depths where tau lands, and the
    path length to it (linear within the panel)."""
    cums_t = torch.stack(cums)
    i_hit = (cums_t[:npanels - 1] < tau[None]).sum(0).to(torch.int32)
    h64 = i_hit.long()
    cum_h = cums_t.gather(0, h64[None])[0]
    cum_prev = torch.where(
        i_hit > 0, cums_t.gather(0, torch.clamp(h64 - 1, min=0)[None])[0],
        0.0)
    dtau_h = cum_h - cum_prev
    frac = torch.clamp(torch.where(dtau_h > 0, (tau - cum_prev)
                                   / torch.clamp(dtau_h, min=_TINY), 0.0),
                       0.0, 1.0)
    return t0 + (i_hit.to(torch.float32) + frac) * delta


def _hg_costheta(g, u_g):
    """Henyey-Greenstein deflection cosine from one uniform (the Pallas
    bodies' form, common.cuh hg_costheta)."""
    f = (1.0 - g) * (1.0 + g) / (1.0 - g + 2.0 * g * u_g)
    small_g = torch.abs(g) < 1e-6
    cos_hg = (1.0 + g * g - f * f) / (2.0 * torch.where(small_g, 1.0, g))
    return torch.where(small_g, 2.0 * u_g - 1.0,
                       torch.clamp(cos_hg, -1.0, 1.0))


def _scatter_direction(costheta, u_phi, DX, DY, DZ):
    """The direction at polar cosine costheta and azimuth 2 pi u_phi about
    (DX, DY, DZ): the branchless Frisvad frame (common.cuh
    scatter_direction)."""
    phi = _f32(2.0 * np.pi) * u_phi
    sintheta = torch.sqrt(torch.clamp(1.0 - costheta * costheta, min=0.0))
    cosphi = torch.cos(phi)
    sinphi = torch.sin(phi)
    sign = torch.where(DZ >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + DZ)
    b = DX * DY * a
    ux = 1.0 + sign * DX * DX * a
    uy = sign * b
    uz = -sign * DX
    vx = b
    vy = sign + DY * DY * a
    vz = -DY
    nxd = sintheta * (cosphi * ux + sinphi * vx) + costheta * DX
    nyd = sintheta * (cosphi * uy + sinphi * vy) + costheta * DY
    nzd = sintheta * (cosphi * uz + sinphi * vz) + costheta * DZ
    inv_n = torch.rsqrt(torch.clamp(nxd * nxd + nyd * nyd + nzd * nzd,
                                    min=_TINY))
    return nxd * inv_n, nyd * inv_n, nzd * inv_n


def mono_event_plain(spec: MonoEventSpec, u, state, lam=None):
    """One monochromatic scattering event for every lane, plain PyTorch.

    Mirrors the Pallas body (skirt_tpu/engine/fused.py:240-560) operation
    for operation.  state: px, py, pz, dx, dy, dz, L, alive, ns, ell, L0
    (and bc with refill).  lam: the per-lane wavelength tables of the
    Pallas body's lam_inputs contract (3 or 3H (N,) tensors), or None to
    gather them from the spec's table by ell.  Returns a dict: "state"
    (px, py, pz, dx, dy, dz, L, alive, ns), "tau", "cos" (nlead, N),
    "phase" (nlead, N) with H > 1, "depi"/"depv" with labs, "bc"/"fresh"
    with refill."""
    H = spec.H
    multi = H > 1
    npanels = spec.npanels
    X, Y, Z, DX, DY, DZ, L = state[:7]
    alive = state[7] != 0
    nscatt = state[8]
    ell = state[9]
    L0 = state[10]
    span = spec.span
    xi = spec.xi
    out = {}
    if lam is None:
        lam = spec.lane_tables(ell)
    if multi:
        kextm_l = list(lam[:H])
        kscam_l = list(lam[H:2 * H])
        g_l = list(lam[2 * H:3 * H])
        g = g_l[0]
    else:
        kextm_l = [lam[0]]
        albedo = lam[1]
        g = lam[2]
    kextm = kextm_l[0]
    Lth = L0 * spec.inv_minred

    # -- traverse: equal-panel quadrature of the analytic density ---------
    t0, t1 = span(X, Y, Z, DX, DY, DZ)
    delta = (t1 - t0) * spec.inv_np
    cum = torch.zeros_like(L)
    cums, albs = [], []
    for kk in range(npanels):
        midk = t0 + _f32(kk + 0.5) * delta
        mx, my, mz = X + midk * DX, Y + midk * DY, Z + midk * DZ
        if multi:
            dke = torch.zeros_like(L)
            dks = torch.zeros_like(L)
            for h in range(H):
                rho = spec.rho_s(h, mx, my, mz)
                dke = dke + kextm_l[h] * rho
                dks = dks + kscam_l[h] * rho
            albs.append(torch.where(dke > 0, dks / torch.clamp(dke, min=1e-37),
                                    0.0))
            cum = cum + dke * delta
        else:
            rho = spec.rho_s(0, mx, my, mz)
            cum = cum + kextm * rho * delta
        cums.append(cum)
    taupath = cum
    one_m_e = 1.0 - torch.exp(-taupath)
    Lm = torch.where(alive, L, 0.0)

    if multi:
        # per-panel absorbed/scattered split: the local albedo varies
        # along the path
        e_prev = torch.ones_like(L)
        Lsca_f = torch.zeros_like(L)
        cab = torch.zeros_like(L)
        cumabs = []
        for kk in range(npanels):
            e_k = torch.exp(-cums[kk])
            seg = e_prev - e_k
            Lsca_f = Lsca_f + albs[kk] * seg
            cab = cab + (1.0 - albs[kk]) * seg
            cumabs.append(cab)
            e_prev = e_k

    # -- sampled absorption deposit -----------------------------------------
    if spec.want_labs:
        u_dep = u[2]
        if multi:
            D = cab * Lm
            target = u_dep * cab
            below = (torch.stack(cumabs[:npanels - 1]) < target[None]
                     if npanels > 1 else None)
        else:
            D = (1.0 - albedo) * Lm * one_m_e
            tau_dep = _expon_cutoff(u_dep, taupath)
            below = (torch.stack(cums[:npanels - 1]) < tau_dep[None]
                     if npanels > 1 else None)
        i_dep = (below.sum(0).to(torch.int32) if below is not None
                 else torch.zeros_like(nscatt))
        mid_dep = t0 + (i_dep.to(torch.float32) + 0.5) * delta
        cell = spec.locate(X + mid_dep * DX, Y + mid_dep * DY,
                           Z + mid_dep * DZ)
        okd = (cell >= 0) & (D > 0) & alive
        out["depi"] = torch.where(okd, cell * spec.nlambda + ell, -1)
        out["depv"] = torch.where(okd, D, 0.0)

    # -- scattered-luminosity update + termination (pre-bias L) -------------
    if multi:
        L = torch.where(alive, Lsca_f * Lm, L)
    else:
        L = torch.where(alive, albedo * Lm * one_m_e, L)
    alive = alive & (L > 0) & torch.logical_not(
        (L <= Lth) & (nscatt >= spec.min_scatt)) & (taupath > 0)

    # -- forced propagation ------------------------------------------------
    u1 = u[0]
    u2 = u[1]
    tau_exp = _expon_cutoff(u2, taupath)
    if xi == 0.0:
        tau = tau_exp
    else:
        tau = torch.where(u1 < xi, u2 * taupath, tau_exp)
        p = torch.exp(-tau) / torch.clamp(one_m_e, min=_TINY)
        # a true division (torch evaluates `scalar / tensor` as
        # reciprocal(tensor) * scalar, which rounds twice)
        qq = spec.one_m_xi * p + (torch.full_like(taupath, xi)
                                  / torch.clamp(taupath, min=_TINY))
        L = torch.where(alive, L * (p / torch.clamp(qq, min=1e-37)), L)
    s = _hit_point(cums, npanels, tau, t0, delta)
    X = torch.where(alive, X + s * DX, X)
    Y = torch.where(alive, Y + s * DY, Y)
    Z = torch.where(alive, Z + s * DZ, Z)

    # -- persistent-lane relaunch ------------------------------------------
    fresh = torch.zeros_like(alive)
    if spec.refill:
        bcount = state[11]
        eligible = torch.logical_not(alive) & (bcount < spec.K)
        nu, sample = spec.sampler_geometry.device_sampler_xyz()
        xs, ys, zs = sample([u[5 + j] for j in range(nu)])
        ct = 2.0 * u[5 + nu] - 1.0
        st_ = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
        ph2 = _f32(2.0 * np.pi) * u[6 + nu]
        X = torch.where(eligible, xs, X)
        Y = torch.where(eligible, ys, Y)
        Z = torch.where(eligible, zs, Z)
        DX = torch.where(eligible, st_ * torch.cos(ph2), DX)
        DY = torch.where(eligible, st_ * torch.sin(ph2), DY)
        DZ = torch.where(eligible, ct, DZ)
        L = torch.where(eligible, L0, L)
        nscatt = torch.where(eligible, 0, nscatt)
        bcount = bcount + eligible.to(torch.int32)
        fresh = eligible
        alive = alive | eligible
        out["bc"] = bcount
        out["fresh"] = fresh.to(torch.int32)

    # -- local mixture at the interaction point (H > 1): component h with
    #    probability ~ ksca_h rho_h; the peel phase is the blend -----------
    if multi:
        w_h = [kscam_l[h] * spec.rho_s(h, X, Y, Z) for h in range(H)]
        w_tot = w_h[0]
        for h in range(1, H):
            w_tot = w_tot + w_h[h]
        u_c = u[spec.u_comp] * torch.clamp(w_tot, min=1e-37)
        g = g_l[0]
        w_acc = w_h[0]
        for h in range(1, H):
            g = torch.where(u_c > w_acc, g_l[h], g)
            w_acc = w_acc + w_h[h]

    # -- peel-off optical depth and cosine toward each leader -------------
    taus, coss, phs = [], [], []
    for kx, ky, kz in spec.leaders:
        if not spec.scattering_peeloff:
            coss.append(torch.zeros_like(L))
            taus.append(torch.zeros_like(L))
            phs.append(torch.zeros_like(L))
            continue
        fx, fy, fz = _f32(kx), _f32(ky), _f32(kz)
        cosj = DX * fx + DY * fy + DZ * fz
        coss.append(cosj)
        if multi:
            ph = torch.zeros_like(L)
            for h in range(H):
                gh = g_l[h]
                t_ = 1.0 + gh * gh - 2.0 * gh * cosj
                ph = ph + w_h[h] * ((1.0 - gh) * (1.0 + gh)
                                    * torch.rsqrt(t_ * t_ * t_))
            phs.append(torch.where(w_tot > 0,
                                   ph / torch.clamp(w_tot, min=_TINY), 0.0))
        pt0, pt1 = span(X, Y, Z, kx, ky, kz, const_d=True)
        pd = (pt1 - pt0) * spec.inv_pp
        rsum = torch.zeros_like(L)
        for kk in range(spec.np_peel):
            mk = pt0 + _f32(kk + 0.5) * pd
            mx, my, mz = X + mk * fx, Y + mk * fy, Z + mk * fz
            if multi:
                for h in range(H):
                    rsum = rsum + kextm_l[h] * spec.rho_s(h, mx, my, mz)
            else:
                rsum = rsum + spec.rho_s(0, mx, my, mz)
        taus.append((rsum if multi else kextm * rsum) * pd)
    out["tau"] = torch.stack(taus)
    out["cos"] = torch.stack(coss)
    if multi:
        out["phase"] = torch.stack(phs)

    # -- Henyey-Greenstein scatter (fresh lanes keep their launch dir) ----
    costheta = _hg_costheta(g, u[3])
    nx, ny, nz = _scatter_direction(costheta, u[4], DX, DY, DZ)
    scat = alive & torch.logical_not(fresh)
    DX = torch.where(scat, nx, DX)
    DY = torch.where(scat, ny, DY)
    DZ = torch.where(scat, nz, DZ)
    nscatt = torch.where(scat, nscatt + 1, nscatt)

    if trace.enabled():
        # the lanes that did an event: alive on entry, or relaunched
        trace.count_live(u.device, (state[7] != 0) | fresh)
    out["state"] = (X, Y, Z, DX, DY, DZ, L, alive.to(torch.int32), nscatt)
    return out


def cuda_route(spec: MonoEventSpec):
    """(chunked, scratch rows) of K3 for a spec: the one-pass route up to
    MAXP panels, MAX_LEAD observers, MAX_COMP components and MAX_TABLE
    table floats, else the chunked route (csrc/fused_mono.cu), whose
    scratch holds each panel chunk's last optical depth and, with H > 1
    and labs, every cumulative absorbed fraction."""
    chunked = (spec.npanels > _CUDA_MAXP
               or len(spec.leaders) > kernels.MonoArgs.MAX_LEAD
               or spec.H > kernels.MonoArgs.MAX_COMP
               or spec.tab.size > kernels.MonoArgs.MAX_TABLE)
    rows = kernels.nchunks(spec.npanels)
    if spec.H > 1 and spec.want_labs:
        rows += spec.npanels
    return chunked, rows if chunked else 0


def _cuda_args(spec: MonoEventSpec):
    """The kernel's constant arguments and template choices for a spec."""
    dens = [geom.cuda_density(spec.lscale)
            for geom in spec.density_geometries]
    kinds = {d[0] if d else None for d in dens}
    if len(kinds) != 1 or not kinds <= set(_CUDA_DENSITY):
        raise ValueError("mono_event kernel: no CUDA device density for "
                         + ", ".join(type(g).__name__
                                     for g in spec.density_geometries))
    samp = None
    if spec.refill:
        samp = spec.sampler_geometry.cuda_sampler()
        if samp is None or samp[0] not in _CUDA_SAMPLER:
            raise ValueError(f"mono_event kernel: no CUDA device sampler "
                             f"for {type(spec.sampler_geometry).__name__}")
    a = kernels.MonoArgs()
    a.nlambda = spec.nlambda
    a.H = spec.H
    a.npanels = spec.npanels
    a.np_peel = spec.np_peel
    a.nlead = len(spec.leaders)
    a.min_scatt = spec.min_scatt
    a.K = spec.K
    a.scattering_peeloff = int(spec.scattering_peeloff)
    a.u_comp = spec.u_comp
    a.xi = spec.xi
    a.one_m_xi = spec.one_m_xi
    a.inv_np = spec.inv_np
    a.inv_pp = spec.inv_pp
    a.inv_minred = spec.inv_minred
    _geom_args(a, spec.box, spec.grid, spec.want_labs, spec.leaders,
               spec.invL, dens[0][1], samp[1] if samp else None)
    if spec.H > 1:
        for i, v in enumerate(dens[1][1]):
            a.dens1[i] = v
    # the chunked route's components: 8 float32 constants each
    a.dens_rows = [float(v) for d in dens for v in (list(d[1]) + [0.0] * 8)[:8]]
    return a, (_CUDA_DENSITY[dens[0][0]],
               _CUDA_SAMPLER[samp[0] if samp else None])


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _mono_event_cuda(spec, u, state):
    N = state[0].shape[0]
    nlead = len(spec.leaders)
    dev = u.device
    n_state = 12 if spec.refill else 11
    if len(state) != n_state:
        raise ValueError(f"mono_event: expected {n_state} state arrays")
    checks = [(u, (spec.n_uniform, N), torch.float32)]
    dts = [torch.float32] * 7 + [torch.int32] * 3 + [torch.float32] \
        + [torch.int32] * (n_state - 11)
    checks += [(s, (N,), dt) for s, dt in zip(state, dts)]
    for t, shape, dt in checks:
        if (t.device != dev or tuple(t.shape) != shape or t.dtype != dt
                or not t.is_contiguous()):
            raise ValueError(f"mono_event kernel: expected a contiguous "
                             f"{dt} tensor of shape {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    a, (dens, samp) = _cuda_args(spec)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    st_out = [torch.empty(N, **f32) for _ in range(7)] \
        + [torch.empty(N, **i32) for _ in range(2)]
    tau = torch.empty((nlead, N), **f32)
    cos = torch.empty((nlead, N), **f32)
    out = {"state": tuple(st_out), "tau": tau, "cos": cos}
    depi = depv = ph = bc = fresh = None
    if spec.want_labs:
        depi = out["depi"] = torch.empty(N, **i32)
        depv = out["depv"] = torch.empty(N, **f32)
    if spec.H > 1:
        ph = out["phase"] = torch.empty((nlead, N), **f32)
    if spec.refill:
        bc = out["bc"] = torch.empty(N, **i32)
        fresh = out["fresh"] = torch.empty(N, **i32)
    a.N = N
    ins = [u, spec.table(dev), *state[:11],
           state[11] if spec.refill else None]
    for name, t in zip(("u", "tab", "px", "py", "pz", "dx", "dy", "dz", "L",
                        "alive", "ns", "ell", "L0", "bc"), ins):
        setattr(a, name, _ptr(t))
    outs = [*st_out, depi, depv, tau, cos, ph, bc, fresh]
    for name, t in zip(("opx", "opy", "opz", "odx", "ody", "odz", "oL",
                        "oalive", "ons", "odepi", "odepv", "otau", "ocos",
                        "oph", "obc", "ofresh"), outs):
        setattr(a, name, _ptr(t))
    chunked, rows = cuda_route(spec)
    if chunked:
        cend = torch.empty((rows, N), dtype=torch.float32, device=dev)
        a.cend = cend.data_ptr()
        a.dens_h = kernels.device_floats(a.dens_rows, dev).data_ptr()
        if nlead:
            a.lead = kernels.device_floats(kernels.lead_rows(spec.leaders),
                                           dev).data_ptr()
    a.live = _ptr(trace.live_counter(dev))
    lib = kernels.library()
    kernels.check(lib.skirt_mono_event(ctypes.byref(a), dens, samp,
                                       int(spec.want_labs),
                                       kernels.stream_of(u)),
                  "mono_event kernel")
    mono_event.launches += 1
    return out


def mono_event(spec: MonoEventSpec, u, state):
    """The event on CPU tensors (plain version) or CUDA tensors (the K3
    kernel, counted in `mono_event.launches`).  Same contract as
    mono_event_plain with the tables gathered from the spec.  While
    tracing, both count the lanes in `trace`'s lane_slots and
    live_lanes."""
    trace.count_slots(state[0].shape[0])
    if u.device.type == "cpu":
        return mono_event_plain(spec, u, state)
    if u.device.type != "cuda":
        raise ValueError(f"mono_event: unsupported device {u.device}")
    return _mono_event_cuda(spec, u, state)


mono_event.launches = 0


# ---------------------------------------------------------------------------
# the lifecycle driver
# ---------------------------------------------------------------------------

def make_fused_lifecycle(grid, dust_system, stellar_system, instruments,
                         options, nlambda: int, launch_fn=None,
                         emission_peeloff: bool = True,
                         scattering_peeloff: bool = True,
                         is_dust_emission=False, mueller=None,
                         io_state: bool = False,
                         max_iterations: int | None = None):
    """Build run_batch(key, ell, L0, tallies) with the whole scattering
    event in kernel K3.

    ell (N,) int32 wavelength indices and L0 (N,) float32 launch
    luminosities on the run's device; the tallies (float32 tensors on the
    same device) are updated in place and returned.  Raises ValueError
    for configurations outside the fused path or not ported yet.

    The event loop runs at most max_scatt_events * K iterations and stops
    when no lane is alive and no lane has launch budget left; the host
    reads that condition every _CHECK_EVERY iterations (an iteration over
    finished lanes changes nothing)."""
    from . import vector_traversal as vt
    from .lifecycle import make_peel_off

    ds = dust_system
    _validate(grid, ds, instruments, options, nlambda, mueller, io_state,
              stellar_system, launch_fn)
    npanels = int(options.quadrature_panels
                  or getattr(grid, "max_steps", 96))
    np_peel = int(options.peel_panels or npanels)
    want_labs = bool(options.store_absorption)
    leaders, lead_of = _group_leaders(instruments)
    refill = options.refill_batches > 1
    K = int(options.refill_batches) if refill else 1
    multi = ds.ncomp > 1
    spec = _build_kernel(
        grid, ds, leaders, npanels, np_peel, options, nlambda, want_labs,
        scattering_peeloff,
        stellar_system.components[0].geometry if refill else None)
    peels = [make_peel_off(grid, ds, ins) for ins in instruments]
    mix = ds.components[0].mix
    iter_cap = int(max_iterations if max_iterations is not None
                   else options.max_scatt_events) * K
    # polarized: K3 runs unchanged; its per-leader cosines feed a
    # torch-side Mueller peel, and the direction it scattered to is
    # overridden by the torch-side Mueller sample, the Stokes ratios and
    # the reference normal riding as loop state (skirt_tpu fused.py:615-628,
    # :798-990; ref: DustMix.cpp:584-620 and peeloffscattering's polarized
    # branch)
    mt = pol.first_table(mueller)

    def leader_taus(pos, kext_pk):
        """Panel quadrature toward each leader (emission peel-off)."""
        taus = []
        for kvec in leaders:
            kobs = torch.tensor(np.asarray(kvec, np.float32),
                                device=pos.device).expand(pos.shape[0], 3)
            dsg, _, mid = vt.panel_paths(grid, pos, kobs, np_peel)
            rows = ds.analytic_rows(pos, kobs, mid, None, kext_pk,
                                    want_sca=False)
            taus.append((rows * dsg).sum(1))
        return taus

    def run_batch(key, ell, L0, tallies):
        with trace.span("launch"):
            n = ell.shape[0]
            dev = ell.device
            k_launch, k_cycle = rng.split(rng.event_key(key, 1))
            pos, direction, L, _ = stellar_system.launch(k_launch, ell, L0)
            alive = L > 0
            ins = tallies["instruments"]
            labs = tallies.get("labs")
            dust = torch.full((n,), bool(is_dust_emission), device=dev)

            if emission_peeloff:
                _, kext_pk = ds.packet_kappas(ell)
                taus0 = leader_taus(pos, kext_pk)
                contribution = torch.where(alive, L, 0.0)
                tags = {"nscatt": torch.zeros(n, dtype=torch.int32,
                                              device=dev),
                        "is_dust": dust}
                for i, peel in enumerate(peels):
                    peel(ins[i], pos, ell, contribution, tags,
                         tau=taus0[lead_of[i]])

            ell = ell.to(torch.int32).contiguous()
            state = [pos[:, 0].contiguous(), pos[:, 1].contiguous(),
                     pos[:, 2].contiguous(), direction[:, 0].contiguous(),
                     direction[:, 1].contiguous(),
                     direction[:, 2].contiguous(),
                     L.to(torch.float32).contiguous(), alive.to(torch.int32),
                     torch.zeros(n, dtype=torch.int32, device=dev), ell,
                     L0.to(torch.float32).contiguous()]
            if refill:
                state.append(torch.ones(n, dtype=torch.int32, device=dev))
            if mt is not None:
                # normalized Stokes ratios and the reference normal; packets
                # launch unpolarized (a zero normal: no reference yet)
                stokes = (torch.zeros(n, device=dev),
                          torch.zeros(n, device=dev),
                          torch.zeros(n, device=dev),
                          torch.zeros((n, 3), device=dev))
                pf = mt.table("pfnorm", dev)[ell.long()]
                kobs_lead = pol.observer_rows(leaders, n, dev)
                ky_ins = pol.frame_axes(instruments, n, dev)

        for it in range(iter_cap):
            if it % _CHECK_EVERY == 0:
                with trace.span("check"):
                    go = state[7].any()
                    if refill:
                        go = go | (state[11] < K).any()
                    go = bool(go)
                if not go:
                    break
            with trace.span("event"):
                u = rng.uniform_open(rng.event_key(k_cycle, it),
                                     (spec.n_uniform, n), dev)
                out = mono_event(spec, u, state)
                st = list(out["state"])
                if want_labs and labs is not None:
                    binned_add(labs, out["depi"], out["depv"])
                alive_new = st[7] != 0
                fresh = out["fresh"] != 0 if refill else None
            if mt is not None:
                with trace.span("mueller"):
                    # -- the Mueller scatter: the pre-event Stokes ratios
                    # and direction feed both the scatter and the peel
                    dir_old = torch.stack(state[3:6], dim=-1)
                    pdeg, pang, nrm0, new, nd = pol.mueller_scatter(
                        mt, rng.event_key(k_cycle, it, 13), ell, stokes,
                        dir_old)
                    # the kernel relaunched fresh lanes in place: they keep
                    # their launch direction
                    scat = alive_new if fresh is None else alive_new & ~fresh
                    for a in range(3):
                        st[3 + a] = torch.where(scat, nd[:, a], st[3 + a]) \
                            .contiguous()
            if scattering_peeloff:
                with trace.span("peel"):
                    pos_new = torch.stack(st[:3], dim=-1)
                    tags = {"nscatt": st[8], "is_dust": dust}
                    if mt is not None:
                        with trace.span("mueller"):
                            speel = pol.StokesPeel(
                                partial(mt.lookup, ell), pf, stokes, pdeg,
                                pang, nrm0, dir_old, fresh)
                    for i, peel in enumerate(peels):
                        j = lead_of[i]
                        tg = tags
                        if mt is not None:
                            # the Mueller peel toward the leader, in this
                            # instrument's frame
                            with trace.span("mueller"):
                                w, stk = speel(j, out["cos"][j],
                                               kobs_lead[j], ky_ins[i])
                            tg = dict(tags, stokes=stk)
                        elif multi:
                            # blended in the kernel (DustSystem.phase_value
                            # form)
                            w = out["phase"][j]
                        else:
                            w = mix.phase_function(ell, out["cos"][j])
                        if refill:
                            # relaunched lanes: isotropic (unpolarized)
                            # emission peel-off, from the same quadrature at
                            # the fresh position
                            w = torch.where(fresh, 1.0, w)
                        con = torch.where(alive_new, st[6] * w, 0.0)
                        peel(ins[i], pos_new, ell, con, tg,
                             tau=out["tau"][j])
            if mt is not None:
                with trace.span("mueller"):
                    stokes = pol.carry_stokes(stokes, new, scat, fresh)
            state = st + state[9:11]
            if refill:
                state.append(out["bc"])
        return tallies

    run_batch.spec = spec
    return run_batch
