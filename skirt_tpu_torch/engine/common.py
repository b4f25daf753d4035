"""The fused drivers' shared skeleton, and the helpers their events share.

The four lifecycle drivers (engine/fused.py: kernel K3, fused_poly.py: K1,
fused_table.py: K4 and K5, fused_table_poly.py: K6 and K7) run one loop:
decode the options (`plan`), launch a batch, then run event iterations
until no lane is alive and none has launch budget left (`events`), each
with the labs deposit (`deposit`), on the table drivers the torch-side
relaunch (`relaunch`), on the polarized ones the Stokes state (`Stokes`),
and the merged peel-off toward the instruments (`peel_mono`,
`peel_poly`).  Those parts live here; each driver keeps its kernel, its
launch and its event step.  This module imports no driver.

The elementwise helpers (_expon_cutoff to _scatter_direction) twin
skirt_tpu/engine/fused.py:55-144 and the event bodies' shared steps;
csrc/common.cuh carries the same arithmetic as `__device__` functions.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels, rng, trace
from ..media import polarization as pol
from ..numerics import f32
from ..ops import binned_add
from . import vector_traversal as vt

_BIG = 3.4e38
_TINY = 1e-30
_CUDA_MAXP = kernels.MAXP   # panels of the kernels' one-pass routes
_CUDA_DENSITY = {"expdisk": 1}
_CUDA_SAMPLER = {None: 0, "point": 1, "expdisk": 2}
_CHECK_EVERY = 16        # event iterations between host reads of the stop test


# ---------------------------------------------------------------------------
# the events' elementwise helpers
# ---------------------------------------------------------------------------

def _expon_cutoff(u, taumax):
    """Truncated-exponential optical-depth sample, the in-kernel form:
    no expm1/log1p, and a small-taumax branch below 1e-4 (the driver-side
    rng.expon_cutoff switches below 1e-6)."""
    tau = -torch.log(torch.clamp(1.0 - u * (1.0 - torch.exp(-taumax)),
                                 min=1e-37))
    return torch.where(taumax < 1e-4, u * taumax, torch.minimum(tau, taumax))


def _axis_span(o, d, lo, hi, tn, tf, const_d):
    """Slab-test update for one axis; const_d means d is a Python float."""
    lo32 = f32(lo)
    hi32 = f32(hi)
    if const_d:
        if abs(d) > 1e-30:
            inv = f32(1.0 / d)
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


def _uniform_grid(grid) -> bool:
    return bool(hasattr(grid, "_uniform") and all(grid._uniform))


def _make_locate(grid):
    """Arithmetic point location for uniform-spacing Cartesian grids."""
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    lo = [f32(v) for v in grid._lo]
    inv = [f32(1.0 / d) for d in grid._dx]

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


def _locate_args(a, grid):
    """Fill the arithmetic-locate fields of a kernels.Geom."""
    a.nx, a.ny, a.nz = grid.nx, grid.ny, grid.nz
    for i in range(3):
        a.loc_lo[i] = f32(grid._lo[i])
        a.loc_inv[i] = f32(1.0 / grid._dx[i])


def _geom_args(a, box, grid, want_labs, leaders, invL, dens, samp):
    """Fill the Geom fields of a kernel argument struct (kernels.Geom):
    the box, the arithmetic locate (with labs), the leaders' directions
    and inverse components, the density and sampler constants."""
    a.invL = invL
    for i in range(3):
        a.box_lo[i] = f32(box[i])
        a.box_hi[i] = f32(box[3 + i])
    if want_labs:
        _locate_args(a, grid)
    # the one-pass routes' observers (the chunked routes read them all from
    # a device buffer, kernels.lead_rows)
    for j, kvec in enumerate(leaders[:kernels.MAX_LEAD]):
        for i, d in enumerate(kvec):
            a.lead_k[j][i] = f32(d)
            moving = abs(d) > 1e-30
            a.lead_moving[j][i] = int(moving)
            a.lead_inv[j][i] = f32(1.0 / d) if moving else 0.0
    for i, v in enumerate(dens):
        a.dens[i] = v
    for i, v in enumerate(samp or ()):
        a.samp[i] = v


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _set_ptrs(a, names, tensors):
    """Point the fields `names` (space-separated) of a kernel argument
    struct at the tensors' data, one each (None: a null pointer)."""
    for name, t in zip(names.split(), tensors, strict=True):
        setattr(a, name, _ptr(t))


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


def _invert(cums_t, P, target):
    """The panel of the (P, N) cumulative sums where target lands and the
    fraction into it, linear within the panel (the Pallas bodies'
    invert)."""
    i_hit = (cums_t[:P - 1] < target[None]).sum(0).to(torch.int32)
    h64 = i_hit.long()
    cum_hi = cums_t.gather(0, h64[None])[0]
    cum_prev = torch.where(
        i_hit > 0, cums_t.gather(0, torch.clamp(h64 - 1, min=0)[None])[0],
        0.0)
    dtau = cum_hi - cum_prev
    frac = torch.clamp(torch.where(dtau > 0, (target - cum_prev)
                                   / torch.clamp(dtau, min=_TINY), 0.0),
                       0.0, 1.0)
    return i_hit, frac


def _hit_point(cums, npanels, tau, t0, delta):
    """Panel of the cumulative optical depths where tau lands, and the
    path length to it (linear within the panel)."""
    i_hit, frac = _invert(torch.stack(cums), npanels, tau)
    return t0 + (i_hit.to(torch.float32) + frac) * delta


def _launch_in_event(spec, u, row, eligible, X, Y, Z, DX, DY, DZ):
    """The in-kernel relaunch (refill) of the plain K1 and K3: eligible
    lanes take a point of the stellar geometry's closed-form sampler from
    the uniforms u[row:row + nu] and an isotropic direction from the next
    two rows.  Returns the new X, Y, Z, DX, DY, DZ."""
    nu, sample = spec.sampler_geometry.device_sampler_xyz()
    xs, ys, zs = sample([u[row + j] for j in range(nu)])
    ct = 2.0 * u[row + nu] - 1.0
    st_ = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    ph2 = f32(2.0 * np.pi) * u[row + 1 + nu]
    return (torch.where(eligible, xs, X), torch.where(eligible, ys, Y),
            torch.where(eligible, zs, Z),
            torch.where(eligible, st_ * torch.cos(ph2), DX),
            torch.where(eligible, st_ * torch.sin(ph2), DY),
            torch.where(eligible, ct, DZ))


def _on_device(name, plain, cuda, spec, u, *args):
    """An event on CPU tensors (its plain version) or CUDA tensors (its
    kernel); any other device raises."""
    if u.device.type == "cpu":
        return plain(spec, u, *args)
    if u.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {u.device}")
    return cuda(spec, u, *args)


def _forced(spec, u_bias, u_tau, taupath, one_m_e, alive, L):
    """Forced propagation: the optical depth to the interaction point, a
    truncated exponential from u_tau, or with a scattering bias xi, with
    probability xi (u_bias < xi) uniform in [0, taupath]; then L carries
    the composite bias weight.  Returns (tau, L)."""
    tau_exp = _expon_cutoff(u_tau, taupath)
    xi = spec.xi
    if xi == 0.0:
        return tau_exp, L
    tau = torch.where(u_bias < xi, u_tau * taupath, tau_exp)
    p = torch.exp(-tau) / torch.clamp(one_m_e, min=_TINY)
    # a true division (torch evaluates `scalar / tensor` as
    # reciprocal(tensor) * scalar, which rounds twice)
    qq = spec.one_m_xi * p + (torch.full_like(taupath, xi)
                              / torch.clamp(taupath, min=_TINY))
    return tau, torch.where(alive, L * (p / torch.clamp(qq, min=1e-37)), L)


def _moved(alive, s, X, Y, Z, DX, DY, DZ):
    """The positions of the lanes alive after a path length s."""
    return (torch.where(alive, X + s * DX, X),
            torch.where(alive, Y + s * DY, Y),
            torch.where(alive, Z + s * DZ, Z))


def _scattered(alive, costheta, u_phi, DX, DY, DZ, nscatt, fresh=None):
    """The Henyey-Greenstein scatter at costheta: the lanes alive, less
    the fresh (relaunched) ones, which keep their launch direction, take
    the new direction and one more scattering.  Returns (DX, DY, DZ,
    nscatt)."""
    nx, ny, nz = _scatter_direction(costheta, u_phi, DX, DY, DZ)
    scat = alive if fresh is None else alive & torch.logical_not(fresh)
    return (torch.where(scat, nx, DX), torch.where(scat, ny, DY),
            torch.where(scat, nz, DZ), torch.where(scat, nscatt + 1, nscatt))


def _hg_costheta(g, u_g):
    """Henyey-Greenstein deflection cosine from one uniform (the Pallas
    bodies' form, common.cuh hg_costheta)."""
    f = (1.0 - g) * (1.0 + g) / (1.0 - g + 2.0 * g * u_g)
    small_g = torch.abs(g) < 1e-6
    cos_hg = (1.0 + g * g - f * f) / (2.0 * torch.where(small_g, 1.0, g))
    return torch.where(small_g, 2.0 * u_g - 1.0,
                       torch.clamp(cos_hg, -1.0, 1.0))


def _hg(g, cosa):
    """The Henyey-Greenstein phase function at cosine cosa."""
    t = 1.0 + g * g - 2.0 * g * cosa
    return (1.0 - g) * (1.0 + g) / torch.sqrt(t * t * t)


def _scatter_direction(costheta, u_phi, DX, DY, DZ):
    """The direction at polar cosine costheta and azimuth 2 pi u_phi about
    (DX, DY, DZ): the branchless Frisvad frame (common.cuh
    scatter_direction)."""
    phi = f32(2.0 * np.pi) * u_phi
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


# ---------------------------------------------------------------------------
# the drivers' preconditions and plan
# ---------------------------------------------------------------------------

def check_shared(bail, stellar_system, instruments, options, io_state,
                 launch_fn):
    """The preconditions every fused driver checks, after its own: no
    dust-emission launch, no io_state, discrete scattering, sampled
    deposits, distant instruments, one isotropic stellar component (the
    only launch ported).  bail(msg) raises with the driver's prefix."""
    if launch_fn is not None:
        bail("launch_fn (the dust-emission launch) is not ported yet "
             "(slice S3)")
    if io_state:
        bail("io_state not supported")
    if options.continuous_scattering:
        bail("continuous_scattering not supported")
    if options.store_absorption and options.deposition != "sampled":
        bail("absorption tallies require deposition='sampled'")
    for ins in instruments:
        if hasattr(ins, "observer_distance") or not hasattr(ins, "kobs"):
            bail("requires distant (constant-direction) instruments")
    if stellar_system is None:
        bail("requires a stellar system (its launch)")
    if not stellar_system.is_isotropic:
        bail("anisotropic stellar emission is not ported yet (slice S6)")
    if stellar_system.ncomp != 1:
        bail("requires a single isotropic stellar component (the others "
             "launch through slice S6)")


@dataclass(frozen=True)
class Plan:
    """What a driver decodes from (grid, instruments, options,
    max_iterations) before it builds its event."""
    npanels: int            # propagation panels a path
    np_peel: int            # panels a peel path (the staged peel's)
    want_labs: bool         # absorption tallies
    leaders: list           # the distinct observer directions
    lead_of: list           # each instrument's index into leaders
    refill: bool            # lanes relaunch (refill_batches > 1)
    K: int                  # launches a lane may make (1 without refill)
    iter_cap: int           # event iterations a batch runs at most
    count_events: bool      # the tallies gain "nevents"


def plan(grid, instruments, options, max_iterations=None) -> Plan:
    """The decoded options: the event loop runs at most max_scatt_events
    (or max_iterations) times K iterations."""
    npanels = int(options.quadrature_panels
                  or getattr(grid, "max_steps", 96))
    leaders, lead_of = _group_leaders(instruments)
    refill = options.refill_batches > 1
    K = int(options.refill_batches) if refill else 1
    return Plan(
        npanels=npanels, np_peel=int(options.peel_panels or npanels),
        want_labs=bool(options.store_absorption), leaders=leaders,
        lead_of=lead_of, refill=refill, K=K,
        iter_cap=int(max_iterations if max_iterations is not None
                     else options.max_scatt_events) * K,
        count_events=bool(getattr(options, "count_events", False)))


def table_peel_mode(grid, options, np_peel=None):
    """(arith_locate, peel mode) of a table driver: a uniform grid locates
    in the kernel; table_peel='exact' needs one, so elsewhere it
    downgrades to 'staged' with skirt_tpu's warning, whose two drivers
    word it apart: the monochromatic one names its np_peel panels
    (skirt_tpu fused_table.py:576-580), the polychromatic one none
    (fused_table_poly.py:699-703)."""
    arith_locate = _uniform_grid(grid)
    peel_mode = getattr(options, "table_peel", "exact")
    if peel_mode == "exact" and not arith_locate:
        warnings.warn(
            "table_peel='exact' needs a uniform Cartesian (voxel) grid; "
            "downgrading to 'staged' "
            + (f"({np_peel} panels) " if np_peel is not None else "")
            + f"on {type(grid).__name__} — peel "
            "flux carries a panel quadrature bias (use >=32 panels)",
            stacklevel=3)
        peel_mode = "staged"
    return arith_locate, peel_mode


def make_peel_off(grid, dust_system, instrument, rho_path_map=None):
    """Returns peel(tallies, pos, ell, contribution, tags, tau=...) that
    applies the extinction exp(-tau) toward the instrument and detects
    (skirt_tpu lifecycle.make_peel_off, which engine/lifecycle.py places).

    Ported: the shared-tau branch (the fused drivers compute tau once per
    observer direction) and the run without dust.  The fast-peeloff map
    (rho_path_map) and the grid-traversal optical depth belong to the
    general lifecycle and raise, naming slice S2b."""
    if rho_path_map is not None:
        raise ValueError("make_peel_off: the fast-peeloff density-path maps "
                         "(compute_rho_path_maps) are not ported yet "
                         "(slice S2b)")
    if hasattr(instrument, "observer_distance"):
        raise ValueError("make_peel_off: perspective instruments are not "
                         "ported yet (slice S6)")

    def peel(tallies, pos, ell, contribution, tags, active=None, cell=None,
             tau=None, kapparho=None):
        if tau is not None:
            extincted = contribution * torch.exp(-tau)
        elif dust_system is None:
            extincted = contribution
        else:
            raise ValueError("make_peel_off: the peel-off optical depth by "
                             "grid traversal is not ported yet (slice S2b)")
        if tags is not None:
            tags = dict(tags, transparent=contribution)
        return instrument.detect(tallies, pos, ell, extincted, tags)

    return peel


# ---------------------------------------------------------------------------
# the event loop
# ---------------------------------------------------------------------------

def batch_keys(key):
    """(k_launch, k_cycle): a batch's stellar-launch key and its event
    loop's, from which iteration `it` draws rng.event_key(k_cycle, it)
    (and the Mueller, relaunch and component draws its tags 13, 7, 11)."""
    return rng.split(rng.event_key(key, 1))


def uniforms(k_cycle, it, rows, n, device):
    """Iteration it's (rows, n) open uniforms, the event kernel's input."""
    return rng.uniform_open(rng.event_key(k_cycle, it), (rows, n), device)


def events(plan, lanes):
    """The event iterations 0, 1, ... of a batch, at most plan.iter_cap.

    Every _CHECK_EVERY iterations, from iteration 0, the host reads the
    stop test in the `check` span: lanes() gives the lanes' alive flags
    and launch counts, and the loop ends when no lane is alive and (with
    refill) none has launched fewer than K times.  An iteration over
    finished lanes changes nothing, so reading rarely keeps the host from
    waiting on the device each iteration."""
    for it in range(plan.iter_cap):
        if it % _CHECK_EVERY == 0:
            with trace.span("check"):
                alive, launches = lanes()
                go = alive.any()
                if plan.refill:
                    go = go | (launches < plan.K).any()
                go = bool(go)
            if not go:
                return
        yield it


def lane_columns(pos, direction):
    """The event kernels' first six state rows, px, py, pz, dx, dy, dz:
    contiguous (N,) columns of pos and direction (N, 3)."""
    return [c[:, i].contiguous() for c in (pos, direction) for i in range(3)]


def panel_taus(grid, ds, leaders, np_peel, pos, kext_pk):
    """The np_peel-panel quadrature toward each leader of the density
    rows weighted by kext_pk (DustSystem.analytic_rows: the closed forms,
    or the table's rows at the located panel midpoints): a list over
    leaders of (N,) depths."""
    taus = []
    for kvec in leaders:
        kobs = torch.as_tensor(np.asarray(kvec, np.float32),
                               device=pos.device).expand(pos.shape[0], 3)
        dsg, _, mid = vt.panel_paths(grid, pos, kobs, np_peel)
        rows = ds.analytic_rows(pos, kobs, mid, None, kext_pk,
                                want_sca=False)
        taus.append((rows * dsg).sum(1))
    return taus


def count_entry_lanes(alive):
    """A table event's lanes in the trace's lane_slots and live_lanes:
    those that did an event were alive on entry (int32 flags, or bool),
    since the table drivers relaunch lanes torch-side (nothing while
    tracing is off)."""
    if trace.enabled():
        trace.count_slots(alive.shape[0])
        trace.count_live(alive.device, alive if alive.dtype == torch.bool
                         else alive != 0)


class EventCount:
    """options.count_events' "nevents": the events run, one per lane alive
    at an iteration's start (scatterings plus each packet's final event),
    summed on the device."""

    def __init__(self, on, device):
        self.n = (torch.zeros((), dtype=torch.float32, device=device)
                  if on else None)

    def add(self, alive):
        if self.n is not None:
            self.n = self.n + alive.sum().to(torch.float32)

    def into(self, tallies):
        if self.n is not None:
            tallies["nevents"] = tallies.get("nevents", 0.0) + self.n


def direct_deposits(grid, pos, direction, mid_dep, value, wl, width):
    """Absorption bins and values of the deposits of a direct-table event
    (K4d, K6d): the point pos + mid_dep * dir of the PRE-event position
    and direction located with one grid.locate_batched, bins cell * width
    + wl; none (-1, 0) where mid_dep < 0, wl < 0 or the point lies outside
    the grid (skirt_tpu fused_table.py:868-879, fused_table_poly.py:
    977-988).  engine/fused_table.py places it."""
    cell = grid.locate_batched((pos + mid_dep[:, None] * direction)
                               [:, None, :])[:, 0]
    okd = (mid_dep >= 0) & (wl >= 0) & (cell >= 0)
    return (torch.where(okd, cell * width + wl, -1),
            torch.where(okd, value, 0.0))


def deposit(labs, out, direct=None):
    """An event's absorption deposits into the labs tally (nothing without
    a tally or deposits): the kernel's bins depi, or on a direct-table
    grid the deposit distances depd located by direct_deposits with
    `direct` = (grid, pre-event pos, direction, wavelengths, width), the
    wavelengths None for the kernel's sampled ones (K6d's depi)."""
    if labs is None or "depv" not in out:
        return
    if direct is None:
        binned_add(labs, out["depi"], out["depv"])
        return
    grid, pos, direction, wl, width = direct
    binned_add(labs, *direct_deposits(
        grid, pos, direction, out["depd"], out["depv"],
        out["depi"] if wl is None else wl, width))


def relaunch(stellar_system, key, K, pos, direction, L, ns, bc, alive,
             ell, L0, l0=None):
    """The table drivers' torch-side relaunch (refill), in the `launch`
    span: the lanes dead after the event with fewer than K launches take
    a new stellar launch from `key` at wavelengths ell and luminosities L0
    (their new L), or with l0 (W, N) the polychromatic lanes take l0 as
    their onward luminosities.  Returns (fresh, pos, direction, L, ns, bc,
    alive)."""
    with trace.span("launch"):
        fresh = (alive == 0) & (bc < K)
        pos_l, dir_l, L_l, _ = stellar_system.launch(key, ell, L0)
        f3 = fresh[:, None]
        pos = torch.where(f3, pos_l, pos)
        direction = torch.where(f3, dir_l, direction)
        L = (torch.where(fresh, L_l, L) if l0 is None
             else torch.where(fresh[None], l0, L))
        ns = torch.where(fresh, 0, ns)
        bc = bc + fresh.to(torch.int32)
        alive = alive | fresh.to(torch.int32)
    return fresh, pos, direction, L, ns, bc, alive


# ---------------------------------------------------------------------------
# polarization and the peel-offs
# ---------------------------------------------------------------------------

class Stokes:
    """The polarized drivers' Stokes state (skirt_tpu fused.py:615-628,
    fused_table_poly.py:866-874): per lane the normalized Stokes ratios q,
    u, v, (N,) or with W wavelengths a lane (W, N), and one reference
    normal (N, 3), launched unpolarized (a zero normal: no reference yet).
    With it, built once a batch, the phase-function normalization pf at
    the lanes' wavelengths ell (or every wavelength, (W, 1)) and the
    leaders' and instruments' axes: a copy to the card inside the event
    loop would make the host wait for the device."""

    def __init__(self, mt, leaders, instruments, n, device, ell=None,
                 W=None):
        shape = (n,) if W is None else (W, n)
        self.state = (torch.zeros(shape, device=device),
                      torch.zeros(shape, device=device),
                      torch.zeros(shape, device=device),
                      torch.zeros((n, 3), device=device))
        pf = mt.table("pfnorm", device)
        self.pf = pf[ell.long()] if W is None else pf[:, None]
        self.kobs_lead = pol.observer_rows(leaders, n, device)
        self.ky_ins = pol.frame_axes(instruments, n, device)

    def peel(self, lookup, pdeg, pang, normal, direction, fresh):
        """An event's polarized peel (pol.StokesPeel, from the pre-event
        state): weights(i, j, cosj) gives instrument i's (phase weights,
        Stokes tags) toward its leader j, in the `mueller` span."""
        with trace.span("mueller"):
            sp = pol.StokesPeel(lookup, self.pf, self.state, pdeg, pang,
                                normal, direction, fresh)

        def weights(i, j, cosj):
            with trace.span("mueller"):
                return sp(j, cosj, self.kobs_lead[j], self.ky_ins[i])

        return weights

    def carry(self, new, scat, fresh):
        """The state after an event (pol.carry_stokes)."""
        with trace.span("mueller"):
            self.state = pol.carry_stokes(self.state, new, scat, fresh)


def leader_cosines(direction, leaders):
    """cos(j): the (N,) cosines of the lanes' directions (N, 3) toward
    leader j, in float32."""
    def cos(j):
        kx, ky, kz = (f32(v) for v in leaders[j])
        return (direction[:, 0] * kx + direction[:, 1] * ky
                + direction[:, 2] * kz)

    return cos


def emit_mono(peels, ins, lead_of, pos, ell, contribution, tags, taus):
    """The monochromatic emission peel-off: every instrument's peel
    (make_peel_off) of `contribution` through its leader's depth taus[j]."""
    for i, peel in enumerate(peels):
        peel(ins[i], pos, ell, contribution, tags, tau=taus[lead_of[i]])


def peel_mono(peels, ins, lead_of, pos, ell, L, alive, tags, taus, cos,
              phase, fresh=None, polarized=None):
    """The monochromatic drivers' merged scattering peel-off toward every
    instrument: lanes that scattered with the phase weight phase(j, cosj)
    toward leader j at the cosine cos(j) of their incoming direction (or
    the Mueller weights and Stokes tags of `polarized`, a
    Stokes.peel(...)), fresh (relaunched) lanes with the isotropic
    emission weight 1, dead lanes with none, through depth taus[j]."""
    for i, peel in enumerate(peels):
        j = lead_of[i]
        cosj = cos(j)
        tg = tags
        if polarized is not None:
            w, stk = polarized(i, j, cosj)
            tg = dict(tags, stokes=stk)
        else:
            w = phase(j, cosj)
        if fresh is not None:
            w = torch.where(fresh, 1.0, w)
        con = torch.where(alive, L * w, 0.0)
        peel(ins[i], pos, ell, con, tg, tau=taus[j])


def emit_poly(instruments, ins, lead_of, pos, wls, contrib, minus_tau,
              tags):
    """The polychromatic emission peel-off: every instrument detects the
    (W, N) `contrib` extincted by exp(minus_tau(j)) toward its leader."""
    tags = dict(tags, transparent=contrib)
    for i, obj in enumerate(instruments):
        ext = contrib * torch.exp(minus_tau(lead_of[i]))
        obj.detect_poly(ins[i], pos, wls, ext, tags)


def peel_poly(instruments, ins, lead_of, pos, wls, Lp, Ln, alive, tags,
              minus_tau, cos, phase, fresh=None, polarized=None):
    """The polychromatic drivers' merged scattering peel-off toward every
    instrument: lanes that scattered carry their peel luminosities Lp
    (W, N) times the per-wavelength phase weights phase(j, cosj) toward
    leader j at the cosine cos(j) of their incoming direction (or the
    Mueller weights and Stokes tags of `polarized`, a Stokes.peel(...)),
    fresh (relaunched) lanes their onward Ln with the isotropic emission
    weight, dead lanes none, extincted by exp(minus_tau(j)) ((W, N),
    minus the optical depths toward leader j)."""
    for i, obj in enumerate(instruments):
        j = lead_of[i]
        cosj = cos(j)
        tg = dict(tags)
        if polarized is not None:
            pw, tg["stokes"] = polarized(i, j, cosj)
        else:
            pw = phase(j, cosj)
        cw = Lp * pw
        if fresh is not None:
            cw = torch.where(fresh[None], Ln, cw)
        cw = torch.where(alive[None], cw, 0.0)
        ext = cw * torch.exp(minus_tau(j))
        tg["transparent"] = cw
        obj.detect_poly(ins[i], pos, wls, ext, tg)
