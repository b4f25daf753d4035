"""Polarization: Stokes-vector algebra and Mueller-matrix scattering.

Twin of skirt_tpu/media/polarization.py: `rotate_stokes`,
`apply_mueller`, `rotate_normal`, `angle_between_planes`, the
`MuellerTables` with their samplers and lookups, and `thomson_mueller`.
ref: SKIRTcore/StokesVector.cpp (applyMueller, rotateStokes),
DustMix.cpp:537-671 (polarized scattering and peel-off),
ElectronDustMix.cpp (the Thomson Mueller matrix).

Conventions: the packet luminosity carries the intensity; q, u, v are the
normalized Stokes ratios Q/I, U/I, V/I; `normal` is the unit normal of the
current reference plane (a zero vector: no reference yet).

The tables are built on the host in float64 NumPy and rounded once to
float32, as skirt_tpu builds them, so both packages sample from the same
bits; each table is copied to a device once and cached there.  Every
sampler has a `_u` form that takes its uniforms as a tensor: the tests
feed both packages the same draws through it.

The last section holds the pieces the three polarized fused engines
share (engine/fused.py, fused_table.py, fused_table_poly.py): the random
default reference normal, the scatter's Stokes update and new direction,
and the polarized peel toward an observer with its rotation into the
instrument frame.  They are the blocks skirt_tpu repeats inline in each
driver, in the same order of operations.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import rng

# ---------------------------------------------------------------------------
# Stokes algebra (device side)
# ---------------------------------------------------------------------------


def rotate_stokes(q, u, phi):
    """Rotate the reference frame by phi about the propagation direction.

    ref: StokesVector::rotateStokes: Q' = Q cos 2phi + U sin 2phi,
    U' = -Q sin 2phi + U cos 2phi."""
    c = torch.cos(2.0 * phi)
    s = torch.sin(2.0 * phi)
    return q * c + u * s, -q * s + u * c


def apply_mueller(q, u, v, S11, S12, S33, S34):
    """Apply a block-diagonal Mueller matrix to normalized Stokes ratios.

    Returns (intensity factor, q', u', v').  The ratios are clamped to the
    physical ball q'^2 + u'^2 + v'^2 <= 1: where I' underflows (a fully
    polarized packet scattered into its zero-intensity direction) the raw
    ratios would blow up (ref: StokesVector::applyMueller)."""
    I2 = S11 + S12 * q
    Q2 = S12 + S11 * q
    U2 = S33 * u + S34 * v
    V2 = -S34 * u + S33 * v
    safe = torch.clamp(I2, min=1e-37)
    q2, u2, v2 = Q2 / safe, U2 / safe, V2 / safe
    norm = torch.sqrt(q2 * q2 + u2 * u2 + v2 * v2)
    scale = torch.where(norm > 1.0, 1.0 / torch.clamp(norm, min=1e-30), 1.0)
    return I2, q2 * scale, u2 * scale, v2 * scale


def _cross(a, b):
    """a x b over the last axis, each component a product difference
    rounded op by op (torch.linalg.cross fuses them on the CPU, so the
    cross product of parallel vectors would not come out exactly 0)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def rotate_normal(normal, direction, phi):
    """Rotate the reference normal about the propagation direction by phi
    (Rodrigues' formula)."""
    k = direction
    cosphi = torch.cos(phi)[..., None]
    sinphi = torch.sin(phi)[..., None]
    kxn = _cross(k, normal)
    kdotn = (k * normal).sum(-1, keepdim=True)
    return normal * cosphi + kxn * sinphi + k * kdotn * (1.0 - cosphi)


def angle_between_planes(np_normal, kc, kn):
    """Angle phi between the previous scattering plane (normal np_normal)
    and the plane spanned by (kc, kn); 0 where kc and kn are parallel.

    ref: DustMix.cpp angleBetweenScatteringPlanes."""
    nc = _cross(kc, kn)
    norm = torch.linalg.norm(nc, dim=-1, keepdim=True)
    nc = nc / torch.clamp(norm, min=1e-30)
    cosphi = (np_normal * nc).sum(-1)
    sinphi = (_cross(np_normal, nc) * kc).sum(-1)
    phi = torch.atan2(sinphi, cosphi)
    return torch.where(norm[..., 0] < 1e-20, 0.0, phi)


# ---------------------------------------------------------------------------
# Mueller tables
# ---------------------------------------------------------------------------

class MuellerTables:
    """Tabulated S11, S12, S33, S34 over (wavelength, theta) and their
    samplers (ref: DustMix polarization tables, theta-CDF sampling).

    Host tables (float32 NumPy, the bits of skirt_tpu's): S11..S34 and
    thetav (nlambda, ntheta); theta_cdf; pfnorm (nlambda,), the phase
    function normalization; theta_quantile (nlambda, NQ + 1), the inverse
    CDF at NQ + 1 uniform knots; S_packed (nlambda * ntheta, 4), one row
    per (ell, theta); S_theta_major (ntheta, 4 * nlambda), one row per
    theta serving every wavelength (the polychromatic lanes' lookup)."""

    NQ = 512

    def __init__(self, thetav, S11, S12, S33, S34):
        self.thetav64 = np.asarray(thetav, dtype=np.float64)
        self.ntheta = self.thetav64.size
        S11 = np.asarray(S11, dtype=np.float64)
        self.S11 = np.asarray(S11, np.float32)
        self.S12 = np.asarray(S12, np.float32)
        self.S33 = np.asarray(S33, np.float32)
        self.S34 = np.asarray(S34, np.float32)
        self.thetav = np.asarray(self.thetav64, np.float32)

        # per-wavelength theta CDF ~ S11 sin(theta) (ref: DustMix.cpp:716)
        w = S11 * np.sin(self.thetav64)[None, :]
        cdf = np.concatenate([np.zeros((S11.shape[0], 1)),
                              np.cumsum(0.5 * (w[:, 1:] + w[:, :-1])
                                        * np.diff(self.thetav64), axis=1)],
                             axis=1)
        total = cdf[:, -1:]
        self.theta_cdf = np.asarray(cdf / np.maximum(total, 1e-300),
                                    np.float32)
        # phase function normalization: N = 2 / int S11 sin dtheta
        # (ref: _pfnormv)
        self.pfnorm = np.asarray(2.0 / np.maximum(total[:, 0], 1e-300),
                                 np.float32)

        # the inverse CDF at NQ + 1 uniform knots: a sample is two flat
        # gathers and a lerp
        self.nq = self.NQ
        uq = np.linspace(0.0, 1.0, self.nq + 1)
        qt = np.empty((S11.shape[0], self.nq + 1), np.float64)
        for ell in range(S11.shape[0]):
            qt[ell] = np.interp(uq, self.theta_cdf[ell].astype(np.float64),
                                self.thetav64)
        self.theta_quantile = np.asarray(qt, np.float32)
        self.S_packed = np.ascontiguousarray(
            np.stack([self.S11, self.S12, self.S33, self.S34],
                     axis=-1).reshape(-1, 4))
        nl = self.S11.shape[0]
        self.S_theta_major = np.ascontiguousarray(
            np.stack([self.S11.T, self.S12.T, self.S33.T, self.S34.T],
                     axis=1).reshape(self.ntheta, 4 * nl))
        self._dev = {}

    @property
    def nlambda(self) -> int:
        return self.S11.shape[0]

    def table(self, name: str, device):
        """A host table as a tensor on `device` (copied once per device)."""
        key = (name, torch.device(device))
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(getattr(self, name),
                                             device=device)
        return self._dev[key]

    def theta_index(self, theta):
        """ref: DustMix.cpp indexForTheta."""
        dt = np.pi / (self.ntheta - 1)
        t = torch.round(theta / dt).to(torch.int64)
        return torch.clamp(t, 0, self.ntheta - 1)

    def sample_theta(self, key, ell):
        """Scattering angles from the S11 sin(theta) distribution at
        wavelength indices ell (N,), drawn from `key`."""
        return self.sample_theta_u(
            rng.uniform_open(key, ell.shape, ell.device), ell)

    def sample_theta_u(self, u, ell):
        """sample_theta with the uniforms given: the quantile table's two
        knots around u and a lerp."""
        x = u * np.float32(self.nq)
        i = torch.clamp(x.to(torch.int32), 0, self.nq - 1)
        frac = x - i.to(torch.float32)
        qt = self.table("theta_quantile", u.device).reshape(-1)
        base = ell.long() * (self.nq + 1) + i.long()
        q0 = qt[base]
        q1 = qt[base + 1]
        return q0 + frac * (q1 - q0)

    def sample_phi(self, key, ell, theta, pol_degree, pol_angle):
        """Azimuths from 1 + p (S12/S11) cos 2(phi - gamma), drawn from
        `key` (ref: DustMix::samplePhi)."""
        return self.sample_phi_u(
            rng.uniform_open(key, ell.shape, ell.device), ell, theta,
            pol_degree, pol_angle)

    def sample_phi_u(self, u, ell, theta, pol_degree, pol_angle):
        """sample_phi with the uniforms given: 26 bisection steps on the
        monotone CDF F(phi) = phi + a/2 (sin 2(phi - gamma) + sin 2 gamma),
        as skirt_tpu takes them (Newton stalls where F' touches zero, at
        |a| = 1: fully polarized Thomson at 90 degrees)."""
        t = self.theta_index(theta)
        idx = ell.long() * self.ntheta + t
        S11 = self.table("S11", u.device).reshape(-1)[idx]
        S12 = self.table("S12", u.device).reshape(-1)[idx]
        ratio = torch.where(S11 > 0, S12 / torch.clamp(S11, min=1e-30), 0.0)
        a = pol_degree * ratio
        target = 2.0 * math.pi * u
        s2g = torch.sin(2.0 * pol_angle)
        lo = torch.zeros_like(target)
        hi = torch.full_like(target, 2.0 * math.pi)
        for _ in range(26):
            mid = 0.5 * (lo + hi)
            F = mid + 0.5 * a * (torch.sin(2.0 * (mid - pol_angle)) + s2g)
            below = F < target
            lo = torch.where(below, mid, lo)
            hi = torch.where(below, hi, mid)
        return 0.5 * (lo + hi)

    def lookup(self, ell, theta):
        """(S11, S12, S33, S34) at (ell, theta) per lane: one packed 4-wide
        row per lane."""
        t = self.theta_index(theta)
        rows = self.table("S_packed", theta.device)[
            ell.long() * self.ntheta + t]
        return rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]

    def lookup_all(self, theta):
        """(S11, S12, S33, S34), each (W, N): every wavelength at one theta
        per lane, from one contiguous (4W,) theta-major row per lane."""
        t = self.theta_index(theta)
        rows = self.table("S_theta_major", theta.device)[t]
        r = rows.reshape(theta.shape[0], 4, self.nlambda)
        return tuple(r[:, i, :].T for i in range(4))


def thomson_mueller(nlambda: int, ntheta: int = 181) -> MuellerTables:
    """Thomson scattering's Mueller matrix, the same at every wavelength.

    ref: ElectronDustMix.cpp: S11 = (cos^2 + 1)/2, S12 = (cos^2 - 1)/2,
    S33 = cos, S34 = 0."""
    theta = np.linspace(0.0, np.pi, ntheta)
    c = np.cos(theta)
    S11 = np.tile(0.5 * (c * c + 1.0), (nlambda, 1))
    S12 = np.tile(0.5 * (c * c - 1.0), (nlambda, 1))
    S33 = np.tile(c, (nlambda, 1))
    S34 = np.zeros((nlambda, ntheta))
    return MuellerTables(theta, S11, S12, S33, S34)


def mueller_list(mueller):
    """`mueller` as a per-component list (a table, or a list of them with
    None for an unpolarized mix); [] for None."""
    if mueller is None:
        return []
    return list(mueller) if isinstance(mueller, (list, tuple)) else [mueller]


def first_table(mueller):
    """The single-component engines' Mueller table (the first entry of
    mueller_list), or None."""
    return (mueller_list(mueller) or [None])[0]


# ---------------------------------------------------------------------------
# the polarized fused engines' shared steps
# ---------------------------------------------------------------------------

def observer_rows(leaders, n, device):
    """Each observer direction (a tuple) as an (n, 3) float32 tensor, built
    once per batch (see frame_axes)."""
    return [torch.tensor(np.asarray(k, np.float32), device=device)
            .expand(n, 3) for k in leaders]


def polarization_of(q, u):
    """Linear polarization degree and angle of normalized Stokes ratios."""
    return torch.sqrt(q * q + u * u), 0.5 * torch.atan2(u, q)


def reference_normals(key, normal, direction):
    """The lanes' reference normals (N, 3): a lane without one (a zero
    normal: unpolarized so far) gets a random unit normal perpendicular to
    its direction, drawn from `key`."""
    have_n = torch.linalg.norm(normal, dim=-1) > 1e-6
    d = rng.isotropic_direction(key, (normal.shape[0],), normal.device)
    d = d - direction * (d * direction).sum(-1, keepdim=True)
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-30)
    return torch.where(have_n[:, None], normal, d)


def scatter_stokes(q, u, v, S, theta, phi, normal, direction):
    """The Stokes ratios, reference normal and direction after a scatter by
    (theta, phi) with Mueller elements S (ref: DustMix.cpp:584-620
    scatteringDirectionAndPolarization): q, u, v and S are (N,) or (W, N),
    theta and phi (N,); the normal and direction (N, 3).  Returns (q', u',
    v', normal', direction')."""
    ph = phi if q.dim() == 1 else phi[None]
    qr, ur = rotate_stokes(q, u, ph)
    nrm = rotate_normal(normal, direction, phi)
    _, qn, un, vn = apply_mueller(qr, ur, v, *S)
    nd = (direction * torch.cos(theta)[:, None]
          + _cross(nrm, direction) * torch.sin(theta)[:, None])
    nd = nd / torch.clamp(torch.linalg.norm(nd, dim=-1, keepdim=True),
                          min=1e-30)
    return qn, un, vn, nrm, nd


def mueller_scatter(mt, key, ell, stokes, direction):
    """The monochromatic engines' Mueller scatter of lanes at wavelength
    indices ell (N,) with Stokes state stokes = (q, u, v, normal), drawn
    from `key` as skirt_tpu folds it (0: theta, 1: phi, 2: the default
    normal).  Returns (pdeg, pang, the reference normals used, the new
    (q, u, v, normal), the new direction)."""
    q, u, v, normal = stokes
    pdeg, pang = polarization_of(q, u)
    nrm0 = reference_normals(rng.fold_in(key, 2), normal, direction)
    theta = mt.sample_theta(rng.fold_in(key, 0), ell)
    phi = mt.sample_phi(rng.fold_in(key, 1), ell, theta, pdeg, pang)
    *new, nd = scatter_stokes(q, u, v, mt.lookup(ell, theta), theta, phi,
                              nrm0, direction)
    return pdeg, pang, nrm0, tuple(new), nd


def carry_stokes(old, new, scat, fresh=None):
    """The lanes' Stokes state (q, u, v, normal) after an event: lanes
    that scattered take `new`, fresh (relaunched) lanes launch unpolarized,
    the rest keep `old`; q, u, v are (N,) or (W, N), the normal (N, 3)."""
    out = []
    for k, (o, n) in enumerate(zip(old, new)):
        s = scat[:, None] if k == 3 else scat
        if fresh is not None:
            o = torch.where(fresh[:, None] if k == 3 else fresh, 0.0, o)
        out.append(torch.where(s, n, o))
    return tuple(out)


def peel_toward(S, pf, q, u, v, pdeg, pang, normal, direction, kobs):
    """The polarized peel toward an observer direction kobs (N, 3) of
    lanes with pre-scatter Stokes ratios q, u, v (N,) or (W, N), their
    polarization degree and angle, reference normal and direction; S the
    Mueller elements at the scattering angle toward kobs, pf the phase
    function normalization broadcasting against them.

    Returns (phase weight, q, u, v after the scatter, the new reference
    normal (N, 3)), the Stokes ratios still in the scattering plane's frame
    (ref: DustMix peeloffscattering's polarized branch)."""
    phi = angle_between_planes(normal, direction, kobs)
    ph = phi if q.dim() == 1 else phi[None]
    qr, ur = rotate_stokes(q, u, ph)
    w = pf * (S[0] + pdeg * S[1] * torch.cos(2.0 * (ph - pang)))
    _, qh, uh, vh = apply_mueller(qr, ur, v, *S)
    nrm = _cross(direction, kobs)
    nn = torch.linalg.norm(nrm, dim=-1, keepdim=True)
    nrm = torch.where(nn > 1e-20, nrm / torch.clamp(nn, min=1e-30), normal)
    return w, qh, uh, vh, nrm


class StokesPeel:
    """One event's polarized peel, shared by the instruments: the peel
    toward each leader direction is computed once (peel_toward) and each
    instrument rotates its Stokes ratios into its own frame.

    `lookup(theta)` gives the Mueller elements at the lanes' scattering
    angles (MuellerTables.lookup at the lanes' wavelengths, or lookup_all);
    pf, the pre-scatter Stokes state (q, u, v, ...), pdeg, pang, normal and
    direction are peel_toward's; `fresh` (or None) marks relaunched lanes,
    which peel unpolarized."""

    def __init__(self, lookup, pf, stokes, pdeg, pang, normal, direction,
                 fresh=None):
        self.lookup, self.pf, self.stokes = lookup, pf, stokes[:3]
        self.pdeg, self.pang = pdeg, pang
        self.normal, self.direction, self.fresh = normal, direction, fresh
        self._lead = {}

    def __call__(self, j, cosj, kobs, ky):
        """(phase weight, Stokes tags (q, u, v)) of an instrument with axis
        ky (frame_axes) whose leader j looks along kobs, cosj the cosine of
        the lanes' scattering angle toward it."""
        if j not in self._lead:
            theta = torch.acos(torch.clamp(cosj, -1.0, 1.0))
            self._lead[j] = peel_toward(
                self.lookup(theta), self.pf, *self.stokes, self.pdeg,
                self.pang, self.normal, self.direction, kobs)
        w, qh, uh, vh, nrm = self._lead[j]
        q, u = to_instrument_frame(qh, uh, nrm, kobs, ky)
        stk = (q, u, vh)
        if self.fresh is not None:
            f = self.fresh if q.dim() == 1 else self.fresh[None]
            stk = tuple(torch.where(f, 0.0, x) for x in stk)
        return w, stk


def frame_axes(instruments, n, device):
    """Each instrument's ky axis as an (n, 3) float32 tensor (None for an
    instrument without one: its Stokes ratios stay in the scattering
    plane's frame).  Built once per batch: a copy to the card in the event
    loop would synchronize the host with the device."""
    return [torch.tensor(np.asarray(i.ky, np.float32), device=device)
            .expand(n, 3) if hasattr(i, "ky") else None
            for i in instruments]


def to_instrument_frame(q, u, normal, kobs, ky):
    """Rotate Stokes ratios whose reference normal is `normal` (N, 3) into
    the frame of an instrument with axis ky (frame_axes; None: no
    rotation), seen along kobs."""
    if ky is None:
        ky = normal
    cosal = (normal * ky).sum(-1)
    sinal = (_cross(normal, ky) * kobs).sum(-1)
    alpha = torch.atan2(sinal, cosal)
    return rotate_stokes(q, u, alpha if q.dim() == 1 else alpha[None])
