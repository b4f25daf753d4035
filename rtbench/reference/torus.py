"""The plain reference for the dusty AGN torus: a straightforward Monte
Carlo of the semantics the configuration file states (its `semantics`
list), worked out from that file alone.

It shares no code and no design with the port beyond what the file
states.  Lengths are in pc.  The field lives on the uniform voxels of
the octree's finest level (2^max_level an axis over the box), each
voxel holding the density at its centre; the program's octree holds the
density at each leaf's centre, so the two fields differ only in leaves
coarser than a voxel, which the refinement leaves where it finds next
to no dust.  Each packet carries one wavelength; its interaction point
is drawn from the plain truncated exponential (no composite bias); the
absorbed energy of an event goes to the voxel of one point drawn from
the same forced-interaction density, independently of the interaction
point; directions turn in an orthonormal frame built from the packet's
own direction; the optical depth toward an observer is summed voxel by
voxel along the ray by a three-dimensional digital differential
analyser (the next wall of each axis, the nearest first), exact for the
piecewise-constant field.  These are other estimators of the same
expectations, so the port's tallies and these agree up to Monte Carlo
noise on both sides, which check.py measures on coarse bins.

`simulate` runs `packets` packets for each wavelength index in `ells`
and returns the raw tallies of those wavelengths: the summed luminosity
in W of each SED and the absorbed energy per voxel, with the voxels'
centres in kpc (the contract of reference/__init__.py).  `dtype` is the
precision of every quantity (the control passes bfloat16); the tallies
are summed in float64 unless `acc_dtype` says otherwise.  TF32 is off,
though no matrix product is taken."""

import math

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KPC_PER_PC = 1e-3
# the voxel walk tests whether every ray has left the box every so many
# steps (each test waits for the device)
WALK_CHECK_EVERY = 32


class Model:
    """The configuration's model as plain numbers (pc): wavelengths and
    optics, the voxel field of kappa rho at the normalisation
    wavelength, the engine's panels and cut, the observers."""

    def __init__(self, cfg: dict):
        wl = cfg["wavelengths"]
        self.lam = np.geomspace(wl["min_m"], wl["max_m"], wl["count"])
        self.Lv = np.full(self.lam.size, float(cfg["luminosity_W"]))
        d = cfg["dust"]
        o = d["optics"]
        f = np.log(self.lam / self.lam[0]) / np.log(self.lam[-1] / self.lam[0])
        kappa = o["kappa_ratio_last_first"] ** f          # kappa / kappa_0
        self.albedo = o["albedo"][0] + (o["albedo"][1] - o["albedo"][0]) * f
        self.g = (o["asymmetry_g"][0]
                  + (o["asymmetry_g"][1] - o["asymmetry_g"][0]) * f)
        # the normalisation bin: the grid wavelength nearest the stated one
        # on a log scale; kappa relative to it per wavelength
        ref = int(np.argmin(np.abs(np.log(self.lam / d["tau_wavelength_m"]))))
        self.kratio = kappa / kappa[ref]
        g = cfg["grid"]
        self.n = 1 << int(g["max_level"])
        self.h = float(g["half_pc"])
        self.dx = 2.0 * self.h / self.n
        self.kr = self._field(d)
        e = cfg["engine"]
        self.P = int(e["quadrature_panels"])
        self.minred = float(e["min_weight_reduction"])
        self.max_events = int(e["max_scatt_events"])
        self.observers = []
        for ins in cfg["instruments"]:
            # toward a distant observer at this inclination and azimuth 0;
            # a component below 1e-12 is a direction along a wall: zero
            inc = float(ins["inclination"])
            self.observers.append(tuple(0.0 if abs(c) < 1e-12 else c for c
                                        in (math.sin(inc), 0.0,
                                            math.cos(inc))))

    def centres(self) -> np.ndarray:
        """(n, n, n, 3) voxel centres in pc, x-major."""
        c = -self.h + (np.arange(self.n) + 0.5) * self.dx
        return np.stack(np.meshgrid(c, c, c, indexing="ij"), -1)

    def _field(self, d) -> np.ndarray:
        """kappa rho per pc at the normalisation wavelength at each voxel
        centre, flat (x-major, z fastest), float64."""
        c = self.centres()
        r = np.sqrt((c ** 2).sum(-1))
        cos = np.abs(c[..., 2]) / r
        p, q = float(d["p"]), float(d["q"])
        rin, rout = float(d["r_in_pc"]), float(d["r_out_pc"])
        if p == 1.0:
            column = math.log(rout / rin)
        else:
            column = (rout ** (1 - p) - rin ** (1 - p)) / (1 - p)
        inside = ((r >= rin) & (r <= rout)
                  & (cos <= math.sin(float(d["delta_rad"]))))
        kr = d["tau_v"] * r ** (-p) * np.exp(-q * cos) / column
        return np.where(inside, kr, 0.0).reshape(-1)


def _exit(m, px, py, pz, dx, dy, dz):
    """Distance from p (inside the box) along d to the box's wall."""
    t = torch.full_like(px, float("inf"))
    for p, d in ((px, dx), (py, dy), (pz, dz)):
        wall = torch.where(d > 0, m.h - p, -m.h - p)
        safe = torch.where(d == 0, torch.ones_like(d), d)
        t = torch.minimum(t, torch.where(d == 0, torch.full_like(p, math.inf),
                                         wall / safe))
    return t.clamp(min=0)


def _voxel(m, x, y, z):
    """Flat voxel ids of points (clamped into the box)."""
    ids = [torch.floor((v + m.h) / m.dx).long().clamp(0, m.n - 1)
           for v in (x, y, z)]
    return (ids[0] * m.n + ids[1]) * m.n + ids[2]


def _columns(m, kr, px, py, pz, ks):
    """(len(ks), N): the integral of the voxel field kr from each point
    (inside the box) to the box's wall along each constant direction of
    ks, for all of them at once.  A digital differential analyser: each
    ray steps, voxel by voxel, through the nearest of its next walls along
    the axes it moves on (through all of them at once where they tie),
    adding kr times the length inside each voxel."""
    O, N = len(ks), px.shape[0]
    k = torch.tensor(ks, dtype=px.dtype, device=px.device)
    kk = [k[:, a].repeat_interleave(N) for a in range(3)]
    pos = [c.repeat(O) for c in (px, py, pz)]
    t_end = _exit(m, *pos, *kk)
    idx, nxt, step, dt = [], [], [], []
    active = [a for a in range(3) if any(d[a] != 0.0 for d in ks)]
    for a in range(3):
        i = torch.floor((pos[a] + m.h) / m.dx).long().clamp(0, m.n - 1)
        idx.append(i)
        nxt.append(None)
        step.append(None)
        dt.append(None)
        if a not in active:
            continue
        ka = kk[a]
        zero = ka == 0
        safe = torch.where(zero, torch.ones_like(ka), ka)
        wall = (i + (ka > 0).long()).to(px.dtype) * m.dx - m.h
        inf = torch.full_like(ka, math.inf)
        nxt[a] = torch.where(zero, inf, (wall - pos[a]) / safe)
        step[a] = (ka > 0).long() - (ka < 0).long()
        dt[a] = torch.where(zero, inf, m.dx / safe.abs())
    t = torch.zeros_like(t_end)
    tau = torch.zeros_like(t_end)
    for s in range(len(active) * (m.n + 1) + 1):
        t_next = t_end
        for a in active:
            t_next = torch.minimum(t_next, nxt[a])
        vox = (idx[0].clamp(0, m.n - 1) * m.n
               + idx[1].clamp(0, m.n - 1)) * m.n + idx[2].clamp(0, m.n - 1)
        tau = tau + kr[vox] * (t_next - t).clamp(min=0)
        t = torch.maximum(t, t_next)
        for a in active:
            cross = nxt[a] <= t
            idx[a] = torch.where(cross, idx[a] + step[a], idx[a])
            nxt[a] = torch.where(cross, nxt[a] + dt[a], nxt[a])
        if s % WALK_CHECK_EVERY == WALK_CHECK_EVERY - 1 \
                and not bool((t < t_end).any()):
            break
    return tau.reshape(O, N)


def _hg_phase(g, cos):
    return (1 - g * g) / (1 + g * g - 2 * g * cos) ** 1.5


def _hg_sample(g, u):
    """Henyey-Greenstein deflection cosine, with g = 0 isotropic."""
    small = g.abs() < 1e-6
    gs = torch.where(small, torch.ones_like(g), g)
    s = (1 - gs * gs) / (1 - gs + 2 * gs * u)
    c = (1 + gs * gs - s * s) / (2 * gs)
    return torch.where(small, 2 * u - 1, c.clamp(-1, 1))


def _turn(dx, dy, dz, cos, phi):
    """The direction at deflection cosine `cos` and azimuth `phi` about
    the unit (dx, dy, dz), in the frame of d, e = d x (axis of d's
    smallest component), d x e."""
    ax = dx.abs()
    ay = dy.abs()
    az = dz.abs()
    use_x = (ax <= ay) & (ax <= az)
    use_y = ~use_x & (ay <= az)
    # e = d x a for the unit axis a of d's smallest component
    ex = torch.where(use_x, torch.zeros_like(dx), torch.where(use_y, -dz, dy))
    ey = torch.where(use_x, dz, torch.where(use_y, torch.zeros_like(dx),
                                             -dx))
    ez = torch.where(use_x, -dy, torch.where(use_y, dx, torch.zeros_like(dx)))
    n = torch.sqrt(ex * ex + ey * ey + ez * ez)
    ex, ey, ez = ex / n, ey / n, ez / n
    fx, fy, fz = dy * ez - dz * ey, dz * ex - dx * ez, dx * ey - dy * ex
    sin = torch.sqrt((1 - cos * cos).clamp(min=0))
    cp, sp = torch.cos(phi), torch.sin(phi)
    nx = cos * dx + sin * (cp * ex + sp * fx)
    ny = cos * dy + sin * (cp * ey + sp * fy)
    nz = cos * dz + sin * (cp * ez + sp * fz)
    r = torch.sqrt(nx * nx + ny * ny + nz * nz)
    return nx / r, ny / r, nz / r


def _panels(m, kr, px, py, pz, dx, dy, dz):
    """The midpoint rule over the engine's P equal panels of the span
    from p to the box's wall: (width, the panels' kappa rho at the
    normalisation wavelength times the width (N, P), their voxels)."""
    w = _exit(m, px, py, pz, dx, dy, dz) / m.P
    k = torch.arange(m.P, device=px.device, dtype=px.dtype) + 0.5
    t = k[None, :] * w[:, None]
    vox = _voxel(m, px[:, None] + t * dx[:, None], py[:, None] + t * dy[:, None],
                 pz[:, None] + t * dz[:, None])
    return w, kr[vox] * w[:, None], vox


def _first_at_or_above(cum, x):
    """Per row, the first panel whose running sum reaches x."""
    return (cum < x[:, None]).sum(1).clamp(max=cum.shape[1] - 1)


def simulate(cfg: dict, ells, packets: int, seed: int, device,
             dtype=torch.float32, acc_dtype=torch.float64,
             chunk: int = 1 << 20) -> dict:
    """Raw tallies of `packets` packets at each wavelength index of
    `ells`: {"sed": [(W,) per instrument], "frame": [None per
    instrument], "labs": (nvoxels, W), "centers": (nvoxels, 3) in kpc},
    as float64 NumPy arrays."""
    m = Model(cfg)
    ells = [int(e) for e in ells]
    W = len(ells)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    kr = torch.tensor(m.kr, dtype=dtype, device=dev)
    kq_w = torch.tensor(m.kratio[ells], dtype=dtype, device=dev)
    alb_w = torch.tensor(m.albedo[ells], dtype=dtype, device=dev)
    g_w = torch.tensor(m.g[ells], dtype=dtype, device=dev)
    L_w = torch.tensor(m.Lv[ells] / packets, dtype=dtype, device=dev)
    sed = [torch.zeros(W, dtype=acc_dtype, device=dev) for _ in m.observers]
    labs = torch.zeros(m.n ** 3 * W, dtype=acc_dtype, device=dev)
    # the source's columns: every packet starts at the origin
    zero = torch.zeros(1, dtype=dtype, device=dev)
    col0 = _columns(m, kr, zero, zero, zero, m.observers)[:, 0]

    def uni(*shape):
        u = torch.rand(*shape, generator=gen, device=dev)
        return u.clamp(min=1e-12, max=1 - 1e-7).to(dtype)

    total = W * packets
    for start in range(0, total, chunk):
        n = min(chunk, total - start)
        li = torch.arange(start, start + n, device=dev) // packets
        # launch at the origin, isotropic; the source's own peel-off
        cz = 2 * uni(n) - 1
        ph = 2 * math.pi * uni(n)
        sz = torch.sqrt((1 - cz * cz).clamp(min=0))
        dx, dy, dz = sz * torch.cos(ph), sz * torch.sin(ph), cz
        px = torch.zeros(n, dtype=dtype, device=dev)
        py, pz = px.clone(), px.clone()
        L0 = L_w[li]
        for o, c in enumerate(col0):
            sed[o].index_add_(0, li, (L0 * torch.exp(-kq_w[li] * c))
                              .to(acc_dtype))
        L = L0.clone()
        idx = torch.arange(n, device=dev)
        for _ in range(m.max_events):
            if not idx.numel():
                break
            lw = li[idx]
            kq, alb = kq_w[lw], alb_w[lw]
            w, dI, vox = _panels(m, kr, px, py, pz, dx, dy, dz)
            cum = torch.cumsum(kq[:, None] * dI, 1)
            tau = cum[:, -1]
            ome = 1 - torch.exp(-tau)
            u = uni(5, idx.numel())
            # absorbed: (1 - albedo) L (1 - e^-tau) into the voxel of the
            # panel holding a point drawn from the forced density
            k_dep = _first_at_or_above(cum, -torch.log(1 - u[0] * ome))
            v_dep = vox.gather(1, k_dep[:, None])[:, 0]
            labs.index_add_(0, v_dep * W + lw,
                            ((1 - alb) * L * ome).to(acc_dtype))
            # forced interaction inside the span
            Ls = alb * L * ome
            ts = torch.minimum(-torch.log(1 - u[1] * ome), tau)
            k_s = _first_at_or_above(cum, ts)
            prev = torch.where(k_s > 0, cum.gather(
                1, (k_s - 1).clamp(min=0)[:, None])[:, 0],
                torch.zeros_like(tau))
            d_k = cum.gather(1, k_s[:, None])[:, 0] - prev
            frac = torch.where(d_k > 0, (ts - prev) / d_k,
                               torch.zeros_like(ts)).clamp(0, 1)
            s = (k_s.to(dtype) + frac) * w
            keep = ((tau > 0) & (Ls > L0[idx] / m.minred)).nonzero()[:, 0]
            idx, lw, u = idx[keep], lw[keep], u[:, keep]
            px = (px + s * dx)[keep]
            py = (py + s * dy)[keep]
            pz = (pz + s * dz)[keep]
            dx, dy, dz, L = dx[keep], dy[keep], dz[keep], Ls[keep]
            kq, g = kq_w[lw], g_w[lw]
            # peel-off of the scattered packet with the HG phase, then its
            # new direction
            cols = _columns(m, kr, px, py, pz, m.observers)
            for o, k in enumerate(m.observers):
                cos = dx * k[0] + dy * k[1] + dz * k[2]
                sed[o].index_add_(0, lw, (L * _hg_phase(g, cos) * torch.exp(
                    -kq * cols[o])).to(acc_dtype))
            dx, dy, dz = _turn(dx, dy, dz, _hg_sample(g, u[2]),
                               2 * math.pi * u[3])
    return {"sed": [t.double().cpu().numpy() for t in sed],
            "frame": [None for _ in m.observers],
            "labs": labs.double().cpu().numpy().reshape(-1, W),
            "centers": m.centres().reshape(-1, 3) * KPC_PER_PC}
