"""The plain reference for the ExpDisk dusty galaxy: a straightforward
Monte Carlo of the semantics the configuration file states (its
`semantics` list), worked out from that file alone.

It shares no code and no design with the port beyond what the file
states.  Lengths are in kpc.  Each packet carries one wavelength; its
interaction point is drawn from the plain truncated exponential (no
composite bias); the absorbed energy goes out of every panel of a path
(no sampled deposit); directions turn in an orthonormal frame built from
the packet's own direction.  These are other estimators of the same
expectations, so the port's tallies and these agree up to Monte Carlo
noise on both sides, which check.py measures on coarse bins.

`simulate` runs `packets` packets for each wavelength index in `ells`
and returns the raw tallies of those wavelengths: the summed luminosity
in W of each SED, of each frame pixel, and of the absorbed energy per
grid cell.  `dtype` is the precision of every quantity (the control
passes bfloat16); the tallies are summed in float64 unless `acc_dtype`
says otherwise."""

import math

import numpy as np
import torch


class Model:
    """The configuration's model: the medium, the sources, the grid and
    the instruments, as plain numbers (kpc)."""

    def __init__(self, cfg: dict):
        wl = cfg["wavelengths"]
        self.lam = np.linspace(wl["min_m"], wl["max_m"], wl["count"])
        n = self.lam.size
        self.Lv = np.full(n, float(cfg["luminosity_W"]))
        d = cfg["dust"]
        o = d["optics"]
        f = (self.lam - self.lam[0]) / (self.lam[-1] - self.lam[0])
        kappa = (self.lam / self.lam[0]) ** o["kappa_slope"]
        self.albedo = o["albedo"][0] + (o["albedo"][1] - o["albedo"][0]) * f
        self.g = (o["asymmetry_g"][0]
                  + (o["asymmetry_g"][1] - o["asymmetry_g"][0]) * f)
        # the normalisation bin: the grid wavelength nearest the stated one
        # on a log scale
        ref = int(np.argmin(np.abs(np.log(self.lam / d["tau_wavelength_m"]))))
        self.hR = float(d["scale_length_kpc"])
        self.hz = float(d["scale_height_kpc"])
        # kappa rho at the centre, per kpc: the face-on column is 2 hz
        self.k0 = d["tau_z_face_on"] * kappa / kappa[ref] / (2.0 * self.hz)
        st = cfg["stars"]
        self.sR = float(st["scale_length_kpc"])
        self.sz = float(st["scale_height_kpc"])
        g = cfg["grid"]
        self.half = np.array([g["half_xy_kpc"], g["half_xy_kpc"],
                              g["half_z_kpc"]], np.float64)
        self.shape = (g["nx"], g["ny"], g["nz"])
        e = cfg["engine"]
        self.P = int(e["quadrature_panels"])
        self.Q = int(e["peel_panels"])
        self.minred = float(e["min_weight_reduction"])
        self.observers = []
        for ins in cfg["instruments"]:
            inc = float(ins["inclination"])
            ct, st_ = math.cos(inc), math.sin(inc)
            # a distant observer at azimuth 0 and position angle 0: the
            # direction towards it and the detector's two axes
            ob = {"name": ins["name"], "kind": ins["kind"],
                  "k": (st_, 0.0, ct), "ax": (0.0, 1.0, 0.0),
                  "ay": (-ct, 0.0, st_)}
            if ins["kind"] == "frame":
                ob.update(nx=int(ins["nx"]), ny=int(ins["ny"]),
                          fov=float(ins["fov_kpc"]))
            self.observers.append(ob)


def _span(m, px, py, pz, dx, dy, dz):
    """(t0, t1): where the ray from p along d is inside the box (t0 >= 0;
    both 0 where it misses)."""
    t0 = torch.zeros_like(px)
    t1 = torch.full_like(px, float("inf"))
    for p, d, h in ((px, dx, m.half[0]), (py, dy, m.half[1]),
                    (pz, dz, m.half[2])):
        safe = torch.where(d == 0, torch.ones_like(d), d)
        a = (-h - p) / safe
        b = (h - p) / safe
        lo = torch.where(d == 0, torch.where(p.abs() <= h, -math.inf,
                                             math.inf), torch.minimum(a, b))
        hi = torch.where(d == 0, torch.where(p.abs() <= h, math.inf,
                                             -math.inf), torch.maximum(a, b))
        t0 = torch.maximum(t0, lo)
        t1 = torch.minimum(t1, hi)
    inside = t1 > t0
    zero = torch.zeros_like(t0)
    return torch.where(inside, t0, zero), torch.where(inside, t1, zero)


def _kappa_rho(m, k0, x, y, z):
    """kappa rho (per kpc) at points inside the box; k0 broadcasts."""
    R = torch.sqrt(x * x + y * y)
    return k0 * torch.exp(-R / m.hR - z.abs() / m.hz)


def _panels(m, k0, px, py, pz, dx, dy, dz, n):
    """Midpoint rule over n equal panels of the span: (t0, width, the
    panels' optical depths (N, n), their midpoints' x, y, z)."""
    t0, t1 = _span(m, px, py, pz, dx, dy, dz)
    w = (t1 - t0) / n
    k = torch.arange(n, device=px.device, dtype=px.dtype) + 0.5
    t = t0[:, None] + k[None, :] * w[:, None]
    x = px[:, None] + t * dx[:, None]
    y = py[:, None] + t * dy[:, None]
    z = pz[:, None] + t * dz[:, None]
    dtau = _kappa_rho(m, k0[:, None], x, y, z) * w[:, None]
    return t0, w, dtau, x, y, z


def _cell(m, x, y, z):
    ids = []
    for v, h, n in ((x, m.half[0], m.shape[0]), (y, m.half[1], m.shape[1]),
                    (z, m.half[2], m.shape[2])):
        i = torch.floor((v + h) / (2 * h) * n).long()
        ids.append(i.clamp(0, n - 1))
    return (ids[0] * m.shape[1] + ids[1]) * m.shape[2] + ids[2]


class Tallies:
    def __init__(self, m, nl, device, acc):
        self.m = m
        self.sed = [torch.zeros(nl, dtype=acc, device=device)
                    for _ in m.observers]
        self.frame = [torch.zeros(nl * o["nx"] * o["ny"], dtype=acc,
                                  device=device) if o["kind"] == "frame"
                      else None for o in m.observers]
        self.labs = torch.zeros(int(np.prod(m.shape)) * nl, dtype=acc,
                                device=device)
        self.nl = nl

    def peel(self, i, li, x, y, z, w):
        """Luminosity w (N,) of wavelength slot li (N,) reaching observer i
        from (x, y, z)."""
        acc = self.sed[i].dtype
        self.sed[i].index_add_(0, li, w.to(acc))
        o = self.m.observers[i]
        if o["kind"] != "frame":
            return
        ax, ay = o["ax"], o["ay"]
        xp = ax[0] * x + ax[1] * y + ax[2] * z
        yp = ay[0] * x + ay[1] * y + ay[2] * z
        ix = torch.floor((xp + o["fov"] / 2) / o["fov"] * o["nx"]).long()
        iy = torch.floor((yp + o["fov"] / 2) / o["fov"] * o["ny"]).long()
        ok = (ix >= 0) & (ix < o["nx"]) & (iy >= 0) & (iy < o["ny"])
        pix = (li * o["ny"] + iy) * o["nx"] + ix
        self.frame[i].index_add_(0, pix[ok], w[ok].to(acc))


def _peel_all(m, tal, k0, li, px, py, pz, L, d=None, g=None):
    """Peel luminosity L off toward every observer, through the peel
    panels' optical depth: isotropic emission, or with direction d and
    asymmetry g the Henyey-Greenstein scattering phase."""
    for i, o in enumerate(m.observers):
        kx, ky, kz = (torch.full_like(px, c) for c in o["k"])
        _, _, dtau, _, _, _ = _panels(m, k0, px, py, pz, kx, ky, kz, m.Q)
        w = L * torch.exp(-dtau.sum(1))
        if d is not None:
            w = w * _hg_phase(g, d[0] * kx + d[1] * ky + d[2] * kz)
        tal.peel(i, li, px, py, pz, w)


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
    (dx, dy, dz)."""
    # a unit vector perpendicular to d, from the smaller of its x and z
    use_x = dx.abs() < 0.9
    ex = torch.where(use_x, torch.zeros_like(dx), -dz)
    ey = torch.where(use_x, -dz, torch.zeros_like(dx))
    ez = torch.where(use_x, dy, dx)
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


def simulate(cfg: dict, ells, packets: int, seed: int, device,
             dtype=torch.float32, acc_dtype=torch.float64,
             chunk: int = 1 << 20) -> dict:
    """Raw tallies of `packets` packets at each wavelength index of
    `ells`: {"sed": [(W,) per instrument], "frame": [(W, ny, nx) or None],
    "labs": (ncells, W)}, as float64 NumPy arrays."""
    m = Model(cfg)
    ells = [int(e) for e in ells]
    W = len(ells)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    tal = Tallies(m, W, dev, acc_dtype)
    k0_w = torch.tensor(m.k0[ells], dtype=dtype, device=dev)
    alb_w = torch.tensor(m.albedo[ells], dtype=dtype, device=dev)
    g_w = torch.tensor(m.g[ells], dtype=dtype, device=dev)
    L_w = torch.tensor(m.Lv[ells] / packets, dtype=dtype, device=dev)
    total = W * packets
    for start in range(0, total, chunk):
        n = min(chunk, total - start)
        li = (torch.arange(start, start + n, device=dev) // packets)

        def uni(*shape):
            u = torch.rand(*shape, generator=gen, device=dev)
            return u.clamp(min=1e-12, max=1 - 1e-7).to(dtype)

        # launch: R from Gamma(2, hR), |z| exponential with a random sign,
        # an isotropic direction
        u = uni(6, n)
        R = -m.sR * (torch.log(u[0]) + torch.log(u[1]))
        ph = 2 * math.pi * u[2]
        px, py = R * torch.cos(ph), R * torch.sin(ph)
        pz = torch.where(u[3] < 0.5, -1.0, 1.0).to(dtype) * (
            -m.sz * torch.log(u[4]))
        cz = 2 * u[5] - 1
        ph = 2 * math.pi * uni(n)
        sz = torch.sqrt((1 - cz * cz).clamp(min=0))
        dx, dy, dz = sz * torch.cos(ph), sz * torch.sin(ph), cz
        L0 = L_w[li]
        L = L0.clone()
        _peel_all(m, tal, k0_w[li], li, px, py, pz, L)
        idx = torch.arange(n, device=dev)
        while idx.numel():
            k0 = k0_w[li[idx]]
            alb = alb_w[li[idx]]
            t0, w, dtau, x, y, z = _panels(m, k0, px, py, pz, dx, dy, dz,
                                           m.P)
            cum = torch.cumsum(dtau, 1)
            tau = cum[:, -1]
            ext = torch.exp(-cum)
            # absorbed: (1 - albedo) of what each panel takes out
            before = torch.cat([torch.ones_like(ext[:, :1]), ext[:, :-1]], 1)
            dep = ((1 - alb) * L)[:, None] * (before - ext)
            cell = _cell(m, x, y, z)
            tal.labs.index_add_(0, (cell * W + li[idx][:, None]).reshape(-1),
                                dep.reshape(-1).to(tal.labs.dtype))
            # forced interaction inside the span
            Ls = alb * L * (1 - torch.exp(-tau))
            keep = (tau > 0) & (Ls > L0[idx] / m.minred)
            u = uni(3, idx.numel())
            ts = -torch.log(1 - u[0] * (1 - torch.exp(-tau)))
            ts = torch.minimum(ts, tau)
            k = (cum < ts[:, None]).sum(1).clamp(max=m.P - 1)
            prev = torch.where(k > 0, cum.gather(1, (k - 1).clamp(min=0)
                                                 [:, None])[:, 0],
                               torch.zeros_like(tau))
            d_k = dtau.gather(1, k[:, None])[:, 0]
            frac = torch.where(d_k > 0, (ts - prev) / d_k,
                               torch.zeros_like(ts)).clamp(0, 1)
            s = t0 + (k.to(dtype) + frac) * w
            keep_i = keep.nonzero()[:, 0]
            idx = idx[keep_i]
            px = (px + s * dx)[keep_i]
            py = (py + s * dy)[keep_i]
            pz = (pz + s * dz)[keep_i]
            dx, dy, dz, L = dx[keep_i], dy[keep_i], dz[keep_i], Ls[keep_i]
            u = u[:, keep_i]
            g = g_w[li[idx]]
            k0 = k0[keep_i]
            # peel-off of the scattered packet, then its new direction
            _peel_all(m, tal, k0, li[idx], px, py, pz, L, (dx, dy, dz), g)
            dx, dy, dz = _turn(dx, dy, dz, _hg_sample(g, u[1]),
                               2 * math.pi * u[2])
    out = {"sed": [t.double().cpu().numpy() for t in tal.sed],
           "frame": [None if f is None else
                     f.double().cpu().numpy().reshape(W, o["ny"], o["nx"])
                     for f, o in zip(tal.frame, m.observers)],
           "labs": tal.labs.double().cpu().numpy().reshape(-1, W)}
    return out
