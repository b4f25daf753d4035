"""Parity helpers for the event kernels K1, K3-K7, the direct-table
variants K4d and K6d and K6p, K6's polarized form: inputs and the
lane-wise criterion.

Shared by tests/test_torch_fused_poly.py, tests/test_torch_fused.py and
tests/test_torch_table*.py (the plain events against the Pallas kernels
on the CPU; K4d and K6d in tests/test_torch_table_direct.py),
tests/test_torch_cuda.py and chip_smoke.py (the CUDA kernels against the
plain events on the card).

The criterion.  An event's discrete outputs are its integer outputs
(alive, nscatt, the deposit bin or K6d's deposit wavelength, bcount,
fresh, K5's interaction cell), whether K4d / K6d deposit at all (depd >=
0) and, for the polychromatic events, the set of wavelengths that survive
the weight cut (Ln > 0).  Each is decided by
comparing float32 values (panel picks against cumulative optical depths,
the wavelength pick against a running sum, the cut against
L0 / min_weight_reduction), and two implementations that round
differently may flip a comparison that lands within an ulp.  So the
discrete outputs are held on a fraction of lanes (>= 99.9%), and every
float output on every lane whose discrete outputs agree, up to a stated
number of lanes: the caller's `float_bad` cap.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .constants import KPC


def event_inputs(N, W, n_uniform, K=None, seed=0):
    """numpy inputs (u, L, L0, state) of one event for N lanes.

    Packets live where the main path's packets do: positions drawn from
    the stellar disc (ExpDisk, 4 kpc x 0.35 kpc; the tail falls outside
    the grid), isotropic directions with some axis-parallel ones (the
    slab test's d == 0 branches), about 10% dead lanes, nscatt 0..3 and,
    with refill (K not None), launch counts 1..K, so some dead lanes have
    used up their budget.

    Positions are not spread uniformly over the box: in its empty corners
    the optical depth falls below 1e-4, where 1 - exp(-tau) in float32
    resolves tau only to ~6e-8 (the Pallas kernel has no expm1), so a
    one-ulp exp difference moves the deposit weight and the interaction
    point by more than float32 noise."""
    rs = np.random.default_rng(seed)
    Rc = -4 * KPC * np.log(rs.uniform(size=N) * rs.uniform(size=N))
    z = rs.laplace(0.0, 0.35 * KPC, size=N)
    phi = rs.uniform(0.0, 2 * np.pi, size=N)
    pos = np.stack([Rc * np.cos(phi), Rc * np.sin(phi), z],
                   axis=1).astype(np.float32)
    d = rs.normal(size=(N, 3))
    n1, n2 = N // 64, N // 128
    d[:n1, 0] = 0.0
    d[n1:n1 + n2, :2] = 0.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    alive = (rs.random(N) < 0.9).astype(np.int32)
    ns = rs.integers(0, 4, N).astype(np.int32)
    state = [pos[:, 0], pos[:, 1], pos[:, 2], d[:, 0], d[:, 1], d[:, 2],
             alive, ns]
    if K is not None:
        state.append(rs.integers(1, K + 1, N).astype(np.int32))
    u = rs.uniform(1e-7, 1 - 1e-7, (n_uniform, N)).astype(np.float32)
    L = (rs.uniform(0.5, 1.5, (W, N)) * 1e32).astype(np.float32)
    L0 = (L * rs.uniform(0.5, 2.0, (W, N))).astype(np.float32)
    return u, L, L0, [np.ascontiguousarray(s) for s in state]


def event_case(spec, N, seed, device):
    """The first event of a kernel-vs-plain check: `spec` with the weight
    cut of the CPU parity test (min_weight_reduction 4 after one
    scattering, so the cut fires), and event_inputs for it as tensors on
    `device`.  Returns (spec, u, oc, L, L0, state)."""
    spec = dataclasses.replace(spec, min_scatt=1, inv_minred=0.25)
    u, L, L0, state = event_inputs(N, spec.W, spec.n_uniform,
                                   spec.K if spec.refill else None, seed)

    def t(x):
        return torch.from_numpy(x).to(device)

    return (spec, t(u), t(spec.oc), t(L), t(L0), [t(s) for s in state])


def mono_event_inputs(N, nlambda, n_uniform, K=None, seed=0):
    """numpy inputs (u, state) of one K3 event for N lanes: the packets of
    event_inputs (positions in the stellar disc, some axis-parallel
    directions, about 10% dead lanes, nscatt 0..3, launch counts 1..K with
    refill), one wavelength index per lane in [0, nlambda), L and L0.
    state: px, py, pz, dx, dy, dz, L, alive, ns, ell, L0 (and bc)."""
    u, L, L0, st = event_inputs(N, 1, n_uniform, K, seed)
    ell = np.random.default_rng(seed + 10007).integers(
        0, nlambda, N).astype(np.int32)
    state = st[:6] + [L[0], st[6], st[7], ell, L0[0]] + st[8:]
    return u, [np.ascontiguousarray(s) for s in state]


def mono_event_case(spec, N, seed, device):
    """The first event of a K3 kernel-vs-plain check: `spec` with the
    weight cut of event_case (min_weight_reduction 4 after one
    scattering), and mono_event_inputs for it as tensors on `device`.
    Returns (spec, u, state)."""
    spec = dataclasses.replace(spec, min_scatt=1, inv_minred=0.25)
    u, state = mono_event_inputs(N, spec.nlambda, spec.n_uniform,
                                 spec.K if spec.refill else None, seed)
    return (spec, torch.from_numpy(u).to(device),
            [torch.from_numpy(s).to(device) for s in state])


def table_event_inputs(ds, N, n_uniform, W, seed=0, npanels=16,
                       small_tau=0.0, outside=0.0, device="cpu"):
    """numpy-made inputs of one table event (K4-K7, K4d, K6d) for N lanes
    on a table-mode dust system `ds` (a uniform Cartesian voxel view, or
    for K4d and K6d a direct-table grid such as a VoronoiGrid: the panel
    rows come from the grid's own locate_batched), as tensors on
    `device`: a dict with u (n_uniform, N), the lanes' pos / dir (N, 3),
    alive and ns (int32), t0 and dt of the P equal panels, ell (one of W
    wavelengths per lane, for K4 and K5), L and L0 (W, N), and rows: the
    staged panel densities (raw rho, kg/m^3) the torch driver would
    gather, (P, N) for one dust component and (H * P, N), h-major, for H.

    Packets: 70% in the torus-like shell |z| < 0.64 r, 0.05-2 kpc from
    the centre, the rest uniform over the box; isotropic directions with
    some axis-parallel ones; about 10% dead lanes; nscatt 0..3.  Two
    optional families stress the event where the main path rarely goes:
    a `small_tau` fraction of lanes with panel densities scaled by 1e-6
    (optical depths below 1e-3), and an `outside` fraction whose panels
    start 10 box widths away, so their deposit point lies outside the
    grid (panels kept dense; K4d and K6d still emit its distance, and
    the lifecycle's locate drops it).  Callers make the weight cut fire
    with a spec past min_scatt_events 1 and a small
    min_weight_reduction."""
    import torch

    from .engine import vector_traversal as vt
    from .engine.fused_table_poly import component_rows

    rs = np.random.default_rng(seed)
    box = np.asarray(ds.grid.bounding_box(), np.float64)
    half = 0.5 * (box[3:] - box[:3])
    r = rs.uniform(0.05, 2.0, N) * KPC
    mu = rs.uniform(-0.64, 0.64, N)
    phi = rs.uniform(0.0, 2 * np.pi, N)
    st = np.sqrt(1.0 - mu * mu)
    shell = np.stack([r * st * np.cos(phi), r * st * np.sin(phi), r * mu], 1)
    flat = box[:3] + rs.uniform(size=(N, 3)) * (box[3:] - box[:3])
    pos = np.where((rs.random(N) < 0.7)[:, None], shell, flat)
    d = rs.normal(size=(N, 3))
    n1, n2 = N // 64, N // 128
    d[:n1, 0] = 0.0
    d[n1:n1 + n2, :2] = 0.0
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    pos_t = torch.from_numpy(pos.astype(np.float32))
    dir_t = torch.from_numpy(d.astype(np.float32))
    dsg, _, mid = vt.panel_paths(ds.grid, pos_t, dir_t, npanels)
    if ds.ncomp == 1:
        ones = [torch.ones(N, dtype=torch.float32)]
        rows = ds.analytic_rows(pos_t, dir_t, mid, None, ones,
                                want_sca=False).T.contiguous().numpy()
    else:
        rows = component_rows(ds.grid, ds, pos_t, dir_t, mid).numpy()
    t0 = (mid[:, 0] - 0.5 * dsg[:, 0]).numpy()
    dt = dsg[:, 0].numpy()
    fam = rs.random(N)
    low = fam < small_tau
    rows = np.where(low[None], rows * np.float32(1e-6), rows)
    far = (fam >= small_tau) & (fam < small_tau + outside)
    t0 = np.where(far, t0 + np.float32(20.0 * half.max()), t0)
    rows = np.where(far[None], np.maximum(rows, np.float32(1e-22)), rows)
    L = (rs.uniform(0.5, 1.5, (W, N)) * 1e32).astype(np.float32)
    out = {"u": rs.uniform(1e-7, 1 - 1e-7, (n_uniform, N)),
           "pos": pos, "dir": d, "alive": rs.random(N) < 0.9,
           "ns": rs.integers(0, 4, N), "t0": t0, "dt": dt, "rows": rows,
           "ell": rs.integers(0, W, N), "L": L,
           "L0": L * rs.uniform(0.5, 2.0, (W, N)), "small_tau": low,
           "outside": far}
    dts = {"alive": torch.int32, "ns": torch.int32, "ell": torch.int32,
           "small_tau": torch.bool, "outside": torch.bool}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        dtype=dts.get(k, torch.float32), device=device)
        for k, v in out.items()}


def table_state(inp, ds):
    """K4's 15 state arrays from table_event_inputs: px..dz, L, alive, ns,
    ell, L0, t0, dt and the per-lane albedo and g at ell; and its kr
    panels (kappa_ext(ell) x rho)."""
    import torch

    dev = inp["u"].device
    ell = inp["ell"]
    ksca, kext = ds.packet_kappas(ell)
    alb = ksca[0] / torch.clamp(kext[0], min=1e-37)
    g = torch.as_tensor(ds.g[0], device=dev)[ell.long()]
    n = ell.shape[0]
    cols = torch.arange(n, device=dev)
    L = inp["L"][ell.long(), cols]
    L0 = inp["L0"][ell.long(), cols]
    state = [inp["pos"][:, 0], inp["pos"][:, 1], inp["pos"][:, 2],
             inp["dir"][:, 0], inp["dir"][:, 1], inp["dir"][:, 2], L,
             inp["alive"], inp["ns"], ell, L0, inp["t0"], inp["dt"], alb, g]
    kr = (kext[0][None] * inp["rows"]).contiguous()
    return kr, [s.contiguous() for s in state]


def table_multi_state(inp, ds):
    """K5's 13 state arrays from table_event_inputs on a multi-component
    system: px..dz, L, alive, ns, ell, L0, t0, dt; and its staged panel
    sums kr = sum_h kappa_ext,h(ell) rho_h and ks = sum_h
    kappa_sca,h(ell) rho_h, (P, N) each."""
    import torch

    ell = inp["ell"]
    ksca, kext = ds.packet_kappas(ell)
    n = ell.shape[0]
    cols = torch.arange(n, device=ell.device)
    L = inp["L"][ell.long(), cols]
    L0 = inp["L0"][ell.long(), cols]
    state = [inp["pos"][:, 0], inp["pos"][:, 1], inp["pos"][:, 2],
             inp["dir"][:, 0], inp["dir"][:, 1], inp["dir"][:, 2], L,
             inp["alive"], inp["ns"], ell, L0, inp["t0"], inp["dt"]]
    rows = inp["rows"].reshape(ds.ncomp, -1, n)
    kr = ks = 0.0
    for h in range(ds.ncomp):
        kr = kr + kext[h][None] * rows[h]
        ks = ks + ksca[h][None] * rows[h]
    return kr.contiguous(), ks.contiguous(), [s.contiguous() for s in state]


def table_poly_state(inp):
    """K6's 10 state arrays from table_event_inputs: px..dz, alive, ns, t0,
    dt."""
    return [s.contiguous() for s in (
        inp["pos"][:, 0], inp["pos"][:, 1], inp["pos"][:, 2],
        inp["dir"][:, 0], inp["dir"][:, 1], inp["dir"][:, 2],
        inp["alive"], inp["ns"], inp["t0"], inp["dt"])]


def table_poly_case(spec, ds, N, seed, device="cpu", **kw):
    """The inputs of one K6 / K6d / K6p event on `ds` for the plain version
    and the kernel alike: table_event_inputs (seed, the spec's panels,
    any of its keywords) as the call's arguments.  Returns (args, inp):
    args = (u, r, oc, L, L0, state) in table_poly_event's order, inp the
    whole input dict (its small_tau / outside lane families)."""
    import torch

    inp = table_event_inputs(ds, N, spec.n_uniform, spec.W, seed=seed,
                             npanels=spec.npanels, device=device, **kw)
    args = (inp["u"], inp["rows"], torch.as_tensor(spec.oc, device=device),
            inp["L"], inp["L0"], table_poly_state(inp))
    return args, inp


def table_restage(grid, ds, pos, d, npanels, kext_pk, ksca_pk=None):
    """The staged panel rows, t0 and dt of lanes at pos, d (N, 3), as the
    table drivers stage them before each event (panel_paths and the table
    analytic_rows with the per-component opacities kext_pk): (kr, t0, dt),
    with ksca_pk (kr, ks, t0, dt) as K5 takes them, with kext_pk None the
    raw (H * P, N) component rows of K7."""
    from .engine import vector_traversal as vt
    from .engine.fused_table_poly import component_rows

    dsg, _, mid = vt.panel_paths(grid, pos, d, npanels)
    if kext_pk is None:
        rows = (component_rows(grid, ds, pos, d, mid),)
    elif ksca_pk is None:
        rows = (ds.analytic_rows(pos, d, mid, None, kext_pk,
                                 want_sca=False).T.contiguous(),)
    else:
        ks, kr = ds.analytic_rows(pos, d, mid, ksca_pk, kext_pk)
        rows = (kr.T.contiguous(), ks.T.contiguous())
    return (*rows, (mid[:, 0] - 0.5 * dsg[:, 0]).contiguous(),
            dsg[:, 0].contiguous())


def event_agreement(got, want, rtol=1e-4, atol_scale=1e-6):
    """Lane-wise agreement of two event results with one of the event
    contracts (dicts of tensors on one device).

    Returns a dict: "discrete", the fraction of lanes whose discrete
    outputs all agree; "float_bad", the number of those lanes on which
    some float output differs by more than rtol with atol = atol_scale x
    the array's largest magnitude; "scaled_err", the largest float
    difference on discretely agreeing lanes, each array scaled by its
    largest magnitude; "lanes", the lane count."""
    N = want["state"][0].shape[0]
    pairs = list(zip(got["state"], want["state"]))
    pairs += [(got[k], want[k]) for k in ("depi", "cell", "bc", "fresh",
                                          "depv", "depd", "Ln", "Lp", "Ip",
                                          "tau", "cos", "phase", "I_s",
                                          "I_tot") if k in want]
    disc = [(a, b) for a, b in pairs if not b.is_floating_point()]
    if "Ln" in want:
        disc.append((got["Ln"] > 0, want["Ln"] > 0))
    if "depd" in want:
        disc.append((got["depd"] >= 0, want["depd"] >= 0))
    floats = [(a, b) for a, b in pairs if b.is_floating_point()]
    agree = torch.ones(N, dtype=torch.bool, device=want["state"][0].device)
    for a, b in disc:
        agree &= (a == b).reshape(-1, N).all(dim=0)
    bad = torch.zeros_like(agree)
    scaled_err = 0.0
    for a, b in floats:
        a = a.double().reshape(-1, N)
        b = b.double().reshape(-1, N)
        scale = max(float(b.abs().max()), 1e-300)
        diff = (a - b).abs()
        bad |= (diff > atol_scale * scale + rtol * b.abs()).any(dim=0)
        d = diff[:, agree]
        if d.numel():
            scaled_err = max(scaled_err, float(d.max()) / scale)
    return {"discrete": float(agree.double().mean()),
            "float_bad": int((bad & agree).sum()),
            "scaled_err": scaled_err, "lanes": N}
