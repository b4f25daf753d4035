"""Parity helpers for the K1 event: inputs and the lane-wise criterion.

Shared by tests/test_torch_fused_poly.py (the plain event against the
Pallas kernel on the CPU), tests/test_torch_cuda.py and chip_smoke.py
(the CUDA kernel against the plain event on the card).

The criterion.  An event's discrete outputs are alive, nscatt, the
deposit bin, bcount, fresh and the set of wavelengths that survive the
weight cut (Ln > 0).  Each is decided by comparing float32 values (panel
picks against cumulative column densities, the wavelength pick against a
running sum, the cut against L0 / min_weight_reduction), and two
implementations that round differently may flip a comparison that lands
within an ulp.  So the discrete outputs are held on a fraction of lanes
(>= 99.9%), and every float output on every lane whose discrete outputs
agree, up to a stated number of lanes: the caller's `float_bad` cap.
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


def event_agreement(got, want, rtol=1e-4, atol_scale=1e-6):
    """Lane-wise agreement of two event results with the poly_event
    contract (dicts of tensors on one device).

    Returns a dict: "discrete", the fraction of lanes whose discrete
    outputs all agree; "float_bad", the number of those lanes on which
    some float output differs by more than rtol with atol = atol_scale x
    the array's largest magnitude; "scaled_err", the largest float
    difference on discretely agreeing lanes, each array scaled by its
    largest magnitude; "lanes", the lane count."""
    N = want["state"][0].shape[0]
    disc = [(got["state"][i], want["state"][i]) for i in (6, 7)]
    disc += [(got[k], want[k]) for k in ("depi", "bc", "fresh") if k in want]
    disc.append((got["Ln"] > 0, want["Ln"] > 0))
    agree = torch.ones(N, dtype=torch.bool, device=want["state"][0].device)
    for a, b in disc:
        agree &= (a == b).reshape(-1, N).all(dim=0)
    floats = [(got["state"][i], want["state"][i]) for i in range(6)]
    floats += [(got[k], want[k]) for k in ("Ln", "Lp", "Ip", "cos", "depv")
               if k in want]
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
