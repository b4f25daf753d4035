"""Slice S1 end to end: the port on the CPU against skirt_tpu on the CPU.

skirt_tpu's make_lifecycle(..., fused=True, polychromatic=True) and the
port's, on the same model carried across (from_skirt_tpu), at the size of
tests/test_poly.py::TestPolyWide: a 16x16x8 grid, W = 12 wavelengths with
per-wavelength varying optics, 4,096 lanes, 16/8 panels, 32 events, an
SED + SimpleInstrument pair and absorption tallies.  Once with a point
source, once with an ExpDisk source and refill K = 4.

The two frameworks draw different random streams, so the results are held
at the JAX suite's own Monte Carlo tolerances for this chain: per-
wavelength SED rtol 0.15 (test_poly.py:296); SED, frame and labs totals
rtol 0.05 (test_poly.py:300); every leaf finite.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skirt_tpu import rng as jrng
from skirt_tpu.engine.lifecycle import make_lifecycle as jax_make_lifecycle
from skirt_tpu_torch import rng
from skirt_tpu_torch.convert import from_skirt_tpu
from skirt_tpu_torch.engine.lifecycle import make_lifecycle, make_multibatch

torch.set_num_threads(2)

W = 12
NPL = 4096


def _jax_model(source, refill):
    from skirt_tpu.engine.lifecycle import LifecycleOptions
    from skirt_tpu.geometry import ExpDiskGeometry, PointGeometry
    from skirt_tpu.grids import CartesianGrid
    from skirt_tpu.instruments import SEDInstrument, SimpleInstrument
    from skirt_tpu.media import (DustComponent, DustSystem,
                                 OpticalDepthNormalization,
                                 SimpleOligoDustMix)
    from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                           StellarSystem)
    from skirt_tpu.wavelengths import OligoWavelengthGrid

    wg = OligoWavelengthGrid(list(np.linspace(0.4e-6, 2.4e-6, W)))
    half = 12 * 3.086e19
    src = (PointGeometry() if source == "point"
           else ExpDiskGeometry(half / 3, half / 40))
    ss = StellarSystem([LuminosityStellarComponent(src, wg, [1e36] * W)])
    b = np.linspace(-half, half, 17)
    bz = np.linspace(-half / 6, half / 6, 9)
    grid = CartesianGrid(b, b, bz)
    fac = np.linspace(1.0, 0.25, W)
    mix = SimpleOligoDustMix(wg, list(2600.0 * fac),
                             list(0.6 * np.linspace(1.0, 0.5, W)),
                             list(0.5 * np.linspace(1.0, 0.3, W)))
    comp = DustComponent(ExpDiskGeometry(half / 3, half / 60), mix,
                         OpticalDepthNormalization("z", 0.4e-6, 1.5))
    dsys = DustSystem(grid, [comp], density_mode="analytic")
    ins = [SEDInstrument("sed", 3.08e23, W, inclination=1.2, azimuth=0.7),
           SimpleInstrument("img", 3.08e23, W, 16, 16, fov_x=2 * half,
                            fov_y=2 * half, inclination=0.5, azimuth=0.3)]
    opts = LifecycleOptions(store_absorption=True, deposition="sampled",
                            quadrature_panels=16, peel_panels=8,
                            max_scatt_events=32, fused=True,
                            polychromatic=True, refill_batches=refill)
    return grid, dsys, ss, ins, opts


def _run_jax(model, refill):
    grid, dsys, ss, ins, opts = model
    K = max(refill, 1)
    run = jax.jit(jax_make_lifecycle(grid, dsys, ss, ins, opts, W))
    L0 = jnp.full((NPL, W), 1e36 / (NPL * K), jnp.float32)
    out = run(jrng.root_key(4357), jnp.zeros(NPL, jnp.int32), L0, {
        "instruments": [i.zero_tallies() for i in ins],
        "labs": jnp.zeros((grid.ncells * W,), jnp.float32)})
    return jax.tree.map(lambda a: np.asarray(a, np.float64), out)


def _port(model):
    return from_skirt_tpu(*model)


def _zero(ins, grid):
    return {"instruments": [i.zero_tallies() for i in ins],
            "labs": torch.zeros(grid.ncells * W, dtype=torch.float32)}


def _run_port(model, refill, seed=4357):
    grid, ds, ss, ins, opts = _port(model)
    K = max(refill, 1)
    run = make_lifecycle(grid, ds, ss, ins, opts, W)
    L0 = torch.full((NPL, W), 1e36 / (NPL * K), dtype=torch.float32)
    out = run(rng.root_key(seed), torch.zeros(NPL, dtype=torch.int32), L0,
              _zero(ins, grid))
    return _host(out)


def _host(t):
    return {"instruments": [{k: v.numpy().astype(np.float64)
                             for k, v in d.items()}
                            for d in t["instruments"]],
            "labs": t["labs"].numpy().astype(np.float64)}


@pytest.fixture(scope="module", params=[("point", 0), ("expdisk", 4)],
                ids=["point", "expdisk-refill4"])
def runs(request):
    source, refill = request.param
    model = _jax_model(source, refill)
    return _run_jax(model, refill), _run_port(model, refill)


def test_sed_per_wavelength(runs):
    tj, tt = runs
    for dj, dt in zip(tj["instruments"], tt["instruments"]):
        np.testing.assert_allclose(dt["Ftot"], dj["Ftot"], rtol=0.15)


def test_totals(runs):
    tj, tt = runs
    for dj, dt in zip(tj["instruments"], tt["instruments"]):
        assert dt["Ftot"].sum() == pytest.approx(dj["Ftot"].sum(), rel=0.05)
    fj = tj["instruments"][1]["ftot"]
    ft = tt["instruments"][1]["ftot"]
    assert ft.sum() == pytest.approx(fj.sum(), rel=0.05)
    assert tt["labs"].sum() == pytest.approx(tj["labs"].sum(), rel=0.05)
    # the cube keeps the detections inside the field of view; the frame
    # instrument's SED keeps them all
    assert 0.5 < ft.sum() / tt["instruments"][1]["Ftot"].sum() <= 1.0 + 1e-5


def test_all_finite_and_physical(runs):
    _, tt = runs
    leaves = [v for d in tt["instruments"] for v in d.values()] + [tt["labs"]]
    for leaf in leaves:
        assert np.isfinite(leaf).all() and (leaf >= 0).all()
    assert 0 < tt["labs"].sum() < W * 1e36


def test_multibatch_fold():
    """make_multibatch runs batch b with key fold_in(key, b) into the same
    tallies: identical to the batches run one after another."""
    grid, ds, ss, ins, opts = _port(_jax_model("expdisk", 4))
    opts = dataclasses.replace(opts, max_scatt_events=8)
    run = make_lifecycle(grid, ds, ss, ins, opts, W)
    n = 512
    L0 = torch.full((n, W), 1e36 / (n * 4), dtype=torch.float32)
    ell = torch.zeros(n, dtype=torch.int32)
    key = rng.root_key(11)
    many = _host(make_multibatch(run, 2)(key, ell, L0, _zero(ins, grid)))
    seq = _zero(ins, grid)
    for b in range(2):
        seq = run(rng.fold_in(key, b), ell, L0, seq)
    seq = _host(seq)
    one = _host(run(rng.fold_in(key, 0), ell, L0, _zero(ins, grid)))
    for dm, ds_ in zip(many["instruments"], seq["instruments"]):
        for k in dm:
            np.testing.assert_array_equal(dm[k], ds_[k])
    np.testing.assert_array_equal(many["labs"], seq["labs"])
    assert many["labs"].sum() > one["labs"].sum() > 0
