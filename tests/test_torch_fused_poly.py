"""Kernel K1 parity: the port's polychromatic event against the Pallas one.

The same numpy-made inputs (uniforms, L, L0, packet state) go through
skirt_tpu's Pallas kernel body — assembled into a pallas_call exactly as
skirt_tpu/engine/fused_poly.py:419-457 does, run in interpret mode — and
through skirt_tpu_torch's plain event (the spec the CUDA kernel is held
against on the GPU).

Tolerances: discrete outputs (deposit bin, alive, nscatt, bcount, fresh,
the wavelengths that survive the weight cut) must agree on >= 99.9% of
lanes.  They are decided by comparisons of float32 values (panel picks
against cumulative column densities, the wavelength pick against a
cumulative sum that the TPU kernel forms by log-step shifted adds), and
the two sides round differently: exp/log differ by an ulp between XLA's
and torch's CPU kernels, and XLA's CPU backend fuses a*b+c into one
rounding where torch rounds twice.  So a comparison that lands within an
ulp may flip.  Float outputs must agree to rtol 1e-4 with atol 1e-6 x the
array's largest magnitude on every lane whose discrete outputs agree, but
for at most FLOAT_BAD_LANES of 1,024: at ill-conditioned spots the fused
rounding moves a result by more than that.  The cases here show one such
lane at most: a scattered direction component of ~3e-3 formed by
cancellation with sin(theta) = sqrt(1 - cos^2) at |cos| ~ 1 (off by
1.6e-6), and a position near the origin reached from ~1.4e20 m (off by
7e-6 of the array's scale).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from skirt_tpu.engine import fused_poly as jfp
from skirt_tpu.engine.fused import _group_leaders as j_group_leaders
from skirt_tpu_torch.convert import from_skirt_tpu
from skirt_tpu_torch.engine import fused_poly as tfp
from skirt_tpu_torch.testing import event_agreement, event_inputs

torch.set_num_threads(2)

R = 8                       # rows of 128 lanes: 1,024 lanes
NPANELS = 8
NP_PEEL = 4
K = 4
FLOAT_BAD_LANES = 2         # of 1,024 (module docstring)


def jax_model(W, source="expdisk", K_refill=0, **opt_kw):
    """A small dusty disc in skirt_tpu (as __graft_entry__._build, with
    per-wavelength varying optics) and two observer directions."""
    from skirt_tpu.constants import KPC
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

    wg = OligoWavelengthGrid(list(np.linspace(0.4e-6, 1.2e-6, W)))
    src = (PointGeometry() if source == "point"
           else ExpDiskGeometry(4 * KPC, 0.35 * KPC))
    ss = StellarSystem([LuminosityStellarComponent(src, wg, [1e36] * W)])
    half = 12 * KPC
    b = np.linspace(-half, half, 9)
    bz = np.linspace(-2 * KPC, 2 * KPC, 5)
    grid = CartesianGrid(b, b, bz)
    fac = np.linspace(1.0, 0.3, W)
    mix = SimpleOligoDustMix(wg, list(2600.0 * fac),
                             list(0.6 * np.linspace(1.0, 0.5, W)),
                             list(0.5 * np.linspace(1.0, 0.4, W)))
    comp = DustComponent(ExpDiskGeometry(4 * KPC, 0.2 * KPC), mix,
                         OpticalDepthNormalization("z", wg.lambdav[0], 1.0))
    ds = DustSystem(grid, [comp], samples_per_cell=2,
                    density_mode="analytic")
    ins = [SEDInstrument("sed", 3.08e23, W, inclination=1.0),
           SimpleInstrument("img", 3.08e23, W, 16, 16, fov_x=24 * KPC,
                            fov_y=24 * KPC, inclination=np.pi / 2)]
    kw = dict(store_absorption=True, deposition="sampled",
              quadrature_panels=NPANELS, peel_panels=NP_PEEL,
              max_scatt_events=16, fused=True, polychromatic=True,
              refill_batches=K_refill)
    kw.update(opt_kw)
    return grid, ds, ss, ins, LifecycleOptions(**kw)


def jax_event(grid, ds, ss, ins, options, W, refill, inputs):
    """skirt_tpu's Pallas event kernel in interpret mode, called as
    make_fused_poly_lifecycle's call_kernel calls it."""
    leaders, _ = j_group_leaders(ins)
    sampler = (ss.components[0].geometry.device_sampler_xyz()
               if refill else None)
    want_labs = bool(options.store_absorption)
    kern, n_uniform, oc_np, _, _ = jfp._build_kernel(
        grid, ds, leaders, NPANELS, NP_PEEL, options, W, want_labs, True,
        sampler)
    nlead = len(leaders)
    tile_rows = min(32, max(8, (1024 // W) // 8 * 8))
    tr = min(tile_rows, R)

    def blk():
        return pl.BlockSpec((tr, 128), lambda i: (i, 0),
                            memory_space=pltpu.VMEM)

    def blkW(lead):
        return pl.BlockSpec((lead, tr, 128), lambda i: (0, i, 0),
                            memory_space=pltpu.VMEM)

    oc_spec = pl.BlockSpec((3, W, 128), lambda i: (0, 0, 0),
                           memory_space=pltpu.VMEM)
    out_shapes = [jax.ShapeDtypeStruct((R, 128), dt)
                  for dt in [jnp.float32] * 6 + [jnp.int32] * 2]
    out_specs = [blk() for _ in range(8)]
    out_shapes += [jax.ShapeDtypeStruct((W, R, 128), jnp.float32)] * 2
    out_specs += [blkW(W)] * 2
    if want_labs:
        out_shapes += [jax.ShapeDtypeStruct((R, 128), jnp.int32),
                       jax.ShapeDtypeStruct((R, 128), jnp.float32)]
        out_specs += [blk(), blk()]
    out_shapes += [jax.ShapeDtypeStruct((R, 128), jnp.float32)] * (2 * nlead)
    out_specs += [blk() for _ in range(2 * nlead)]
    if refill:
        out_shapes += [jax.ShapeDtypeStruct((R, 128), jnp.int32)] * 2
        out_specs += [blk(), blk()]
    n_state = 8 + (1 if refill else 0)
    u, L, L0, state = inputs
    assert u.shape[0] == n_uniform
    outs = pl.pallas_call(
        kern, grid=(R // tr,),
        in_specs=[blkW(n_uniform), oc_spec, blkW(W), blkW(W)]
        + [blk() for _ in range(n_state)],
        out_specs=tuple(out_specs), out_shape=tuple(out_shapes),
        interpret=True,
    )(jnp.asarray(u.reshape(n_uniform, R, 128)), jnp.asarray(oc_np),
      jnp.asarray(L.reshape(W, R, 128)), jnp.asarray(L0.reshape(W, R, 128)),
      *[jnp.asarray(s.reshape(R, 128)) for s in state])
    outs = [np.asarray(o) for o in outs]
    res = {"state": [o.reshape(-1) for o in outs[:8]],
           "Ln": outs[8].reshape(W, -1), "Lp": outs[9].reshape(W, -1)}
    k = 10
    if want_labs:
        res["depi"] = outs[k].reshape(-1)
        res["depv"] = outs[k + 1].reshape(-1)
        k += 2
    res["Ip"] = np.stack([o.reshape(-1) for o in outs[k:k + nlead]])
    res["cos"] = np.stack([o.reshape(-1) for o in
                           outs[k + nlead:k + 2 * nlead]])
    k += 2 * nlead
    if refill:
        res["bc"] = outs[k].reshape(-1)
        res["fresh"] = outs[k + 1].reshape(-1)
    return res, n_uniform


def compare(jres, tres):
    """The criterion of skirt_tpu_torch.testing.event_agreement: discrete
    outputs on >= 99.9% of lanes, every float output on every lane whose
    discrete outputs agree, but for at most FLOAT_BAD_LANES lanes (see the
    module docstring)."""
    def as_torch(res):
        out = {k: torch.tensor(np.array(v)) for k, v in res.items()
               if k != "state"}
        out["state"] = [torch.tensor(np.array(s)) for s in res["state"]]
        return out

    res = event_agreement(as_torch(tres), as_torch(jres))
    assert res["discrete"] >= 0.999, res
    assert res["float_bad"] <= FLOAT_BAD_LANES, res


def _torch_event(model, W, refill, inputs):
    grid, ds, ss, ins, options = from_skirt_tpu(*model)
    leaders, _ = tfp._group_leaders(ins)
    spec = tfp._build_kernel(grid, ds, leaders, NPANELS, NP_PEEL, options, W,
                             bool(options.store_absorption), True,
                             ss.components[0].geometry if refill else None)
    u, L, L0, state = inputs
    out = tfp.poly_event(spec, torch.from_numpy(u),
                         torch.from_numpy(spec.oc), torch.from_numpy(L),
                         torch.from_numpy(L0),
                         [torch.from_numpy(s) for s in state])
    res = {k: v for k, v in out.items() if k != "state"}
    res["state"] = list(out["state"])
    return {k: ([x.numpy() for x in v] if isinstance(v, list) else v.numpy())
            for k, v in res.items()}


@pytest.mark.parametrize("W", [1, 4, 12])
@pytest.mark.parametrize("source", [None, "point", "expdisk"],
                         ids=["norefill", "refill-point", "refill-expdisk"])
def test_event_matches_pallas(W, source):
    refill = source is not None
    model = jax_model(W, source or "expdisk", K_refill=K if refill else 0,
                      min_weight_reduction=4.0, min_scatt_events=1)
    n_uniform = 7 + ((4 if source == "expdisk" else 1) + 2 if refill else 0)
    inputs = event_inputs(R * 128, W, n_uniform, K if refill else None,
                          seed=W * 7 + 1)
    jres, _ = jax_event(*model, W, refill, inputs)
    tres = _torch_event(model, W, refill, inputs)
    compare(jres, tres)
    # the inputs exercise every branch: deposits, kills, scatters
    assert (tres["depi"] >= 0).sum() > 100
    assert (tres["state"][6] == 0).sum() > 10
    if refill:
        assert tres["fresh"].sum() > 10


def test_event_without_labs_matches_pallas():
    W = 4
    model = jax_model(W, "expdisk", store_absorption=False)
    inputs = event_inputs(R * 128, W, 7, seed=5)
    jres, _ = jax_event(*model, W, False, inputs)
    tres = _torch_event(model, W, False, inputs)
    assert "depi" not in tres
    compare(jres, tres)


def test_event_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper runs the plain version and launches no
    kernel (the launch count stays put)."""
    W = 4
    model = jax_model(W, "expdisk")
    before = tfp.poly_event.launches
    inputs = event_inputs(R * 128, W, 7, seed=9)
    _torch_event(model, W, False, inputs)
    assert tfp.poly_event.launches == before
