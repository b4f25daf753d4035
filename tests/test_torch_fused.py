"""Kernel K3 parity: the port's monochromatic event against the Pallas one.

The same numpy-made inputs (uniforms and packet state) go through
skirt_tpu's Pallas kernel body — assembled into a pallas_call exactly as
skirt_tpu/engine/fused.py:660-687 does, run in interpret mode — and
through skirt_tpu_torch's plain event (the spec the CUDA kernel is held
against on the GPU), on 1,024 lanes with 8 propagation and 4 peel panels
and two observer directions.  Cases: one dust component with labs and
refill from the ExpDisk sampler; with the Point sampler; without labs;
two components (the mix of tests/test_fused.py:172-232, with refill and
labs); 17 wavelengths, where the Pallas driver reads per-lane float32
tables (`lam_inputs`) instead of compile-time ones.

Tolerances (skirt_tpu_torch.testing.event_agreement): the discrete
outputs (deposit bin, alive, nscatt, bcount, fresh) agree exactly on
>= 99.9% of lanes; they are decided by float32 comparisons, and a
comparison that lands within an ulp may flip between two
implementations that round differently (XLA's CPU backend fuses a*b+c
into one rounding, torch rounds twice; exp/log differ by an ulp between
the two CPU libraries).  Every float output (position, direction, L,
deposit value, peel tau and cosine, blended phase) agrees to rtol 1e-4
(atol 1e-6 x the array's largest magnitude) on every lane whose discrete
outputs agree, but for at most FLOAT_BAD_LANES of 1,024, for the reason
tests/test_torch_fused_poly.py states (ill-conditioned spots amplify the
fused rounding).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from skirt_tpu.engine import fused as jfused
from skirt_tpu_torch.convert import from_skirt_tpu
from skirt_tpu_torch.engine import common as tcm
from skirt_tpu_torch.engine import fused as tfused
from skirt_tpu_torch.testing import event_agreement, mono_event_inputs

torch.set_num_threads(2)

R = 8                       # rows of 128 lanes: 1,024 lanes
NPANELS = 8
NP_PEEL = 4
K = 4
FLOAT_BAD_LANES = 2         # of 1,024 (module docstring)


def jax_model(nlambda, source="expdisk", K_refill=0, ncomp=1, nlead=2,
              **opt_kw):
    """A small dusty disc in skirt_tpu (as __graft_entry__._build, with
    per-wavelength varying optics), two observer directions (or nlead:
    SED instruments at more inclinations); with ncomp=2 the two-component
    mix of tests/test_fused.py, with ncomp=3 that mix and a third
    component."""
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

    wg = OligoWavelengthGrid(list(np.linspace(0.4e-6, 1.2e-6, nlambda)))
    src = (PointGeometry() if source == "point"
           else ExpDiskGeometry(4 * KPC, 0.35 * KPC))
    ss = StellarSystem([LuminosityStellarComponent(src, wg,
                                                   [1e36] * nlambda)])
    half = 12 * KPC
    b = np.linspace(-half, half, 9)
    bz = np.linspace(-2 * KPC, 2 * KPC, 5)
    grid = CartesianGrid(b, b, bz)
    if ncomp == 1:
        fac = np.linspace(1.0, 0.3, nlambda)
        mix = SimpleOligoDustMix(wg, list(2600.0 * fac),
                                 list(0.6 * np.linspace(1.0, 0.5, nlambda)),
                                 list(0.5 * np.linspace(1.0, 0.4, nlambda)))
        comps = [DustComponent(ExpDiskGeometry(4 * KPC, 0.2 * KPC), mix,
                               OpticalDepthNormalization(
                                   "z", wg.lambdav[0], 1.0))]
    else:
        assert nlambda == 2 and ncomp in (2, 3)
        mix1 = SimpleOligoDustMix(wg, [2600.0, 800.0], [0.6, 0.3],
                                  [0.5, 0.2])
        mix2 = SimpleOligoDustMix(wg, [1000.0, 1500.0], [0.2, 0.8],
                                  [-0.2, 0.6])
        comps = [DustComponent(ExpDiskGeometry(4 * KPC, 0.2 * KPC), mix1,
                               OpticalDepthNormalization(
                                   "z", wg.lambdav[0], 0.8)),
                 DustComponent(ExpDiskGeometry(2 * KPC, 0.5 * KPC), mix2,
                               OpticalDepthNormalization(
                                   "z", wg.lambdav[0], 0.5))]
        if ncomp == 3:
            mix3 = SimpleOligoDustMix(wg, [1800.0, 1200.0], [0.4, 0.5],
                                      [0.3, -0.1])
            comps.append(DustComponent(
                ExpDiskGeometry(3 * KPC, 0.3 * KPC), mix3,
                OpticalDepthNormalization("z", wg.lambdav[0], 0.4)))
    ds = DustSystem(grid, comps, samples_per_cell=2, density_mode="analytic")
    ins = [SEDInstrument("sed", 3.08e23, nlambda, inclination=1.0),
           SimpleInstrument("img", 3.08e23, nlambda, 16, 16, fov_x=24 * KPC,
                            fov_y=24 * KPC, inclination=np.pi / 2)]
    ins += [SEDInstrument(f"sed{i}", 3.08e23, nlambda, inclination=inc,
                          azimuth=0.3 * i)
            for i, inc in enumerate(np.linspace(0.2, 2.9, nlead - 2))]
    kw = dict(store_absorption=True, deposition="sampled",
              quadrature_panels=NPANELS, peel_panels=NP_PEEL,
              max_scatt_events=16, fused=True, refill_batches=K_refill)
    kw.update(opt_kw)
    return grid, ds, ss, ins, LifecycleOptions(**kw)


def jax_lane_tables(ds, ell):
    """The per-lane tables skirt_tpu's driver gathers with lam_inputs
    (skirt_tpu/engine/fused.py:650-658, 736-742)."""
    mL3s = [float(v) for v in np.asarray(ds._mass_over_L3).ravel()]
    kextm = (np.asarray(ds.kappaext, np.float32)
             * np.asarray(mL3s, np.float32)[:, None])
    kscam = (np.asarray(ds.kappasca, np.float32)
             * np.asarray(mL3s, np.float32)[:, None])
    g = np.asarray(ds.g, np.float32)
    if ds.ncomp > 1:
        return ([kextm[h, ell] for h in range(ds.ncomp)]
                + [kscam[h, ell] for h in range(ds.ncomp)]
                + [g[h, ell] for h in range(ds.ncomp)])
    alb = (np.asarray(ds.kappasca[0], np.float32)
           / np.maximum(np.asarray(ds.kappaext[0], np.float32), 1e-37))
    return [kextm[0, ell], alb[ell], g[0, ell]]


def jax_event(model, nlambda, refill, inputs):
    """skirt_tpu's Pallas event kernel in interpret mode, called as
    make_fused_lifecycle's call_kernel calls it."""
    grid, ds, ss, ins, options = model
    leaders, _ = jfused._group_leaders(ins)
    sampler = (ss.components[0].geometry.device_sampler_xyz()
               if refill else None)
    want_labs = bool(options.store_absorption)
    lam_inputs = nlambda > jfused._MAX_CHAIN_AUTO
    kern = jfused._build_kernel(grid, ds, leaders, options.quadrature_panels,
                                options.peel_panels, options, nlambda,
                                want_labs, True, sampler=sampler,
                                lam_inputs=lam_inputs)
    multi = ds.ncomp > 1
    nlead = len(leaders)
    tr = min(32, R)
    u, state = inputs
    n_uniform = u.shape[0]
    arrays = list(state[:11])
    if lam_inputs:
        arrays += jax_lane_tables(ds, state[9])
    arrays += list(state[11:])

    def blk():
        return pl.BlockSpec((tr, 128), lambda i: (i, 0),
                            memory_space=pltpu.VMEM)

    out_dtypes = ([jnp.float32] * 7 + [jnp.int32] * 2
                  + ([jnp.int32, jnp.float32] if want_labs else [])
                  + [jnp.float32] * (2 * nlead)
                  + ([jnp.float32] * nlead if multi else [])
                  + ([jnp.int32, jnp.int32] if refill else []))
    u_spec = pl.BlockSpec((n_uniform, tr, 128), lambda i: (0, i, 0),
                          memory_space=pltpu.VMEM)
    outs = pl.pallas_call(
        kern, grid=(R // tr,),
        in_specs=[u_spec] + [blk() for _ in arrays],
        out_specs=tuple(blk() for _ in out_dtypes),
        out_shape=tuple(jax.ShapeDtypeStruct((R, 128), dt)
                        for dt in out_dtypes),
        interpret=True,
    )(jnp.array(u.reshape(n_uniform, R, 128)),
      *[jnp.array(np.asarray(a).reshape(R, 128)) for a in arrays])
    outs = [np.asarray(o).reshape(-1) for o in jax.block_until_ready(outs)]
    res = {"state": outs[:9]}
    k = 9
    if want_labs:
        res["depi"], res["depv"] = outs[k], outs[k + 1]
        k += 2
    res["tau"] = np.stack(outs[k:k + nlead])
    res["cos"] = np.stack(outs[k + nlead:k + 2 * nlead])
    k += 2 * nlead
    if multi:
        res["phase"] = np.stack(outs[k:k + nlead])
        k += nlead
    if refill:
        res["bc"], res["fresh"] = outs[k], outs[k + 1]
    return res


def torch_event(model, nlambda, refill, inputs):
    grid, ds, ss, ins, options = from_skirt_tpu(*model)
    leaders, _ = tcm._group_leaders(ins)
    spec = tfused._build_kernel(
        grid, ds, leaders, options.quadrature_panels, options.peel_panels,
        options, nlambda,
        bool(options.store_absorption), True,
        ss.components[0].geometry if refill else None)
    u, state = inputs
    out = tfused.mono_event(spec, torch.from_numpy(u.copy()),
                            [torch.from_numpy(s.copy()) for s in state])
    res = {k: v.numpy() for k, v in out.items() if k != "state"}
    res["state"] = [s.numpy() for s in out["state"]]
    return spec, res


def compare(jres, tres):
    def as_torch(res):
        out = {k: torch.from_numpy(np.array(v)) for k, v in res.items()
               if k != "state"}
        out["state"] = [torch.from_numpy(np.array(s)) for s in res["state"]]
        return out

    res = event_agreement(as_torch(tres), as_torch(jres))
    assert res["discrete"] >= 0.999, res
    assert res["float_bad"] <= FLOAT_BAD_LANES, res
    return res


CASES = {
    # id: (nlambda, source, refill, ncomp, extra options)
    "labs-refill-expdisk": (4, "expdisk", True, 1, {}),
    "refill-point": (4, "point", True, 1, {}),
    "nolabs": (4, "expdisk", False, 1, {"store_absorption": False}),
    "two-components": (2, "expdisk", True, 2, {}),
    "lam-inputs-17": (17, "expdisk", False, 1, {}),
    # shapes past the card's one-pass route (the chunked route's: more than
    # 32 panels, more than 8 observers, more than 2 components)
    "panels-40": (4, "expdisk", True, 1, {"quadrature_panels": 40}),
    "leaders-10": (4, "expdisk", False, 1, {"nlead": 10}),
    "three-components": (2, "expdisk", True, 3, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_event_matches_pallas(case):
    nlambda, source, refill, ncomp, extra = CASES[case]
    model = jax_model(nlambda, source, K_refill=K if refill else 0,
                      ncomp=ncomp, min_weight_reduction=4.0,
                      min_scatt_events=1, **extra)
    assert len(tcm._group_leaders(model[3])[0]) == extra.get("nlead", 2)
    nu = 4 if source == "expdisk" else 1
    n_uniform = 5 + (nu + 2 if refill else 0) + (1 if ncomp > 1 else 0)
    inputs = mono_event_inputs(R * 128, nlambda, n_uniform,
                               K if refill else None, seed=nlambda + 31)
    jres = jax_event(model, nlambda, refill, inputs)
    spec, tres = torch_event(model, nlambda, refill, inputs)
    assert spec.n_uniform == n_uniform
    compare(jres, tres)
    # the inputs exercise every branch: deposits, kills, scatters, refill
    alive_in = inputs[1][7] != 0
    alive_out = tres["state"][7] != 0
    assert (alive_in & ~alive_out).sum() > 10
    assert (tres["state"][8] > inputs[1][8]).sum() > 100
    if extra.get("store_absorption", True):
        assert (tres["depi"] >= 0).sum() > 100
    else:
        assert "depi" not in tres
    if refill:
        assert tres["fresh"].sum() > 10
    if ncomp > 1:
        assert (tres["phase"] > 0).sum() > 100
    if nlambda > jfused._MAX_CHAIN_AUTO:
        # the per-lane tables skirt_tpu's driver feeds the kernel give the
        # plain event the same result as the spec's own gather
        u, state = inputs
        lam = [torch.from_numpy(np.ascontiguousarray(a))
               for a in jax_lane_tables(model[1], state[9])]
        out = tfused.mono_event_plain(
            spec, torch.from_numpy(u.copy()),
            [torch.from_numpy(s.copy()) for s in state], lam=lam)
        for a, b in zip(out["state"], tres["state"]):
            np.testing.assert_array_equal(a.numpy(), b)
        for k in ("tau", "cos", "bc"):
            if k in tres:
                np.testing.assert_array_equal(out[k].numpy(), tres[k])


def test_event_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper runs the plain version and launches no
    kernel (the launch count stays put)."""
    model = jax_model(4, "expdisk", K_refill=K)
    before = tfused.mono_event.launches
    inputs = mono_event_inputs(R * 128, 4, 11, K, seed=9)
    torch_event(model, 4, True, inputs)
    assert tfused.mono_event.launches == before


# ---------------------------------------------------------------------------
# the slice end to end: make_lifecycle(fused=True) on the port vs skirt_tpu
# ---------------------------------------------------------------------------
#
# skirt_tpu's monochromatic fused engine and the port's on the same model
# carried across (from_skirt_tpu).  The two frameworks draw different
# random streams, so the results are held at tests/test_fused.py's Monte
# Carlo tolerances for each case (SED per wavelength, frame total, labs
# total; 128 wavelengths: the SED total 0.02, each wavelength 0.25, labs,
# and the frame total at the 2-wavelength bound, since test_fused runs
# that case without a frame), at four times its packet counts (the
# 128-wavelength case at its own): test_fused shares the launch stream
# between its two runs, these runs share nothing, and at these counts the
# spread between seeds stays under a third of each bound.

SLICE = {
    # id: (model kw, packets, refill, SED rtol, frame rtol, labs rtol)
    "pair": (dict(nlambda=2, ncells=8), 1 << 15, 0, 0.03, 0.03, 0.05),
    "refill": (dict(nlambda=2, ncells=8), 1 << 13, 4, 0.04, 0.03, 0.05),
    "two-components": (dict(nlambda=2, ncells=16, ncomp=2), 1 << 15, 0,
                       0.02, 0.02, 0.03),
    "lambda-128": (dict(nlambda=128, ncells=8, vary_lambda=True), 1 << 14,
                   0, 0.25, 0.03, 0.05),
}


def graft_model(nlambda, ncells, n_instruments=2, vary_lambda=False,
                ncomp=1, refill=0):
    """__graft_entry__._build's dusty disc as skirt_tpu objects (with
    ncomp=2 the two-component model of tests/test_fused.py)."""
    from skirt_tpu.constants import KPC
    from skirt_tpu.engine.lifecycle import LifecycleOptions
    from skirt_tpu.geometry import ExpDiskGeometry
    from skirt_tpu.grids import CartesianGrid
    from skirt_tpu.instruments import SEDInstrument, SimpleInstrument
    from skirt_tpu.media import (DustComponent, DustSystem,
                                 OpticalDepthNormalization,
                                 SimpleOligoDustMix)
    from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                           StellarSystem)
    from skirt_tpu.wavelengths import OligoWavelengthGrid

    if ncomp == 2:
        wg = OligoWavelengthGrid([0.55e-6, 1.0e-6])
    else:
        wg = OligoWavelengthGrid(list(np.linspace(0.4e-6, 1.2e-6, nlambda)))
    ss = StellarSystem([LuminosityStellarComponent(
        ExpDiskGeometry(4 * KPC, 0.35 * KPC), wg, [1e36] * nlambda)])
    half = 12 * KPC
    b = np.linspace(-half, half, ncells + 1)
    bz = np.linspace(-2 * KPC, 2 * KPC, max(ncells // 2, 2) + 1)
    grid = CartesianGrid(b, b, bz)
    if ncomp == 2:
        mix1 = SimpleOligoDustMix(wg, [2600.0, 800.0], [0.6, 0.3],
                                  [0.5, 0.2])
        mix2 = SimpleOligoDustMix(wg, [1000.0, 1500.0], [0.2, 0.8],
                                  [-0.2, 0.6])
        comps = [DustComponent(ExpDiskGeometry(4 * KPC, 0.2 * KPC), mix1,
                               OpticalDepthNormalization(
                                   "z", wg.lambdav[0], 0.8)),
                 DustComponent(ExpDiskGeometry(2 * KPC, 0.5 * KPC), mix2,
                               OpticalDepthNormalization(
                                   "z", wg.lambdav[0], 0.5))]
        npix = 8
    else:
        if vary_lambda:
            fac = np.linspace(1.0, 0.3, nlambda)
            mix = SimpleOligoDustMix(
                wg, list(2600.0 * fac),
                list(0.6 * np.linspace(1.0, 0.5, nlambda)),
                list(0.5 * np.linspace(1.0, 0.4, nlambda)))
        else:
            mix = SimpleOligoDustMix(wg, [2600.0] * nlambda,
                                     [0.6] * nlambda, [0.5] * nlambda)
        comps = [DustComponent(ExpDiskGeometry(4 * KPC, 0.2 * KPC), mix,
                               OpticalDepthNormalization(
                                   "z", wg.lambdav[0], 1.0))]
        npix = 16
    ds = DustSystem(grid, comps, samples_per_cell=4, density_mode="analytic")
    ins = [SEDInstrument("sed", 3.08e23, nlambda, inclination=1.0),
           SimpleInstrument("img", 3.08e23, nlambda, npix, npix,
                            fov_x=24 * KPC, fov_y=24 * KPC,
                            inclination=np.pi / 2)][:n_instruments]
    opts = LifecycleOptions(store_absorption=True, deposition="sampled",
                            max_scatt_events=24, quadrature_panels=8,
                            refill_batches=refill, fused=True)
    return grid, ds, ss, ins, opts


@pytest.fixture(scope="module", params=list(SLICE))
def slice_runs(request):
    from skirt_tpu.engine.lifecycle import make_lifecycle as jax_lifecycle
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine.lifecycle import make_lifecycle

    kw, n, refill, *tols = SLICE[request.param]
    model = graft_model(refill=refill, **kw)
    nl = kw["nlambda"]
    ell = np.arange(n, dtype=np.int32) % nl
    L0 = np.full(n, 1e36 * nl / (n * max(refill, 1)), np.float32)

    grid, ds, ss, ins, opts = model
    run = jax.jit(jax_lifecycle(grid, ds, ss, ins, opts, nl))
    tj = run(jax.random.key(4357), jnp.array(ell), jnp.array(L0), {
        "instruments": [i.zero_tallies() for i in ins],
        "labs": jnp.zeros((grid.ncells * nl,), jnp.float32)})
    tj = jax.tree.map(lambda a: np.asarray(a, np.float64), tj)

    grid, ds, ss, ins, opts = from_skirt_tpu(*model)
    run = make_lifecycle(grid, ds, ss, ins, opts, nl)
    tt = run(rng.root_key(4357), torch.from_numpy(ell.copy()),
             torch.from_numpy(L0.copy()),
             {"instruments": [i.zero_tallies("cpu") for i in ins],
              "labs": torch.zeros(grid.ncells * nl)})
    tt = {"instruments": [{k: v.double().numpy() for k, v in d.items()}
                          for d in tt["instruments"]],
          "labs": tt["labs"].double().numpy()}
    return request.param, tj, tt, tols


def test_slice_sed(slice_runs):
    case, tj, tt, (sed_tol, _, _) = slice_runs
    fj = tj["instruments"][0]["Ftot"]
    ft = tt["instruments"][0]["Ftot"]
    np.testing.assert_allclose(ft, fj, rtol=sed_tol)
    if case == "lambda-128":
        assert ft.sum() == pytest.approx(fj.sum(), rel=0.02)


def test_slice_frame_total(slice_runs):
    _, tj, tt, (_, frame_tol, _) = slice_runs
    cj = tj["instruments"][1]["ftot"].sum()
    ct = tt["instruments"][1]["ftot"].sum()
    assert ct == pytest.approx(cj, rel=frame_tol)


def test_slice_absorption(slice_runs):
    _, tj, tt, (_, _, labs_tol) = slice_runs
    assert tt["labs"].sum() == pytest.approx(tj["labs"].sum(), rel=labs_tol)


def test_slice_finite_and_physical(slice_runs):
    _, _, tt, _ = slice_runs
    leaves = [v for d in tt["instruments"] for v in d.values()] + [tt["labs"]]
    for leaf in leaves:
        assert np.isfinite(leaf).all() and (leaf >= 0).all()
    assert tt["labs"].sum() > 0


def _closure(fn):
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


@pytest.mark.parametrize("nlambda, ncomp", [(4, 1), (2, 2), (17, 1)],
                         ids=["chain", "chain-two-components",
                              "lam-inputs-17"])
def test_converted_model_computes_the_same_constants(nlambda, ncomp):
    """A model carried across by convert.py gives the event the constants
    and wavelength tables the Pallas body closes over (and the per-lane
    tables its driver gathers above 16 wavelengths, which carry the same
    bits), bit for bit; the per-packet opacities and the HG phase
    function agree too."""
    model = jax_model(nlambda, "expdisk", K_refill=K, ncomp=ncomp)
    grid, ds, ss, ins, options = model
    leaders, _ = jfused._group_leaders(ins)
    lam_inputs = nlambda > 16
    kern = jfused._build_kernel(
        grid, ds, leaders, NPANELS, NP_PEEL, options, nlambda, True, True,
        sampler=ss.components[0].geometry.device_sampler_xyz(),
        lam_inputs=lam_inputs)
    jc = _closure(kern)
    spec, _ = torch_event(model, nlambda, True, mono_event_inputs(
        128, nlambda, 11 + (ncomp > 1), K, seed=1))
    H = ds.ncomp
    if lam_inputs:
        want = np.stack(jax_lane_tables(ds, np.arange(nlambda)))
    elif H == 1:
        want = np.asarray([jc["kextm_t"][0], jc["alb_t"], jc["g_t"][0]],
                          np.float32)
    else:
        want = np.asarray(jc["kextm_t"] + jc["kscam_t"] + jc["g_t"],
                          np.float32)
    np.testing.assert_array_equal(spec.tab, want)
    # the two branches of the Pallas driver give the same bits
    np.testing.assert_array_equal(
        spec.tab, np.stack(jax_lane_tables(ds, np.arange(nlambda))))
    assert spec.tab.dtype == np.float32 and spec.H == H
    for name in ("inv_np", "inv_pp", "inv_minred", "min_scatt", "K",
                 "nu_pos", "u_comp", "npanels", "np_peel"):
        assert getattr(spec, name) == jc[name], name
    assert spec.xi == np.float32(jc["xi"])
    assert spec.leaders == jc["leaders"]
    rc = _closure(jc["rho_s"])
    assert spec.invL == rc["invL"] and spec.lscale == rc["lscale"]

    tgrid, tds, *_ = from_skirt_tpu(*model)
    ell = np.arange(64, dtype=np.int32) % nlambda
    cosa = np.linspace(-1, 1, 64).astype(np.float32)
    jks, jke = ds.packet_kappas(jnp.array(ell))
    tks, tke = tds.packet_kappas(torch.from_numpy(ell.copy()))
    for a, b in zip(jks + jke, tks + tke):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for jc_, tc in zip(ds.components, tds.components):
        jp = np.asarray(jc_.mix.phase_function(jnp.array(ell),
                                               jnp.array(cosa)))
        tp = tc.mix.phase_function(torch.from_numpy(ell.copy()),
                                   torch.from_numpy(cosa.copy())).numpy()
        np.testing.assert_allclose(tp, jp, rtol=1e-6)
