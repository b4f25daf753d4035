"""The public entry point: skirt_tpu_torch's OligoSimulation.

The verify skill's minimal run (an ExpDisk stellar disc in an ExpDisk
dust disc on a uniform Cartesian grid, an SED instrument and a
SimpleInstrument frame, absorption tallies, the fused analytic engine
with refill) is built in skirt_tpu and carried across with
convert.convert_simulation.  skirt_tpu runs with use_mesh=False: the
test session gives JAX 8 virtual CPU devices, and use_mesh=None would
shard its run over them.

Tolerances: the two frameworks draw different random streams, so the
SED per wavelength and the frame total are held at 3% and the labs
total at 5% (tests/test_fused.py's Monte Carlo bounds; at 16,384 packets
per wavelength the spread between seeds is about 1%).  Checkpoint/resume
must reproduce the uninterrupted run exactly: batch b runs with the same
key grouped or alone, and the float64 host sums resume from the saved
ones.  The written files round-trip through skirt_tpu.io.fits.read_fits
with skirt_tpu's headers, shapes and units.
"""

import dataclasses

import numpy as np
import pytest
import torch

from skirt_tpu_torch.convert import convert_simulation
from skirt_tpu_torch.engine import fused as tfused
from skirt_tpu_torch.engine import fused_poly as tfp
from skirt_tpu_torch.log import SilentLog

torch.set_num_threads(2)

NL = 2
PACKETS = 1 << 14


def jax_simulation(out_dir, packets=PACKETS, **opt_kw):
    """The verify skill's minimal run in skirt_tpu."""
    from skirt_tpu.constants import KPC
    from skirt_tpu.engine.lifecycle import LifecycleOptions
    from skirt_tpu.engine.simulation import OligoSimulation
    from skirt_tpu.geometry import ExpDiskGeometry
    from skirt_tpu.grids import CartesianGrid
    from skirt_tpu.instruments import SEDInstrument, SimpleInstrument
    from skirt_tpu.log import SilentLog as JSilentLog
    from skirt_tpu.media import (DustComponent, DustSystem,
                                 OpticalDepthNormalization,
                                 SimpleOligoDustMix)
    from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                           StellarSystem)
    from skirt_tpu.wavelengths import OligoWavelengthGrid

    wg = OligoWavelengthGrid([0.55e-6, 1.0e-6])
    ss = StellarSystem([LuminosityStellarComponent(
        ExpDiskGeometry(4 * KPC, 0.35 * KPC), wg, [1e36, 6e35])])
    half = 12 * KPC
    b = np.linspace(-half, half, 17)
    grid = CartesianGrid(b, b, np.linspace(-2 * KPC, 2 * KPC, 9))
    mix = SimpleOligoDustMix(wg, [2600.0, 1200.0], [0.6, 0.45], [0.5, 0.3])
    ds = DustSystem(grid, [DustComponent(
        ExpDiskGeometry(4 * KPC, 0.2 * KPC), mix,
        OpticalDepthNormalization("z", wg.lambdav[0], 1.0))],
        samples_per_cell=4, density_mode="analytic")
    ins = [SEDInstrument("sed", 3.08e23, NL, inclination=1.0),
           SimpleInstrument("img", 3.08e23, NL, 16, 16, fov_x=24 * KPC,
                            fov_y=24 * KPC, inclination=np.pi / 2)]
    kw = dict(store_absorption=True, deposition="sampled",
              quadrature_panels=16, peel_panels=8, max_scatt_events=32,
              refill_batches=4, fused=True)
    kw.update(opt_kw)
    return OligoSimulation(stellar_system=ss, instruments=ins,
                           dust_system=ds, packets=packets,
                           options=LifecycleOptions(**kw),
                           batch_size=1 << 12, dispatch_batches=2,
                           log=JSilentLog(), out_dir=str(out_dir),
                           prefix="run", use_mesh=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jdir = tmp_path_factory.mktemp("jax")
    tdir = tmp_path_factory.mktemp("torch")
    jsim = jax_simulation(jdir)
    tsim = convert_simulation(jsim, log=SilentLog(), out_dir=str(tdir),
                              device="cpu")
    return jsim, jsim.run(), tsim, tsim.run(), jdir, tdir


def test_settings_carried_across(runs):
    jsim, _, tsim, *_ = runs
    for name in ("packets", "seed", "batch_size", "prefix",
                 "checkpoint_every", "dispatch_batches", "nlambda"):
        assert getattr(tsim, name) == getattr(jsim, name), name
    assert dataclasses.asdict(tsim.options) == {
        f: getattr(jsim.options, f) for f in tsim.options.__dataclass_fields__}
    np.testing.assert_array_equal(tsim.stellar_system.Lv,
                                  jsim.stellar_system.Lv)
    batches_j = [(b, np.asarray(e), np.asarray(L)) for b, e, L
                 in jsim._batches()]
    batches_t = [(b, e.numpy(), L.numpy()) for b, e, L in tsim._batches()]
    assert len(batches_t) == len(batches_j) == 2
    for (bj, ej, Lj), (bt, et, Lt) in zip(batches_j, batches_t):
        assert bj == bt
        np.testing.assert_array_equal(et, ej)
        np.testing.assert_array_equal(Lt, Lj)
    # the fused mono engine ran (kernel K3's spec), not the poly one
    assert isinstance(tsim._lifecycle.spec, tfused.MonoEventSpec)


def test_sed_and_frame_match_skirt_tpu(runs):
    _, accj, _, acct, *_ = runs
    for dj, dt in zip(accj["instruments"], acct["instruments"]):
        np.testing.assert_allclose(dt["Ftot"], dj["Ftot"], rtol=0.03)
    fj = accj["instruments"][1]["ftot"].sum()
    ft = acct["instruments"][1]["ftot"].sum()
    assert ft == pytest.approx(fj, rel=0.03)
    assert acct["labs"].sum() == pytest.approx(accj["labs"].sum(), rel=0.05)
    for d in acct["instruments"]:
        for v in d.values():
            assert v.dtype == np.float64 and np.isfinite(v).all()


def test_written_files_round_trip(runs):
    from skirt_tpu.io.fits import read_fits

    *_, jdir, tdir = runs
    files = sorted(p.name for p in jdir.iterdir())
    assert files == sorted(p.name for p in tdir.iterdir())
    assert files == ["run_img_sed.dat", "run_img_total.fits",
                     "run_sed_sed.dat"]
    dj, hj = read_fits(str(jdir / "run_img_total.fits"))
    dt, ht = read_fits(str(tdir / "run_img_total.fits"))
    assert dt.shape == dj.shape == (NL, 16, 16)
    assert ht == hj
    assert np.isfinite(dt).all() and dt.sum() == pytest.approx(dj.sum(),
                                                               rel=0.03)
    for name in ("run_sed_sed.dat", "run_img_sed.dat"):
        sj = np.loadtxt(jdir / name)
        st = np.loadtxt(tdir / name)
        np.testing.assert_array_equal(st[:, 0], sj[:, 0])
        np.testing.assert_allclose(st[:, 1], sj[:, 1], rtol=0.03)
        assert (tdir / name).read_text().splitlines()[0] == \
            (jdir / name).read_text().splitlines()[0]


class _Interrupt(Exception):
    pass


def test_checkpoint_resume_reproduces_uninterrupted_run(tmp_path):
    """A run cut during its third dispatch resumes from the checkpoint
    the second one left and ends with the uninterrupted run's tallies."""
    from skirt_tpu_torch import rng

    def sim(out_dir):
        # 4 full batches of 256 lanes x K = 4 per wavelength, 1 ragged
        jsim = jax_simulation(out_dir, packets=4608)
        return convert_simulation(jsim, log=SilentLog(), batch_size=1 << 9,
                                  checkpoint_every=2, device="cpu")

    full = sim(tmp_path / "full")
    assert len(list(full._batches())) == 5      # 2 + 2 + the last alone
    want = full._run_phase(rng.root_key(full.seed), 0)

    cut = sim(tmp_path / "cut")
    calls = []
    life = cut._lifecycle

    def interrupted(*args):
        calls.append(1)
        if len(calls) == 5:
            raise _Interrupt
        return life(*args)

    cut._lifecycle = interrupted
    with pytest.raises(_Interrupt):
        cut._run_phase(rng.root_key(cut.seed), 0)
    ckpt = tmp_path / "cut" / "run_phase0.ckpt.npz"
    assert int(np.load(ckpt)["next_batch"]) == 4

    resumed = sim(tmp_path / "cut")
    got = resumed._run_phase(rng.root_key(resumed.seed), 0)
    assert not ckpt.exists()
    for dg, dw in zip(got["instruments"], want["instruments"]):
        for k in dw:
            np.testing.assert_array_equal(dg[k], dw[k])
    np.testing.assert_array_equal(got["labs"], want["labs"])
    assert want["labs"].sum() > 0


def test_polychromatic_reaches_the_s1_engine(tmp_path):
    """polychromatic=True builds the polychromatic engine (kernel K1)
    through the public API; the two estimators agree on the SED."""
    from skirt_tpu_torch import rng

    jsim = jax_simulation(tmp_path, packets=1 << 12)
    mono = convert_simulation(jsim, log=SilentLog(), device="cpu")
    poly = convert_simulation(jsim, log=SilentLog(), device="cpu",
                              options=dataclasses.replace(
                                  mono.options, polychromatic=True))
    assert poly._poly and isinstance(poly._lifecycle.spec, tfp.PolyEventSpec)
    # one batch of packets / K lanes, each carrying both wavelengths
    assert [tuple(L.shape) for _, _, L in poly._batches()] == [(1 << 10, NL)]
    key = rng.root_key(poly.seed)
    sp = poly._run_phase(key, 0)["instruments"][0]["Ftot"]
    sm = mono._run_phase(key, 0)["instruments"][0]["Ftot"]
    np.testing.assert_allclose(sp, sm, rtol=0.05)


def test_unported_settings_raise(tmp_path):
    jsim = jax_simulation(tmp_path, packets=1 << 10)
    for kw, slice_ in ((dict(use_mesh=True), "S8"),
                       (dict(use_mesh="slab"), "S8"),
                       (dict(compaction_iterations=4), "S2b"),
                       (dict(write_density=True), "S2b"),
                       (dict(options=dataclasses.replace(
                           jsim.options, fused=False)), "S2b"),
                       # skirt_tpu's driver tries polychromatic lanes
                       # without fused and crashes on shapes; the port
                       # falls back to monochromatic batches and names the
                       # unported general lifecycle
                       (dict(options=dataclasses.replace(
                           jsim.options, fused=False, polychromatic=True)),
                        "S2b")):
        with pytest.raises(ValueError, match=f"slice {slice_}"):
            convert_simulation(jsim, log=SilentLog(), device="cpu", **kw)
