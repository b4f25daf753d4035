"""The port never imports JAX, and importing it needs no CUDA toolchain.

Checked in a fresh subprocess: in this test process tests/conftest.py has
already imported jax, so an in-process check would prove nothing.  The
subprocess imports every module of skirt_tpu_torch (the CUDA wrapper
modules included) and chip_smoke.py with no nvcc on PATH, runs a tiny
analytic slice, a monochromatic OligoSimulation, both table engines
(config 3's octree torus at max_level 3), both multi-component table
engines (the two-component model, K5 and K7) and config 4 (a 200-site
Voronoi tessellation from the native cell builder: the direct table,
K4d and K6d, and the voxel view) and the three polarized chains (K3, K4
and K6p with the Mueller machinery) on the CPU, writes the simulation's
results, and reports which of jax / triton / skirt_tpu got imported and
whether a kernel build was attempted.  The native Voronoi library is
built in the test process first (the subprocess has no compiler on PATH
and loads it from the port's build cache).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import importlib, json, pkgutil, sys
    import torch
    torch.set_num_threads(1)
    import skirt_tpu_torch
    from skirt_tpu_torch import kernels
    from skirt_tpu_torch.ops import binned
    from skirt_tpu_torch.engine import fused_poly, fused_table, fused_table_poly
    import chip_smoke
    mods = sorted(m.name for m in pkgutil.walk_packages(
        skirt_tpu_torch.__path__, "skirt_tpu_torch."))
    for m in mods:
        importlib.import_module(m)
    from bench_torch import _build, _model
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine import fused
    from skirt_tpu_torch.engine.simulation import OligoSimulation
    from skirt_tpu_torch.log import SilentLog
    run, zero, ell, L0 = _build(nlambda=3, ncells=4, packets=256,
                                refill_batches=2, quadrature_panels=8,
                                peel_panels=4, max_scatt=4)
    t = run(rng.root_key(1), ell, L0, zero())
    # the public entry point on the monochromatic engine (kernel K3)
    grid, ds, ss, ins, opts = _model(nlambda=3, ncells=4, refill_batches=2,
                                     quadrature_panels=8, peel_panels=4,
                                     max_scatt=4, polychromatic=False)
    sim = OligoSimulation(stellar_system=ss, instruments=ins,
                          dust_system=ds, options=opts, packets=512,
                          batch_size=384, log=SilentLog(),
                          out_dir=sys.argv[1], prefix="run", device="cpu")
    acc = sim._run_phase(rng.root_key(sim.seed), 0)
    # the writers (OligoSimulation.write, as run() calls it)
    sim.write(acc)
    # the table engines (kernels K4 and K6) on config 3's octree torus
    from bench_torch import _octree_build
    table = []
    for poly in (False, True):
        tr, tz, tell, tL0, _, _ = _octree_build(
            64, device="cpu", polychromatic=poly, refill_batches=2,
            quadrature_panels=8, peel_panels=4, max_level=3)
        tt = tr(rng.root_key(2), tell, tL0, tz())
        table.append([float(tt["instruments"][0]["Ftot"].sum()),
                      float(tt["labs"].sum())])
        # the two-component model (kernels K5 and K7)
        tr, tz, tell, tL0, _, _ = _octree_build(
            64, device="cpu", multi=True, polychromatic=poly,
            refill_batches=2, max_level=3)
        tt = tr(rng.root_key(3), tell, tL0, tz())
        table.append([float(tt["instruments"][0]["Ftot"].sum()),
                      float(tt["labs"].sum())])
    # config 4: the direct table (K4d, K6d) and the voxel view (K6)
    voronoi = []
    for direct, poly in ((True, False), (True, True), (False, True)):
        tr, tz, tell, tL0, _, vm = _octree_build(
            64, device="cpu", voronoi=True, nsites=200, direct=direct,
            polychromatic=poly, refill_batches=2, quadrature_panels=8,
            peel_panels=4, res=16)
        tt = tr(rng.root_key(4), tell, tL0, tz())
        voronoi.append([float(tt["instruments"][0]["Ftot"].sum()),
                        float(tt["labs"].sum()), tr.spec.arith_locate])
        if direct:
            native_cells = vm[0].used_native
    # the three polarized chains of bench_polarized.py (K3, K4, K6p)
    from bench_torch import _polarized_build
    polarized = []
    for kw in ({}, {"table": True}, {"table": True, "poly": True}):
        tr, tz, tell, tL0, _, _ = _polarized_build(
            64, device="cpu", refill_batches=2, **kw)
        tt = tr(rng.root_key(5), tell, tL0, tz())["instruments"][0]
        polarized.append([float(tt["Fscastel"].sum()),
                          float(tt["FQ"].abs().sum()),
                          getattr(tr.spec, "want_pol", None)])
    reference = sorted(m for m in sys.modules
                       if m == "skirt_tpu" or m.startswith("skirt_tpu."))
    print(json.dumps({
        "jax": "jax" in sys.modules,
        "triton": "triton" in sys.modules,
        "reference_during_run": reference,
        "built": kernels._lib is not None,
        "launches": [binned.binned_add.launches,
                     fused_poly.poly_event.launches,
                     fused.mono_event.launches,
                     fused_table.table_event.launches,
                     fused_table.table_event.direct_launches,
                     fused_table.table_multi_event.launches,
                     fused_table_poly.table_poly_event.launches,
                     fused_table_poly.table_poly_event.direct_launches,
                     fused_table_poly.table_poly_multi_event.launches],
        "mono": isinstance(sim._lifecycle.spec, fused.MonoEventSpec),
        "mono_sed": float(acc["instruments"][0]["Ftot"].sum()),
        "mono_labs": float(acc["labs"].sum()),
        "modules": mods,
        "sed": float(t["instruments"][0]["Ftot"].sum()),
        "labs": float(t["labs"].sum()),
        "table": table,
        "voronoi": voronoi,
        "native_cells": native_cells,
        "polarized": polarized,
    }))
""")


def test_port_imports_and_runs_without_jax_or_toolchain(tmp_path):
    from skirt_tpu_torch import native

    native_built = native.load() is not None
    env = dict(os.environ, PYTHONPATH=str(REPO), PATH=str(tmp_path),
               CUDA_VISIBLE_DEVICES="")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["jax"] is False
    assert res["triton"] is False
    # a run, its writers and chip_smoke.py import nothing of the JAX package
    assert res["reference_during_run"] == []
    assert res["built"] is False and res["launches"] == [0] * 9
    for mod in ("engine.fused_poly", "engine.fused", "engine.simulation",
                "engine.fused_table", "engine.fused_table_poly",
                "grids.octree", "grids.voronoi", "native", "devices", "units",
                "fits", "kernels", "media.polarization"):
        assert f"skirt_tpu_torch.{mod}" in res["modules"]
    assert res["sed"] > 0 and res["labs"] > 0
    assert res["mono"] and res["mono_sed"] > 0 and res["mono_labs"] > 0
    assert len(res["table"]) == 4
    assert all(sed > 0 and labs > 0 for sed, labs in res["table"])
    assert [arith for *_, arith in res["voronoi"]] == [False, False, True]
    assert all(sed > 0 and labs > 0 for sed, labs, _ in res["voronoi"])
    assert res["native_cells"] is native_built
    assert [p[2] for p in res["polarized"]] == [None, None, True]
    assert all(sca > 0 and q > 0 for sca, q, _ in res["polarized"])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "run_img_sed.dat", "run_img_total.fits", "run_sed_sed.dat"]
