"""The port never imports JAX, and importing it needs no CUDA toolchain.

Checked in a fresh subprocess: in this test process tests/conftest.py has
already imported jax, so an in-process check would prove nothing.  The
subprocess imports every module of skirt_tpu_torch (the CUDA wrapper
modules included) and chip_smoke.py with no nvcc on PATH, runs a tiny
slice on the CPU, writes its results, and reports which of jax / triton /
skirt_tpu got imported and whether a kernel build was attempted.
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
    from skirt_tpu_torch.engine import fused_poly
    import chip_smoke
    mods = sorted(m.name for m in pkgutil.walk_packages(
        skirt_tpu_torch.__path__, "skirt_tpu_torch."))
    for m in mods:
        importlib.import_module(m)
    from bench_torch import _build
    from skirt_tpu_torch import rng
    run, zero, ell, L0 = _build(nlambda=3, ncells=4, packets=256,
                                refill_batches=2, quadrature_panels=8,
                                peel_panels=4, max_scatt=4)
    t = run(rng.root_key(1), ell, L0, zero())
    reference = sorted(m for m in sys.modules
                       if m == "skirt_tpu" or m.startswith("skirt_tpu."))
    # the writers, on the run's tallies (instruments as _build makes them)
    import numpy as np
    from skirt_tpu.units import Units
    from skirt_tpu_torch.instruments import SEDInstrument, SimpleInstrument
    from skirt_tpu_torch.wavelengths import OligoWavelengthGrid
    wg = OligoWavelengthGrid(list(np.linspace(0.4e-6, 1.2e-6, 3)))
    ins = [SEDInstrument("sed", 3.08e23, 3),
           SimpleInstrument("img", 3.08e23, 3, 16, 16, fov_x=7e20,
                            fov_y=7e20)]
    for i, acc in zip(ins, t["instruments"]):
        i.write(acc, wg, Units(), sys.argv[1], "run")
    print(json.dumps({
        "jax": "jax" in sys.modules,
        "triton": "triton" in sys.modules,
        "reference_during_run": reference,
        "built": kernels._lib is not None,
        "launches": [binned.binned_add.launches,
                     fused_poly.poly_event.launches],
        "modules": mods,
        "sed": float(t["instruments"][0]["Ftot"].sum()),
        "labs": float(t["labs"].sum()),
    }))
""")


def test_port_imports_and_runs_without_jax_or_toolchain(tmp_path):
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
    # a run (and chip_smoke.py, which drives one) imports nothing of the
    # JAX package; only the writers use its JAX-free io.fits and units
    assert res["reference_during_run"] == []
    assert res["built"] is False and res["launches"] == [0, 0]
    assert "skirt_tpu_torch.engine.fused_poly" in res["modules"]
    assert "skirt_tpu_torch.kernels" in res["modules"]
    assert res["sed"] > 0 and res["labs"] > 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "run_img_sed.dat", "run_img_total.fits", "run_sed_sed.dat"]
