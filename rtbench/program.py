"""The system under test, driven as a user drives it: one
`OligoSimulation` built from a cell's files, its `run()` called again
and again, each call with a fresh seed derived from the run's seed."""

import hashlib
import time

import numpy as np

from .builders import load as builder, sub


def call_seed(seed: int, index: int) -> int:
    """The seed of run() call `index` (0 is the warm-up) of a run."""
    h = hashlib.sha256(f"rtbench:{int(seed)}:{int(index)}".encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def packets_per_run(cell: dict, cfg: dict) -> int:
    """Photon packets per run() as SKIRT counts them: packets per
    wavelength x wavelengths (lanes x K x W on poly lanes, lanes x K on
    mono lanes, which cycle the wavelengths)."""
    return cfg["wavelengths"]["count"] * per_wavelength(cell, cfg)


def per_wavelength(cell: dict, cfg: dict) -> int:
    lanes = max(cell["batch_size"] // cfg["wavelengths"]["count"], 1)
    return cell["batches_per_run"] * lanes * cell["refill_batches"]


def build(cell: dict, cfg: dict, pkg, device, out_dir: str):
    """(OligoSimulation of `pkg`, host build seconds) for a cell: the
    model from its configuration's builder, then the simulation (its
    lifecycle).  Refuses a simulation that would not run the cell's
    lanes or batches."""
    t0 = time.perf_counter()
    model, _ = builder(cfg["builder"]).build(
        cfg, pkg, cell["polychromatic"], cell["refill_batches"])
    log = sub(pkg, "log").SilentLog()
    sim = sub(pkg, "engine.simulation").OligoSimulation(
        stellar_system=model["stellar_system"],
        instruments=model["instruments"], dust_system=model["dust_system"],
        packets=per_wavelength(cell, cfg), seed=0, options=model["options"],
        batch_size=cell["batch_size"], log=log, out_dir=out_dir,
        prefix=cell["name"], dispatch_batches=cell["dispatch_batches"],
        device=device)
    host_s = time.perf_counter() - t0
    if bool(sim._poly) != bool(cell["polychromatic"]):
        raise RuntimeError(f"{cell['name']}: the simulation chose "
                           f"polychromatic={sim._poly}, the cell asks for "
                           f"{cell['polychromatic']}")
    nb = sum(1 for _ in sim._batches())
    if nb != cell["batches_per_run"]:
        raise RuntimeError(f"{cell['name']}: {nb} batches a run(), the "
                           f"cell asks for {cell['batches_per_run']}")
    return sim, host_s


def cell_centers_kpc(sim, pkg) -> np.ndarray:
    """(ncells, 3) float64 centres in kpc of the cells that the labs rows
    of run() belong to: the cells of the dust system's grid as built
    (a voxel view's labs are folded back onto them)."""
    KPC = sub(pkg, "constants").KPC
    return np.asarray(sim.dust_system_out.grid.cell_centers(),
                      np.float64) / KPC


def run_once(sim, seed: int):
    """One run() with this seed: the float64 host tallies it returns
    (it has drained, folded and written them)."""
    sim.seed = seed
    return sim.run()
