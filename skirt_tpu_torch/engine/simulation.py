"""Simulation drivers.

Twin of skirt_tpu/engine/simulation.py (OligoSimulation on one device).
ref: SKIRTcore/Simulation.cpp:18-74 (setupAndRun), MonteCarloSimulation.cpp
(runstellaremission, chunk policy :71-104), OligoMonteCarloSimulation.cpp
(stellar emission then write).

The (wavelength x chunk) task grid of the reference is a sequence of
launch batches with the wavelength index as a per-packet attribute;
tallies accumulate on the device in float32 within a dispatch (a group
of `dispatch_batches` batches) and on the host in float64 across
dispatches.  Batch b of phase p always runs with key
rng.event_key(root, p, b), grouped or not, so a phase resumes from a
checkpoint mid-stream and reproduces the uninterrupted run.
"""

from __future__ import annotations

import os
import time
from dataclasses import replace

import numpy as np
import torch

from .. import rng
from ..devices import resolve
from ..log import Log
from ..units import Units
from .lifecycle import (LifecycleOptions, make_lifecycle,
                        make_lifecycle_with_fallback, make_multibatch)


class OligoSimulation:
    """Oligochromatic Monte Carlo simulation: stellar emission only.

    ref: SKIRTcore/OligoMonteCarloSimulation.cpp:69-74.  Same keywords as
    skirt_tpu's, plus `device` (where the tallies and packets live: the
    card unless the caller passes another; without a CUDA device the
    default raises).  Tree grids are traced through their exact voxel
    view, as skirt_tpu does (`LifecycleOptions.voxelize`: None voxelizes
    exactly voxelizable grids, True any, False none; "table" also turns
    the gridded densities into table mode, which the fused table engines
    run); the returned absorption tallies fold back onto the leaf cells.
    A Voronoi grid's approximate voxel view is measured and refused above
    a 10% mass-weighted field error; with voxelize="table" the run then
    keeps the exact tessellation in table mode (the direct table).
    Not ported yet, and raising with the slice that ports them: use_mesh
    True or "slab" (S8), compaction_iterations > 0 (S2b), a gridded dust
    system left for the per-crossing walk (S2b), the write_convergence /
    write_density / write_depth_map / write_grid / write_cells_crossed
    diagnostics (S2b).  use_mesh=None
    means one device here (skirt_tpu shards over every local device)."""

    def __init__(self, *, stellar_system, instruments, dust_system=None,
                 packets: float = 1e6, seed: int = rng.DEFAULT_SEED,
                 options: LifecycleOptions | None = None,
                 batch_size: int = 1 << 17, log: Log | None = None,
                 units=None, out_dir: str = ".", prefix: str = "skirt_tpu",
                 write_convergence: bool = False, write_density: bool = False,
                 write_depth_map: bool = False, checkpoint_every: int = 0,
                 use_mesh: bool | str | None = None,
                 compaction_iterations: int = 0, dispatch_batches: int = 8,
                 write_grid: bool = False, write_cells_crossed: bool = False,
                 device="cuda"):
        self.device = resolve(device)
        self.options = options or LifecycleOptions()
        diagnostics = {"write_convergence": write_convergence,
                       "write_density": write_density,
                       "write_depth_map": write_depth_map,
                       "write_grid": write_grid,
                       "write_cells_crossed": write_cells_crossed}
        for name, on in diagnostics.items():
            if on:
                raise ValueError(f"OligoSimulation: {name} (media/outputs.py"
                                 ") is not ported yet (slice S2b)")
        if use_mesh:
            raise ValueError(f"OligoSimulation: use_mesh={use_mesh!r} "
                             "(multi-device engines) is not ported yet "
                             "(slice S8)")
        if int(compaction_iterations) > 0:
            raise ValueError("OligoSimulation: survivor compaction "
                             "(compaction_iterations > 0) is not ported yet "
                             "(slice S2b)")
        self.stellar_system = stellar_system
        self.instruments = list(instruments)
        self.log = log or Log()
        self.packets = int(packets)
        self.seed = seed
        self.batch_size = int(batch_size)
        self.units = units
        self.out_dir = out_dir
        self.prefix = prefix
        # checkpoint/resume: batches are deterministic per (seed, phase,
        # batch index), so a phase can resume mid-stream
        self.checkpoint_every = int(checkpoint_every)

        self.wavelength_grid = stellar_system.wavelength_grid
        self.nlambda = self.wavelength_grid.nlambda
        self.dust_system_out = dust_system   # original (leaf resolution)
        self.dust_system = self._voxelized(dust_system)
        self.grid = (self.dust_system.grid if self.dust_system is not None
                     else None)
        # a polarizing mix's Mueller tables go to the lifecycle (skirt_tpu
        # simulation.py:119)
        self._mueller = (self.dust_system.mueller
                         if self.dust_system is not None else None)
        self._build_main_lifecycle()
        # fold several launch batches into one dispatch; the tallies drain
        # to the host once per dispatch
        self.dispatch_batches = max(int(dispatch_batches), 1)

    # ------------------------------------------------------------------

    def _voxelized(self, dust_system):
        """The dust system the run traces (skirt_tpu simulation.py:74-109):
        a tree grid's exact voxel view, or a Voronoi grid's approximate one
        when its measured field error stays within 10% (else the exact
        tessellation), in table mode with voxelize='table'; sets the voxel
        -> cell fold of the labs."""
        self._labs_fold = None
        if dust_system is None:
            return None
        vox_opt = getattr(self.options, "voxelize", None)
        if vox_opt in (True, "table") or (
                vox_opt is not False
                and getattr(dust_system.grid, "voxelize_exact", False)):
            v = dust_system.voxelized(max_field_error=0.10, log=self.log)
            if v is not None:
                dust_system, self._labs_fold = v
                g = dust_system.grid
                self.log.info(f"Voxelized tree grid: {g.nx}x{g.ny}x{g.nz} "
                              "voxels over "
                              f"{self.dust_system_out.grid.ncells} leaf cells")
        if vox_opt == "table" and not dust_system.analytic:
            dust_system = dust_system.as_table()
            self.log.info("Table density mode: panel quadrature over the "
                          "gridded densities")
        if not dust_system.analytic:
            raise ValueError(
                "OligoSimulation: a gridded dust system runs the per-crossing "
                "gridded walk of the unfused lifecycle, not ported yet (slice "
                "S2b); voxelize='table' with fused=True runs the table "
                "engines")
        return dust_system

    def _fold_acc(self, acc):
        """Fold voxel-resolution absorption tallies back onto leaf cells
        (after the float64 drain; checkpoints keep the voxel tallies)."""
        if self._labs_fold is not None and "labs" in acc:
            acc["labs"] = self._labs_fold(acc["labs"])
        return acc

    def _build_main_lifecycle(self):
        """Build self._lifecycle, engaging polychromatic lanes when the
        options ask for them and the model qualifies, monochromatic
        batches otherwise (the batch shapes depend on which engine built,
        so the choice is made up front)."""
        self._poly = False
        if getattr(self.options, "polychromatic", False):
            try:
                self._lifecycle = make_lifecycle(
                    self.grid, self.dust_system, self.stellar_system,
                    self.instruments, self.options, self.nlambda,
                    mueller=self._mueller)
                self._poly = True
            except ValueError as e:
                self.log.info(f"polychromatic lanes unavailable ({e}); "
                              "monochromatic batches")
                self.options = replace(self.options, polychromatic=False)
        if not self._poly:
            self._lifecycle = make_lifecycle_with_fallback(
                self.grid, self.dust_system, self.stellar_system,
                self.instruments, self.options, self.nlambda, log=self.log,
                mueller=self._mueller)

    def _batches(self):
        """Yield (batch index, ell, L0) per launch batch.

        Every wavelength receives `packets` photon packets (ref:
        dostellaremissionchunk: L = luminosity(ell)/Npp).  Polychromatic
        engines get batch_size // nlambda LANES per batch, each carrying
        the full (nlambda,) launch row Lv/packets; monochromatic batches
        cycle the wavelength over the lanes.  With refill each lane
        launches refill_batches packets, so the final batch may overshoot
        `packets` by less than one lane's worth."""
        nl = self.nlambda
        dev = self.device
        per_batch = max(self.batch_size // nl, 1)
        Lv = np.asarray(self.stellar_system.Lv, np.float64)
        k = max(int(self.options.refill_batches), 1)
        nbatches = int(np.ceil(self.packets / (per_batch * k)))
        if self._poly:
            row = (Lv / self.packets).astype(np.float32)

            def make(count):
                return (torch.zeros(count, dtype=torch.int32, device=dev),
                        torch.as_tensor(np.broadcast_to(row, (count, nl))
                                        .copy(), device=dev))
        else:
            def make(count):
                ell = np.tile(np.arange(nl, dtype=np.int32), count)
                return (torch.as_tensor(ell, device=dev),
                        torch.as_tensor((Lv[ell] / self.packets)
                                        .astype(np.float32), device=dev))
        # one shared device buffer for every full batch
        ell_full, L0_full = make(per_batch)
        launched = 0
        for b in range(nbatches):
            count = min(per_batch, -(-(self.packets - launched) // k))
            if count < per_batch:
                yield (b, *make(count))
            else:
                yield b, ell_full, L0_full
            launched += count * k

    def _zero_tallies(self):
        t = {"instruments": [ins.zero_tallies(self.device)
                             for ins in self.instruments]}
        if self.options.store_absorption and self.dust_system is not None:
            t["labs"] = torch.zeros((self.grid.ncells * self.nlambda,),
                                    dtype=torch.float32, device=self.device)
        return t

    def run(self):
        """Run the stellar-emission phase and write results."""
        key = rng.root_key(self.seed)
        with self.log.timer("the stellar emission phase"):
            acc = self._run_phase(key, phase_tag=0)
        self.write(acc)
        return acc

    def _run_phase(self, key, phase_tag: int):
        """Run every batch of a phase; returns the float64 host tallies
        (raw, uncalibrated, in W; labs at leaf resolution)."""
        tallies = self._zero_tallies()
        acc = {"instruments": [
            {k: np.zeros(v.shape, np.float64) for k, v in t.items()}
            for t in tallies["instruments"]]}
        if "labs" in tallies:
            acc["labs"] = np.zeros(tallies["labs"].shape, np.float64)

        # resume from a phase checkpoint when present
        start_batch = 0
        ckpt_path = os.path.join(self.out_dir,
                                 f"{self.prefix}_phase{phase_tag}.ckpt.npz")
        if self.checkpoint_every and os.path.exists(ckpt_path):
            data = np.load(ckpt_path)
            start_batch = int(data["next_batch"])
            for i in range(len(self.instruments)):
                for k in acc["instruments"][i]:
                    acc["instruments"][i][k] = data[f"ins{i}_{k}"]
            if "labs" in acc:
                acc["labs"] = data["labs"]
            self.log.info(f"Resumed phase {phase_tag} from batch "
                          f"{start_batch}")

        t0 = time.perf_counter()
        total = 0
        batches = [bt for bt in self._batches() if bt[0] >= start_batch]
        key_p = rng.event_key(key, phase_tag)
        pos = 0
        while pos < len(batches):
            b, ell, L0 = batches[pos]
            K = self.dispatch_batches
            # group K consecutive same-shape batches into one dispatch
            # (the final batch may be ragged and runs singly); batch b's
            # key is fold_in(key_p, b) either way
            if (K > 1 and pos + K <= len(batches)
                    and batches[pos + K - 1][1].shape[0] == ell.shape[0]):
                run_many = make_multibatch(
                    self._lifecycle, K,
                    key_fn=lambda k, i, b0=b: rng.fold_in(k, b0 + i))
                tallies = run_many(key_p, ell, L0, tallies)
                nproc = K
            else:
                tallies = self._lifecycle(rng.fold_in(key_p, b), ell, L0,
                                          tallies)
                nproc = 1
            total += sum(batches[pos + j][1].shape[0] for j in range(nproc))
            # drain to the host in float64 and restart the device tallies
            for i, t in enumerate(tallies["instruments"]):
                for k, v in t.items():
                    acc["instruments"][i][k] += v.double().cpu().numpy()
            if "labs" in tallies:
                acc["labs"] += tallies["labs"].double().cpu().numpy()
            tallies = self._zero_tallies()
            dt = time.perf_counter() - t0
            self.log.info(f"Launched {total:,} photon packages "
                          f"({total / max(dt, 1e-9):,.0f} lanes/s)")
            bend = b + nproc
            if self.checkpoint_every and (
                    bend // self.checkpoint_every > b // self.checkpoint_every):
                self._save_checkpoint(ckpt_path, bend, acc)
            pos += nproc
        if self.checkpoint_every and os.path.exists(ckpt_path):
            os.remove(ckpt_path)  # phase complete
        return self._fold_acc(acc)

    def _save_checkpoint(self, path, next_batch, acc):
        os.makedirs(self.out_dir, exist_ok=True)
        payload = {"next_batch": next_batch}
        for i, t in enumerate(acc["instruments"]):
            for k, v in t.items():
                payload[f"ins{i}_{k}"] = v
        if "labs" in acc:
            payload["labs"] = acc["labs"]
        tmp = path + ".tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, path)

    def write(self, acc):
        """Write every instrument's calibrated SED table and FITS cube."""
        os.makedirs(self.out_dir, exist_ok=True)
        units = self.units
        if units is None:
            units = Units()
        for ins, a in zip(self.instruments, acc["instruments"]):
            ins.write(a, self.wavelength_grid, units, self.out_dir,
                      self.prefix)
        self.log.success("Wrote instrument outputs to " + self.out_dir)
