"""The plain reference of the benchmark: one module per model family
(`expdisk.py`), each a straightforward Monte Carlo of the semantics its
configuration file states, written from that file alone.  Nothing here
imports the port, skirt_tpu, jax or the rest of rtbench
(test_rtbench_cpu.py checks so).

A configuration names its module by its `reference` key; check.py
imports rtbench.reference.<name> and calls

    simulate(cfg, ells, packets, seed, device, dtype=..., acc_dtype=...)

cfg        the configuration file's dict, as the run loaded it
ells       the compared wavelength indices (ints into the
           configuration's wavelength grid)
packets    photon packets to run at each of them
seed       a non-negative int below 2**63, the reference's own seed
device     where to run (a torch device or its name)
dtype      the precision of every quantity (the control passes
           torch.bfloat16; default torch.float32)
acc_dtype  the precision the tallies are summed in (default
           torch.float64; the control passes torch.bfloat16)

and takes back a dict of float64 NumPy arrays, raw tallies in W (the
luminosity that reached each bin, summed over packets, uncalibrated):

"sed"      one (len(ells),) array per instrument of cfg["instruments"],
           in their order
"frame"    per instrument, None for an SED, else (len(ells), ny, nx):
           rows along the frame's y axis, columns along its x axis
"labs"     (ncells, len(ells)): the energy absorbed in each of the
           reference's own cells
"centers"  (ncells, 3): each of those cells' centre (x, y, z) in kpc,
           row for row with "labs"

The reference's cells need not be the program's: check.py compares the
absorbed energy in the configuration's `labs_blocks`, blocks of space
into which each side puts each of its cells by its centre.
"""
