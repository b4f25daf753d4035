"""Where the port's tensors live: on the card unless the caller says so.

The entry points (`OligoSimulation`, `convert.convert_simulation`, the
instruments' `zero_tallies`, the geometries' `generate_position`) default
to `"cuda"`.  Without a CUDA device they raise: a run never carries on
quietly on the CPU.  Pass `device="cpu"` to run there (the tests do).
"""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """`torch.device(device)`, refusing a CUDA device that is not there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: skirt_tpu_torch runs on the card by default; "
            "pass device='cpu' to run on the CPU")
    return dev
