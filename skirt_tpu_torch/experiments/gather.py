"""PG: the table gather of the JAX package's Pallas gather probes.

`table_gather_plain` is the plain PyTorch version and `table_gather` the
wrapper of csrc/probe_gather.cu: out = tab[idx], or with steps > 0 the
chained form sum_{i < steps} tab[(idx + i) % T] of microbench_gather.py,
added in order of i.  CPU tensors take the plain version; CUDA tensors
launch the kernel (route "l2": the table read through the read-only
cache path; "smem": staged in each block's shared memory, T <= 32,768)
or raise.

The Pallas probes P1-P10 (VARIANTS) gather from one table through layouts
the TPU needed ((8, W) tiles, the table broadcast to the tile, 128-entry
chunks); on the card each is this one function on the same flat indices,
the output reshaped to the variant's shape.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels

ROUTES = ("l2", "smem")
MAX_SMEM_ENTRIES = 32768


def table_gather_plain(tab, idx, *, steps=0):
    """tab[idx] (steps = 0), or sum_{i < steps} tab[(idx + i) % T] in
    float32, in order of i."""
    if steps == 0:
        return tab[idx.long()]
    T = tab.shape[0]
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    for i in range(steps):
        acc = acc + tab[torch.remainder(idx + i, T).long()]
    return acc


def table_gather(tab, idx, *, steps=0, route="l2"):
    """The PG kernel on CUDA tensors (one launch, counted in
    `table_gather.launches`); the plain version on CPU tensors.  Indices
    must lie in [0, T): the kernel does not check them."""
    if route not in ROUTES:
        raise ValueError(f"table_gather: route {route!r}, not one of "
                         f"{ROUTES}")
    if tab.device.type == "cpu" and idx.device.type == "cpu":
        return table_gather_plain(tab, idx, steps=steps)
    if tab.device.type != "cuda" or idx.device != tab.device:
        raise ValueError(f"table_gather: tensors on {tab.device} and "
                         f"{idx.device}; the kernel takes one CUDA device")
    if tab.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError("table_gather kernel takes a float32 table and "
                        "int32 indices")
    if tab.dim() != 1 or not tab.is_contiguous():
        raise ValueError("table_gather: the table must be 1-D and "
                         "contiguous")
    T = tab.shape[0]
    if route == "smem" and T > MAX_SMEM_ENTRIES:
        raise ValueError(f"table_gather: {T} entries do not fit the smem "
                         f"route (at most {MAX_SMEM_ENTRIES})")
    if steps < 0:
        raise ValueError("table_gather: steps must be >= 0")
    idx = idx.contiguous()
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    kernels.check(kernels.library().skirt_probe_gather(
        tab.data_ptr(), T, idx.data_ptr(), out.data_ptr(), idx.numel(),
        steps, ROUTES.index(route), kernels.stream_of(tab)),
        "table_gather kernel")
    table_gather.launches += 1
    return out


table_gather.launches = 0


def tables_like_jax(T):
    """The probes' float32 table of T entries: default_rng(0).random(T),
    as every Pallas gather script builds its `tab_np` / `rho_np`.
    (microbench_gather.py draws its table and indices with jax.random;
    the port draws that table this way too.)"""
    return np.random.default_rng(0).random(T).astype(np.float32)


@dataclass(frozen=True)
class Variant:
    """One distinct call of the Pallas gather probes: its table size T,
    its index array's shape (indices uniform in [0, T)), for the chained
    form steps, and the Pallas variants (`pallas`, at the sites
    `replaces`) that gather the same number of elements from the same
    table, which on the card are this one call."""
    name: str
    pallas: tuple
    replaces: tuple
    T: int
    shape: tuple
    steps: int = 0


_G = "experiments/microbench_gather"
_PG = "experiments/microbench_pallas_gather"
_FLAT3 = (1 << 20, 88)

# P1-P10 at the JAX scripts' shapes
VARIANTS = (
    Variant("T=16384 2^17 x 64 chained", ("P1 pk", "P2 pk2"),
            (f"{_G}.py:101", f"{_G}.py:128"), 16384, (128, 1024), 64),
    Variant("T=16384 2^20 x 88", ("P3 take", "P7 build_c 8xT",
                                  "P7 build_c2 32xT"),
            (f"{_G}2.py:85", f"{_PG}2.py:60", f"{_PG}2.py:96"), 16384,
            _FLAT3),
    Variant("T=16384 2^27", ("P4 take_along_axis TN=8",
                             "P5 take_along_axis TN=128", "P6 take (1, T)"),
            (f"{_PG}.py:65", f"{_PG}.py:91", f"{_PG}.py:117"), 16384,
            (1 << 20, 128)),
    Variant("T=128 2^25", ("P8 W=128", "P9 raw_dg"),
            (f"{_PG}3.py:42", f"{_PG}4.py:45"), 128,
            ((1 << 25) // 128, 128)),
    Variant("T=256 2^25", ("P8 W=256",), (f"{_PG}3.py:42",), 256,
            ((1 << 25) // 256, 256)),
    Variant("T=512 2^25", ("P8 W=512",), (f"{_PG}3.py:42",), 512,
            ((1 << 25) // 512, 512)),
    Variant("T=16384 2^25", ("P10 full_table",), (f"{_PG}4.py:88",), 16384,
            ((1 << 25) // 128, 128)),
)
