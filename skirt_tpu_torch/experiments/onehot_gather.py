"""PO: the one-hot tensor-core gather of the JAX package's MXU probes.

`onehot_gather_plain` is the plain PyTorch version and `onehot_gather` the
wrapper of csrc/probe_onehot_gather.cu.  CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.

The table: T = 128 x 256 = 32,768 float32 entries tab[hi * 256 + lo], held
as tabT (256 lo rows, 128 hi columns) in bf16 (`tab_hi`) and, for the
f32-exact split, `tab_lo` = bf16(tabT - tab_hi).  Indices: (rows, 128)
int32 in [0, T), rows a multiple of 8; group s is rows 8s..8s+7, and its
element (j, l) is column 128 j + l of the group's one-hot product
R = tab_hi @ onehot(hi) (256 x 1,024).  The stages write what the Pallas
variants write (see csrc/probe_onehot_gather.cu):
  "full"     out[8s + j, l] = tab_hi[lo, hi] (+ tab_lo[lo, hi])
  "onehot"   out[8s + h, l] = sum_{j in js} [hi(8s + j, l) == h], h < 8
  "matmul"   out[8s + r, l] = sum_{j in js} tab_hi[r, hi(8s + j, l)], r < 8
  "fixed_B"  out[8s + r, l] = sum_{j in js} A[r, 128 j + l], r < 8, every
             group alike, A = sum_{m < nmm} tab_hi @ bfix
Sums over js run in the order given, from the first term.  Every non-zero
product has one 1 from the one-hot, so the kernel is bit-identical to this
plain version.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels

T = 32768
STAGES = ("onehot", "matmul", "fixed_B", "full")


def _terms(js, term):
    out = term(js[0])
    for j in js[1:]:
        out = out + term(j)
    return out


def onehot_gather_plain(tab_hi, idx, *, stage="full", tab_lo=None,
                        bfix=None, js=(), nmm=1):
    """The stage's output (module docstring), float32 (rows, 128)."""
    rows = idx.shape[0]
    g = idx.reshape(rows // 8, 8, 128).long()
    hi, lo = g >> 8, g & 255
    th = tab_hi.float()
    if stage == "full":
        out = th[lo, hi]
        if tab_lo is not None:
            out = out + tab_lo.float()[lo, hi]
    elif stage == "onehot":
        h = torch.arange(8, device=idx.device).view(1, 8, 1)
        out = _terms(js, lambda j: (hi[:, j:j + 1, :] == h).float())
    elif stage == "matmul":
        # th[r, hi(8s + j, l)] for r < 8: (8, groups, 128) -> (groups, 8, 128)
        out = _terms(js, lambda j: th[:8][:, hi[:, j, :]].permute(1, 0, 2))
    elif stage == "fixed_B":
        R = th @ bfix.float()
        acc = _terms(range(nmm), lambda m: R)
        out = _terms(js, lambda j: acc[:8, 128 * j:128 * (j + 1)])
        out = out.expand(rows // 8, 8, 128)
    else:
        raise ValueError(f"onehot_gather: stage {stage!r}, not one of "
                         f"{STAGES}")
    return out.reshape(rows, 128).contiguous()


def onehot_gather(tab_hi, idx, *, stage="full", tab_lo=None, bfix=None,
                  js=(), nmm=1):
    """The PO kernel on CUDA tensors (one launch, counted in
    `onehot_gather.launches`); the plain version on CPU tensors.  Indices
    must lie in [0, T): the kernel does not check them."""
    if stage not in STAGES:
        raise ValueError(f"onehot_gather: stage {stage!r}, not one of "
                         f"{STAGES}")
    if stage in ("onehot", "matmul", "fixed_B") and (
            not js or any(not 0 <= j < 8 for j in js)):
        raise ValueError(f"onehot_gather: stage {stage!r} needs js in 0..7")
    if stage == "fixed_B" and (bfix is None or nmm < 1):
        raise ValueError("onehot_gather: fixed_B needs bfix and nmm >= 1")
    if tab_lo is not None and stage != "full":
        raise ValueError("onehot_gather: the split table is for 'full' only")
    if idx.dim() != 2 or idx.shape[1] != 128 or idx.shape[0] % 8:
        raise ValueError(f"onehot_gather: indices of shape "
                         f"{tuple(idx.shape)}, not (8k, 128)")
    tensors = [t for t in (tab_hi, tab_lo, bfix, idx) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return onehot_gather_plain(tab_hi, idx, stage=stage, tab_lo=tab_lo,
                                   bfix=bfix, js=js, nmm=nmm)
    if tab_hi.device.type != "cuda" or any(t.device != tab_hi.device
                                           for t in tensors):
        raise ValueError("onehot_gather: the kernel takes tensors on one "
                         "CUDA device")
    if idx.dtype != torch.int32 or any(
            t.dtype != torch.bfloat16 for t in (tab_hi, tab_lo, bfix)
            if t is not None):
        raise TypeError("onehot_gather kernel takes bf16 tables and int32 "
                        "indices")
    for name, t, shape in (("tab_hi", tab_hi, (256, 128)),
                           ("tab_lo", tab_lo, (256, 128)),
                           ("bfix", bfix, (128, 1024))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"onehot_gather: {name} must be {shape}")
    # the kernel reads the tables and the indices in pairs
    tab_hi, idx = kernels.aligned(tab_hi, 4), kernels.aligned(idx, 8)
    if tab_lo is not None:
        tab_lo = kernels.aligned(tab_lo, 4)
    if bfix is not None:
        bfix = bfix.contiguous()
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    jmask = sum(1 << j for j in js)
    kernels.check(kernels.library().skirt_probe_onehot_gather(
        tab_hi.data_ptr(), None if tab_lo is None else tab_lo.data_ptr(),
        None if bfix is None else bfix.data_ptr(), idx.data_ptr(),
        out.data_ptr(), idx.shape[0], STAGES.index(stage), jmask, nmm,
        kernels.stream_of(idx)), "onehot_gather kernel")
    onehot_gather.launches += 1
    return out


onehot_gather.launches = 0


def tables_like_jax():
    """The MXU scripts' numpy inputs: tab = default_rng(0).random(T) * 3.0
    + 0.5 (float32), tabT = tab.reshape(128, 256).T, its bf16 hi / lo
    split (round to nearest even, as numpy's bfloat16 casts), and the fixed
    B = default_rng(1).random((128, 1024)) < 0.01; the bf16 arrays as the
    float32 values they hold."""
    tab = np.random.default_rng(0).random(T).astype(np.float32) * 3.0 + 0.5
    tabT = tab.reshape(128, 256).T.copy()
    hi = torch.from_numpy(tabT).to(torch.bfloat16).float()
    lo = (torch.from_numpy(tabT) - hi).to(torch.bfloat16).float()
    bfix = (np.random.default_rng(1).random((128, 1024)) < 0.01)
    return {"tab": tab, "tabT": tabT, "tab_hi": hi.numpy(),
            "tab_lo": lo.numpy(), "bfix": bfix.astype(np.float32)}


@dataclass(frozen=True)
class Variant:
    """One distinct call of the Pallas MXU-gather probes: its stage and
    arguments, and the Pallas variants (`pallas`, at the sites `replaces`)
    whose output it computes.  Variants that differ only in a TPU schedule
    (group8, unroll, the one-hot builds) are one call on the card."""
    name: str
    pallas: tuple
    replaces: tuple
    stage: str
    split: bool = False
    js: tuple = ()
    nmm: int = 1


_M = "experiments/microbench_mxu_gather"
NFLAT = 1 << 23

# P11-P14 at the JAX scripts' size, 2^23 elements
VARIANTS = (
    Variant("full", ("P11 split=False group8=True",
                     "P11 split=False group8=False", "P12 select",
                     "P13 full_slice"),
            (f"{_M}.py:62", f"{_M}2.py:48", f"{_M}3.py:55"), "full"),
    Variant("full split", ("P11 split=True group8=True",
                           "P11 split=True group8=False"),
            (f"{_M}.py:62",), "full", True),
    Variant("onehot js=0,1", ("P12 onehot",), (f"{_M}2.py:48",), "onehot",
            js=(0, 1)),
    Variant("matmul js=0,1,2,7", ("P12 matmul",), (f"{_M}2.py:48",),
            "matmul", js=(0, 1, 2, 7)),
    Variant("fixed_B js=0,1,7", ("P13 mm_pure",), (f"{_M}3.py:55",),
            "fixed_B", js=(0, 1, 7)),
    Variant("onehot js=0-7", ("P13 oh_slice", "P13 oh_bidim",
                              "P13 oh_mxu"), (f"{_M}3.py:55",), "onehot",
            js=tuple(range(8))),
    Variant("fixed_B js=0,7", ("P14 kern_unroll1_mm1",
                               "P14 kern_unroll4_mm1"), (f"{_M}4.py:91",),
            "fixed_B", js=(0, 7)),
    Variant("fixed_B js=0,7 nmm=4", ("P14 kern_unroll1_mm4",
                                     "P14 kern_unroll4_mm4"),
            (f"{_M}4.py:91",), "fixed_B", js=(0, 7), nmm=4),
)


def variant(pallas_name):
    """The distinct call that computes a Pallas variant's output."""
    v, = [v for v in VARIANTS if pallas_name in v.pallas]
    return v


def onehot_flops(v, rows):
    """Tensor-core flop of the one-hot formulation as the Pallas kernels
    run it: the (256, 128) @ (128, 1024) product of every group (twice
    with the split, nmm times with fixed B); none for the one-hot stage."""
    if v.stage == "onehot":
        return 0
    per_group = 2 * 256 * 128 * 1024
    return rows // 8 * per_group * (2 if v.split else v.nmm)


def kept_flops(v, rows):
    """Flop of what a stage's output keeps: the 8-row products (8 x 128
    by 128 x 128 for each j in js) of every group for "matmul", once for
    "fixed_B" (its output is alike in every group), nmm times; one add
    per term and element otherwise (the split's hi + lo, the one-hot
    sums)."""
    elems = rows * 128
    if v.stage in ("matmul", "fixed_B"):
        groups = rows // 8 if v.stage == "matmul" else 1
        return groups * 2 * 8 * 128 * 128 * len(v.js) * v.nmm
    if v.stage == "onehot":
        return elems * len(v.js)
    return elems if v.split else 0
