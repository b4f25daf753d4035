"""PM: the in-kernel matrix product of experiments/microbench_mxu_mm.py.

`mm_plain` is the plain PyTorch version and `mm` the wrapper of
csrc/probe_mm.cu: out = sum_{i < inner} A @ B in float32, the sum taken in
order.  A (M, K) and B (K, N) are both bf16 (TMA and wgmma on the tensor
cores) or both float32 (the kernel's own tile loop, outside the tensor
cores); M and N multiples of 64, K of 32.  `plan` picks the route and the
tile of C a block owns from the shape.  CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.

The Pallas body's `inner` chain perturbs A by acc[:, :K] * 1e-20 between
products, below one ulp of A at the seeded inputs
(tests/test_torch_probes.py asserts it), so it is `inner` sums of one
product.  The kernel and the plain version sum the K products in another
order than each other: `tolerance` is the bound they are held to.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels


def mm_plain(a, b, *, inner=1):
    """sum_{i < inner} a @ b in float32 (no TF32), in order."""
    p = a.float() @ b.float()
    acc = p
    for _ in range(1, inner):
        acc = acc + p
    return acc


def tolerance(a, b, inner=1):
    """Elementwise bound on |kernel - plain|: each of the two float32
    results lies within inner (K + inner) 2^-23 (|A| @ |B|) of the exact
    sum (K products and inner sums, each rounding by at most 2^-23 of its
    magnitude even under an accumulator that truncates); the bound is twice
    that."""
    K = a.shape[1]
    mag = a.abs().double() @ b.abs().double()
    return (2 * inner * (K + inner) * 2.0 ** -23 * mag).float()


# an H100 SXM's SMs: the plan's default card
SMS = 132


@dataclass(frozen=True)
class Plan:
    """The kernel's route ("wgmma" for bf16, "simt" for float32) and the
    bm x bn tile of C one block owns."""
    route: str
    bm: int
    bn: int


# the tiles each route takes, in the order ties go (64 x 128 first: one
# consumer warpgroup on the wide tile ran 1024^3 fastest,
# experiments/sweep_probe_routes.py)
TILES = {"wgmma": ((64, 128), (64, 64)), "simt": ((32, 64),)}


def plan(M, K, N, dtype, sms=SMS) -> Plan:
    """The route of the dtype and the tile that fills the card best: the
    least waves x tile area (the outputs the busiest SM computes), ties to
    the tile first in TILES.  bf16 tiles need not divide M or N (TMA fills the
    edge with zeros, the epilogue masks it); float32 tiles divide them."""
    if dtype == torch.bfloat16:
        route = "wgmma"
    elif dtype == torch.float32:
        route = "simt"
    else:
        raise TypeError("mm kernel takes two bf16 or two float32 matrices")

    def cost(tile):
        bm, bn = tile
        blocks = -(-M // bm) * -(-N // bn)
        return -(-blocks // sms) * bm * bn

    bm, bn = min(TILES[route], key=cost)
    return Plan(route, bm, bn)


def mm(a, b, *, inner=1):
    """The PM kernel on CUDA tensors (one launch on `plan`'s tile, counted
    in `mm.launches`); the plain version on CPU tensors."""
    if inner < 1:
        raise ValueError("mm: inner must be >= 1")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"mm: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mm_plain(a, b, inner=inner)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError("mm: the kernel takes tensors on one CUDA device")
    if a.dtype != b.dtype or a.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("mm kernel takes two bf16 or two float32 matrices")
    M, K = a.shape
    N = b.shape[1]
    if M % 64 or N % 64 or K % 32:
        raise ValueError(f"mm: M and N must be multiples of 64 and K of 32 "
                         f"({M}, {K}, {N})")
    return _mm_cuda(a, b, inner, torch.cuda.get_device_properties(
        a.device).multi_processor_count)


def _mm_cuda(a, b, inner, sms):
    """The launch: `plan`'s route and tile on a card of `sms` SMs, handed
    to the C entry point."""
    M, K = a.shape
    N = b.shape[1]
    p = plan(M, K, N, a.dtype, sms)
    a, b = kernels.aligned(a, 16), kernels.aligned(b, 16)
    out = torch.empty(M, N, dtype=torch.float32, device=a.device)
    kernels.check(kernels.library().skirt_probe_mm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N,
        int(p.route == "wgmma"), inner, p.bm, p.bn, kernels.stream_of(a)),
        "mm kernel")
    mm.launches += 1
    return out


mm.launches = 0


def tables_like_jax(M, K, N, dtype):
    """microbench_mxu_mm.py's inputs: a = default_rng(0).random((M, K)) -
    0.5 and b = default_rng(1).random((K, N)) - 0.5, cast from float64 to
    dtype (bf16 rounds to nearest even, as numpy's bfloat16 casts)."""
    a = np.random.default_rng(0).random((M, K)) - 0.5
    b = np.random.default_rng(1).random((K, N)) - 0.5
    return (torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype))


@dataclass(frozen=True)
class Shape:
    """One run(M, K, N, dt_in, G, inner) of microbench_mxu_mm.py."""
    M: int
    K: int
    N: int
    dtype: torch.dtype
    G: int = 4096
    inner: int = 1

    @property
    def name(self) -> str:
        dt = "bf16" if self.dtype == torch.bfloat16 else "f32"
        return (f"P15 ({self.M},{self.K})@({self.K},{self.N}) {dt} "
                f"inner={self.inner}")


REPLACES = "experiments/microbench_mxu_mm.py:34"

# microbench_mxu_mm.py:352-358, in its order
SHAPES = (
    Shape(128, 128, 128, torch.bfloat16),
    Shape(256, 128, 1024, torch.bfloat16, G=1024),
    Shape(128, 128, 128, torch.float32),
    Shape(256, 128, 1024, torch.float32, G=1024),
    Shape(128, 128, 128, torch.bfloat16, G=1024, inner=8),
    Shape(256, 128, 1024, torch.bfloat16, G=256, inner=8),
    Shape(512, 512, 512, torch.bfloat16, G=1024),
    Shape(1024, 1024, 1024, torch.bfloat16, G=512),
)
