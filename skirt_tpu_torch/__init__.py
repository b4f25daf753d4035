"""skirt_tpu_torch — the PyTorch / CUDA port of skirt_tpu.

The JAX package `skirt_tpu` stays the reference; this package mirrors its
module paths (`skirt_tpu_torch.engine.fused_poly` is the twin of
`skirt_tpu.engine.fused_poly`) so each counterpart is easy to find.

Rules the port keeps:
- It imports `torch` and never `jax`.  A run imports no module of
  `skirt_tpu` at all (`constants` and `wavelengths` have twins here); only
  the result writers import the shared, JAX-free `skirt_tpu.io.fits` and
  `skirt_tpu.units`, when they write.
- Plain functions on tensors with an explicit `device=` and explicit
  random streams (`rng`); no autograd.
- Every TPU kernel on a ported path is a hand-written CUDA kernel under
  `csrc/`, built with nvcc at first use (`kernels.py`).  Beside each one
  lives its plain PyTorch version; a wrapper takes the plain version only
  for tensors on the CPU and launches the kernel (or raises) for CUDA
  tensors — there is no fallback.

Slice 1 ports the polychromatic analytic main path
(`engine.lifecycle.make_lifecycle` -> `engine.fused_poly`).
"""

__version__ = "0.1.0"
