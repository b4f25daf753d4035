"""Counter-based random streams with a fixed seeding discipline.

Twin of skirt_tpu/rng.py.  A key is a plain 64-bit integer: the user seed
defines the root key and every (phase, batch, event) tag folds into it
with a splitmix64 hash, on the host and without touching the device.  A
key seeds a `torch.Generator` only where numbers are drawn (Philox on
CUDA, mt19937 on the CPU), so runs are reproducible for any batch
schedule.  The streams differ from JAX's threefry streams: tests that
compare the two frameworks feed both the same numpy-made inputs, and
end-to-end runs are compared at Monte Carlo tolerance.
"""

from __future__ import annotations

import math

import torch

DEFAULT_SEED = 4357  # ref: SKIRTcore/Random.cpp:21

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def root_key(seed: int = DEFAULT_SEED) -> int:
    return _splitmix64(int(seed) & _MASK64)


def fold_in(key: int, tag: int) -> int:
    """Derive a subkey from one integer tag."""
    return _splitmix64(int(key) ^ _splitmix64(int(tag) & _MASK64))


def event_key(key: int, *tags: int) -> int:
    """Derive a subkey by folding in a sequence of integer tags."""
    for t in tags:
        key = fold_in(key, t)
    return key


def split(key: int, num: int = 2) -> list[int]:
    """`num` independent subkeys (a tag namespace apart from fold_in's)."""
    return [fold_in(key, (1 << 40) + i) for i in range(num)]


def generator(key: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(key) & ((1 << 63) - 1))
    return g


def uniform(key: int, shape, device, dtype=torch.float32):
    """Uniform deviates in [0, 1)."""
    return torch.rand(shape, generator=generator(key, device), device=device,
                      dtype=dtype)


def uniform_open(key: int, shape, device, dtype=torch.float32):
    """Uniform deviate in the open interval (0,1): never exactly 0 or 1.

    The reference's uniform() also excludes 0 and 1 (ref: SKIRTcore/Random.cpp).
    """
    tiny = 1e-7 if dtype == torch.float32 else 1e-15
    return uniform(key, shape, device, dtype).clamp_(tiny, 1.0 - tiny)


def isotropic_direction(key: int, shape, device, dtype=torch.float32):
    """Isotropic unit vectors, shape (*shape, 3).

    ref: SKIRTcore/Random.cpp Random::direction().
    """
    k1, k2 = split(key)
    costheta = uniform(k1, shape, device, dtype) * 2.0 - 1.0
    phi = uniform(k2, shape, device, dtype) * (2.0 * math.pi)
    sintheta = torch.sqrt(torch.clamp(1.0 - costheta * costheta, min=0.0))
    return torch.stack([sintheta * torch.cos(phi), sintheta * torch.sin(phi),
                        costheta], dim=-1)


def expon_cutoff(u, taumax):
    """Sample optical depth from an exponential truncated at taumax.

    tau = -ln(1 - u*(1-exp(-taumax))), the forced-scattering sampler
    (ref: SKIRTcore/Random.cpp:163-175 exponcutoff).  For tiny taumax the
    distribution degenerates to uniform*taumax, matching the reference.
    """
    small = taumax < 1e-6
    tau = -torch.log1p(-u * (-torch.expm1(-taumax)))
    return torch.where(small, u * taumax, torch.minimum(tau, taumax))
