"""Randomness for the lattice schemes: uniform mod q, ternary and CBD
noise for BFV; uniform 64-bit words, binary keys and rounded torus
Gaussians for TFHE; all drawn from an explicit generator.

Same distributions as `sunscreen_tpu/math/sampling.py`; the bits differ
(threefry there, the generator's own stream here), so tests that need
identical keys or ciphertexts inject the reference's values instead.
The integer samplers take a `torch.Generator`, whose samples are drawn
on its device and moved to `device`, or a `numpy.random.Generator`,
whose samples are drawn on the host and moved to `device`: the runtime's
keys (`fresh_key`, `key_from_seed`) are numpy generators, as a torch
generator's seed holds 64 bits. `torus_gaussian` takes a torch
generator only.
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from sunscreen_tpu_torch.math import modular as m

Rng = torch.Generator | np.random.Generator

CBD_WEIGHT = 21  # CBD(21): variance 21/2, sigma ~ 3.24 (SEAL sigma = 3.2)
_R62 = 1 << 62


def fresh_key() -> np.random.Generator:
    """A generator seeded with 128 bits of OS entropy (`secrets`): the
    runtime's randomness for keygen and encryption, as the reference's
    `fresh_key` carries 128 bits. Its PCG64 state holds all of them."""
    return np.random.default_rng(secrets.randbits(128))


def key_from_seed(seed: int | None) -> np.random.Generator:
    """seed=None -> `fresh_key()`; an int seed -> a deterministic
    generator (test-only, insecure), the same stream on every device."""
    return fresh_key() if seed is None else np.random.default_rng(seed)


def _draw(gen: Rng, high: int, shape, device):
    """Uniform int64 in [0, high) of `shape` on `device`."""
    if isinstance(gen, np.random.Generator):
        x = gen.integers(0, high, tuple(shape), dtype=np.int64)
        return torch.from_numpy(x).to(device)
    x = torch.randint(0, high, tuple(shape), generator=gen,
                      device=gen.device, dtype=torch.int64)
    return x.to(device)


def uniform_mod_q(gen: Rng, shape, base) -> torch.Tensor:
    """Uniform residues [..., k, N] in [0, q_i) per limb of `base` (an
    `rns.RnsBase`); `shape` excludes the limb axis. Two exact 62-bit
    draws make a 124-bit value, reduced mod q: statistical distance
    below 2^-94 from uniform."""
    full = tuple(shape[:-1]) + (base.k, shape[-1])
    q = base.q
    hi = _draw(gen, _R62, full, base.device) % q
    lo = _draw(gen, _R62, full, base.device) % q
    r62 = torch.tensor([_R62 % v for v in base.moduli], dtype=torch.int64,
                       device=q.device).reshape(-1, 1)
    return m.add_mod(base.mul(hi, r62), lo, q)


def ternary(gen: Rng, shape, device) -> torch.Tensor:
    """Uniform in {-1, 0, 1}, as int8."""
    return (_draw(gen, 3, shape, device) - 1).to(torch.int8)


def _popcount(x):
    """Population count of nonnegative int64 values below 2^32."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & 0xFFFFFFFF) >> 24


def cbd(gen: Rng, shape, device,
        weight: int = CBD_WEIGHT) -> torch.Tensor:
    """Centered binomial popcount(a) - popcount(b) over `weight` bits
    each: int32 in [-weight, weight], sigma = sqrt(weight / 2)."""
    a = _draw(gen, 1 << weight, shape, device)
    b = _draw(gen, 1 << weight, shape, device)
    return (_popcount(a) - _popcount(b)).to(torch.int32)


def uniform_u64(gen: Rng, shape, device) -> torch.Tensor:
    """Uniform 64-bit words as int64 bit patterns, from two 32-bit draws
    (the torus masks of TFHE)."""
    hi = _draw(gen, 1 << 32, shape, device)
    lo = _draw(gen, 1 << 32, shape, device)
    return (hi << 32) | lo


def binary(gen: Rng, shape, device) -> torch.Tensor:
    """Uniform bits {0, 1} as int64 (TFHE binary secret keys)."""
    return _draw(gen, 2, shape, device)


def torus_gaussian(gen: torch.Generator, shape, std: float,
                   device) -> torch.Tensor:
    """round(N(0, 1) * std * 2^64) as int64 torus words, drawn in
    float64 as the reference draws under x64."""
    e = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float64) * (std * 2.0 ** 64)
    return torch.round(e).to(torch.int64).to(device)


def signed_to_rns(x, q) -> torch.Tensor:
    """Small signed ints [..., N] (|x| < min q_i) -> residues
    [..., k, N] for the moduli column q [k, 1]."""
    return x.to(torch.int64).unsqueeze(-2) % q
