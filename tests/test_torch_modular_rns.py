"""The port's modular and RNS arithmetic (sunscreen_tpu_torch.math.modular
and .rns) against the JAX package, bit for bit, on the same numpy-seeded
inputs. Integer arithmetic: the tolerance is zero."""

import jax  # noqa: F401  (conftest pins the CPU first)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunscreen_tpu.math import modular as rm
from sunscreen_tpu.math import primes as rprimes
from sunscreen_tpu_torch.math import modular as pm

N = 512


def _t(a) -> torch.Tensor:
    """numpy uint32/uint64 -> int64 tensor with the same bits."""
    a = np.asarray(a)
    if a.dtype == np.uint64:
        return torch.from_numpy(a.view(np.int64).copy())
    return torch.from_numpy(a.astype(np.int64))


def _np(x) -> np.ndarray:
    """reference output -> int64 numpy with the same bits."""
    a = np.asarray(x)
    return a.view(np.int64) if a.dtype == np.uint64 else a.astype(np.int64)


def _u64(rng, shape):
    return rng.integers(0, 1 << 64, shape, dtype=np.uint64)


def test_mul_wide_full_range():
    rng = np.random.default_rng(1)
    a, b = _u64(rng, 4096), _u64(rng, 4096)
    a[:4] = b[:4] = np.uint64((1 << 64) - 1)
    rh, rl = rm.mul_wide(jnp.asarray(a), jnp.asarray(b))
    ph, pl = pm.mul_wide(_t(a), _t(b))
    np.testing.assert_array_equal(ph.numpy(), _np(rh))
    np.testing.assert_array_equal(pl.numpy(), _np(rl))


@pytest.mark.parametrize("bits", [20, 30, 45, 61])
def test_barrett_reduce_128_full_range(bits):
    """Full-range 64-bit words: carries past 2^63 need unsigned compares."""
    rng = np.random.default_rng(bits)
    q = rprimes.gen_ntt_primes(bits, 1, 256)[0]
    rh, rl = rm.barrett_ratio(q)
    lo = _u64(rng, 4096)
    hi = rng.integers(0, q, 4096, dtype=np.uint64)
    want = rm.barrett_reduce_128(jnp.asarray(hi), jnp.asarray(lo),
                                 jnp.uint64(q), jnp.uint64(rh),
                                 jnp.uint64(rl))
    got = pm.barrett_reduce_128(_t(hi), _t(lo), q, pm.s64(rh), pm.s64(rl))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    got64 = pm.barrett_reduce_64(_t(lo), q, pm.s64(rh), pm.s64(rl))
    np.testing.assert_array_equal(got64.numpy(),
                                  (lo % np.uint64(q)).astype(np.int64))
    a = rng.integers(0, q, 4096, dtype=np.uint64)
    b = rng.integers(0, q, 4096, dtype=np.uint64)
    want = rm.mul_mod(jnp.asarray(a), jnp.asarray(b), jnp.uint64(q),
                      jnp.uint64(rh), jnp.uint64(rl))
    got = pm.mul_mod(_t(a), _t(b), q, pm.s64(rh), pm.s64(rl))
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("bits", [17, 24, 30])
def test_u32_engine_helpers(bits):
    rng = np.random.default_rng(100 + bits)
    q = rprimes.gen_ntt_primes(bits, 1, 256)[0]
    mu, s1 = rm.barrett32_consts(q)
    assert pm.barrett32_consts(q) == (mu, s1)
    w = int(rng.integers(0, q))
    wsh = rm.shoup_ratio32(w, q)
    assert pm.shoup_ratio32(w, q) == wsh
    x = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    q32 = jnp.uint32(q)
    want = rm.mul_mod_shoup32(jnp.asarray(x), jnp.uint32(w),
                              jnp.uint32(wsh), q32)
    got = pm.mul_mod_shoup32(_t(x), w, wsh, q)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    a = rng.integers(0, q, 4096, dtype=np.uint32)
    b = rng.integers(0, q, 4096, dtype=np.uint32)
    want = rm.mul_mod32(jnp.asarray(a), jnp.asarray(b), q32, mu, s1)
    got = pm.mul_mod32(_t(a), _t(b), q, mu, s1)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_array_equal(
        got.numpy(), (a.astype(np.int64) * b.astype(np.int64)) % q)
    for name in ("add_mod", "sub_mod"):
        want = getattr(rm, name)(jnp.asarray(a), jnp.asarray(b), q32)
        got = getattr(pm, name)(_t(a), _t(b), q)
        np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_array_equal(pm.neg_mod(_t(a), q).numpy(),
                                  _np(rm.neg_mod(jnp.asarray(a), q32)))


def _bases(k):
    qs = tuple(rprimes.gen_ntt_primes(27, k, N))
    aux = tuple(rprimes.gen_ntt_primes(30, k + 1, N, skip=qs))
    return qs, aux


def _residues(rng, moduli, lead):
    return np.stack([rng.integers(0, q, lead + (N,)) for q in moduli],
                    axis=-2).astype(np.uint32)
