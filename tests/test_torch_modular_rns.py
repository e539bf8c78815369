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
from sunscreen_tpu.math import rns as rrns
from sunscreen_tpu_torch.math import modular as pm
from sunscreen_tpu_torch.math import rns as prns

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


@pytest.mark.parametrize("add_half", [False, True])
def test_fixed_point_dot(add_half):
    """phi words are full 64-bit, y full 30-bit: every column carries."""
    rng = np.random.default_rng(3)
    k = 7
    y = rng.integers(0, 1 << 30, (2, k, N), dtype=np.uint64)
    y[0, :, :8] = (1 << 30) - 1
    ph, pl = _u64(rng, k), _u64(rng, k)
    ph[0] = pl[0] = np.uint64((1 << 64) - 1)
    (wi_h, wi_l), (wf_h, wf_l) = rrns.fixed_point_dot(
        jnp.asarray(y), jnp.asarray(ph), jnp.asarray(pl), add_half)
    (gi_h, gi_l), (gf_h, gf_l) = prns.fixed_point_dot(
        _t(y), _t(ph).reshape(k, 1), _t(pl).reshape(k, 1), add_half)
    for got, want in ((gi_h, wi_h), (gi_l, wi_l), (gf_h, wf_h),
                      (gf_l, wf_l)):
        np.testing.assert_array_equal(got.numpy(), _np(want))


def _bases(k):
    qs = tuple(rprimes.gen_ntt_primes(27, k, N))
    aux = tuple(rprimes.gen_ntt_primes(30, k + 1, N, skip=qs))
    return qs, aux


def _residues(rng, moduli, lead):
    return np.stack([rng.integers(0, q, lead + (N,)) for q in moduli],
                    axis=-2).astype(np.uint32)


@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("centered", [False, True])
def test_base_converter(k, centered):
    rng = np.random.default_rng(10 * k + centered)
    qs, aux = _bases(k)
    ref = rrns.BaseConverter(rrns.RnsBase(qs), rrns.RnsBase(aux))
    port = prns.BaseConverter(prns.RnsBase(qs, "cpu"),
                              prns.RnsBase(aux, "cpu"))
    x = _residues(rng, qs, (2,))
    x[0, :, :4] = 0                    # small values at both ends
    x[1, :, :4] = np.array(qs, np.uint32)[:, None] - 1
    np.testing.assert_array_equal(
        port.convert(_t(x), centered=centered).numpy(),
        _np(ref.convert(jnp.asarray(x), centered=centered)))
    np.testing.assert_array_equal(
        port.extend(_t(x), centered=centered).numpy(),
        _np(ref.extend(jnp.asarray(x), centered=centered)))


@pytest.mark.parametrize("k", [3, 7])
def test_scale_and_round(k):
    rng = np.random.default_rng(20 + k)
    qs, aux = _bases(k)
    t = 65537
    ref = rrns.ScaleAndRound(rrns.RnsBase(qs + aux), rrns.RnsBase(qs),
                             rrns.RnsBase(aux), t)
    port = prns.ScaleAndRound(prns.RnsBase(qs + aux, "cpu"),
                              prns.RnsBase(qs, "cpu"),
                              prns.RnsBase(aux, "cpu"), t)
    x = _residues(rng, qs + aux, (2,))
    np.testing.assert_array_equal(port.apply(_t(x)).numpy(),
                                  _np(ref.apply(jnp.asarray(x))))


@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("t", [17, 1032193])
def test_decrypt_scaler(k, t):
    rng = np.random.default_rng(30 + k)
    qs, _ = _bases(k)
    ref = rrns.DecryptScaler(rrns.RnsBase(qs), t)
    port = prns.DecryptScaler(prns.RnsBase(qs, "cpu"), t)
    x = _residues(rng, qs, (2,))
    want, (wf_h, wf_l) = ref.apply(jnp.asarray(x))
    got, (gf_h, gf_l) = port.apply(_t(x))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_array_equal(gf_h.numpy(), _np(wf_h))
    np.testing.assert_array_equal(gf_l.numpy(), _np(wf_l))


@pytest.mark.parametrize("k", [3, 7])
def test_mod_down(k):
    rng = np.random.default_rng(40 + k)
    qs, aux = _bases(k)
    p = aux[0]
    ref = rrns.ModDown(rrns.RnsBase(qs), p)
    port = prns.ModDown(prns.RnsBase(qs, "cpu"), p)
    x = _residues(rng, qs, (2,))
    xp = rng.integers(0, p, (2, N)).astype(np.uint32)
    np.testing.assert_array_equal(
        port.apply(_t(x), _t(xp)).numpy(),
        _np(ref.apply(jnp.asarray(x), jnp.asarray(xp))))
