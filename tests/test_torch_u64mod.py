"""The port's u64 modular arithmetic against the JAX package, bit for bit:
the u64 word section of `math/modular.py` and the word-generic `w_*`
wrappers, kernel B18 (`math/pallas_mod.py`: `shoup_mul_mod`, `mul_mod`)
and kernel B19 (`math/pallas_kernels.py`: `make_pointwise_mul_mod`), each
through its plain twin on the CPU against the reference's Pallas kernel
in interpret mode (as tests/test_pallas_mod.py and tests/test_pallas.py
run them) and a python big-int oracle. Inputs come from numpy with fixed
seeds; the tolerance is exact equality (integer arithmetic)."""

import jax  # noqa: F401  (conftest pins the CPU first)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunscreen_tpu.math import modular as rm
from sunscreen_tpu.math import pallas_kernels as rpk
from sunscreen_tpu.math import pallas_mod as rpm
from sunscreen_tpu.math import primes as rprimes
from sunscreen_tpu_torch import _build
from sunscreen_tpu_torch.math import modular as m
from sunscreen_tpu_torch.math import pallas_kernels as pk
from sunscreen_tpu_torch.math import pallas_mod as pm

# tests/test_pallas_mod.py's moduli: 2^31 - 1, 2^50 - 27, 2^56 - 5 and a
# modulus just under 2^62
MODULI = ((1 << 50) - 27, (1 << 31) - 1, (1 << 56) - 5, 0x3FFFFFFFFFFFFFE3)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _oracle(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    return (a.astype(object) * b.astype(object)) % q


def _sh(w: np.ndarray, q: int) -> np.ndarray:
    return ((w.astype(object) << 64) // q).astype(np.uint64)


def test_word_section_matches_reference():
    """Host constants, word selection and every w_* wrapper in both
    words, against `sunscreen_tpu.math.modular`."""
    rng = np.random.default_rng(1)
    for q in (rprimes.gen_ntt_primes(29, 1, 256)[0],
              rprimes.gen_ntt_primes(54, 1, 256)[0], MODULI[3]):
        rword = rm.word_dtype_for((q,))
        word = m.word_dtype_for((q,))
        assert word == (m.U32 if rword == rm.U32 else m.U64)
        wnp = np.uint32 if word == m.U32 else np.uint64
        c0, c1 = m.w_consts_host(q, word)
        assert (c0, c1) == tuple(rm.w_consts_host(q, rword))
        a = rng.integers(0, q, (3, 64), dtype=np.uint64)
        b = rng.integers(0, q, (3, 64), dtype=np.uint64)
        x = rng.integers(0, 2 * q, (3, 64), dtype=np.uint64)
        w = int(b[0, 0])
        assert m.w_shoup_host(w, q, word) == rm.w_shoup_host(w, q, rword)
        assert m.shoup_ratio(w, q) == rm.shoup_ratio(w, q)
        assert m.inv_mod_host(w, q) == rm.inv_mod_host(w, q)
        assert m.pow_mod_host(w, 12345, q) == rm.pow_mod_host(w, 12345, q)
        w_sh = m.w_shoup_host(w, q, word)
        rq, ja, jb, jx = (wnp(q), jnp.asarray(a.astype(wnp)),
                          jnp.asarray(b.astype(wnp)),
                          jnp.asarray(x.astype(wnp)))
        got = m.w_mul_mod(_t(a), _t(b), q, m.s64(c0), m.s64(c1), word)
        np.testing.assert_array_equal(_u(got), np.asarray(rm.w_mul_mod(
            ja, jb, rq, wnp(c0), wnp(c1))).astype(np.uint64))
        got = m.w_shoup_mul(_t(x), w, m.s64(w_sh), q, word)
        np.testing.assert_array_equal(_u(got), np.asarray(rm.w_shoup_mul(
            jx, wnp(w), wnp(w_sh), rq)).astype(np.uint64))
        if word == m.U64:
            raw = rng.integers(0, 1 << 64, (4, 64), dtype=np.uint64)
            got = m.w_reduce(_t(raw), q, m.s64(c0), m.s64(c1), word)
            np.testing.assert_array_equal(_u(got), np.asarray(rm.w_reduce(
                jnp.asarray(raw), rq, wnp(c0), wnp(c1))))
            np.testing.assert_array_equal(
                _u(m.mul_mod_shoup(_t(x), w, m.s64(w_sh), q)),
                np.asarray(rm.mul_mod_shoup(jx, np.uint64(w),
                                            np.uint64(w_sh), rq)))
        got = m.w_sum_reduce(_t(a), q, m.s64(c0), m.s64(c1), word, axis=0)
        np.testing.assert_array_equal(_u(got), np.asarray(rm.w_sum_reduce(
            ja, rq, wnp(c0), wnp(c1), axis=0)).astype(np.uint64))


@pytest.mark.parametrize("entry", ["shoup_mul_mod", "mul_mod"])
def test_b18_matches_reference(entry):
    """B18's twin against the reference's Pallas kernel (interpret mode)
    and the big-int oracle over the four moduli, full tables, then the
    lazy [0, 2q) input and broadcast tables."""
    rng = np.random.default_rng(0xA11A5)
    for q in MODULI:
        a = rng.integers(0, q, (4, 256), dtype=np.uint64)
        b = rng.integers(0, q, (4, 256), dtype=np.uint64)
        if entry == "shoup_mul_mod":
            want = np.asarray(rpm.shoup_mul_mod(
                jnp.asarray(a), jnp.asarray(b), jnp.asarray(_sh(b, q)), q))
            got = pm.shoup_mul_mod(_t(a), _t(b), _t(_sh(b, q)), q)
        else:
            want = np.asarray(rpm.mul_mod(jnp.asarray(a), jnp.asarray(b), q))
            got = pm.mul_mod(_t(a), _t(b), q)
        np.testing.assert_array_equal(_u(got), want)
        np.testing.assert_array_equal(_u(got).astype(object),
                                      _oracle(a, b, q))
    q = MODULI[0]
    x = rng.integers(0, 2 * q if entry == "shoup_mul_mod" else q,
                     (3, 2, 128), dtype=np.uint64)
    w = rng.integers(0, q, (2, 128), dtype=np.uint64)
    if entry == "shoup_mul_mod":
        want = np.asarray(rpm.shoup_mul_mod(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(_sh(w, q)), q))
        got = pm.shoup_mul_mod(_t(x), _t(w), _t(_sh(w, q)), q)
    else:
        want = np.asarray(rpm.mul_mod(jnp.asarray(x), jnp.asarray(w), q))
        got = pm.mul_mod(_t(x), _t(w), q)
    np.testing.assert_array_equal(_u(got), want)
    np.testing.assert_array_equal(_u(got).astype(object),
                                  _oracle(x, w[None], q))
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_b18_edges():
    """The largest inputs each entry takes: x = 2q - 1, w = q - 1,
    a = b = q - 1, and 0, under every modulus."""
    for q in MODULI:
        x = np.array([[2 * q - 1, q, q - 1, 0, 1]], dtype=np.uint64)
        w = np.array([[q - 1, q - 1, q - 1, q - 1, 0]], dtype=np.uint64)
        got = pm.shoup_mul_mod(_t(x), _t(w), _t(_sh(w, q)), q)
        np.testing.assert_array_equal(_u(got).astype(object),
                                      _oracle(x, w, q))
        a = np.array([[q - 1, q - 1, 0, 1, q - 2]], dtype=np.uint64)
        got = pm.mul_mod(_t(a), _t(a), q)
        np.testing.assert_array_equal(_u(got).astype(object),
                                      _oracle(a, a, q))
        np.testing.assert_array_equal(_u(got), np.asarray(
            rpm.mul_mod(jnp.asarray(a), jnp.asarray(a), q)))


@pytest.mark.parametrize("bits,seed", [(50, 0), (61, 1)])
def test_b19_matches_reference(bits, seed):
    """make_pointwise_mul_mod on halves against the reference's kernel in
    interpret mode, at tests/test_pallas.py's 50- and 61-bit primes."""
    q = rprimes.gen_ntt_primes(bits, 1, 128)[0]
    rng = np.random.default_rng(seed)
    a = rng.integers(0, q, (8, 128), dtype=np.uint64)
    b = rng.integers(0, q, (8, 128), dtype=np.uint64)
    a[0, :2] = b[0, :2] = q - 1
    rfn = rpk.make_pointwise_mul_mod(q, interpret=True)
    want = np.asarray(rpk.join_u64(*rfn(*rpk.split_u64(jnp.asarray(a)),
                                        *rpk.split_u64(jnp.asarray(b)))))
    fn = pk.make_pointwise_mul_mod(q, device="cpu")
    hi, lo = fn(*pk.split_u64(_t(a)), *pk.split_u64(_t(b)))
    np.testing.assert_array_equal(_u(pk.join_u64(hi, lo)), want)
    np.testing.assert_array_equal(_u(pk.join_u64(hi, lo)).astype(object),
                                  _oracle(a, b, q))
    assert (hi >= 0).all() and (hi < 1 << 32).all() and (lo < 1 << 32).all()


def test_split_join_round_trips():
    """split64/join64 (lo, hi) and split_u64/join_u64 (hi, lo) as the
    reference's halves."""
    x = np.random.default_rng(5).integers(0, 1 << 64, (5, 64),
                                          dtype=np.uint64)
    lo, hi = pm.split64(_t(x))
    rlo, rhi = rpm.split64(jnp.asarray(x))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(rlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(rhi))
    np.testing.assert_array_equal(_u(pm.join64(lo, hi)), x)
    hi, lo = pk.split_u64(_t(x))
    rhi, rlo = rpk.split_u64(jnp.asarray(x))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(rhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(rlo))
    np.testing.assert_array_equal(_u(pk.join_u64(hi, lo)), x)


def test_wrappers_refuse_bad_input(monkeypatch):
    """No card: the B19 factory defaults to CUDA and raises; halves on
    another device or of other shapes, and tables that do not broadcast,
    raise before any launch."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        pk.make_pointwise_mul_mod(MODULI[0])
    fn = pk.make_pointwise_mul_mod(MODULI[0], device="cpu")
    z = torch.zeros(2, 8, dtype=torch.int64)
    with pytest.raises(ValueError, match="halves"):
        fn(z, z, z, z[:1])
    with pytest.raises(ValueError, match="broadcast"):
        pm._operands(z, torch.zeros(3, 8, dtype=torch.int64))
    sizes, strides = pm._layout(
        (3, 2, 8), z.new_zeros(3, 2, 8), z.new_zeros(2, 8).expand(3, 2, 8))
    assert sizes.tolist() == [1, 1, 3, 2]
    assert strides.tolist() == [[0, 0, 16, 8, 1], [0, 0, 0, 8, 1]]
