"""The port's torus arithmetic and torus NTT plans (sunscreen_tpu_torch.tfhe
.torus / .poly) against the JAX package's, bit for bit, on the same
numpy inputs: full-range 64-bit words (bit 63 set included), the 62-bit
`TorusNttPlan` at k = 2 and 3, and the u32 `TorusNttPlanU32` (the
reference's Pallas plan in interpret mode) at N = 256 and 1024."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunscreen_tpu.tfhe import GlweDef as RefGlweDef
from sunscreen_tpu.tfhe import ops as rops
from sunscreen_tpu.tfhe import poly as rpoly
from sunscreen_tpu.tfhe import torus as rtorus
from sunscreen_tpu_torch.tfhe import GlweDef, ops, poly, torus

TOP = (1 << 64) - 1


def _t(a) -> torch.Tensor:
    """numpy uint64 / int -> int64 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(a))
    return torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64
                            else a.astype(np.int64))


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _words(rng, shape) -> np.ndarray:
    """Uniform u64 words with the edge values 0, 1, 2^63 - 1, 2^63 and
    2^64 - 1 at the front."""
    w = rng.integers(0, 1 << 64, shape, dtype=np.uint64).reshape(-1)
    w[:5] = [0, 1, (1 << 63) - 1, 1 << 63, TOP]
    return w.reshape(shape)


@pytest.mark.parametrize("radix_log, count", [(4, 3), (8, 8)])
def test_torus_ops_match_reference(radix_log, count):
    """encode, decode, signed_decompose and recompose; (8, 8) keeps all
    64 bits, so the rounding shift is 0."""
    rng = np.random.default_rng(radix_log)
    w = _words(rng, (4, 64))
    msgs = rng.integers(0, 16, (4, 64), dtype=np.uint64)
    np.testing.assert_array_equal(_u64(torus.encode(_t(msgs), 4)),
                                  np.asarray(rtorus.encode(msgs, 4)))
    for bits in (1, 2, 5):
        np.testing.assert_array_equal(
            _u64(torus.decode(_t(w), bits)),
            np.asarray(rtorus.decode(jnp.asarray(w), bits)))
    want = np.asarray(rtorus.signed_decompose(jnp.asarray(w), radix_log,
                                              count))
    got = torus.signed_decompose(_t(w), radix_log, count)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        _u64(torus.recompose(got, radix_log)),
        np.asarray(rtorus.recompose(jnp.asarray(want), radix_log)))


def test_mod_switch_and_monomial_mul():
    """_mod_switch_2n at log_v 0 and 2 on full-range words, and the
    negacyclic rotation by a per-row exponent in [0, 2N) against the
    reference rotating one row at a time."""
    rng = np.random.default_rng(3)
    n = 256
    w = _words(rng, (3, 40))
    for log_v in (0, 2):
        np.testing.assert_array_equal(
            ops._mod_switch_2n(_t(w), n, log_v).numpy(),
            np.asarray(rops._mod_switch_2n(jnp.asarray(w), n, log_v)))
    rows = _words(rng, (5, 2, n))
    e = np.array([0, 1, n - 1, n + 3, 2 * n - 1])
    got = _u64(poly.negacyclic_monomial_mul(_t(rows), _t(e), n))
    one = _u64(poly.negacyclic_monomial_mul(_t(rows[0, 0]), _t(e), n))
    for r in range(5):
        want = np.asarray(rpoly.negacyclic_monomial_mul(
            jnp.asarray(rows[r]), int(e[r]), n))
        np.testing.assert_array_equal(got[r], want)
        np.testing.assert_array_equal(
            one[r], np.asarray(rpoly.negacyclic_monomial_mul(
                jnp.asarray(rows[0, 0]), int(e[r]), n)))


def _centered_near_half(base, count: int) -> tuple[np.ndarray, list[int]]:
    """Residues [k, 2 count] of X = +-(C/2 - C/2^24 - j), j < count: near
    the largest magnitudes the reconstruction takes exactly (|X| < C/2
    (1 - 2^-27) for the u32 plan's 60-bit fixed point)."""
    c = base.product
    top = c // 2 - (c >> 24)
    xs = [top - j for j in range(count)] + [-(top - j) for j in range(count)]
    res = np.array([[x % q for x in xs] for q in base.moduli],
                   dtype=np.uint64)
    return res, [x % (1 << 64) for x in xs]


@pytest.mark.parametrize("k", [2, 3])
def test_torus_plan_matches_reference(k):
    """negacyclic_mul_signed_torus on full-range torus words, to_torus at
    +-(C/2 - j), and (k = 3) _glwe_mask_dot_sk with a uniform key, N=256."""
    n = 256
    rng = np.random.default_rng(10 + k)
    ref = rpoly.get_torus_plan(n, k)
    port = poly.get_torus_plan(n, k, device="cpu")
    assert port.base.moduli == ref.base.moduli
    digits = rng.integers(-128, 129, (2, n))
    tor = _words(rng, (2, n))
    res, want = _centered_near_half(port.base, 3)
    ref_mul, ref_tt = jax.jit(lambda d, t, r: (
        ref.negacyclic_mul_signed_torus(d, t), ref.to_torus(r)))(
        jnp.asarray(digits), jnp.asarray(tor), jnp.asarray(res))
    np.testing.assert_array_equal(
        _u64(port.negacyclic_mul_signed_torus(_t(digits), _t(tor))),
        np.asarray(ref_mul))
    got = _u64(port.to_torus(_t(res)))
    np.testing.assert_array_equal(got, np.array(want, dtype=np.uint64))
    np.testing.assert_array_equal(got, np.asarray(ref_tt))
    if k == 3:
        rglwe = RefGlweDef(2, n, 1e-16)
        sk = _words(rng, (2, n))
        masks = _words(rng, (3, 2, n))
        want = np.asarray(jax.jit(lambda a, s: rops._glwe_mask_dot_sk(
            a, s, rglwe))(jnp.asarray(masks), jnp.asarray(sk)))
        got = ops._glwe_mask_dot_sk(_t(masks), _t(sk), GlweDef(2, n, 1e-16))
        np.testing.assert_array_equal(_u64(got), want)


@pytest.mark.parametrize("n", [256, 1024])
def test_torus_plan_u32_matches_reference(n):
    """TorusNttPlanU32: torus_to_rns and fwd (B1's twin) of signed
    digits, contract_inv (B5's twin) against keys [6, 4, N], to_torus of
    the result and at +-(C/2 - j)."""
    rng = np.random.default_rng(n)
    ref = rpoly.get_torus_plan_u32(n)
    port = poly.get_torus_plan_u32(n, device="cpu")
    assert port.base.moduli == ref.base.moduli
    tor = _words(rng, (3, n))
    digits = rng.integers(-8, 9, (2, 6, n))
    keys = port.fwd(port.torus_to_rns(_t(_words(rng, (2, 6, n)))))
    k0, k1 = keys[0], keys[1]

    @jax.jit
    def reference(tor, digits, k0, k1):
        d_rns = ref.signed_to_rns(digits)
        d_hat = ref.fwd(d_rns)
        upd = ref.contract_inv(d_hat, k0, k1)
        return ref.torus_to_rns(tor), d_rns, d_hat, upd, ref.to_torus(upd)

    want = [np.asarray(v) for v in reference(
        jnp.asarray(tor), jnp.asarray(digits),
        jnp.asarray(k0.numpy().astype(np.uint32)),
        jnp.asarray(k1.numpy().astype(np.uint32)))]
    d_rns = port.signed_to_rns(_t(digits))
    d_hat = port.fwd(d_rns)
    upd = port.contract_inv(d_hat, k0, k1)
    for got, ref_v in zip((port.torus_to_rns(_t(tor)), d_rns, d_hat, upd),
                          want):
        np.testing.assert_array_equal(got.numpy(), ref_v.astype(np.int64))
    np.testing.assert_array_equal(_u64(port.to_torus(upd)), want[4])
    assert torch.equal(port.ks_full(d_rns, k0, k1), upd)
    res, want = _centered_near_half(port.base, 2)
    np.testing.assert_array_equal(_u64(port.to_torus(_t(res))),
                                  np.array(want, dtype=np.uint64))


def test_wrapping_sums_match_u64():
    """int64 products and sums wrap mod 2^64 exactly as the reference's
    uint64 arithmetic: the LWE phase with a uniform key, on operands
    near 2^63 and 2^64."""
    rng = np.random.default_rng(5)
    ct = _words(rng, (4, 65))
    ct[:, :8] = (1 << 63) + np.arange(8, dtype=np.uint64)
    sk = _words(rng, (64,))
    sk[:8] = TOP - np.arange(8, dtype=np.uint64)
    got = _u64(ops.decrypt_lwe_torus(_t(ct), _t(sk)))
    np.testing.assert_array_equal(got, np.asarray(rops.decrypt_lwe_torus(
        jnp.asarray(ct), jnp.asarray(sk))))
    for r in range(4):
        want = (int(ct[r, -1]) - sum(int(a) * int(s) for a, s in
                                     zip(ct[r, :-1], sk))) % (1 << 64)
        assert int(got[r]) == want
