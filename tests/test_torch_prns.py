"""The port's fused RNS ops (sunscreen_tpu_torch.math.prns) against the
JAX package's Pallas kernels (sunscreen_tpu.math.prns, interpret mode on
the CPU), bit for bit, on the inputs of tests/test_prns.py. On CPU
tensors each op runs its plain twin; chip_smoke.py holds the CUDA kernels
against the same twins on the card. Integer arithmetic: the tolerance is
zero."""

import jax  # noqa: F401  (conftest pins the CPU first)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunscreen_tpu.bfv import BfvParams as RefParams
from sunscreen_tpu.bfv import get_context as ref_context
from sunscreen_tpu.math import prns as rprns
from sunscreen_tpu_torch import _build
from sunscreen_tpu_torch.bfv import BfvParams, get_context, ops
from sunscreen_tpu_torch.math import prns


@pytest.fixture(scope="module")
def ctxs():
    ref = ref_context(RefParams.insecure(poly_degree=256, limbs=3,
                                         limb_bits=28))
    port = get_context(BfvParams.insecure(poly_degree=256, limbs=3,
                                          limb_bits=28), "cpu")
    assert port.mul_base.moduli == ref.mul_base.moduli
    assert port.key_mods == ref.key_mods
    return ref, port


def _rand(moduli, lead, n, rng):
    return np.stack([rng.integers(0, q, lead + (n,)) for q in moduli],
                    axis=-2).astype(np.uint32)


def _put(x, col, value, moduli):
    """Writes the integer `value` (CRT-decomposed) into column `col` of
    x [k, N]."""
    for i, q in enumerate(moduli):
        x[i, col] = value % q


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_convert_matches_reference(ctxs):
    """Extension Q -> Q∪B (include_src) and the bare conversion, on
    random residues plus the centered boundary: small +-values and the
    values within 3 of Q/2, whose sum sum_i y_i/q_i lies within 2^-80
    of a half."""
    ref, port = ctxs
    qb = port.q_base
    rng = np.random.default_rng(0)
    x = _rand(qb.moduli, (2,), port.n, rng)
    big_q = qb.product
    for col, v in enumerate([*range(-8, 9),
                             *range(big_q // 2 - 3, big_q // 2 + 4)]):
        _put(x[0], col, v, qb.moduli)
    want = np.asarray(rprns.fused_converter(ref.conv_q_to_aux)(
        jnp.asarray(x), include_src=True)).astype(np.int64)
    op = prns.fused_converter(port.conv_q_to_aux)
    np.testing.assert_array_equal(op(_t(x), include_src=True).numpy(), want)
    np.testing.assert_array_equal(op(_t(x)).numpy(), want[..., qb.k:, :])
    np.testing.assert_array_equal(
        port.conv_q_to_aux.extend(_t(x)).numpy(), want)
    np.testing.assert_array_equal(
        port.conv_q_to_aux.convert(_t(x), centered=True).numpy(),
        want[..., qb.k:, :])


def test_scale_convert_matches_reference(ctxs):
    """B7 on random tensor-base residues plus values x whose t x / Q
    lies next to a half-integer (the rounding of r)."""
    ref, port = ctxs
    mb = port.mul_base
    rng = np.random.default_rng(6)
    x = _rand(mb.moduli, (2,), port.n, rng)
    _half_integer_columns(x, port, 1)
    want = np.asarray(rprns.FusedScaleConvert(
        ref.scale_mul_to_aux, ref.conv_aux_to_q)(jnp.asarray(x)))
    got = prns.FusedScaleConvert(port.scale_mul_to_aux,
                                 port.conv_aux_to_q)(_t(x))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(ops._scale_convert(port, _t(x)).numpy(),
                                  want.astype(np.int64))


def _half_integer_columns(x, port, row):
    """Writes into row `row` of x values v whose t v / Q lies next to a
    half-integer, where the rounding of r flips."""
    mb, t, big_q = port.mul_base, port.t, port.q_base.product
    col = 0
    for h in (1, 3, 2 * t - 1):
        mid = h * big_q // (2 * t)
        for v in range(mid - 2, mid + 3):
            _put(x[row], col, v, mb.moduli)
            col += 1


def test_scaler_matches_reference(ctxs):
    """B9's twin and ScaleAndRound.apply against the reference's mode
    "scale" kernel, on random tensor-base residues plus half-integer
    boundaries of t x / Q and a column whose digits are all q_i - 1."""
    ref, port = ctxs
    mb = port.mul_base
    rng = np.random.default_rng(12)
    x = _rand(mb.moduli, (2,), port.n, rng)
    _half_integer_columns(x, port, 1)
    for i, (q, p) in enumerate(zip(mb.moduli, mb.punctured)):
        x[0, i, 0] = (q - 1) * (p % q) % q       # every y_i = q_i - 1
    want = np.asarray(rprns.fused_scaler(ref.scale_mul_to_aux)(
        jnp.asarray(x))).astype(np.int64)
    op = prns.fused_scaler(port.scale_mul_to_aux)
    assert op.mode == "scale"
    np.testing.assert_array_equal(op(_t(x)).numpy(), want)
    np.testing.assert_array_equal(
        port.scale_mul_to_aux.apply(_t(x)).numpy(), want)
    with pytest.raises(ValueError, match="include_src"):
        op(_t(x), include_src=True)


def test_tensor3_matches_reference(ctxs):
    """B10's twin against the reference's FusedTensor3, with residues at
    q - 1 in every component (the largest middle sum)."""
    ref, port = ctxs
    mb = port.mul_base
    rng = np.random.default_rng(13)
    a = _rand(mb.moduli, (2, 2), port.n, rng)
    b = _rand(mb.moduli, (2, 2), port.n, rng)
    top = np.array(mb.moduli, dtype=np.uint32)[:, None] - 1
    a[0, :, :, :3] = top[None, :, :]
    b[0, :, :, :3] = top[None, :, :]
    want = np.asarray(rprns.FusedTensor3(ref.mul_base.moduli)(
        jnp.asarray(a), jnp.asarray(b))).astype(np.int64)
    np.testing.assert_array_equal(
        prns.FusedTensor3(mb)(_t(a), _t(b)).numpy(), want)
    np.testing.assert_array_equal(
        port.fused_op("tensor3")(_t(a), _t(b)).numpy(), want)


def test_ks_inner_matches_reference(ctxs):
    """B11's twin against the reference's FusedKsInner at the context's
    kdig = k digits, including digits and keys all equal to q - 1."""
    ref, port = ctxs
    kb = port.key_base
    rng = np.random.default_rng(14)
    kdig = port.k
    d = _rand(kb.moduli, (2, kdig), port.n, rng)
    k0 = _rand(kb.moduli, (kdig,), port.n, rng)
    k1 = _rand(kb.moduli, (kdig,), port.n, rng)
    top = np.array(kb.moduli, dtype=np.uint32)[:, None] - 1
    d[1, :, :, :] = top
    k0[:, :, :4] = top
    k1[:, :, 2:6] = top
    want = np.asarray(rprns.FusedKsInner(ref.key_base.moduli)(
        jnp.asarray(d), jnp.asarray(k0), jnp.asarray(k1))).astype(np.int64)
    np.testing.assert_array_equal(
        prns.FusedKsInner(kb)(_t(d), _t(k0), _t(k1)).numpy(), want)
    np.testing.assert_array_equal(
        port.fused_op("ks_inner")(_t(d), _t(k0), _t(k1)).numpy(), want)


def test_mod_down_matches_reference(ctxs):
    ref, port = ctxs
    rng = np.random.default_rng(3)
    p = port.params.special_modulus
    x_q = _rand(port.q_base.moduli, (2,), port.n, rng)
    x_p = rng.integers(0, p, (2, port.n)).astype(np.uint32)
    want = np.asarray(rprns.fused_mod_down(ref.mod_down)(
        jnp.asarray(x_q), jnp.asarray(x_p))).astype(np.int64)
    got = prns.fused_mod_down(port.mod_down)(_t(x_q), _t(x_p))
    np.testing.assert_array_equal(got.numpy(), want)
    # the keyswitch's layout: both operands are views of one tensor
    both = torch.zeros(2, port.k + 1, port.n, dtype=torch.int64)
    both[:, :port.k] = _t(x_q)
    both[:, port.k] = _t(x_p)
    np.testing.assert_array_equal(
        port.mod_down.apply(both[:, :port.k], both[:, port.k]).numpy(), want)


def test_cpu_tensors_never_launch(ctxs):
    _, port = ctxs
    _build.reset_launches()
    rng = np.random.default_rng(5)
    x = _t(_rand(port.q_base.moduli, (1,), port.n, rng))
    ext = port.conv_q_to_aux.extend(x)
    ops._scale_convert(port, ext)
    port.scale_mul_to_aux.apply(ext)
    port.mod_down.apply(x, x[:, 0])
    pair = torch.stack([ext, ext], dim=-3)
    port.fused_op("tensor3")(pair, pair)
    key = torch.ones(port.k, port.k + 1, port.n, dtype=torch.int64)
    port.fused_op("ks_inner")(key.unsqueeze(0), key, key)
    assert all(v == 0 for v in _build.LAUNCHES.values())
    assert set(_build.LAUNCHES) >= {"convert", "scale_convert", "mod_down",
                                    "scale", "tensor3", "ks_inner"}


def test_other_devices_raise(ctxs):
    """A tensor on neither the CPU nor CUDA is refused, never computed
    by the plain twin."""
    _, port = ctxs
    x = torch.empty(1, port.k, port.n, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.conv_q_to_aux.convert(x)
    with pytest.raises(ValueError, match="unsupported device"):
        port.mod_down.apply(x, x[:, 0])
