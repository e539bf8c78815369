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
from sunscreen_tpu.math import rns as rrns
from sunscreen_tpu_torch import _build
from sunscreen_tpu_torch.bfv import BfvParams, get_context, ops
from sunscreen_tpu_torch.math import primes, prns, rns


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


@pytest.mark.parametrize("kdig", [16, 20])
def test_ks_inner_digit_sums(kdig):
    """At 16 and 20 digits, where the kernel folds its u64 sum, the twin
    against a python-int oracle; the first column has every digit and
    key at q - 1, the largest sum."""
    n = 16
    moduli = tuple(primes.gen_ntt_primes(30, 2, 256))
    op = prns.FusedKsInner(rns.RnsBase(moduli, "cpu"))
    rng = np.random.default_rng(kdig)
    d = _rand(moduli, (1, kdig), n, rng)
    k0 = _rand(moduli, (kdig,), n, rng)
    k1 = _rand(moduli, (kdig,), n, rng)
    top = np.array(moduli, dtype=np.uint32) - 1
    d[0, :, :, 0] = top
    k0[:, :, 0] = top
    k1[:, :, 0] = top
    got = op(_t(d), _t(k0), _t(k1)).numpy()
    for c, key in enumerate((k0, k1)):
        for j, q in enumerate(moduli):
            for col in range(n):
                want = sum(int(d[0, i, j, col]) * int(key[i, j, col])
                           for i in range(kdig)) % q
                assert got[0, c, j, col] == want, (c, j, col)


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


def _ref_base(moduli):
    return rrns.RnsBase(tuple(moduli))


def test_wide_bases_match_unfused_reference():
    """Bases past 16 source limbs, where the kernels fold their limb
    sums: a 20-limb conversion and the default_u32(16384) scale+convert
    (29-limb tensor base), against the reference's unfused rns.py."""
    rng = np.random.default_rng(11)
    n = 256
    src = tuple(primes.gen_ntt_primes(29, 20, n))
    dst = tuple(primes.gen_ntt_primes(30, 4, n, skip=src))
    conv = rns.BaseConverter(rns.RnsBase(src, "cpu"),
                             rns.RnsBase(dst, "cpu"))
    rconv = rrns.BaseConverter(_ref_base(src), _ref_base(dst))
    x = _rand(src, (1,), n, rng)
    x[0, :, 0] = 0
    x[0, :, 1] = np.array(src) - 1                  # -1, centered
    np.testing.assert_array_equal(
        prns.fused_converter(conv)(_t(x), include_src=True).numpy(),
        np.asarray(rconv.extend(jnp.asarray(x), centered=True)))

    params = BfvParams.default_u32(16384)
    qs = params.coeff_modulus
    skip = qs + (params.special_modulus,)
    aux = tuple(primes.gen_ntt_primes(30, 15, 16384, skip=skip))
    t = params.plain_modulus
    q_b, a_b = rns.RnsBase(qs, "cpu"), rns.RnsBase(aux, "cpu")
    m_b = rns.RnsBase(qs + aux, "cpu")
    op = prns.FusedScaleConvert(rns.ScaleAndRound(m_b, q_b, a_b, t),
                                rns.BaseConverter(a_b, q_b))
    assert (op.ks, op.km, op.kd) == (29, 15, 14)
    rq, ra = _ref_base(qs), _ref_base(aux)
    rsc = rrns.ScaleAndRound(_ref_base(qs + aux), rq, ra, t)
    x = _rand(qs + aux, (1,), n, rng)
    want = rrns.BaseConverter(ra, rq).convert(rsc.apply(jnp.asarray(x)),
                                              centered=True)
    np.testing.assert_array_equal(op(_t(x)).numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("params", [
    BfvParams.insecure_u32(1024, limbs=17),
    BfvParams.default_u32(32768)], ids=["35_limbs", "59_limbs"])
def test_scale_past_32_limbs_matches_unfused_reference(params):
    """B7's and B9's twins past 32 tensor-base limbs (the kernels'
    <64, 32> and <64>): insecure_u32(1024, limbs=17)'s 35 and
    default_u32(32768)'s 59, on random residues, a column whose digits
    are all q_i - 1 and values whose t x / Q lies next to a
    half-integer, against the reference's unfused rns.py scale and
    centered conversion."""
    port = get_context(params, "cpu", "pallas_vpu")
    qs, aux = port.q_base.moduli, port.aux_base.moduli
    mb = port.mul_base
    assert mb.k == 2 * len(qs) + 1 > prns.MAX_CONVERT_LIMBS
    rq, ra = _ref_base(qs), _ref_base(aux)
    rsc = rrns.ScaleAndRound(_ref_base(mb.moduli), rq, ra, port.t)
    x = _rand(mb.moduli, (2,), 256, np.random.default_rng(mb.k))
    _half_integer_columns(x, port, 1)
    for i, (q, p) in enumerate(zip(mb.moduli, mb.punctured)):
        x[0, i, 0] = (q - 1) * (p % q) % q       # every y_i = q_i - 1
    scaled = rsc.apply(jnp.asarray(x))
    op = prns.fused_scaler(port.scale_mul_to_aux)
    np.testing.assert_array_equal(op(_t(x)).numpy(),
                                  np.asarray(scaled).astype(np.int64))
    want = rrns.BaseConverter(ra, rq).convert(scaled, centered=True)
    sc = port.fused_op("scale_convert")
    assert (sc.ks, sc.km, sc.kd) == (mb.k, len(aux), len(qs))
    np.testing.assert_array_equal(sc(_t(x)).numpy(),
                                  np.asarray(want).astype(np.int64))


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


def test_strided_rows():
    """The mod-down kernel's input: evenly strided rows are read in
    place, anything else is copied to a contiguous tensor first."""
    k, n = 3, 16
    both = torch.arange(4 * 2 * (k + 1) * n).reshape(4, 2, k + 1, n)
    xq, sq = prns._strided_rows(both[..., :k, :], 2)
    assert xq.data_ptr() == both.data_ptr() and sq == (k + 1) * n
    xp, sp = prns._strided_rows(both[..., k, :], 1)
    assert xp.data_ptr() == both[..., k, :].data_ptr() and sp == (k + 1) * n
    flat, s = prns._strided_rows(torch.zeros(5, k, n), 2)
    assert s == k * n
    swapped = both[..., :k, :].transpose(0, 1)      # rows no longer even
    copy, s = prns._strided_rows(swapped, 2)
    assert copy.is_contiguous() and s == k * n
    assert torch.equal(copy, swapped)
    t_inner = torch.zeros(2, n, k).transpose(-1, -2)  # limbs not N apart
    copy, s = prns._strided_rows(t_inner, 2)
    assert copy.is_contiguous() and s == k * n
