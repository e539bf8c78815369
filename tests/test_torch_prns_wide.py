"""The port's fused RNS twins at their edges: keyswitch inner products at
16 and 20 digits, bases past 32 limbs against the reference's unfused
glue, and strided rows (the helpers of test_torch_prns.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunscreen_tpu.math import rns as rrns
from sunscreen_tpu_torch.bfv import BfvParams, get_context
from sunscreen_tpu_torch.math import primes, prns, rns
from test_torch_prns import _half_integer_columns, _rand, _t


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
