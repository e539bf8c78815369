"""csrc/rns.cu's four entry points (B6-B9) built with g++ against the host
stand-in for the CUDA runtime and held bit for bit against their twins at
7, 14, 17 and 29 limbs (the build and helpers of
test_torch_csrc_host_ks_rns.py)."""

import copy
import itertools

import numpy as np
import pytest
import torch

from sunscreen_tpu_torch.bfv import BfvParams, get_context
from sunscreen_tpu_torch.math import prns, rns
from test_torch_csrc_host_ks_rns import (_convert_input, _np, _p,
                                         _tensor_input, host)


@pytest.mark.parametrize("limbs", [7, 14, 17, 29])
def test_rns_kernels_match_twins(host, limbs):
    """scale_convert (B7), rns_scale (B9), rns_convert (B6: q -> aux,
    aux -> q and, while it has at most 32 limbs, the tensor base -> q,
    with and without the source copy, centered and not) and mod_down (B8)
    at the bases of `limbs` 30-bit limbs: ks = 2 limbs + 1 tensor-base
    limbs (15 as default_u32(8192)'s, 29 as default_u32(16384)'s, 59 as
    default_u32(32768)'s)."""
    lib = host["rns"]
    ctx = get_context(BfvParams.insecure(poly_degree=256, limbs=limbs,
                                         limb_bits=30), "cpu")
    n = ctx.n
    rng = np.random.default_rng(limbs)
    x = _tensor_input(ctx, rng)
    rows = x.shape[0] * x.shape[1]
    xt = torch.from_numpy(x)

    # and with every omega_ij at b_j - 1: a limb sum of 29 terms at the
    # all-(q_i - 1) column passes 2^64 unless folded
    top = copy.copy(ctx.scale_mul_to_aux)
    top.omega = torch.broadcast_to(top.dst.q - 1, top.omega.shape)
    for sc in (ctx.fused_op("scale_convert"),
               prns.FusedScaleConvert(top, ctx.conv_aux_to_q)):
        assert sc.ks == 2 * limbs + 1
        out = np.empty((2, 3, sc.kd, n), dtype=np.int64)
        assert lib.scale_convert(
            _p(x), _p(out), *map(_p, map(_np, (sc.a_tab, sc.b_tab, sc.d_tab,
                                               sc.omega, sc.theta))),
            rows, sc.ks, sc.km, sc.kd, n, None) == 0
        np.testing.assert_array_equal(out, sc.call_plain(xt).numpy())

    # rns_scale (B9) on the same columns, with every omega_ij at b_j - 1
    # too, and on 7 rows: two blocks of rows (4 a block), 4 and 3 each
    x7 = np.ascontiguousarray(
        _tensor_input(ctx, rng, rows=3).reshape(9, -1, n)[:7])
    for op in (ctx.scale_mul_to_aux, top):
        scaler = prns.FusedRnsOp(op, "scale")
        assert (scaler.ks, scaler.kd) == (2 * limbs + 1, limbs + 1)
        for xs in (x, x7):
            out = np.empty((*xs.shape[:-2], scaler.kd, n), dtype=np.int64)
            assert lib.rns_scale(
                _p(xs), _p(out), _p(_np(scaler.src_tab)),
                _p(_np(scaler.dst_tab)), _p(_np(scaler.mat)),
                out.size // (scaler.kd * n), scaler.ks, scaler.kd, n,
                None) == 0
            want = scaler.call_plain(torch.from_numpy(xs))
            np.testing.assert_array_equal(out, want.numpy())

    # rns_convert (B6): q -> aux, aux -> q and, through the <32>
    # instantiation (ks > 16 at 14 limbs), the tensor base -> q with every
    # theta_ij at d_j - 1, each with and without the source copy, centered
    # and not
    convs = [ctx.conv_q_to_aux, ctx.conv_aux_to_q]
    if ctx.mul_base.k <= prns.MAX_CONVERT_LIMBS:
        wide = copy.copy(rns.BaseConverter(ctx.mul_base, ctx.q_base))
        wide.theta = torch.broadcast_to(ctx.q_base.q - 1, wide.theta.shape)
        convs.append(wide)
    for conv in convs:
        op = prns.fused_converter(conv)
        xs = _convert_input(conv.src, rng)
        xt = torch.from_numpy(xs)
        for include_src, centered in itertools.product((0, 1), (0, 1)):
            out = np.empty((2, 3, op.kd + include_src * op.ks, n),
                           dtype=np.int64)
            assert lib.rns_convert(
                _p(xs), _p(out), _p(_np(op.src_tab)), _p(_np(op.dst_tab)),
                _p(_np(op.mat)), rows, op.ks, op.kd, n, centered,
                include_src, None) == 0
            want = op.call_plain(xt, bool(include_src), bool(centered))
            np.testing.assert_array_equal(out, want.numpy())

    md = prns.fused_mod_down(ctx.mod_down)
    kb = ctx.key_base.q.numpy()
    both = rng.integers(0, 1 << 62, (rows, md.k + 1, n)) % kb
    both[0] = kb - 1
    xq = np.ascontiguousarray(both[:, :md.k])
    xp = np.ascontiguousarray(both[:, md.k])
    out = np.empty((rows, md.k, n), dtype=np.int64)
    assert lib.mod_down(_p(xq), _p(xp), _p(out), _p(_np(md.tab)), rows,
                        md.k, n, md.k * n, n, md.p, md.half, None) == 0
    want = md.call_plain(torch.from_numpy(xq), torch.from_numpy(xp))
    np.testing.assert_array_equal(out, want.numpy())
