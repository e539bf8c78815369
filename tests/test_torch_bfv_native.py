"""The port's own BFV round trips on the CPU: encrypt, `multiply_relin` and
rotations under its own keys against numpy oracles, and the plain-glue
setting as a no-op."""

import numpy as np
import pytest
import torch

from sunscreen_tpu_torch.bfv import BfvParams, get_context, keys, ops


def test_plain_glue_setting_is_a_no_op_on_cpu(monkeypatch):
    monkeypatch.setenv("SUNSCREEN_TPU_FUSED_RNS", "0")
    assert ops.multiply_route(512, 2, 2, "cpu") == "fwd_tensor3"
    assert ops.keyswitch_route("cpu") == "inv_ks"
    assert ops.scale_convert_route("cpu") == "scale_convert"


def _negacyclic_square(a, t):
    conv = np.convolve(a, a)
    n = a.shape[0]
    res = conv[:n].copy()
    res[:n - 1] -= conv[n:]
    return np.mod(res, t)


def test_native_roundtrip():
    """Port-native keys and randomness from a torch generator: encrypt,
    multiply_relin and decrypt a batch against the numpy oracle."""
    ctx = get_context(BfvParams.insecure_u32(512, limbs=3, limb_bits=27),
                      "cpu")
    gen = torch.Generator().manual_seed(7)
    sk = keys.gen_secret_key(ctx, gen)
    pk = keys.gen_public_key(ctx, sk, gen)
    rlk = keys.gen_relin_key(ctx, sk, gen)
    pts = torch.randint(0, ctx.t, (2, ctx.n), generator=gen)
    cts = ops.encrypt(ctx, pk, pts, gen)
    assert torch.equal(ops.decrypt(ctx, sk, cts), pts)
    assert torch.equal(ops.decrypt(ctx, sk, ops.add(ctx, cts, cts)),
                       2 * pts % ctx.t)
    prod = ops.multiply_relin(ctx, cts, cts, rlk)
    dec = ops.decrypt(ctx, sk, prod).numpy()
    for r in range(2):
        np.testing.assert_array_equal(
            dec[r], _negacyclic_square(pts[r].numpy(), ctx.t))
    assert np.all(ops.invariant_noise_budget(ctx, sk, prod) > 0)


def _automorphism(ctx, pts, g):
    """a(x) -> a(x^g) mod (x^N + 1, t) on plaintext rows, in numpy."""
    n, t = ctx.n, ctx.t
    out = np.zeros_like(pts)
    for i in range(n):
        j = i * g % (2 * n)
        if j < n:
            out[..., j] = (out[..., j] + pts[..., i]) % t
        else:
            out[..., j - n] = (out[..., j - n] - pts[..., i]) % t
    return out


def test_native_rotation_roundtrip():
    """Port-native Galois keys from a torch generator: rotate, decrypt,
    and compare with the automorphism of the plaintext; a rotation by 3
    slots is composed from the keys for 1 and 2."""
    ctx = get_context(BfvParams.insecure_u32(512, limbs=3, limb_bits=27),
                      "cpu")
    gen = torch.Generator().manual_seed(11)
    sk = keys.gen_secret_key(ctx, gen)
    pk = keys.gen_public_key(ctx, sk, gen)
    g1, g2 = ctx.rotate_rows_element(1), ctx.rotate_rows_element(2)
    gc = ctx.rotate_columns_element
    gks = keys.gen_galois_keys(ctx, sk, gen, (g1, g2, gc))
    pts = torch.randint(0, ctx.t, (2, ctx.n), generator=gen)
    cts = ops.encrypt(ctx, pk, pts, gen)
    p = pts.numpy()
    for got, g in ((ops.rotate_rows(ctx, cts, 1, gks), g1),
                   (ops.rotate_columns(ctx, cts, gks), gc),
                   (ops.rotate_rows(ctx, cts, 3, gks),
                    ctx.rotate_rows_element(3))):
        np.testing.assert_array_equal(ops.decrypt(ctx, sk, got).numpy(),
                                      _automorphism(ctx, p, g))
    assert ops.rotate_rows(ctx, cts, ctx.n // 2, gks) is cts
    with pytest.raises(KeyError, match="rotation 4"):
        ops.rotate_rows(ctx, cts, 4, gks)
