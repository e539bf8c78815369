"""The port's BFV slice (keygen, encrypt, multiply_relin, rotations,
decrypt, noise budget) against the JAX package and its frozen u32 golden
vectors, bit for bit. The reference's relinearization and Galois keys are
built exactly as tests/test_golden_u32.py builds them, in its "pallas"
NTT mode, and carried over with `keys.from_reference` and
`keys.galois_from_reference`."""

import os

import jax
import numpy as np
import pytest
import torch

from sunscreen_tpu_torch.bfv import BfvParams, get_context, keys, ops
from sunscreen_tpu_torch.errors import InvalidArgument

FIXTURE = os.path.join(os.path.dirname(__file__), "golden_u32_v1.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURE)


@pytest.fixture(scope="module")
def reference():
    """The reference's params, secret key, relin and Galois keys under
    the pallas NTT mode (env var set only inside this fixture), plus its
    Galois tables."""
    prev = os.environ.get("SUNSCREEN_TPU_NTT")
    os.environ["SUNSCREEN_TPU_NTT"] = "pallas"
    try:
        from sunscreen_tpu.bfv import BfvParams as RefParams
        from sunscreen_tpu.bfv import get_context as ref_context
        from sunscreen_tpu.bfv import keys as ref_keys

        params = RefParams.insecure(512, limbs=3, limb_bits=27)
        ctx = ref_context(params)
        assert ctx.plan_q.mode == "pallas", ctx.plan_q.mode
        key = jax.random.key(1000)
        sk = ref_keys.gen_secret_key(ctx, jax.random.fold_in(key, 0))
        rlk = ref_keys.gen_relin_key(ctx, sk, jax.random.fold_in(key, 2))
        elements = (ctx.rotate_rows_element(1), ctx.rotate_columns_element)
        gks = ref_keys.gen_galois_keys(ctx, sk, jax.random.fold_in(key, 3),
                                       elements)
        ref = {name: np.asarray(v) for name, v in (
            ("s", sk.s), ("s_ntt_q", sk.s_ntt_q),
            ("s_ntt_key", sk.s_ntt_key), ("k0", rlk.k0), ("k1", rlk.k1))}
        ref["galois"] = {g: (np.asarray(gks[g].k0), np.asarray(gks[g].k1))
                         for g in elements}
        ref["galois_tables"] = {g: ctx.galois_table_host(g)
                                for g in (*elements, 3 ** 5 % 1024)}
        ref["default_elements"] = ref_keys.default_rotation_elements(ctx)
        yield params, ref
    finally:
        if prev is None:
            os.environ.pop("SUNSCREEN_TPU_NTT", None)
        else:
            os.environ["SUNSCREEN_TPU_NTT"] = prev


@pytest.fixture(scope="module")
def port(golden, reference):
    """The port's context and the reference's keys carried over."""
    ctx = get_context(BfvParams.insecure(512, limbs=3, limb_bits=27), "cpu")
    _, ref = reference
    sk, _, rlk = keys.from_reference(ctx, mode="pallas", s=golden["sk"],
                                     k0=ref["k0"], k1=ref["k1"])
    return ctx, sk, rlk, keys.galois_from_reference(ctx, ref["galois"],
                                                    "pallas")


def test_params_match_reference(golden, reference):
    params, _ = reference
    ours = BfvParams.insecure(512, limbs=3, limb_bits=27)
    got = [ours.poly_degree, ours.plain_modulus, *ours.coeff_modulus,
           ours.special_modulus]
    assert got == [int(v) for v in golden["params"]]
    assert (ours.coeff_modulus, ours.special_modulus) == \
        (params.coeff_modulus, params.special_modulus)
    ref_u32 = type(params).default_u32(8192)
    ours_u32 = BfvParams.default_u32(8192)
    assert (ours_u32.plain_modulus, ours_u32.coeff_modulus,
            ours_u32.special_modulus) == (ref_u32.plain_modulus,
                                          ref_u32.coeff_modulus,
                                          ref_u32.special_modulus)


def test_from_reference_is_a_move(golden, reference, port):
    """Same NTT layout: the port's own transforms of the reference's s
    reproduce the reference's stored NTT images. NTT-domain arrays from
    a reference context of another mode, or of no stated mode, raise."""
    _, ref = reference
    ctx, sk, rlk, _ = port
    np.testing.assert_array_equal(sk.s.numpy(), golden["sk"])
    np.testing.assert_array_equal(sk.s_ntt_q.numpy(), ref["s_ntt_q"])
    np.testing.assert_array_equal(sk.s_ntt_key.numpy(), ref["s_ntt_key"])
    assert rlk.k0.dtype == torch.int64 and rlk.k0.shape == ref["k0"].shape
    moved, _, _ = keys.from_reference(ctx, mode="pallas", s=ref["s"],
                                      s_ntt_q=ref["s_ntt_q"],
                                      s_ntt_key=ref["s_ntt_key"])
    assert torch.equal(moved.s_ntt_key, sk.s_ntt_key)
    for mode in ("pallas_vpu", "unrolled", None):
        with pytest.raises(InvalidArgument, match="NTT"):
            keys.from_reference(ctx, mode=mode, s=ref["s"],
                                s_ntt_q=ref["s_ntt_q"])
        with pytest.raises(InvalidArgument, match="NTT"):
            keys.galois_from_reference(ctx, ref["galois"], mode)


def test_routes_by_size_and_device(monkeypatch):
    """The route is a pure function of N, the component counts, the
    device and the environment: on CUDA the B4 and B13 kernels hold every
    N of the "pallas" plans (up to 16384), as the CPU twins do, so
    default_u32(16384) takes B4 (B13 under FUSE_TFULL=1) as the
    reference does; FUSE_T3=1 takes B12 only with FUSE_FT3 off, and
    FUSE_INV=0 takes B10; other component counts take the plain loop."""
    for device_type in ("cuda", "cpu"):
        for n in (8192, 16384):
            assert ops.multiply_route(n, 2, 2, device_type) == "fwd_tensor3"
    assert ops.multiply_route(8192, 3, 2, "cuda") == "loop"
    monkeypatch.setenv("SUNSCREEN_TPU_FUSE_TFULL", "1")
    assert ops.multiply_route(16384, 2, 2, "cuda") == "fwd_tensor3_full"
    monkeypatch.delenv("SUNSCREEN_TPU_FUSE_TFULL")
    monkeypatch.setenv("SUNSCREEN_TPU_FUSE_T3", "1")
    assert ops.multiply_route(16384, 2, 2, "cuda") == "fwd_tensor3"
    monkeypatch.setenv("SUNSCREEN_TPU_FUSE_FT3", "0")
    assert ops.multiply_route(16384, 2, 2, "cuda") == "inv_tensor3"
    monkeypatch.setenv("SUNSCREEN_TPU_FUSE_INV", "0")
    assert ops.multiply_route(16384, 2, 2, "cuda") == "tensor3"


@pytest.mark.parametrize("name, value, call, kernel", [
    ("SUNSCREEN_TPU_FUSE_TFULL", "1",
     lambda: ops.multiply_route(8192, 2, 2, "cuda", "pallas_vpu"), "B13"),
    ("SUNSCREEN_TPU_FUSED_RNS", "0",
     lambda: ops.multiply_route(8192, 2, 2, "cuda"), "FUSED_RNS=0"),
    ("SUNSCREEN_TPU_FUSED_RNS", "0",
     lambda: ops.keyswitch_route("cuda"), "FUSED_RNS=0"),
    ("SUNSCREEN_TPU_FUSED_RNS", "0",
     lambda: ops.scale_convert_route("cuda"), "FUSED_RNS=0"),
])
def test_unported_settings_raise(monkeypatch, name, value, call, kernel):
    """A setting that asks for a kernel the port does not have (B4/B13
    under the "pallas_vpu" NTT mode, whose reference plan lacks them), or
    for the plain glue on the card, raises instead of being ignored."""
    monkeypatch.setenv(name, value)
    with pytest.raises(NotImplementedError, match=kernel):
        call()


def test_galois_tables_match_reference(reference, port):
    _, ref = reference
    ctx = port[0]
    for g, (idx, neg) in ref["galois_tables"].items():
        got_idx, got_neg = ctx.galois_table_host(g)
        np.testing.assert_array_equal(got_idx, idx)
        np.testing.assert_array_equal(got_neg, neg)
    assert keys.default_rotation_elements(ctx) == ref["default_elements"]


def test_rotations_match_golden(golden, port):
    """rotate_rows by one slot and the column swap with the reference's
    Galois keys reproduce `rot1` and `swap` bit for bit."""
    ctx, _, _, gks = port
    ct = torch.from_numpy(golden["ct"].astype(np.int64))
    np.testing.assert_array_equal(ops.rotate_rows(ctx, ct, 1, gks).numpy(),
                                  golden["rot1"])
    np.testing.assert_array_equal(ops.rotate_columns(ctx, ct, gks).numpy(),
                                  golden["swap"])
