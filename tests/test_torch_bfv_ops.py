"""The port's BFV slice under the NTT mode "pallas_vpu", its BatchEncoder
and the rest of the BFV evaluator (plain ops, mod switching, powers and
sums) against the JAX package, bit for bit.

The reference context is built under SUNSCREEN_TPU_NTT=pallas_vpu with
`get_context.__wrapped__`, since the reference caches contexts by their
parameters alone. Its keys and its encryption randomness are carried
over as numpy arrays. Where the reference raises AttributeError (its
PallasNttPlan reports mode "pallas", pntt.py:222, and lacks that mode's
fused methods), the port must raise its own named error."""

import contextlib
import os

import jax
import numpy as np
import pytest
import torch

from sunscreen_tpu.bfv import BatchEncoder as RefEncoder
from sunscreen_tpu.bfv import BfvParams as RefParams
from sunscreen_tpu.bfv import get_context as ref_context
from sunscreen_tpu.bfv import keys as rkeys
from sunscreen_tpu.bfv import ops as rops
from sunscreen_tpu.math import primes as rprimes
from sunscreen_tpu_torch import _build
from sunscreen_tpu_torch.bfv import BatchEncoder, BfvParams, get_context
from sunscreen_tpu_torch.bfv import keys, ops
from sunscreen_tpu_torch.errors import InvalidArgument
from sunscreen_tpu_torch.math import pntt

N = 256
T = rprimes.gen_ntt_primes(18, 1, N)[0]   # >= 17 bits: t's plan is a u32 one


@contextlib.contextmanager
def _env(**settings):
    saved = {k: os.environ.get(k) for k in settings}
    os.environ.update(settings)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _np(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


@pytest.fixture(scope="module")
def ref():
    """The reference's pallas_vpu context, encoder, keys, two encrypted
    slot vectors (one with its randomness) and every op's output."""
    with _env(SUNSCREEN_TPU_NTT="pallas_vpu"):
        rc = ref_context.__wrapped__(
            RefParams.insecure(N, plain_modulus=T, limbs=2, limb_bits=28))
        enc = RefEncoder(rc)
    assert type(rc.plan_q).__name__ == "PallasNttPlan"
    assert type(enc.plan).__name__ == "PallasNttPlan"
    key = jax.random.key(55)
    sk = rkeys.gen_secret_key(rc, jax.random.fold_in(key, 0))
    pk = rkeys.gen_public_key(rc, sk, jax.random.fold_in(key, 1))
    slots = np.random.default_rng(55).integers(0, T, (2, N))
    pts = enc.encode(slots)
    ct_a, comps = rops.encrypt_return_components(rc, pk, pts[0],
                                                 jax.random.fold_in(key, 2))
    ct_b = rops.encrypt(rc, pk, pts[1], jax.random.fold_in(key, 3))
    sym, sym_e = rops.encrypt_symmetric_return_components(
        rc, sk, pts[0], jax.random.fold_in(key, 4))
    with _env(SUNSCREEN_TPU_FUSE_FT3="0"):
        prod = rops.multiply(rc, ct_a, ct_b)
    mp = rops.multiply_plain(rc, ct_a, pts[1])
    out = {
        "rc": rc, "enc": enc, "slots": slots, "pts": _np(pts),
        "sk": {n: np.asarray(getattr(sk, n)) for n in
               ("s", "s_ntt_q", "s_ntt_key")},
        "pk": {n: np.asarray(getattr(pk, n)) for n in ("p0", "p1")},
        "comps": [_np(v) for v in comps], "ct_a": _np(ct_a),
        "ct_b": _np(ct_b), "prod": _np(prod), "mp": _np(mp),
        "sym": _np(sym), "sym_e": _np(sym_e),
        "dec_prod": _np(rops.decrypt(rc, sk, prod)),
        "dec_mp": _np(rops.decrypt(rc, sk, mp)),
        "noise": [int(np.asarray(v)) for v in
                  rops.noise_distance_words(rc, sk, prod)],
        "add_plain": _np(rops.add_plain(rc, ct_a, pts[1])),
        "sub_plain": _np(rops.sub_plain(rc, ct_a, pts[1])),
        "sub": _np(rops.sub(rc, ct_a, prod)),
        "negate": _np(rops.negate(rc, ct_a)),
        "add_many": _np(rops.add_many(rc, [ct_a, ct_b, ct_a])),
        "mod_switch": _np(rops.mod_switch_to_next(rc, ct_a)),
    }
    return out


@pytest.fixture(scope="module")
def port(ref):
    """The port's pallas_vpu context on the CPU with the reference's keys
    carried over unchanged."""
    ctx = get_context(BfvParams.insecure(N, plain_modulus=T, limbs=2,
                                         limb_bits=28), "cpu", "pallas_vpu")
    sk, pk, _ = keys.from_reference(ctx, mode="pallas_vpu", **ref["sk"],
                                    **ref["pk"])
    return ctx, sk, pk


def test_context_and_keys_carry_across(ref, port):
    """Every plan of the context is the pallas_vpu plan; the port's NTT
    images of the reference's secret are the reference's arrays; the
    context cache honours a mode set after another mode's context was
    built, which the reference's cache does not."""
    ctx, _, _ = port
    assert ctx.mode == "pallas_vpu"
    assert all(isinstance(p, pntt.PallasNttPlan)
               for p in (ctx.plan_q, ctx.plan_mul, ctx.plan_key))
    s = ref["sk"]["s"]
    mine, _, _ = keys.from_reference(ctx, s=s)
    np.testing.assert_array_equal(mine.s_ntt_q.numpy(), ref["sk"]["s_ntt_q"])
    np.testing.assert_array_equal(mine.s_ntt_key.numpy(),
                                  ref["sk"]["s_ntt_key"])
    assert get_context(ctx.params, "cpu").mode == "pallas"
    with _env(SUNSCREEN_TPU_NTT="pallas_vpu"):
        assert get_context(ctx.params, "cpu") is ctx


def test_encrypt_matches_reference(ref, port):
    """The reference's randomness through the port's encryptions gives
    the reference's ciphertexts: (u, e0, e1) for the public-key one, the
    mask (its second component) and e for the symmetric one; the port's
    own draws decrypt."""
    ctx, sk, pk = port
    got = ops._encrypt_parts(ctx, pk, _t(ref["pts"][0]),
                             *(_t(v) for v in ref["comps"]))
    np.testing.assert_array_equal(got.numpy(), ref["ct_a"])
    sym = _t(ref["sym"])
    got = ops._encrypt_symmetric_parts(ctx, sk, _t(ref["pts"][0]), sym[1],
                                       _t(ref["sym_e"]))
    assert torch.equal(got, sym)
    gen = torch.Generator().manual_seed(3)
    ct, comps = ops.encrypt_return_components(ctx, pk, _t(ref["pts"]), gen)
    again = ops.encrypt(ctx, pk, _t(ref["pts"]),
                        torch.Generator().manual_seed(3))
    assert torch.equal(ct, again) and comps[0].dtype == torch.int64
    np.testing.assert_array_equal(ops.decrypt(ctx, sk, ct).numpy(),
                                  ref["pts"])


def test_multiply_matches_reference(ref, port, monkeypatch):
    """The 3-component multiply under FUSE_FT3=0 (the "loop" route: B17's
    twin per product) and multiply_plain, their decryptions, slot-wise
    products through the encoder, and the noise distance words."""
    ctx, sk, _ = port
    monkeypatch.setenv("SUNSCREEN_TPU_FUSE_FT3", "0")
    assert ops.multiply_route(N, 2, 2, "cpu", ctx.mode) == "loop"
    _build.reset_launches()
    prod = ops.multiply(ctx, _t(ref["ct_a"]), _t(ref["ct_b"]))
    np.testing.assert_array_equal(prod.numpy(), ref["prod"])
    mp = ops.multiply_plain(ctx, _t(ref["ct_a"]), _t(ref["pts"][1]))
    np.testing.assert_array_equal(mp.numpy(), ref["mp"])
    enc = BatchEncoder(ctx)
    want = ref["slots"][0] * ref["slots"][1] % T
    for ct, dec in ((prod, ref["dec_prod"]), (mp, ref["dec_mp"])):
        got = ops.decrypt(ctx, sk, ct)
        np.testing.assert_array_equal(got.numpy(), dec)
        np.testing.assert_array_equal(enc.decode(got).numpy(), want)
    hi, lo = ops.noise_distance_words(ctx, sk, prod)
    assert [int(hi) & (2**64 - 1), int(lo) & (2**64 - 1)] == ref["noise"]
    assert ops.invariant_noise_budget(ctx, sk, prod) > 0
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_multiply_above_16384_matches_reference(monkeypatch):
    """A whole pallas_vpu `multiply` at N = 32768, past the reference's
    "pallas" plans (insecure_u32(32768, limbs=1): 3 limbs in the product
    base), on the reference's ciphertexts: the port's product is the
    reference's, bit for bit, and decrypts under the reference's secret
    to the reference's plaintext."""
    n = 32768
    t = rprimes.gen_ntt_primes(20, 1, n)[0]
    with _env(SUNSCREEN_TPU_NTT="pallas_vpu"):
        rc = ref_context.__wrapped__(
            RefParams.insecure_u32(n, plain_modulus=t, limbs=1))
    key = jax.random.key(32)
    sk = rkeys.gen_secret_key(rc, jax.random.fold_in(key, 0))
    pk = rkeys.gen_public_key(rc, sk, jax.random.fold_in(key, 1))
    pts = np.random.default_rng(32).integers(0, t, (2, n))
    a, b = (rops.encrypt(rc, pk, pts[i], jax.random.fold_in(key, 2 + i))
            for i in range(2))
    monkeypatch.setenv("SUNSCREEN_TPU_FUSE_FT3", "0")
    prod = rops.multiply(rc, a, b)
    ctx = get_context(BfvParams.insecure_u32(n, plain_modulus=t, limbs=1),
                      "cpu", "pallas_vpu")
    got = ops.multiply(ctx, _t(a), _t(b))
    np.testing.assert_array_equal(got.numpy(), _np(prod))
    port_sk, _, _ = keys.from_reference(ctx, s=np.asarray(sk.s))
    np.testing.assert_array_equal(ops.decrypt(ctx, port_sk, got).numpy(),
                                  _np(rops.decrypt(rc, sk, prod)))


def test_raises_where_reference_raises(ref, port, monkeypatch):
    """FUSE_FT3 on (the default), FUSE_T3=1, and every keyswitch: the
    reference raises AttributeError, the port a NotImplementedError that
    names the missing method and pntt.py:222. The routes that work are
    pure functions of the settings: "loop" on the CPU, "tensor3" (B16,
    B10, B16) on CUDA."""
    ctx, _, _ = port
    rc = ref["rc"]
    a, b, prod = (_t(ref[k]) for k in ("ct_a", "ct_b", "prod"))
    ra, rb, rprod = (jax.numpy.asarray(ref[k].astype(np.uint32))
                     for k in ("ct_a", "ct_b", "prod"))
    cases = [({}, "fwd_tensor3"),
             ({"SUNSCREEN_TPU_FUSE_FT3": "0", "SUNSCREEN_TPU_FUSE_T3": "1"},
              "inv_tensor3")]
    for settings, method in cases:
        with _env(**settings):
            with pytest.raises(AttributeError, match=method):
                rops.multiply(rc, ra, rb)
            with pytest.raises(NotImplementedError,
                               match=f"{method}.*pntt.py:222"):
                ops.multiply(ctx, a, b)
    for settings, method in (({}, "fwd_broadcast"),
                             ({"SUNSCREEN_TPU_FUSE_KSFULL": "1"}, "ks_full")):
        with _env(**settings):
            with pytest.raises(AttributeError, match=method):
                rops.relinearize(rc, rprod, None)
            with pytest.raises(NotImplementedError,
                               match=f"{method}.*pntt.py:222"):
                ops.relinearize(ctx, prod, None)
    assert ops.multiply_route(N, 3, 2, "cuda", "pallas_vpu") == "loop"
    for name in ("SUNSCREEN_TPU_FUSE_FT3", "SUNSCREEN_TPU_FUSE_INV"):
        with _env(**{name: "0"}):
            assert ops.multiply_route(N, 2, 2, "cpu", "pallas_vpu") == "loop"
            assert ops.multiply_route(8192, 2, 2, "cuda",
                                      "pallas_vpu") == "tensor3"
    monkeypatch.setenv("SUNSCREEN_TPU_FUSE_INV", "0")
    monkeypatch.setenv("SUNSCREEN_TPU_FUSE_T3", "1")
    assert ops.multiply_route(N, 2, 2, "cuda", "pallas_vpu") == "tensor3"


def test_batch_encoder_matches_reference(ref, port):
    """Slot positions and encodings equal the reference encoder's; encode
    and decode (also signed) round trip; under the default mode the
    encoder's (t,) plan is the "pallas" one, with the same slots."""
    ctx, _, _ = port
    enc = BatchEncoder(ctx)
    assert isinstance(enc.plan, pntt.PallasNttPlan)
    np.testing.assert_array_equal(enc.slot_pos.numpy(),
                                  np.asarray(ref["enc"].slot_pos))
    pts = enc.encode(ref["slots"])
    np.testing.assert_array_equal(pts.numpy(), ref["pts"])
    np.testing.assert_array_equal(enc.decode(pts).numpy(), ref["slots"])
    signed = ref["slots"] - T // 2
    np.testing.assert_array_equal(
        enc.decode_signed(enc.encode_signed(signed)).numpy(), signed)
    default = BatchEncoder(get_context(ctx.params, "cpu", "pallas"))
    assert default.plan.mode == "pallas"
    np.testing.assert_array_equal(default.decode(pts).numpy(),
                                  ref["slots"])


def test_plain_ops_and_mod_switch_match_reference(ref, port):
    """add_plain, sub_plain, sub (2 - 3 components), negate, add_many and
    mod_switch_to_next against the reference; the switched ciphertext
    decrypts under mod_switch_context, which keeps device and mode."""
    ctx, _, _ = port
    a, b, prod = (_t(ref[k]) for k in ("ct_a", "ct_b", "prod"))
    pt = _t(ref["pts"][1])
    for name, got in (("add_plain", ops.add_plain(ctx, a, pt)),
                      ("sub_plain", ops.sub_plain(ctx, a, pt)),
                      ("sub", ops.sub(ctx, a, prod)),
                      ("negate", ops.negate(ctx, a)),
                      ("add_many", ops.add_many(ctx, [a, b, a])),
                      ("mod_switch", ops.mod_switch_to_next(ctx, a))):
        np.testing.assert_array_equal(got.numpy(), ref[name], err_msg=name)
    ctx2 = ops.mod_switch_context(ctx)
    assert (ctx2.k, ctx2.mode, ctx2.device) == (ctx.k - 1, ctx.mode,
                                                ctx.device)
    sk2, _, _ = keys.from_reference(ctx2, s=ref["sk"]["s"])
    np.testing.assert_array_equal(
        ops.decrypt(ctx2, sk2, _t(ref["mod_switch"])).numpy(),
        ref["pts"][0])
    with pytest.raises(InvalidArgument):
        ops.mod_switch_to_next(ctx2, _t(ref["mod_switch"]))


def test_powers_and_products_follow_reference(monkeypatch):
    """exponentiate, multiply_many and square call multiply_relin /
    multiply in the reference's order (the relinearization noise depends
    on it): both packages with those stubbed to record the expression."""
    for mod in (rops, ops):
        monkeypatch.setattr(mod, "multiply_relin",
                            lambda ctx, a, b, rlk: f"({a}*{b})")
        monkeypatch.setattr(mod, "multiply", lambda ctx, a, b: f"[{a}x{b}]")
    for power in range(1, 8):
        assert ops.exponentiate(None, "c", power, None) == \
            rops.exponentiate(None, "c", power, None)
    for count in range(1, 6):
        cts = [f"c{i}" for i in range(count)]
        assert ops.multiply_many(None, cts, None) == \
            rops.multiply_many(None, cts, None)
    assert ops.square(None, "c") == rops.square(None, "c")
    for call in (lambda: ops.exponentiate(None, "c", 0, None),
                 lambda: ops.multiply_many(None, [], None),
                 lambda: ops.add_many(None, [])):
        with pytest.raises(InvalidArgument):
            call()


def test_user_flow_default_mode(monkeypatch):
    """The BFV user flow on the port's default mode with its own keys:
    encode, encrypt (public and symmetric), exponentiate, multiply_many,
    rotate_rows, a square under FUSE_TFULL=1 (route "fwd_tensor3_full",
    B13's twin) equal to the default route's, decrypt and decode
    slot-wise, and a positive noise budget."""
    ctx = get_context(BfvParams.insecure(N, plain_modulus=T, limbs=4,
                                         limb_bits=28), "cpu")
    gen = torch.Generator().manual_seed(11)
    sk = keys.gen_secret_key(ctx, gen)
    pk = keys.gen_public_key(ctx, sk, gen)
    rlk = keys.gen_relin_key(ctx, sk, gen)
    gks = keys.gen_galois_keys(ctx, sk, gen, (ctx.rotate_rows_element(1),))
    enc = BatchEncoder(ctx)
    slots = np.random.default_rng(11).integers(0, T, (3, N))
    cts = ops.encrypt(ctx, pk, enc.encode(slots), gen)
    sym = ops.encrypt_symmetric(ctx, sk, enc.encode(slots[0]), gen)

    def dec(ct):
        return enc.decode(ops.decrypt(ctx, sk, ct)).numpy()

    np.testing.assert_array_equal(dec(sym), slots[0])
    cube = ops.exponentiate(ctx, cts[0], 3, rlk)
    np.testing.assert_array_equal(dec(cube), slots[0] ** 3 % T)
    many = ops.multiply_many(ctx, list(cts), rlk)
    np.testing.assert_array_equal(dec(many), slots.prod(0) % T)
    half = N // 2
    rolled = np.concatenate([np.roll(slots[1, :half], -1),
                             np.roll(slots[1, half:], -1)])
    np.testing.assert_array_equal(dec(ops.rotate_rows(ctx, cts[1], 1, gks)),
                                  rolled)
    assert ops.invariant_noise_budget(ctx, sk, many) > 0
    default = ops.square(ctx, cts[2])
    monkeypatch.setenv("SUNSCREEN_TPU_FUSE_TFULL", "1")
    assert ops.multiply_route(N, 2, 2, "cpu") == "fwd_tensor3_full"
    assert ops.multiply_route(8192, 2, 2, "cuda") == "fwd_tensor3_full"
    assert ops.multiply_route(16384, 2, 2, "cuda") == "fwd_tensor3_full"
    assert torch.equal(ops.square(ctx, cts[2]), default)
    np.testing.assert_array_equal(dec(default), slots[2] ** 2 % T)
