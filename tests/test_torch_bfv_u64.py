"""The port's u64 engine (limbs above 30 bits: `BfvParams.default`,
`insecure(1024, limbs=2)`) against the JAX package, bit for bit: the NTT
modes "unrolled", "compact" and "matmul" (NTT-domain arrays included),
the RNS glue at 40-56-bit limbs, the u64 default parameters, the golden
`bfv_*` vectors of tests/golden_v1.npz under "unrolled" (the CPU
default on both sides) with the reference's keys built exactly as
tools/gen_golden.py builds them, and one `multiply_relin` under
"matmul". The reference's `get_context` is cached by params alone, so
its contexts here are built through `get_context.__wrapped__` with
SUNSCREEN_TPU_NTT set around that call only."""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunscreen_tpu.bfv import BfvParams as RefParams
from sunscreen_tpu.bfv import params as ref_params
from sunscreen_tpu.bfv.params import coefficient_modulus_create as ref_create
from sunscreen_tpu.bfv import get_context as ref_context
from sunscreen_tpu.bfv import keys as rkeys
from sunscreen_tpu.bfv import ops as rops
from sunscreen_tpu.math import ntt as rntt
from sunscreen_tpu.math import primes as rprimes
from sunscreen_tpu_torch import _build
from sunscreen_tpu_torch.bfv import (BatchEncoder, BfvParams, get_context,
                                     keys, ops)
from sunscreen_tpu_torch.bfv import params as port_params
from sunscreen_tpu_torch.bfv.params import coefficient_modulus_create
from sunscreen_tpu_torch.math import mntt, ntt, rns
from sunscreen_tpu_torch.math.pmntt import _bitrev

FIXTURE = os.path.join(os.path.dirname(__file__), "golden_v1.npz")


@contextlib.contextmanager
def _mode(mode):
    prev = os.environ.get("SUNSCREEN_TPU_NTT")
    os.environ["SUNSCREEN_TPU_NTT"] = mode
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("SUNSCREEN_TPU_NTT", None)
        else:
            os.environ["SUNSCREEN_TPU_NTT"] = prev


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint64).view(np.int64))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURE)


@pytest.fixture(scope="module")
def ref(golden):
    """The reference's context under "unrolled" and its relin and Galois
    keys as tools/gen_golden.py makes them."""
    with _mode("unrolled"):
        rc = ref_context.__wrapped__(RefParams.insecure(1024, limbs=2))
    key = jax.random.key(0)
    sk = rkeys.gen_secret_key(rc, jax.random.fold_in(key, 0))
    rlk = rkeys.gen_relin_key(rc, sk, jax.random.fold_in(key, 2))
    elements = (rc.rotate_rows_element(1), rc.rotate_columns_element)
    gks = rkeys.gen_galois_keys(rc, sk, jax.random.fold_in(key, 3), elements)
    np.testing.assert_array_equal(np.asarray(sk.s), golden["bfv_sk"])
    return {"rc": rc, "s": np.asarray(sk.s),
            "rlk": (np.asarray(rlk.k0), np.asarray(rlk.k1)),
            "galois": {g: (np.asarray(gks[g].k0), np.asarray(gks[g].k1))
                       for g in elements}}


@pytest.fixture(scope="module")
def port(ref):
    """The port's default CPU context for the golden params (mode
    "unrolled") with the reference's keys carried over."""
    ctx = get_context(BfvParams.insecure(1024, limbs=2), "cpu")
    k0, k1 = ref["rlk"]
    sk, _, rlk = keys.from_reference(ctx, mode="unrolled", s=ref["s"],
                                     k0=k0, k1=k1)
    gks = keys.galois_from_reference(ctx, ref["galois"], "unrolled")
    return ctx, sk, rlk, gks


@pytest.mark.parametrize("mode", ["unrolled", "compact", "matmul"])
def test_ntt_modes_match_reference(mode):
    """fwd, inv and negacyclic_mul at N=1024 over two 54-bit primes equal
    the reference's plan of the same mode, NTT-domain arrays included;
    "matmul" is "unrolled" gathered by the bit reversal."""
    n = 1024
    mods = tuple(rprimes.gen_ntt_primes(54, 2, n))
    rng = np.random.default_rng(6)
    a = rng.integers(0, min(mods), (2, 2, n), dtype=np.uint64)
    b = rng.integers(0, min(mods), (2, 2, n), dtype=np.uint64)
    a[0, :, 0] = [q - 1 for q in mods]
    want_plan = rntt.get_plan(n, mods, mode)
    plan = ntt.get_plan(n, mods, "cpu", mode)
    assert plan.mode == mode
    fa = plan.fwd(_t(a))
    np.testing.assert_array_equal(_u(fa), np.asarray(want_plan.fwd(
        jnp.asarray(a))))
    np.testing.assert_array_equal(_u(plan.inv(fa)), a)
    np.testing.assert_array_equal(
        _u(plan.negacyclic_mul(_t(a), _t(b))),
        np.asarray(want_plan.negacyclic_mul(jnp.asarray(a), jnp.asarray(b))))
    if mode == "matmul":
        assert isinstance(plan, mntt.MatmulNttPlan)
        unrolled = ntt.get_plan(n, mods, "cpu", "unrolled").fwd(_t(a))
        assert torch.equal(fa, unrolled[..., _bitrev(n)])
    else:
        assert torch.equal(plan.fwd_compact(_t(a)), fa)
        assert torch.equal(plan.inv_compact(fa), _t(a))


def test_rns_glue_matches_reference(ref):
    """BaseConverter (plain and centered, extend), ScaleAndRound,
    DecryptScaler (with the noise words) and ModDown on the bases of
    insecure(1024, limbs=2): 40-bit Q, 56-bit aux, 44-bit special."""
    rc = ref["rc"]
    ctx = get_context(BfvParams.insecure(1024, limbs=2), "cpu")
    assert ctx.aux_base.moduli == rc.aux_base.moduli
    assert max(q.bit_length() for q in ctx.aux_base.moduli) == 56
    rng = np.random.default_rng(9)

    def residues(base, lead):
        return np.stack([rng.integers(0, q, lead + (1024,), dtype=np.uint64)
                         for q in base.moduli], axis=-2)

    x = residues(rc.q_base, (3,))
    x[0, :, 0] = [q - 1 for q in rc.q_base.moduli]
    for centered in (False, True):
        np.testing.assert_array_equal(
            _u(ctx.conv_q_to_aux.convert(_t(x), centered=centered)),
            np.asarray(rc.conv_q_to_aux.convert(jnp.asarray(x),
                                                centered=centered)))
    np.testing.assert_array_equal(
        _u(ctx.conv_q_to_aux.extend(_t(x))),
        np.asarray(rc.conv_q_to_aux.extend(jnp.asarray(x))))
    xm = residues(rc.mul_base, (2,))
    np.testing.assert_array_equal(
        _u(ctx.scale_mul_to_aux.apply(_t(xm))),
        np.asarray(rc.scale_mul_to_aux.apply(jnp.asarray(xm))))
    got, (f_hi, f_lo) = ctx.decrypt_scaler.apply(_t(x))
    want, (w_hi, w_lo) = rc.decrypt_scaler.apply(jnp.asarray(x))
    np.testing.assert_array_equal(_u(got), np.asarray(want))
    np.testing.assert_array_equal(_u(f_hi), np.asarray(w_hi))
    np.testing.assert_array_equal(_u(f_lo), np.asarray(w_lo))
    xk = residues(rc.key_base, (2,))
    np.testing.assert_array_equal(
        _u(ctx.mod_down.apply(_t(xk[..., :2, :]), _t(xk[..., 2, :]))),
        np.asarray(rc.mod_down.apply(jnp.asarray(xk[..., :2, :]),
                                     jnp.asarray(xk[..., 2, :]))))
    base = rns.get_base(ctx.q_base.moduli, "cpu")
    assert base is rns.get_base(ctx.q_base.moduli, "cpu") and base.u64


def test_default_params_match_reference():
    """BfvParams.default(n) equals the reference's for n = 4096, 8192 and
    16384 (limbs of up to 56 bits, 64-bit words), and so does
    `coefficient_modulus_create` on mixed and repeated bit sizes."""
    for n in (4096, 8192, 16384):
        ours, theirs = BfvParams.default(n), RefParams.default(n)
        assert (ours.plain_modulus, ours.coeff_modulus,
                ours.special_modulus) == (theirs.plain_modulus,
                                          theirs.coeff_modulus,
                                          theirs.special_modulus)
        assert ours.word_bits == theirs.word_bits == 64
    assert BfvParams.default_u32(8192).word_bits == 32
    p = BfvParams.default(8192)
    assert [q.bit_length() for q in p.coeff_modulus] == [54, 54, 54]
    assert p.special_modulus.bit_length() == 56
    for n, bits in ((8192, [50, 30, 30, 50, 50]), (4096, [54, 54, 54, 56]),
                    (16384, [36, 60, 36, 30])):
        assert coefficient_modulus_create(n, bits) == ref_create(n, bits)


def test_seal_presets_match_reference():
    """SEAL's BFVDefault chains (`SEAL_BFV_DEFAULT_128`, and
    `SEAL_BFV_DEFAULT_1024` by security tier) equal the reference's,
    and each prime is 1 mod 2N for its N."""
    assert (port_params.SEAL_BFV_DEFAULT_128
            == ref_params.SEAL_BFV_DEFAULT_128)
    assert (port_params.SEAL_BFV_DEFAULT_1024
            == ref_params.SEAL_BFV_DEFAULT_1024)
    for n, chain in port_params.SEAL_BFV_DEFAULT_128.items():
        assert all(q % (2 * n) == 1 for q in chain), n
    assert all(q % 2048 == 1 for chain in
               port_params.SEAL_BFV_DEFAULT_1024.values() for q in chain)


def test_golden_multiply_relin(golden, port):
    """bfv_mul_relin, bfv_dec_mul and bfv_noise_budget of golden_v1.npz
    from bfv_ct under the default CPU settings, with no kernel launch."""
    ctx, sk, rlk, _ = port
    assert ctx.mode == "unrolled"
    _build.reset_launches()
    ct = _t(golden["bfv_ct"])
    prod = ops.multiply_relin(ctx, ct, ct, rlk)
    np.testing.assert_array_equal(_u(prod), golden["bfv_mul_relin"])
    np.testing.assert_array_equal(_u(ops.decrypt(ctx, sk, prod)),
                                  golden["bfv_dec_mul"])
    assert ops.invariant_noise_budget(ctx, sk, prod) == \
        float(golden["bfv_noise_budget"][0])
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_golden_rotations(golden, port):
    """bfv_rot1 and bfv_swap of golden_v1.npz through the reference's
    Galois keys; the BatchEncoder on this u64 context decodes them to the
    row rotation and the row swap of the decoded bfv_ct."""
    ctx, sk, _, gks = port
    ct = _t(golden["bfv_ct"])
    rot = ops.rotate_rows(ctx, ct, 1, gks)
    swap = ops.rotate_columns(ctx, ct, gks)
    np.testing.assert_array_equal(_u(rot), golden["bfv_rot1"])
    np.testing.assert_array_equal(_u(swap), golden["bfv_swap"])
    enc = BatchEncoder(ctx)
    slots = enc.decode(ops.decrypt(ctx, sk, ct)).numpy()
    half = ctx.n // 2
    rows = slots.reshape(2, half)
    np.testing.assert_array_equal(
        enc.decode(ops.decrypt(ctx, sk, rot)).numpy(),
        np.roll(rows, -1, axis=1).reshape(-1))
    np.testing.assert_array_equal(
        enc.decode(ops.decrypt(ctx, sk, swap)).numpy(),
        rows[::-1].reshape(-1))
    np.testing.assert_array_equal(enc.decode(enc.encode(slots)).numpy(),
                                  slots)


def test_multiply_relin_under_matmul_matches_reference():
    """The reference's context under SUNSCREEN_TPU_NTT=matmul: its keys
    (NTT-domain arrays in natural order) carried over, its ciphertexts
    multiplied and relinearized, bit for bit; the key material refuses
    an "unrolled" context."""
    params = RefParams.insecure(1024, limbs=2)
    with _mode("matmul"):
        rc = ref_context.__wrapped__(params)
    assert rc.plan_q.mode == rc.plan_mul.mode == "matmul"
    key = jax.random.key(13)
    sk = rkeys.gen_secret_key(rc, jax.random.fold_in(key, 0))
    pk = rkeys.gen_public_key(rc, sk, jax.random.fold_in(key, 1))
    rlk = rkeys.gen_relin_key(rc, sk, jax.random.fold_in(key, 2))
    pt = np.random.default_rng(13).integers(0, params.plain_modulus,
                                            1024).astype(np.uint64)
    ct = rops.encrypt(rc, pk, jnp.asarray(pt), jax.random.key(14))
    want = np.asarray(rops.multiply_relin(rc, ct, ct, rlk))
    ctx = get_context(BfvParams.insecure(1024, limbs=2), "cpu", "matmul")
    assert (ctx.plan_q.mode, ctx.plan_mul.mode) == ("matmul", "matmul")
    psk, _, prlk = keys.from_reference(
        ctx, mode="matmul", s=np.asarray(sk.s), s_ntt_q=np.asarray(sk.s_ntt_q),
        k0=np.asarray(rlk.k0), k1=np.asarray(rlk.k1))
    np.testing.assert_array_equal(
        psk.s_ntt_key.numpy(), np.asarray(sk.s_ntt_key).view(np.int64))
    prod = ops.multiply_relin(ctx, _t(np.asarray(ct)), _t(np.asarray(ct)),
                              prlk)
    np.testing.assert_array_equal(_u(prod), want)
    unrolled = get_context(BfvParams.insecure(1024, limbs=2), "cpu")
    with pytest.raises(Exception, match="NTT domain"):
        keys.from_reference(unrolled, mode="matmul", s=np.asarray(sk.s),
                            k0=np.asarray(rlk.k0), k1=np.asarray(rlk.k1))
