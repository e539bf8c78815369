"""The port's SDLP statements over BFV ciphertexts
(`sunscreen_tpu_torch.logproof.bfv_statement`) and TFHE's LWE proof
(`sunscreen_tpu_torch.tfhe.zkp`) held against the JAX package on the CPU.

The statements are built by both packages from the reference's keys,
ciphertexts and encryption components (the port samples differently), the
reference's public key carried into the port's NTT domain ("matmul" at
N = 64) through the two transforms. The verifier's and prover's knowledge
must be equal as integers, and the proofs equal byte for byte under one
seeded source of blindings: the reference's `secrets` in
`logproof.linear_relation` and `inner_product._rand` patched with it.
Everything is exact: no tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sunscreen_tpu.logproof.inner_product as ref_ipp
import sunscreen_tpu.logproof.linear_relation as ref_lr
from sunscreen_tpu.bfv import BfvParams as RefParams
from sunscreen_tpu.bfv import get_context as ref_get_context
from sunscreen_tpu.bfv import keys as ref_keys
from sunscreen_tpu.bfv import ops as ref_ops
from sunscreen_tpu.logproof.bfv_statement import BfvStatements as RefStatements
from sunscreen_tpu.tfhe import LweDef as RefLweDef
from sunscreen_tpu.tfhe import ops as ref_tops
from sunscreen_tpu.tfhe import torus as ref_torus
from sunscreen_tpu.tfhe import zkp as ref_tzkp
from sunscreen_tpu.zk.merlin import Transcript as RefTranscript
from sunscreen_tpu_torch.bfv import BfvParams, get_context, keys, ops
from sunscreen_tpu_torch.logproof import inner_product as ipp
from sunscreen_tpu_torch.logproof import linear_relation as lr
from sunscreen_tpu_torch.logproof.bfv_statement import BfvStatements
from sunscreen_tpu_torch.math import ntt
from sunscreen_tpu_torch.tfhe import LweDef
from sunscreen_tpu_torch.tfhe import zkp as tzkp
from sunscreen_tpu_torch.zk.merlin import Transcript
from sunscreen_tpu_torch.zk.r1cs import scalar_source

PARAMS = dict(poly_degree=64, limbs=1, limb_bits=28)
SEED = 17


class _Secrets:
    """A stand-in for the `secrets` module drawing from one scalar source."""

    def __init__(self, draw):
        self.randbelow = lambda n: draw()


def seed_reference(monkeypatch, seed: int):
    """Route every blinding of the reference's SDLP through
    `scalar_source(seed)`, the sequence the port draws with that seed."""
    draw = scalar_source(seed)
    monkeypatch.setattr(ref_lr, "secrets", _Secrets(draw))
    monkeypatch.setattr(ref_ipp, "_rand", draw)


def _np(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def jitted(fn, ctx):
    """`fn(ctx, *args)` of the reference under `jax.jit`: its eager ops
    compile one by one, which costs tens of seconds on the CPU."""
    return jax.jit(lambda *args: fn(ctx, *args))


@pytest.fixture(scope="module")
def setup():
    """The reference's context, keys and jitted encryptions; the port's
    context with the reference's public key carried from the reference's
    NTT mode ("unrolled" on the CPU) into its own. The reference's
    statement builder runs its public-key transform under `jax.jit` (the
    same computation, without compiling its ops one by one)."""
    rctx = ref_get_context(RefParams.insecure(**PARAMS))
    key = jax.random.key(1)
    rsk, rpk = jitted(lambda c, k: (lambda sk: (sk, ref_keys.gen_public_key(
        c, sk, jax.random.fold_in(k, 1))))(ref_keys.gen_secret_key(
            c, jax.random.fold_in(k, 0))), rctx)(key)
    ctx = get_context(BfvParams.insecure(**PARAMS), "cpu")
    src = ntt.get_plan(ctx.n, ctx.q_base.moduli, "cpu", "unrolled")

    def carry(a):
        return ctx.plan_q.fwd(src.inv(torch.from_numpy(_np(a))))

    pk = keys.PublicKey(carry(rpk.p0), carry(rpk.p1))
    sk, _, _ = keys.from_reference(ctx, s=_np(rsk.s))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rctx.plan_q, "inv", jax.jit(rctx.plan_q.inv))
        yield {"rctx": rctx, "rsk": rsk, "rpk": rpk, "key": key,
               "ctx": ctx, "pk": pk, "sk": sk,
               "enc": jitted(ref_ops.encrypt_return_components, rctx),
               "enc_sym": jitted(
                   ref_ops.encrypt_symmetric_return_components, rctx),
               "enc_plain": jitted(ref_ops.encrypt, rctx)}


def _statements(kind: str, s: dict):
    """The same statements in both packages from the reference's data."""
    rctx, key = s["rctx"], s["key"]
    rng = np.random.default_rng({"public": 0, "private": 1, "decryption": 7,
                                 "two": 2}[kind])
    pt = rng.integers(0, rctx.t, rctx.n, dtype=np.uint64)
    ref, port = RefStatements(rctx), BfvStatements(s["ctx"])
    rmid, mid = ref.add_message(pt), port.add_message(pt)
    if kind in ("public", "two"):
        for i in ((2,) if kind == "public" else (5, 6)):
            ct, comps = s["enc"](s["rpk"], pt, jax.random.fold_in(key, i))
            np.testing.assert_array_equal(
                ops.decrypt(s["ctx"], s["sk"], torch.from_numpy(_np(ct))),
                pt.astype(np.int64))
            comps = [np.asarray(c) for c in comps]
            ref.add_public_encryption(rmid, np.asarray(ct), s["rpk"], *comps)
            port.add_public_encryption(mid, _np(ct), s["pk"], *comps)
    elif kind == "private":
        ct, e = s["enc_sym"](s["rsk"], pt, jax.random.fold_in(key, 4))
        ref.add_private_encryption(rmid, np.asarray(ct),
                                   np.asarray(s["rsk"].s), np.asarray(e))
        port.add_private_encryption(mid, torch.from_numpy(_np(ct)),
                                    s["sk"].s, np.asarray(e))
    else:
        ct = s["enc_plain"](s["rpk"], pt, jax.random.fold_in(key, 9))
        re = ref.add_decryption(rmid, np.asarray(ct), s["rsk"])
        e = port.add_decryption(mid, torch.from_numpy(_np(ct)), s["sk"])
        np.testing.assert_array_equal(e, re)
        assert np.abs(e).max() < (s["ctx"].params.q_product
                                  // s["ctx"].t) // 2
    return ref.build(), port.build()


@pytest.mark.parametrize("kind", ["public", "private", "decryption", "two"])
def test_statement_matches_reference(monkeypatch, setup, kind):
    """The public-key, private-key and decryption statements and two
    encryptions of one message (`tests/test_bfv_statement.py:27-121`):
    knowledge equal as integers, proofs equal byte for byte under one
    seed, the port's proof verifying and a changed T refused."""
    (rvk, rpk_know), (vk, pk_know) = _statements(kind, setup)
    assert (vk.a, vk.t, vk.bounds, vk.f, vk.q, vk.n_messages) == (
        rvk.a, rvk.t, rvk.bounds, rvk.f, rvk.q, rvk.n_messages)
    assert [[list(map(int, p)) for p in row] for row in pk_know.s] == [
        [list(map(int, p)) for p in row] for row in rpk_know.s]
    seed_reference(monkeypatch, SEED)
    label = f"bfv-sdlp-{kind}".encode()
    rgens = ref_lr.LogProofGenerators(rvk.l)
    want = ref_lr.create(RefTranscript(label), rpk_know, rgens.g, rgens.h,
                         ref_ipp.get_u(), gens=rgens)
    gens = lr.LogProofGenerators(vk.l)
    proof = lr.create(Transcript(label), pk_know, gens.g, gens.h,
                      ipp.get_u(), gens=gens, device="cpu",
                      rand_fn=scalar_source(SEED))
    assert proof.to_bytes() == want.to_bytes()
    assert lr.verify(proof, Transcript(label), vk, gens.g, gens.h,
                     ipp.get_u(), gens=gens, device="cpu")
    vk.t[0][0] = [(vk.t[0][0][0] + 1) % vk.q] + vk.t[0][0][1:]
    assert not lr.verify(proof, Transcript(label), vk, gens.g, gens.h,
                         ipp.get_u(), gens=gens, device="cpu")


def test_lwe_proof_matches_reference(monkeypatch):
    """`tfhe/zkp.py` (`tests/test_tfhe_zkp.py:15`): the LWE statement
    equal to the reference's, the proof's bytes equal under one seed, the
    proof verifying, and refused against a ciphertext whose b changed."""
    lwe = RefLweDef(dim=32, std=1e-16)
    key = jax.random.key(4)
    rsk = ref_tops.generate_binary_lwe_sk(lwe, jax.random.fold_in(key, 0))
    msg, bits = 5, 4
    ct, e = ref_tops.encrypt_lwe_return_components(
        ref_torus.encode(jnp.uint64(msg), bits), rsk, lwe,
        jax.random.fold_in(key, 1))
    ct_words, sk_words = _np(ct), _np(rsk)
    params = LweDef(dim=32, std=1e-16)
    rvk = ref_tzkp.lwe_statement(ct, lwe, bits)
    vk = tzkp.lwe_statement(torch.from_numpy(ct_words), params, bits)
    assert (vk.a, vk.t, vk.bounds, vk.f, vk.q) == (rvk.a, rvk.t, rvk.bounds,
                                                   rvk.f, rvk.q)
    seed_reference(monkeypatch, SEED)
    want, _ = ref_tzkp.prove_lwe_encryption(ct, rsk, msg, int(e), lwe, bits)
    proof, vk = tzkp._prove(torch.from_numpy(ct_words),
                            torch.from_numpy(sk_words), msg, int(e), params,
                            bits, 16, "cpu", scalar_source(SEED))
    assert proof.to_bytes() == want.to_bytes()
    assert tzkp.verify_lwe_encryption(proof, vk, device="cpu")
    assert ref_tzkp.verify_lwe_encryption(
        ref_lr.LogProof.from_bytes(proof.to_bytes()), rvk)
    ct_words[-1] += 1
    assert not tzkp.verify_lwe_encryption(
        proof, tzkp.lwe_statement(ct_words, params, bits), device="cpu")
