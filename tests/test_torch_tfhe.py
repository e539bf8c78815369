"""The port's TFHE slice (sunscreen_tpu_torch.tfhe) against the JAX
package, bit for bit, on keys and ciphertexts the reference made:
sample extraction, LWE keyswitching, blind rotation (raw and NTT-domain
bootstrap keys, GLWE sizes 1 and 2) and the univariate programmable
bootstrap under SUNSCREEN_TPU_TFHE_KSFULL 0 and 1, carried over with
`tfhe.keys`. The reference's keys are built once per module at LWE dim
8 and N=256: every GGSW row of the bootstrap key comes from one batched
`encrypt_glwe` call, and the keyswitch key and the ciphertexts from one
batched `encrypt_lwe` call (the same keys on both sides, not the
reference keygen's stream).
A last test runs the port's own keygen end to end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunscreen_tpu.tfhe import GlweDef as RefGlweDef
from sunscreen_tpu.tfhe import LweDef as RefLweDef
from sunscreen_tpu.tfhe import RadixDecomposition as RefRadix
from sunscreen_tpu.tfhe import ops as rops
from sunscreen_tpu.tfhe import torus as rtorus
from sunscreen_tpu_torch import _build
from sunscreen_tpu_torch.tfhe import (GlweDef, LweDef, RadixDecomposition,
                                      high_level, keys, ops, torus)

N, DIM, STD = 256, 8, 1e-16
LWE = LweDef(DIM, STD)
GLWE = {s: GlweDef(s, N, STD) for s in (1, 2)}
PBS_RADIX = RadixDecomposition(3, 4)
KS_RADIX = RadixDecomposition(8, 6)


def _fn(m):
    return (m + 1) % 2


def _out_bits(size: int):
    """GLWE size 1 runs the reference bench's unpadded LUT (1 output
    bit); size 2 the chainable default."""
    return 1 if size == 1 else None


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


@pytest.fixture(scope="module")
def ref():
    """Reference keys, ciphertexts and outputs, as numpy arrays."""
    key = jax.random.key(404)
    rlwe, rpbs, rks = RefLweDef(DIM, STD), RefRadix(3, 4), RefRadix(8, 6)
    enc_lwe = jax.jit(rops.encrypt_lwe, static_argnums=(2,))
    enc_glwe = jax.jit(rops.encrypt_glwe, static_argnums=(2,))
    lwe_sk = rops.generate_binary_lwe_sk(rlwe, jax.random.fold_in(key, 0))
    gsks = {size: rops.generate_binary_glwe_sk(
        RefGlweDef(size, N, STD), jax.random.fold_in(key, 10 * size))
        for size in (1, 2)}
    # the ciphertexts and the keyswitch key KSK_{i,j} = LWE(s_i B_j) in
    # one batched encryption
    gadget = jnp.asarray([1 << (64 - 6 * (j + 1)) for j in range(8)],
                         dtype=jnp.uint64)
    msgs = jnp.concatenate([
        rtorus.encode(jnp.arange(3, dtype=jnp.uint64) % 2, 2),
        (rops.flatten_glwe_sk(gsks[1])[:, None] * gadget).reshape(-1)])
    both = enc_lwe(msgs, lwe_sk, rlwe, jax.random.fold_in(key, 1))
    cts, ksk = both[:3], both[3:].reshape(N, 8, DIM + 1)
    out = {"lwe_sk": np.asarray(lwe_sk), "cts": np.asarray(cts),
           "ksk": np.asarray(ksk)}
    bits = np.asarray(lwe_sk)
    for size in (1, 2):
        glwe = RefGlweDef(size, N, STD)
        gsk = gsks[size]
        # rows (i, j) of GGSW(bit): GLWE(0) + bit * B_j on component i
        bsk = np.array(enc_glwe(
            jnp.zeros((DIM, size + 1, 3, N), jnp.uint64), gsk, glwe,
            jax.random.fold_in(key, 10 * size + 1)))
        for i in range(size + 1):
            for j in range(3):
                bsk[:, i, j, i, 0] += bits * np.uint64(1 << (60 - 4 * j))
        nbk = rops.NttBootstrapKey(jax.jit(
            lambda b: rops.bootstrap_key_to_ntt(b, glwe, rpbs).rows)(
            jnp.asarray(bsk)), glwe, rpbs)
        tp = rops.test_polynomial_for(_fn, 2, glwe,
                                      output_bits=_out_bits(size))
        rot = jax.vmap(lambda c: rops.blind_rotate(tp, c, nbk, glwe, rpbs))(
            cts)
        out[size] = {"glwe_sk": np.asarray(gsk), "bsk": bsk,
                     "ntt_rows": np.asarray(nbk.rows), "tp": np.asarray(tp),
                     "rot": np.asarray(rot)}
    glwe1 = RefGlweDef(1, N, STD)
    rot1 = jnp.asarray(out[1]["rot"])
    out["extract"] = {h: np.asarray(rops.sample_extract(rot1, glwe1, h))
                      for h in (0, 5)}
    # the reference's PBS is blind_rotate -> sample_extract -> keyswitch
    keyswitch = jax.jit(jax.vmap(
        lambda c, k: rops.keyswitch_lwe_to_lwe(c, k, rlwe, rks), (0, None)))
    out["pbs"] = np.asarray(keyswitch(jnp.asarray(out["extract"][0]), ksk))
    out["pbs_dec"] = np.asarray(rops.decrypt_lwe(jnp.asarray(out["pbs"]),
                                                 lwe_sk, 1))
    # a full-range LWE ciphertext of dim kN for the keyswitch alone
    wide = np.random.default_rng(8).integers(0, 1 << 64, (2, N + 1),
                                             dtype=np.uint64)
    wide[:, :4] = [0, 1 << 63, (1 << 64) - 1, (1 << 63) - 1]
    out["wide"] = wide
    out["wide_ks"] = np.asarray(keyswitch(jnp.asarray(wide), ksk))
    return out


@pytest.mark.parametrize("coeff", [0, 5])
def test_sample_extract_matches_reference(ref, coeff):
    got = ops.sample_extract(keys.words(ref[1]["rot"], "cpu"), GLWE[1],
                             coeff)
    np.testing.assert_array_equal(_u64(got), ref["extract"][coeff])


def test_keyswitch_matches_reference(ref):
    """keyswitch_lwe_to_lwe on the extracted ciphertexts and on
    full-range words: the exact float64 product over 16-bit limbs. Then
    wide digits at n_in = 1024, n_out = 8, uniform words from numpy: one
    28-bit digit (where the port raised before the digits were split
    into 16-bit pieces too) and two 32-bit digits."""
    ksk = keys.words(ref["ksk"], "cpu")
    for ct, want in ((ref["extract"][0], ref["pbs"]),
                     (ref["wide"], ref["wide_ks"])):
        got = ops.keyswitch_lwe_to_lwe(keys.words(ct, "cpu"), ksk, LWE,
                                       KS_RADIX)
        np.testing.assert_array_equal(_u64(got), want)
    rng = np.random.default_rng(0)
    n_in = 1024
    for count, radix_log in ((1, 28), (2, 32)):
        ct = rng.integers(0, 1 << 64, (n_in + 1,), dtype=np.uint64)
        wide_ksk = rng.integers(0, 1 << 64, (n_in, count, DIM + 1),
                                dtype=np.uint64)
        want = np.asarray(rops.keyswitch_lwe_to_lwe(
            jnp.asarray(ct), jnp.asarray(wide_ksk), RefLweDef(DIM, STD),
            RefRadix(count, radix_log)))
        got = ops.keyswitch_lwe_to_lwe(
            keys.words(ct, "cpu"), keys.words(wide_ksk, "cpu"), LWE,
            RadixDecomposition(count, radix_log))
        np.testing.assert_array_equal(_u64(got), want)


@pytest.mark.parametrize("size", [1, 2])
def test_blind_rotate_matches_reference(ref, size):
    """The raw-key path (2-prime CRT per CMUX), the port's own NTT key and
    the reference's NTT key carried over all give the reference's bits;
    size 1 runs B1 + B5's twins, size 2 B1 + a plain contraction + B3."""
    glwe, r = GLWE[size], ref[size]
    tp = ops.test_polynomial_for(_fn, 2, glwe, output_bits=_out_bits(size),
                                 device="cpu")
    np.testing.assert_array_equal(_u64(tp), r["tp"])
    bsk = keys.words(r["bsk"], "cpu")
    ntt_bsk = ops.bootstrap_key_to_ntt(bsk, glwe, PBS_RADIX)
    carried = keys.ntt_bootstrap_key_from_reference(r["ntt_rows"], glwe,
                                                    PBS_RADIX, "cpu")
    assert torch.equal(ntt_bsk.rows, carried.rows)
    cts = keys.words(ref["cts"], "cpu")
    for key in (ntt_bsk, bsk):
        got = ops.blind_rotate(tp, cts, key, glwe, PBS_RADIX)
        np.testing.assert_array_equal(_u64(got), r["rot"])


@pytest.mark.parametrize("ksfull", ["0", "1"])
def test_pbs_matches_reference(ref, monkeypatch, ksfull):
    """programmable_bootstrap_univariate on the reference's keys and
    ciphertexts; the CPU path launches no kernel."""
    monkeypatch.setenv("SUNSCREEN_TPU_TFHE_KSFULL", ksfull)
    glwe = GLWE[1]
    bsk = keys.ntt_bootstrap_key_from_reference(ref[1]["ntt_rows"], glwe,
                                                PBS_RADIX, "cpu")
    tp = keys.words(ref[1]["tp"], "cpu")
    _build.reset_launches()
    got = ops.programmable_bootstrap_univariate(
        keys.words(ref["cts"], "cpu"), tp, bsk, keys.words(ref["ksk"], "cpu"),
        LWE, glwe, PBS_RADIX, KS_RADIX)
    assert all(v == 0 for v in _build.LAUNCHES.values())
    np.testing.assert_array_equal(_u64(got), ref["pbs"])
    lwe_sk = keys.words(ref["lwe_sk"], "cpu")
    np.testing.assert_array_equal(ops.decrypt_lwe(got, lwe_sk, 1).numpy(),
                                  ref["pbs_dec"])
    np.testing.assert_array_equal(ref["pbs_dec"], [1, 0, 1])


def test_decrypt_matches_reference(ref):
    """decrypt_lwe and decrypt_lwe_with_carry on the reference's
    ciphertexts; the GLWE rows of its bootstrap key decrypt (through the
    port's 3-prime mask . key dot) to bit * B_j plus the noise."""
    lwe_sk = keys.words(ref["lwe_sk"], "cpu")
    cts = keys.words(ref["cts"], "cpu")
    rsk, rcts = jnp.asarray(ref["lwe_sk"]), jnp.asarray(ref["cts"])
    np.testing.assert_array_equal(
        ops.decrypt_lwe(cts, lwe_sk, 2).numpy(),
        np.asarray(rops.decrypt_lwe(rcts, rsk, 2)))
    np.testing.assert_array_equal(
        ops.decrypt_lwe_with_carry(cts, lwe_sk, 1, 1).numpy(),
        np.asarray(rops.decrypt_lwe_with_carry(rcts, rsk, 1, 1)))
    glwe = GLWE[1]
    bsk = keys.words(ref[1]["bsk"], "cpu")
    gsk = keys.words(ref[1]["glwe_sk"], "cpu")
    phase = ops.decrypt_glwe_torus(bsk[:, 1], gsk, glwe)    # body rows
    want = torch.zeros_like(phase)
    for j in range(3):
        want[:, j, 0] = lwe_sk * (1 << (60 - 4 * j))
    assert int((phase - want).abs().max()) < 1 << 20


def test_native_keygen_pbs_roundtrip():
    """The port's own keygen from a torch generator (binary keys, the
    batched bootstrap and keyswitch keys), through the high-level API:
    every PBS output decrypts to (m + 1) mod 2, and the raw and NTT keys
    give the same bits."""
    lwe, glwe = LweDef(16, STD), GLWE[1]
    gen = torch.Generator().manual_seed(9)
    kg, enc, ev = high_level.keygen, high_level.encryption, \
        high_level.evaluation
    lwe_sk = kg.generate_binary_lwe_sk(lwe, gen, "cpu")
    glwe_sk = kg.generate_binary_glwe_sk(glwe, gen, "cpu")
    bsk = kg.generate_bootstrapping_key(lwe_sk, glwe_sk, lwe, glwe,
                                        PBS_RADIX, gen)
    ksk = kg.generate_ksk(ops.flatten_glwe_sk(glwe_sk), lwe_sk, lwe,
                          KS_RADIX, gen)
    assert bsk.shape == (16, 2, 3, 2, N) and ksk.shape == (N, 8, 17)
    lut = high_level.UnivariateLookupTable.trivial_from_fn(
        _fn, glwe, 2, output_bits=1, device="cpu")
    msgs = torch.arange(4) % 2
    cts = enc.encrypt_lwe(torus.encode(msgs, 2), lwe_sk, lwe, gen)
    assert torch.equal(enc.decrypt_lwe(cts, lwe_sk, 2), msgs)
    outs = [ev.univariate_programmable_bootstrap(
        cts, lut, key, ksk, lwe, glwe, PBS_RADIX, KS_RADIX)
        for key in (ops.bootstrap_key_to_ntt(bsk, glwe, PBS_RADIX), bsk)]
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(enc.decrypt_lwe(outs[0], lwe_sk, lut.plaintext_bits),
                       (msgs + 1) % 2)
    # uniform 64-bit keys decrypt exactly (wrapping LWE dot, 3-prime GLWE
    # dot); a GGSW of 1 selects the second input of a CMUX
    usk = kg.generate_uniform_lwe_sk(lwe, gen, "cpu")
    assert torch.equal(enc.decrypt_lwe(enc.encrypt_lwe(
        torus.encode(msgs, 2), usk, lwe, gen), usk, 2), msgs)
    assert torch.equal(enc.decrypt_lwe(enc.trivial_lwe(
        torus.encode(msgs, 2), lwe, "cpu"), usk, 2), msgs)
    polys = torch.arange(2 * N).reshape(2, N) % 4
    ugsk = kg.generate_uniform_glwe_sk(glwe, gen, "cpu")
    assert torch.equal(enc.decrypt_glwe(enc.encrypt_glwe(
        torus.encode(polys, 2), ugsk, glwe, gen), ugsk, glwe, 2), polys)
    d0, d1 = enc.encrypt_glwe(torus.encode(polys, 2), glwe_sk, glwe, gen)
    sel = enc.encrypt_ggsw(1, glwe_sk, glwe, PBS_RADIX, gen)
    assert torch.equal(enc.decrypt_glwe(ev.cmux(sel, d0, d1, glwe,
                                                PBS_RADIX), glwe_sk, glwe, 2),
                       polys[1])
