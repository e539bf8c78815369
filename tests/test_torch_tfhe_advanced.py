"""The rest of the port's TFHE (sunscreen_tpu_torch.tfhe) against the JAX
package at LWE dim 8 and N=256: LWE arithmetic, GLEV, the public keys,
the multifunctional, bivariate and generalized PBS, circuit
bootstrapping, the private and public functional keyswitches, the scheme
switch and the GLWE keyswitch.

Deterministic ops are held bit for bit on keys and ciphertexts the
reference made, carried over with `tfhe.keys.words`; the bootstraps run
on the raw bootstrap key and on the port's NTT form of it, at radix
(8, 4): 16 digits a blind-rotation step. The reference's keys are built
once per module from one batched `encrypt_glwe` and one batched
`encrypt_lwe` (not its per-row keygen loops), and its outputs come from
`jax.jit`, its bootstraps on its NTT form of the raw key. Its 62-bit
torus plans run in its "compact" NTT mode there (`_reference_plans`): a
fraction of the unrolled stages' trace and compile time, and the same
bits, as every product is exact.
Ops that sample are held by cross-decryption: the port encrypts, or
makes a key, under the reference's secret keys and the reference
decrypts, and the reverse. A last case runs the port's own keygen
through every scenario of tests/test_tfhe_advanced.py."""

import contextlib
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunscreen_tpu.tfhe import GlweDef as RefGlweDef
from sunscreen_tpu.tfhe import LweDef as RefLweDef
from sunscreen_tpu.tfhe import RadixDecomposition as RefRadix
from sunscreen_tpu.tfhe import high_level as rhigh
from sunscreen_tpu.tfhe import ops as rops
from sunscreen_tpu.tfhe import poly as rpoly
from sunscreen_tpu.tfhe import torus as rtorus
from sunscreen_tpu_torch import _build
from sunscreen_tpu_torch.tfhe import (GlweDef, LweDef, RadixDecomposition,
                                      high_level, keys, ops, torus)

N, DIM, STD = 256, 8, 1e-16
LWE, GLWE, GLWE2 = LweDef(DIM, STD), GlweDef(1, N, STD), GlweDef(2, N, STD)
RLWE, RGLWE, RGLWE2 = (RefLweDef(DIM, STD), RefGlweDef(1, N, STD),
                       RefGlweDef(2, N, STD))
# (count, radix_log): the bootstrap key's (16 digits a step), the
# keyswitches', the GLEV / GGSW outputs', the scheme switch key's in the
# bit-exact case (3 levels: an odd count of product terms) and the
# public functional keyswitch's (n_in l terms, each traced on its own by
# the reference)
RADICES = {"fine": (8, 4), "ks": (8, 6), "out": (2, 8), "ssk": (3, 8),
           "pub": (2, 16)}
PORT = {k: RadixDecomposition(*v) for k, v in RADICES.items()}
REF = {k: RefRadix(*v) for k, v in RADICES.items()}
FNS = [lambda m: (m + 1) % 2, lambda m: m, lambda m: 1 - m]
WEIGHTS = np.zeros((3, N), np.uint64)          # f = x1 + 2 x2 X + x3 X^2
WEIGHTS[0, 0], WEIGHTS[1, 1], WEIGHTS[2, 2] = 1, 2, 1
TOL = 1 << 20                                  # noise bound of a phase


def _and(a, b):
    return a & b


def _identity(m):
    return m


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _w(a) -> torch.Tensor:
    return keys.words(a, "cpu")


def _gadget(name: str) -> np.ndarray:
    count, log = RADICES[name]
    return np.array([1 << (64 - (j + 1) * log) for j in range(count)],
                    dtype=np.uint64)


def _neg(a: np.ndarray) -> np.ndarray:
    return (-a.astype(np.int64)).astype(np.uint64)


def _negacyclic(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a b mod (X^N + 1) for integer polynomials [N], wrapping mod 2^64."""
    a, b = a.astype(np.int64), b.astype(np.int64)
    out = np.zeros(N, np.int64)
    for i in np.nonzero(a)[0]:
        out += a[i] * np.concatenate([-b[N - i:], b[:N - i]])
    return out.astype(np.uint64)


def _near(phase, want) -> bool:
    """Every phase within TOL of its message, mod 2^64."""
    d = (np.asarray(phase, np.uint64) - np.asarray(want, np.uint64))
    return bool((np.abs(d.view(np.int64)) < TOL).all())


@contextlib.contextmanager
def _reference_plans():
    """The reference's 62-bit torus plans under SUNSCREEN_TPU_NTT=compact,
    rebuilt for the rest of the process afterwards."""
    saved = os.environ.get("SUNSCREEN_TPU_NTT")
    os.environ["SUNSCREEN_TPU_NTT"] = "compact"
    rpoly.get_torus_plan.cache_clear()
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("SUNSCREEN_TPU_NTT", None)
        else:
            os.environ["SUNSCREEN_TPU_NTT"] = saved
        rpoly.get_torus_plan.cache_clear()


def _ref_decrypt(cts, sk, glwe) -> np.ndarray:
    return np.asarray(jax.jit(rops.decrypt_glwe_torus, static_argnums=2)(
        jnp.asarray(cts), jnp.asarray(sk), glwe))


@pytest.fixture(scope="module")
def ref():
    """Reference keys, ciphertexts and outputs, as numpy arrays."""
    key = jax.random.key(1313)
    out = {}
    with _reference_plans():
        lwe_sk = np.asarray(rops.generate_binary_lwe_sk(
            RLWE, jax.random.fold_in(key, 0)))
        gsk = np.asarray(rops.generate_binary_glwe_sk(
            RGLWE, jax.random.fold_in(key, 1)))
        ext = gsk.reshape(-1)
        # every size-1 key in one GLWE encryption: the bootstrap key's and
        # the scheme switch key's encryptions of zero, the cbs keys
        # GLWE(f_i(s_t) B_j) with f_0 = -s'_0 X^0 . x, f_1 = x, and the
        # public functional keyswitch key GLWE(s_t B_j)
        f = np.zeros((2, N), np.uint64)
        f[0], f[1, 0] = _neg(gsk[0]), 1
        cbs_msgs = np.concatenate([ext[None, :, None] * f[:, None],
                                   f[:, None]], 1)[:, :, None] \
            * _gadget("ks")[:, None]                     # [2, N+1, 8, N]
        pub_msgs = np.zeros((DIM, 2, N), np.uint64)
        pub_msgs[:, :, 0] = lwe_sk[:, None] * _gadget("pub")
        msgs = np.concatenate([np.zeros((DIM * 16 + 16, N), np.uint64),
                               cbs_msgs.reshape(-1, N),
                               pub_msgs.reshape(-1, N)])
        enc = np.array(jax.jit(rops.encrypt_glwe, static_argnums=2)(
            jnp.asarray(msgs), jnp.asarray(gsk), RGLWE,
            jax.random.fold_in(key, 2)))
        bsk = enc[:DIM * 16].reshape(DIM, 2, 8, 2, N)
        ssk = enc[DIM * 16:DIM * 16 + 16].reshape(1, 2, 8, 2, N)
        for i in range(2):
            for j in range(8):
                bsk[:, i, j, i, 0] += lwe_sk * _gadget("fine")[j]
                ssk[0, i, j, i] += _neg(gsk[0]) * _gadget("fine")[j]
        cut = DIM * 16 + 16 + cbs_msgs[..., 0].size
        cbs = enc[DIM * 16 + 16:cut].reshape(2, N + 1, 8, 2, N)
        pksk = enc[cut:].reshape(DIM, 2, 2, N)
        # the keyswitch key LWE(s'_t B_j) and every ciphertext in one LWE
        # encryption: multifunctional (m at 2 bits), bivariate (a, b at 4
        # bits), generalized / cbs (2 bits), public functional (4 bits)
        bits = np.array([0, 1, 0, 1], np.uint64)
        lwe_msgs = np.concatenate([
            (ext[:, None] * _gadget("ks")).reshape(-1),
            np.asarray(rtorus.encode(jnp.asarray(bits), 2)),
            np.asarray(rtorus.encode(jnp.asarray(bits[[0, 0, 1, 1]]), 4)),
            np.asarray(rtorus.encode(jnp.asarray(bits), 4)),
            np.asarray(rtorus.encode(jnp.asarray([3, 5, 7], jnp.uint64), 4))])
        lct = np.asarray(jax.jit(rops.encrypt_lwe, static_argnums=2)(
            jnp.asarray(lwe_msgs), jnp.asarray(lwe_sk), RLWE,
            jax.random.fold_in(key, 3)))
        ksk, lct = lct[:N * 8].reshape(N, 8, DIM + 1), lct[N * 8:]
        out.update(lwe_sk=lwe_sk, gsk=gsk, bsk=bsk, ssk=ssk, cbs=cbs,
                   pksk=pksk, ksk=ksk, cts=lct[:4], ca=lct[4:8],
                   cb=lct[8:12], pub_cts=lct[12:])
        args = {k: jnp.asarray(v) for k, v in out.items()}
        fine, ks, out_r = REF["fine"], REF["ks"], REF["out"]
        # the reference's bootstraps on its NTT form of the raw key: its
        # blind rotation traces and compiles in a third of the raw key's
        # time here (every CMUX of the raw key is an external product of
        # 32 transforms), with the same bits by its own contract
        rows = jax.jit(lambda b: rops.bootstrap_key_to_ntt(
            b, RGLWE, fine).rows)(args["bsk"])
        out["ntt_rows"] = np.asarray(rows)
        nbk = rops.NttBootstrapKey(rows, RGLWE, fine)

        tp_multi = rops.test_polynomial_multi(FNS, 2, RGLWE)
        out["multi"] = np.asarray(jax.jit(jax.vmap(
            lambda c, b, k: rops.programmable_bootstrap_multifunctional(
                c, tp_multi, 3, b, k, RLWE, RGLWE, fine, ks),
            (0, None, None)))(args["cts"], nbk, args["ksk"]))
        out["bivariate"] = np.asarray(jax.jit(jax.vmap(
            lambda a, b, bk, k: rops.programmable_bootstrap_bivariate(
                a, b, _and, bk, k, RLWE, RGLWE, fine, ks, 2),
            (0, 0, None, None)))(args["ca"], args["cb"], nbk, args["ksk"]))
        # the generalized PBS of m -> m is circuit_bootstrap's first half
        # (ops.py:804-808): its levels, privately keyswitched into each
        # GGSW row, are the reference's circuit bootstrap
        gen = jax.jit(jax.vmap(
            lambda c, b: rops.generalized_programmable_bootstrap(
                c, _identity, 2, b, RLWE, RGLWE, fine, out_r),
            (0, None)))(args["cts"][:2], nbk)
        out["generalized"] = np.asarray(gen)
        pfks = jax.vmap(lambda c, p: rops.private_functional_keyswitch(
            c, p, RGLWE, ks), (0, None))
        out["cbs_out"] = np.asarray(jax.jit(lambda e, p: jnp.stack([
            jnp.stack([pfks(e[:, j], p[i]) for j in range(2)], 1)
            for i in range(2)], 1))(gen, args["cbs"]))
        rng = np.random.default_rng(13)
        # deterministic ops on full-range words: the scheme switch key at
        # radix "ssk" and the GLWE keyswitch key at "pub" (2 levels: each
        # key row is one more product in the reference's trace)
        words = {k: rng.integers(0, 1 << 64, s, dtype=np.uint64) for k, s in
                 (("wide", (3, N + 1)), ("glev", (2, 2, N)),
                  ("ssk_words", (1, 2, 3, 2, N)), ("d0", (2, 2, N)),
                  ("d1", (2, 2, N)), ("ct2", (2, 3, N)),
                  ("gksk", (2, 2, 3, N)))}
        words["wide"][0, :4] = [0, 1 << 63, (1 << 64) - 1, (1 << 63) - 1]
        out.update(words)
        out["pfks"] = np.asarray(jax.jit(pfks)(words["wide"], args["cbs"][0]))
        ggsw = jax.jit(lambda g, s: rops.scheme_switch(
            g, s, RGLWE, REF["ssk"], out_r))(words["glev"],
                                              words["ssk_words"])
        out["scheme"] = np.asarray(ggsw)
        out["glev_cmux"] = np.asarray(jax.jit(lambda s, a, b: rops.glev_cmux(
            s, a, b, RGLWE, out_r))(ggsw, words["d0"], words["d1"]))
        gks = jax.jit(lambda c, k: rops.keyswitch_glwe_to_glwe(
            c, k, RGLWE2, REF["pub"]))
        out["gks"] = np.asarray(gks(words["ct2"], words["gksk"]))
        out["pub"] = np.asarray(jax.jit(
            lambda c, k, w: rops.public_functional_keyswitch(
                c, k, w, RGLWE, REF["pub"]))(args["pub_cts"], args["pksk"],
                                             jnp.asarray(WEIGHTS)))
    return out


def test_every_name_has_a_counterpart():
    """Every public function and class of the reference's tfhe/ops.py and
    every name of its high_level.py (the namespaces, the lookup tables'
    constructors and fields) exists in the port; tfhe/zkp.py is not
    ported yet."""
    missing = [name for name, obj in vars(rops).items()
               if not name.startswith("_") and callable(obj)
               and getattr(obj, "__module__", "") == rops.__name__
               and not hasattr(ops, name)]
    for cls in ("keygen", "encryption", "evaluation",
                "UnivariateLookupTable", "BivariateLookupTable"):
        ref_cls, port_cls = getattr(rhigh, cls), getattr(high_level, cls)
        missing += [f"{cls}.{name}" for name in vars(ref_cls)
                    if not name.startswith("_")
                    and not hasattr(port_cls, name)]
    fields = [p for p in inspect.signature(rhigh.UnivariateLookupTable)
              .parameters]
    assert fields == list(inspect.signature(
        high_level.UnivariateLookupTable).parameters)
    assert not missing, missing


def test_lwe_glev_and_tables_match_reference(ref):
    """lwe_add / lwe_sub / lwe_scalar_mul on full-range words,
    trivial_glev, and the multifunctional, torus and bivariate test
    polynomials (decrypt_glev is held in the cross-decryption case)."""
    a, b = ref["wide"][:2], ref["wide"][1:]
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for got, want in ((ops.lwe_add(_w(a), _w(b)), rops.lwe_add(ja, jb)),
                      (ops.lwe_sub(_w(a), _w(b)), rops.lwe_sub(ja, jb)),
                      (ops.lwe_scalar_mul(_w(a), 12345),
                       rops.lwe_scalar_mul(ja, 12345))):
        np.testing.assert_array_equal(_u64(got), np.asarray(want))
    msg = np.arange(N, dtype=np.uint64) % 4
    np.testing.assert_array_equal(
        _u64(ops.trivial_glev(_w(msg), GLWE, PORT["out"])),
        np.asarray(rops.trivial_glev(jnp.asarray(msg), RGLWE, REF["out"])))
    tables = (
        (ops.test_polynomial_multi(FNS, 2, GLWE, "cpu"),
         rops.test_polynomial_multi(FNS, 2, RGLWE)),
        (ops.test_polynomial_torus(lambda m: (m + 3) << 50, 3, GLWE, "cpu"),
         rops.test_polynomial_torus(lambda m: (m + 3) << 50, 3, RGLWE)),
        (ops.bivariate_test_polynomial(_and, 1, GLWE, 2, "cpu"),
         rops.bivariate_test_polynomial(_and, 1, RGLWE, 2)))
    for got, want in tables:
        np.testing.assert_array_equal(_u64(got), np.asarray(want))


@pytest.mark.parametrize("kind", ["raw", "ntt"])
def test_bootstraps_match_reference(ref, kind):
    """The multifunctional PBS (through the high-level table), the
    bivariate PBS (with its own test polynomial and through a
    BivariateLookupTable), the generalized PBS and the circuit bootstrap
    on the raw bootstrap key and on the port's NTT form of it; each
    output decrypts as its function says. The CPU path launches no
    kernel."""
    bsk = _w(ref["bsk"])
    if kind == "ntt":
        bsk = ops.bootstrap_key_to_ntt(bsk, GLWE, PORT["fine"])
        assert torch.equal(bsk.rows, keys.ntt_bootstrap_key_from_reference(
            ref["ntt_rows"], GLWE, PORT["fine"], "cpu").rows)
    ksk, lwe_sk = _w(ref["ksk"]), _w(ref["lwe_sk"])
    cts, fine, ks = _w(ref["cts"]), PORT["fine"], PORT["ks"]
    _build.reset_launches()
    lut = high_level.UnivariateLookupTable.trivial_multifunctional(
        FNS, GLWE, 2, "cpu")
    multi = high_level.evaluation.multifunctional_programmable_bootstrap(
        cts, lut, bsk, ksk, LWE, GLWE, fine, ks)
    np.testing.assert_array_equal(_u64(multi), ref["multi"])
    m = torch.tensor([0, 1, 0, 1])
    assert torch.equal(ops.decrypt_lwe(multi, lwe_sk, 2),
                       torch.stack([fn(m) % 4 for fn in FNS], 1))
    biv = high_level.BivariateLookupTable.trivial_from_fn(_and, GLWE, 2,
                                                          device="cpu")
    assert biv.as_univariate().plaintext_bits == 4
    ca, cb = _w(ref["ca"]), _w(ref["cb"])
    for got in (ops.programmable_bootstrap_bivariate(
            ca, cb, _and, bsk, ksk, LWE, GLWE, fine, ks, 2),
            high_level.evaluation.bivariate_programmable_bootstrap(
                ca, cb, biv, bsk, ksk, LWE, GLWE, fine, ks)):
        np.testing.assert_array_equal(_u64(got), ref["bivariate"])
    assert torch.equal(ops.decrypt_lwe(got, lwe_sk, 4),
                       torch.tensor([0, 0, 0, 1]))
    gen = ops.generalized_programmable_bootstrap(
        cts[:2], _identity, 2, bsk, LWE, GLWE, fine, PORT["out"])
    np.testing.assert_array_equal(_u64(gen), ref["generalized"])
    cbs = high_level.evaluation.circuit_bootstrap(
        cts[:2], bsk, _w(ref["cbs"]), LWE, GLWE, fine, PORT["out"], ks)
    np.testing.assert_array_equal(_u64(cbs), ref["cbs_out"])
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_keyswitches_match_reference(ref):
    """private_functional_keyswitch on full-range words, scheme_switch and
    glev_cmux under its GGSW, keyswitch_glwe_to_glwe from GLWE size 2,
    and public_functional_keyswitch, whose output decrypts to
    3 + 10 X + 7 X^2."""
    got = ops.private_functional_keyswitch(
        _w(ref["wide"]), _w(ref["cbs"][0]), GLWE, PORT["ks"])
    np.testing.assert_array_equal(_u64(got), ref["pfks"])
    ggsw = high_level.evaluation.scheme_switch(
        _w(ref["glev"]), _w(ref["ssk_words"]), GLWE, PORT["ssk"], PORT["out"])
    np.testing.assert_array_equal(_u64(ggsw), ref["scheme"])
    got = high_level.evaluation.glev_cmux(ggsw, _w(ref["d0"]), _w(ref["d1"]),
                                          GLWE, PORT["out"])
    np.testing.assert_array_equal(_u64(got), ref["glev_cmux"])
    got = ops.keyswitch_glwe_to_glwe(_w(ref["ct2"]), _w(ref["gksk"]), GLWE2,
                                     PORT["pub"])
    np.testing.assert_array_equal(_u64(got), ref["gks"])
    pub = ops.public_functional_keyswitch(
        _w(ref["pub_cts"]), _w(ref["pksk"]), _w(WEIGHTS), GLWE, PORT["pub"])
    np.testing.assert_array_equal(_u64(pub), ref["pub"])
    want = np.zeros(N, np.int64)
    want[:3] = [3, 10, 7]
    np.testing.assert_array_equal(
        ops.decrypt_glwe(pub, _w(ref["gsk"]), GLWE, 4).numpy(), want)


def test_sampling_ops_cross_decrypt(ref):
    """The port's encryptions and keys under the reference's secret keys
    decrypt by the reference, and the reference's by the port: GLEV,
    RLWE and LWE public keys and public-key encryption, RLEV,
    encrypt_lwe_return_components (e = b - <a, s> - m), every generate_*
    key of this slice row by row (GGSW rows of the scheme switch key
    through a numpy negacyclic product) and the module's reference keys;
    decrypt_glev bit for bit on the reference's GLEV."""
    gen = torch.Generator().manual_seed(31)
    lwe_sk, gsk = _w(ref["lwe_sk"]), _w(ref["gsk"])
    sk0 = ref["gsk"][0]
    out_r, rng = PORT["out"], np.random.default_rng(3)
    msg = rng.integers(0, 4, N).astype(np.uint64)
    bit = rng.integers(0, 2, N).astype(np.uint64)
    m4 = np.array([0, 5, 11, 15], np.uint64)
    enc4 = np.asarray(rtorus.encode(jnp.asarray(m4), 4))

    # the port's ciphertexts and keys, GLWE rows [rows, 2, N] with the
    # phase each must decrypt to
    glev = ops.encrypt_glev(_w(msg), gsk, GLWE, out_r, gen)
    rpk = ops.generate_rlwe_public_key(gsk, GLWE, gen)
    glwe_pub = ops.encrypt_glwe_public(torus.encode(_w(msg), 2), rpk, GLWE,
                                       gen)
    rlev = ops.encrypt_rlev_public(_w(bit), rpk, GLWE, out_r, gen)
    f_poly = np.zeros(N, np.int64)
    f_poly[:2] = [3, -2]
    pfksk = ops.generate_private_functional_keyswitch_key(
        torch.from_numpy(f_poly), lwe_sk, gsk, GLWE, PORT["ks"], gen)
    cbs = ops.generate_cbs_pfksk(ops.flatten_glwe_sk(gsk), gsk, GLWE,
                                 PORT["ks"], gen)
    ssk = ops.generate_scheme_switch_key(gsk, GLWE, PORT["fine"], gen)
    pksk = ops.generate_public_functional_keyswitch_key(
        lwe_sk, gsk, GLWE, PORT["pub"], gen)
    assert (tuple(pfksk.shape), tuple(cbs.shape), tuple(ssk.shape),
            tuple(pksk.shape)) == ((DIM + 1, 8, 2, N), (2, N + 1, 8, 2, N),
                                   (1, 2, 8, 2, N), (DIM, 2, 2, N))
    g_out, g_ks, g_fine = _gadget("out"), _gadget("ks"), _gadget("fine")
    f_u = f_poly.astype(np.uint64)
    one = np.ones(1, np.uint64)
    s_ext = np.concatenate([ref["lwe_sk"], one])
    cbs_f = np.stack([_neg(sk0), np.eye(1, N, dtype=np.uint64)[0]])
    ext = np.concatenate([ref["gsk"].reshape(-1), one])
    unit = np.stack([_negacyclic(sk0, sk0), _neg(sk0)])   # (-s) u_i phases
    pub_w = np.zeros((DIM, 2, N), np.uint64)
    pub_w[:, :, 0] = ref["lwe_sk"][:, None] * _gadget("pub")
    rows = [(glev, msg[None] * g_out[:, None]),
            (rpk.unsqueeze(0), np.zeros((1, N), np.uint64)),
            (glwe_pub, np.asarray(rtorus.encode(jnp.asarray(msg), 2))[None]),
            (rlev, bit[None] * g_out[:, None]),
            (pfksk, s_ext[:, None, None] * f_u * g_ks[:, None]),
            (cbs, ext[None, :, None, None] * cbs_f[:, None, None]
             * g_ks[:, None]),
            (ssk, unit[None, :, None] * g_fine[:, None]),
            (pksk, pub_w)]
    cts = torch.cat([c.reshape(-1, 2, N) for c, _ in rows])
    want = np.concatenate([w.reshape(-1, N) for _, w in rows])
    # size 2: the GLWE keyswitch key GLEV(s_i) under another key
    from_sk = rng.integers(0, 2, (2, N)).astype(np.uint64)
    to_sk = rng.integers(0, 2, (2, N)).astype(np.uint64)
    gksk = ops.generate_glwe_keyswitch_key(_w(from_sk), _w(to_sk), GLWE2,
                                           PORT["ks"], gen)
    lpk = ops.generate_lwe_public_key(lwe_sk, LWE, 64, gen)
    lwe_pub = ops.encrypt_lwe_public(_w(enc4), lpk, LWE, gen)
    ct_e, e = ops.encrypt_lwe_return_components(_w(enc4), lwe_sk, LWE, gen)

    def reference(msg, bit, enc4, rsk, rgsk, key):
        """The reference's encryptions (decrypted by the port below) and
        its decrypt_glev of its GLEV, in one trace."""
        k = [jax.random.fold_in(key, i) for i in range(7)]
        glev = rops.encrypt_glev(msg, rgsk, RGLWE, REF["out"], k[0])
        pk = rops.generate_rlwe_public_key(rgsk, RGLWE, k[1])
        lpk = rops.generate_lwe_public_key(rsk, RLWE, 64, k[4])
        return dict(
            glev=glev, glev_dec=rops.decrypt_glev(glev, rgsk, RGLWE,
                                                  REF["out"]),
            pk=pk, pub=rops.encrypt_glwe_public(rtorus.encode(msg, 2), pk,
                                                RGLWE, k[2]),
            rlev=rops.encrypt_rlev_public(bit, pk, RGLWE, REF["out"], k[3]),
            lpk=lpk, lwe_pub=jax.vmap(lambda m, kk: rops.encrypt_lwe_public(
                m, lpk, RLWE, kk))(enc4, jax.random.split(k[5], 4)),
            ce=rops.encrypt_lwe_return_components(enc4, rsk, RLWE, k[6]))

    rsk = jnp.asarray(ref["lwe_sk"])
    with _reference_plans():
        assert _near(_ref_decrypt(_u64(cts), ref["gsk"], RGLWE), want)
        assert _near(_ref_decrypt(_u64(gksk), to_sk, RGLWE2),
                     from_sk[:, None] * g_ks[:, None])
        for ct in (lwe_pub, ct_e):
            np.testing.assert_array_equal(np.asarray(rops.decrypt_lwe(
                jnp.asarray(_u64(ct)), rsk, 4)), m4)
        phase = np.asarray(rops.decrypt_lwe_torus(jnp.asarray(_u64(ct_e)),
                                                  rsk))
        r = jax.tree.map(np.asarray, jax.jit(reference)(
            jnp.asarray(msg), jnp.asarray(bit), jnp.asarray(enc4), rsk,
            jnp.asarray(ref["gsk"]), jax.random.key(77)))
    (r_ct, r_e) = r["ce"]
    np.testing.assert_array_equal(_u64(e), phase - enc4)
    got = ops.decrypt_glev(_w(r["glev"]), gsk, GLWE, out_r)
    np.testing.assert_array_equal(_u64(got), r["glev_dec"])
    np.testing.assert_array_equal(r["glev_dec"], msg)
    assert torch.equal(ops.decrypt_glwe(_w(r["pub"]), gsk, GLWE, 2), _w(msg))
    assert torch.equal(ops.decrypt_glev(_w(r["rlev"]), gsk, GLWE, out_r),
                       _w(bit))
    assert _near(_u64(ops.decrypt_glwe_torus(_w(r["pk"]), gsk, GLWE)), 0)
    assert _near(_u64(ops.decrypt_lwe_torus(_w(r["lpk"]), lwe_sk)), 0)
    for ct in (r["lwe_pub"], r_ct):
        assert torch.equal(ops.decrypt_lwe(_w(ct), lwe_sk, 4), _w(m4))
    np.testing.assert_array_equal(
        _u64(ops.decrypt_lwe_torus(_w(r_ct), lwe_sk)) - enc4,
        np.asarray(r_e).astype(np.uint64))
    # the module's reference keys (the reference's layouts) by the port
    for kind, want in (("cbs", ext[None, :, None, None] * cbs_f[:, None, None]
                        * g_ks[:, None]), ("pksk", pub_w),
                       ("ssk", unit[None, :, None] * g_fine[:, None])):
        phase = ops.decrypt_glwe_torus(_w(ref[kind]).reshape(-1, 2, N), gsk,
                                       GLWE)
        assert _near(_u64(phase), want.reshape(-1, N)), kind


def test_native_keys_scenarios():
    """The port's own keygen through tests/test_tfhe_advanced.py's
    scenarios: circuit-bootstrapped and scheme-switched GGSWs of a bit
    drive a CMUX, the multifunctional PBS gives its three functions, the
    bivariate PBS a AND b, the generalized PBS 1 - m on every level, the
    GLWE keyswitch and the public functional keyswitch keep their
    messages, and public-key LWE encryption decrypts."""
    gen = torch.Generator().manual_seed(17)
    kg, enc = high_level.keygen, high_level.encryption
    fine, ks, out_r = PORT["fine"], PORT["ks"], PORT["out"]
    lwe_sk = kg.generate_binary_lwe_sk(LWE, gen, "cpu")
    gsk = kg.generate_binary_glwe_sk(GLWE, gen, "cpu")
    ext = ops.flatten_glwe_sk(gsk)
    bsk = ops.bootstrap_key_to_ntt(kg.generate_bootstrapping_key(
        lwe_sk, gsk, LWE, GLWE, fine, gen), GLWE, fine)
    ksk = kg.generate_ksk(ext, lwe_sk, LWE, ks, gen)
    cbs_key = kg.generate_cbs_ksk(ext, gsk, GLWE, ks, gen)
    ssk = kg.generate_scheme_switch_key(gsk, GLWE, fine, gen)
    data = torch.arange(N) % 4
    c0 = enc.encrypt_glwe(torus.encode(torch.zeros(N, dtype=torch.int64), 2),
                          gsk, GLWE, gen)
    c1 = enc.encrypt_glwe(torus.encode(data, 2), gsk, GLWE, gen)
    bits = torch.tensor([0, 1])
    cts = enc.encrypt_lwe(torus.encode(bits, 2), lwe_sk, LWE, gen)
    ggsws = ops.circuit_bootstrap(cts, bsk, cbs_key, LWE, GLWE, fine, out_r,
                                  ks)
    glevs = enc.encrypt_glev(bits.unsqueeze(-1) * (torch.arange(N) == 0),
                             gsk, GLWE, out_r, gen)
    for g_cbs, g_ss, bit in zip(ggsws, ops.scheme_switch(
            glevs, ssk, GLWE, fine, out_r), bits):
        for ggsw in (g_cbs, g_ss):
            got = enc.decrypt_glwe(ops.cmux(ggsw, c0, c1, GLWE, out_r), gsk,
                                   GLWE, 2)
            assert torch.equal(got, data * bit)
    m = torch.tensor([0, 1])
    multi = ops.programmable_bootstrap_multifunctional(
        cts, ops.test_polynomial_multi(FNS, 2, GLWE, "cpu"), 3, bsk, ksk,
        LWE, GLWE, fine, ks)
    assert torch.equal(enc.decrypt_lwe(multi, lwe_sk, 2),
                       torch.stack([fn(m) % 4 for fn in FNS], 1))
    a, b = torch.tensor([0, 0, 1, 1]), torch.tensor([0, 1, 0, 1])
    got = ops.programmable_bootstrap_bivariate(
        enc.encrypt_lwe(torus.encode(a, 4), lwe_sk, LWE, gen),
        enc.encrypt_lwe(torus.encode(b, 4), lwe_sk, LWE, gen), _and, bsk,
        ksk, LWE, GLWE, fine, ks, 2)
    assert torch.equal(enc.decrypt_lwe(got, lwe_sk, 4), a & b)
    lev = ops.generalized_programmable_bootstrap(
        cts, lambda x: 1 - x, 2, bsk, LWE, GLWE, fine, out_r)
    for j in range(out_r.count):          # round(phase / B_j) mod 2^8
        phase = ops.decrypt_lwe_torus(lev[:, j], ext)
        got = torus.decode(phase, (j + 1) * out_r.radix_log)
        assert torch.equal(got % (1 << out_r.radix_log), 1 - m)
    from_sk = kg.generate_binary_glwe_sk(GLWE2, gen, "cpu")
    to_sk = kg.generate_binary_glwe_sk(GLWE2, gen, "cpu")
    msgs = torch.arange(N) % 16
    ct = enc.encrypt_glwe(torus.encode(msgs, 4), from_sk, GLWE2, gen)
    gksk = ops.generate_glwe_keyswitch_key(from_sk, to_sk, GLWE2, ks, gen)
    assert torch.equal(enc.decrypt_glwe(ops.keyswitch_glwe_to_glwe(
        ct, gksk, GLWE2, ks), to_sk, GLWE2, 4), msgs)
    pksk = ops.generate_public_functional_keyswitch_key(lwe_sk, gsk, GLWE,
                                                        PORT["pub"], gen)
    pub_cts = enc.encrypt_lwe(torus.encode(torch.tensor([3, 5, 7]), 4),
                              lwe_sk, LWE, gen)
    got = enc.decrypt_glwe(ops.public_functional_keyswitch(
        pub_cts, pksk, _w(WEIGHTS), GLWE, PORT["pub"]), gsk, GLWE, 4)
    assert got[:3].tolist() == [3, 10, 7] and not got[3:].any()
    lpk = kg.generate_lwe_pk(lwe_sk, LWE, 64, gen)
    m4 = torch.tensor([0, 5, 11, 15])
    assert torch.equal(enc.decrypt_lwe(ops.encrypt_lwe_public(
        torus.encode(m4, 4), lpk, LWE, gen), lwe_sk, 4), m4)
