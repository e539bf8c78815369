"""The port's linked proofs (`sunscreen_tpu_torch.runtime.linked`: SDLP +
Bulletproofs R1CS + the compressed bridge, `LogProofBuilder`) held against
the JAX package on the CPU at the reference tests' parameters
(`tests/test_linked.py`: `BfvParams.insecure(64, limbs=1, limb_bits=28)`).

The packages sample differently, so the reference's ciphertexts and their
encryption components (u, e0, e1) reach the port's builder through its
private `_record_encryptions`, with the reference's public key carried into
the port's NTT domain ("matmul" at N = 64). Under one seeded source of
blindings on both sides (the reference's `secrets` in `runtime.linked` and
`logproof.linear_relation`, `inner_product._rand` and `r1cs._rand_scalar`
patched with `scalar_source(seed)`, the port's builder given the same
source), the linked proofs must be equal byte for byte. The reference's
eager encryption, decryption and public-key transform run under `jax.jit`
here (`jit_reference`: its ops otherwise compile one by one). Everything
is exact: no tolerance. No `from __future__ import annotations`: the ZKP
DSL reads its programs' annotations as objects."""

import contextlib
import dataclasses
import functools
import io
import os
import struct

import jax
import numpy as np
import pytest
import torch

import sunscreen_tpu.bfv.ops as ref_bops
import sunscreen_tpu.logproof.inner_product as ref_ipp
import sunscreen_tpu.logproof.linear_relation as ref_lr
import sunscreen_tpu.runtime.linked as ref_linked
import sunscreen_tpu.zk.r1cs as ref_r1cs
import sunscreen_tpu_torch.runtime.runtime as port_runtime
from sunscreen_tpu import types as rtypes
from sunscreen_tpu.bfv import BfvParams as RefParams
from sunscreen_tpu.runtime import Runtime as RefRuntime
from sunscreen_tpu.types import zkp_types as rz
from sunscreen_tpu_torch import types as ptypes
from sunscreen_tpu_torch.bfv import BfvParams, keys
from sunscreen_tpu_torch.math import ntt
from sunscreen_tpu_torch.runtime import (Ciphertext, PrivateKey,
                                         PublicKeySet, Runtime)
from sunscreen_tpu_torch.runtime.linked import LinkedProof, LogProofBuilder
from sunscreen_tpu_torch.types import zkp_types as pz
from sunscreen_tpu_torch.zk import curve25519 as cv
from sunscreen_tpu_torch.zk.r1cs import scalar_source

PARAMS = dict(poly_degree=64, limbs=1, limb_bits=28)
EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "private_tx_linkedproof.py")


def programs(z):
    """tests/test_linked.py's programs in the package of `z`, a
    `types.zkp_types` module."""
    Field, Private, Public = z.Field, z.Private, z.Public

    @z.zkp_program()
    def in_range(x: Private[Field]):
        x.to_unsigned(8)

    @z.zkp_program()
    def equals_public(x: Private[Field], y: Public[Field]):
        x.constrain_eq(y)

    @z.zkp_program()
    def in_balance(balance: z.Linked[z.BfvSigned],
                   unshielded: Public[Field]):
        diff = balance.into_field_elem() - unshielded
        diff.to_unsigned(16)
        unshielded.to_unsigned(16)

    @z.zkp_program()
    def rational_prog(x: z.Linked[z.BfvRational]):
        num, den = x.into_field_elems()
        num.constrain_eq(num)
        del den

    return {"in_range": in_range, "equals_public": equals_public,
            "in_balance": in_balance, "rational_prog": rational_prog}


# scenario: (program, type, value, encryption seed, public inputs)
SCENARIOS = {
    "values": ("in_range", "Unsigned64", 200, 11, []),
    "equality": ("equals_public", "Unsigned64", 77, 12, [77]),
    "signed": ("equals_public", "Signed", -42, 16, [(-42) % cv.L]),
    "wires": ("in_balance", "Signed", 1000, 22, [400]),
}


class _Secrets:
    def __init__(self, draw):
        self.randbelow = lambda n: draw()


def seed_reference(mp, seed: int) -> None:
    """Every blinding of the reference's linked proofs from one
    `scalar_source(seed)`, in the order its builder draws them."""
    draw = scalar_source(seed)
    mp.setattr(ref_linked, "secrets", _Secrets(draw))
    mp.setattr(ref_lr, "secrets", _Secrets(draw))
    mp.setattr(ref_ipp, "_rand", draw)
    mp.setattr(ref_r1cs, "_rand_scalar", draw)


def jit_reference(mp, ctx) -> None:
    """The reference's eager encryption, decryption and public-key
    transform (`logproof/bfv_statement._ntt_pk_to_coeff`) on `ctx` under
    `jax.jit`: the same computations, without compiling their ops one by
    one (tens of seconds on the CPU)."""
    for name in ("encrypt_return_components", "decrypt"):
        fn = jax.jit(functools.partial(getattr(ref_bops, name), ctx))
        mp.setattr(ref_bops, name, lambda _ctx, *args, fn=fn: fn(*args))
    mp.setattr(ctx.plan_q, "inv", jax.jit(ctx.plan_q.inv))


@pytest.fixture(scope="module")
def env():
    """Both runtimes with the reference's keys (seed 3), the port's carried
    from the reference's "unrolled" domain, both packages' programs, and a
    cache of the scenarios' proofs (`build`)."""
    with pytest.MonkeyPatch.context() as mp:
        rrt = RefRuntime.new_fhe_zkp(RefParams.insecure(**PARAMS))
        jit_reference(mp, rrt.ctx)
        rpub, rpriv = rrt.generate_keys(seed=3, galois=False, relin=False)
        prt = Runtime.new_fhe_zkp(BfvParams.insecure(**PARAMS),
                                  device="cpu")
        ctx = prt.ctx
        src = ntt.get_plan(ctx.n, ctx.q_base.moduli, "cpu", "unrolled")

        def carry(a):
            return ctx.plan_q.fwd(src.inv(torch.from_numpy(
                np.asarray(a).astype(np.int64))))

        rp = rpub.public_key
        pub = PublicKeySet(keys.PublicKey(carry(rp.p0), carry(rp.p1)))
        sk, _, _ = keys.from_reference(
            ctx, s=np.asarray(rpriv.sk.s).astype(np.int64))
        e = {"rrt": rrt, "rpub": rpub, "rpriv": rpriv, "prt": prt,
             "pub": pub, "priv": PrivateKey(sk),
             "ref_progs": programs(rz), "progs": programs(pz), "built": {}}
        yield e


def port_builder(env, rb, seed: int, tcls, link=True):
    """A port builder holding the reference builder `rb`'s encryptions,
    one typed value a message; returns it and the (ciphertext, link)
    pairs."""
    pb = LogProofBuilder(env["prt"], rand_scalar=scalar_source(seed))
    st, out = rb.statements, []
    for mid, msg in enumerate(st.messages):
        idx = [i for i, s in enumerate(st.statements) if s.message_id == mid]
        out.append(pb._record_encryptions(
            tcls, [msg], [st.statements[i].ct for i in idx],
            [(w.u, w.e0, w.e1) for w in (st.witnesses[i] for i in idx)],
            env["pub"].public_key, link))
    return pb, out


def build(env, name: str):
    """(reference proof, port proof, port ciphertext, port link) of a
    scenario, both under the seed 100 + its encryption seed."""
    if name not in env["built"]:
        prog, tname, value, seed, public = SCENARIOS[name]
        with pytest.MonkeyPatch.context() as mp:
            seed_reference(mp, 100 + seed)
            rb = ref_linked.LogProofBuilder(env["rrt"])
            rb.encrypt_returning_link(getattr(rtypes, tname)(value),
                                      env["rpub"], seed=seed)
            want = rb.build_linked(env["ref_progs"][prog],
                                   public_inputs=public)
        pb, [(ct, link)] = port_builder(env, rb, 100 + seed,
                                        getattr(ptypes, tname))
        got = pb.build_linked(env["progs"][prog], public_inputs=public)
        env["built"][name] = (want, got, ct, link)
    return env["built"][name]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_linked_matches_reference(env, name):
    """tests/test_linked.py's values-mode range proof, public equality, a
    signed negative value and the typed (wires-mode) balance proof: the
    port's proof equal to the reference's byte for byte, verifying with
    its link pinned, refused under the wrong public input or pins, and its
    ciphertext decrypting to the value."""
    prog_name, tname, value, _, public = SCENARIOS[name]
    want, got, ct, link = build(env, name)
    assert got.to_bytes() == want.to_bytes()
    prog = env["progs"][prog_name]
    mid = link.message_id
    assert link.value == value % cv.L
    assert env["prt"].decrypt(ct, env["priv"]) == value
    if name == "wires":
        assert got.verify(prog, public_inputs=public)
        assert not got.verify(prog, public_inputs=[40000])
        assert got.size_bytes()["bridge"] < 4096
        return
    assert got.verify(prog, public_inputs=public, expected_link_count=1)
    assert got.verify(prog, public_inputs=public, expected_message_ids=[mid])
    assert not got.verify(prog, public_inputs=public,
                          expected_message_ids=[mid + 1])
    # values mode needs the link pinned: unpinned or miscounted fails
    assert not got.verify(prog, public_inputs=public)
    assert not got.verify(prog, public_inputs=public, expected_link_count=2)
    if public:
        assert not got.verify(prog, public_inputs=[42],
                              expected_link_count=1)


def test_decrypt_returning_link_matches_reference(env):
    """`decrypt_returning_link` on the reference's ciphertext of 99: the
    same Decryption statement and linked proof, byte for byte."""
    rct = env["rrt"].encrypt(rtypes.Unsigned64(99), env["rpub"], seed=17)
    ct = Ciphertext(rct.type_name, [torch.from_numpy(
        np.asarray(c).astype(np.int64)) for c in rct.cts],
        env["prt"].params)
    with pytest.MonkeyPatch.context() as mp:
        seed_reference(mp, 117)
        rb = ref_linked.LogProofBuilder(env["rrt"])
        rb.decrypt_returning_link(rct, env["rpriv"])
        want = rb.build_linked(env["ref_progs"]["equals_public"],
                               public_inputs=[99])
    pb = LogProofBuilder(env["prt"], rand_scalar=scalar_source(117))
    value, link = pb.decrypt_returning_link(ct, env["priv"])
    assert value == 99 and link.value == 99
    got = pb.build_linked(env["progs"]["equals_public"], public_inputs=[99])
    assert got.to_bytes() == want.to_bytes()
    assert got.verify(env["progs"]["equals_public"], public_inputs=[99],
                      expected_link_count=1)


def test_reencrypt(env):
    """`reencrypt` binds the old ciphertext's Decryption statement and the
    new one's encryption to ONE message column: the SDLP verifies, the
    new ciphertext decrypts to the same 31, and a changed T is refused."""
    prt, pub, priv = env["prt"], env["pub"], env["priv"]
    ct = prt.encrypt(ptypes.Unsigned64(31), pub, seed=18)
    pb = LogProofBuilder(prt, rand_scalar=scalar_source(19))
    new_ct, link = pb.reencrypt(ct, priv, pub, seed=19)
    assert link.value == 31 and prt.decrypt(new_ct, priv) == 31
    sdlp = pb.build_sdlp()
    assert sdlp.vk.n == 3 and sdlp.vk.n_messages == 1
    assert all(row[0] != [0] for row in sdlp.vk.a[:2])
    assert sdlp.verify()
    sdlp.vk.t[0][0] = [(sdlp.vk.t[0][0][0] + 1) % sdlp.vk.q] \
        + sdlp.vk.t[0][0][1:]
    assert not sdlp.verify()


def test_tampers_and_bad_witness(env):
    """The bulletproof swapped for another proof's (values mode), the
    bridge's two IPPs swapped (wires mode) and a witness of 300 against
    an 8-bit range (ValueError, as in the reference) all fail."""
    progs = env["progs"]
    p1 = dataclasses.replace(build(env, "values")[1])
    p1.bp_proof = build(env, "equality")[1].bp_proof
    assert not p1.verify(progs["in_range"], expected_link_count=1)
    p2 = build(env, "wires")[1]
    br = p2.bridge
    p2 = dataclasses.replace(p2, bridge=dataclasses.replace(
        br, ipp_shared=br.ipp_unshared, ipp_unshared=br.ipp_shared))
    assert not p2.verify(progs["in_balance"], public_inputs=[400])
    pb = LogProofBuilder(env["prt"], rand_scalar=scalar_source(13))
    pb.encrypt_returning_link(ptypes.Unsigned64(300), env["pub"], seed=13)
    with pytest.raises(ValueError):
        pb.build_linked(progs["in_range"])


def test_bytes_across_packages_and_hostile_ids(env):
    """A LinkedProof's wire format read both ways across the packages (each
    verifying the other's proof), truncation refused, hostile message ids
    (duplicated, out of range, negative, bool) and forged params failing
    closed, and a type mismatch refused (TypeError)."""
    want, got, _, _ = build(env, "wires")
    progs, ref_progs = env["progs"], env["ref_progs"]
    blob = got.to_bytes()
    back = ref_linked.LinkedProof.from_bytes(blob, want.vk)
    assert back.to_bytes() == blob
    assert back.verify(ref_progs["in_balance"], public_inputs=[400])
    mine = LinkedProof.from_bytes(want.to_bytes(), got.vk, device="cpu")
    assert mine.params == got.params and mine.to_bytes() == blob
    assert mine.verify(progs["in_balance"], public_inputs=[400])
    with pytest.raises(cv.DecodeError):
        LinkedProof.from_bytes(blob[:-3], got.vk)
    with pytest.raises(cv.DecodeError):
        LinkedProof.from_bytes(blob + b"\x00", got.vk)
    (n_mids,) = struct.unpack_from("<I", blob, 0)
    forged = bytearray(blob)
    struct.pack_into("<I", forged, 4 + 8 * n_mids, 27)
    with pytest.raises(cv.DecodeError):
        LinkedProof.from_bytes(bytes(forged), got.vk)
    vals = build(env, "values")[1]
    mid = vals.message_ids[0]
    for bad in ([mid, mid], [10**6], [-1], [vals.vk.n_messages], [True]):
        hostile = dataclasses.replace(vals, message_ids=bad)
        assert not hostile.verify(progs["in_range"],
                                  expected_message_ids=list(bad))
        assert not hostile.verify(progs["in_range"],
                                  expected_link_count=len(bad))
    for forged_params in (
            dataclasses.replace(got.params,
                                plain_modulus=got.params.plain_modulus * 4),
            dataclasses.replace(got.params, poly_degree=128), None):
        assert not dataclasses.replace(got, params=forged_params).verify(
            progs["in_balance"], public_inputs=[400])
    assert dataclasses.replace(got, params=None).verify(
        progs["in_balance"], public_inputs=[400], params=got.params)
    pb = LogProofBuilder(env["prt"], rand_scalar=scalar_source(23))
    pb.encrypt_returning_link(ptypes.Unsigned64(5), env["pub"], seed=23)
    with pytest.raises(TypeError):
        pb.build_linked(progs["rational_prog"])


def _run_example(source: str) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        exec(compile(source, EXAMPLE, "exec"),
             {"__name__": "__main__", "__file__": EXAMPLE})
    return out.getvalue().splitlines()


def test_example_flow(env):
    """examples/private_tx_linkedproof.py (the file untouched) on the port,
    its imports rewritten to `sunscreen_tpu_torch` and its runtime on the
    CPU, prints the reference's verdict lines."""
    with open(EXAMPLE) as f:
        source = f.read()
    want = _run_example(source)
    assert len(want) == 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_runtime, "resolve_device",
                   lambda device=None: torch.device("cpu"))
        got = _run_example(source.replace("from sunscreen_tpu.",
                                          "from sunscreen_tpu_torch."))
    assert got == want
