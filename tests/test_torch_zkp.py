"""The port's ZKP stack (`sunscreen_tpu_torch.zk`, `types/zkp_types.py`,
`runtime/builders.py`, the ZKP halves of the compiler and runtime) held
against the JAX package on the CPU with the same seeded inputs: the
group, scalar field and transcript, the generators (and golden_v1.npz's
`zk_pedersen`), the host C++ kernels, the MSM's plain version (against
`tpu_curve`'s field and point ops and its Pippenger, the python oracle and
the reference's native MSM), proofs byte for byte under one seeded source
of blindings on both sides (the reference's `r1cs._rand_scalar` patched
with it), proofs verifying across the two packages, tampered proofs
failing on both, and the compiler and fluent builders. Everything is exact
integers or bytes: no tolerance. No `from __future__ import annotations`
here: the ZKP DSL reads its programs' annotations as objects."""

import hashlib
import os
import random

import numpy as np
import pytest
import torch

import sunscreen_tpu.zk.r1cs as ref_r1cs
from sunscreen_tpu.runtime.runtime import Runtime as RefRuntime
from sunscreen_tpu.types import zkp_types as rz
from sunscreen_tpu.zk import curve25519 as rcv
from sunscreen_tpu.zk import merlin as rmerlin
from sunscreen_tpu.zk import native as rnative
from sunscreen_tpu.zk import pedersen as rped
from sunscreen_tpu.zk import tpu_curve as tc
from sunscreen_tpu.zk.backend import BulletproofsProof as RefProof
from sunscreen_tpu_torch.runtime import Runtime
from sunscreen_tpu_torch.types import zkp_types as pz
from sunscreen_tpu_torch.zk import cuda_curve as cc
from sunscreen_tpu_torch.zk import curve25519 as cv
from sunscreen_tpu_torch.zk import merlin, native, pedersen
from sunscreen_tpu_torch.zk.backend import BulletproofsProof, ZkpError
from sunscreen_tpu_torch.zk.r1cs import scalar_source

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden_v1.npz")
RNG = random.Random(0x2C0DE)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain MSM runs thousands of small int64 ops, which PyTorch's
    intra-op threads only slow down (15 times over on a shared host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _point(mod, p):
    return mod.Point(p.x, p.y, p.z, p.t)


def test_group_and_scalar_field():
    """Encodings of B * 0..40, decode and its refusals, the elligator map,
    scalar multiples and the scalar field, port == reference."""
    acc_p, acc_r = cv.IDENTITY, rcv.IDENTITY
    for _ in range(41):
        enc = acc_p.encode()
        assert enc == acc_r.encode()
        assert cv.decode(enc).encode() == enc
        acc_p, acc_r = acc_p + cv.BASEPOINT, acc_r + rcv.BASEPOINT
    bad = [bytes.fromhex("01" + "00" * 31), b"\xff" * 32,
           (cv.P).to_bytes(32, "little"), b"\x00" * 31]
    bad += [RNG.randbytes(32) for _ in range(40)]
    for data in bad:
        outcome = []
        for mod in (cv, rcv):
            try:
                outcome.append(mod.decode(data).encode())
            except mod.DecodeError:
                outcome.append(None)
        assert outcome[0] == outcome[1]
    assert all(_refused(d) for d in bad[:4])
    for i in range(8):
        raw = hashlib.sha512(bytes([i])).digest()
        assert (cv.from_uniform_bytes(raw).encode()
                == rcv.from_uniform_bytes(raw).encode())
        k = RNG.randrange(cv.L)
        assert (cv.BASEPOINT * k).encode() == (rcv.BASEPOINT * k).encode()
        assert cv.scalar_from_bytes_wide(raw) == rcv.scalar_from_bytes_wide(
            raw)
    xs = [RNG.randrange(1, cv.L) for _ in range(16)]
    assert cv.batch_scalar_inv(xs) == rcv.batch_scalar_inv(xs)
    assert cv.scalar_inv(xs[0]) * xs[0] % cv.L == 1
    with pytest.raises(cv.DecodeError):
        cv.scalar_from_canonical_bytes(cv.L.to_bytes(32, "little"))
    assert cv.scalar_to_bytes(cv.L + 5) == rcv.scalar_to_bytes(cv.L + 5)


def _refused(data: bytes) -> bool:
    try:
        cv.decode(data)
    except cv.DecodeError:
        return True
    return False


def test_transcript_and_generators():
    """The merlin test vectors of tests/test_merlin.py, an interleaved
    transcript, the keccak permutation, `cached_pedersen()` against
    golden_v1.npz and a digest of `cached_bp_gens(64)`, port == reference."""
    t = merlin.Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615")
    ts = [mod.Transcript(b"test protocol") for mod in (merlin, rmerlin)]
    data = bytes([99] * 1024)
    for tr in ts:
        tr.append_message(b"step1", b"some data")
    for i in range(32):
        chl = [tr.challenge_bytes(b"challenge", 32) for tr in ts]
        assert chl[0] == chl[1]
        for tr in ts:
            tr.append_message(b"bigdata", data)
            tr.append_message(b"challengedata", chl[0])
            tr.append_u64(b"i", i)
    assert ts[0].challenge_scalar(b"s") == ts[1].challenge_scalar(b"s")
    for _ in range(4):
        state = bytearray(RNG.randbytes(200))
        a, b = bytearray(state), bytearray(state)
        merlin.keccak_f1600(a)
        rmerlin._keccak_f1600_py(b)
        assert a == b
    golden = np.load(GOLDEN)
    pc = pedersen.cached_pedersen()
    assert pc.B.encode().hex() == str(golden["zk_pedersen"][0])
    assert pc.B_blinding.encode().hex() == str(golden["zk_pedersen"][1])
    digests = []
    for mod in (pedersen, rped):
        h = hashlib.sha256()
        gens = mod.cached_bp_gens(64)
        for p in gens.G + gens.H:
            h.update(p.encode())
        digests.append(h.hexdigest())
    assert digests[0] == digests[1]


def _points(n: int, distinct: int):
    base = [cv.BASEPOINT * RNG.randrange(1, cv.L) for _ in range(distinct)]
    return [base[i % distinct] for i in range(n)]


def _edge_scalars(n: int) -> list[int]:
    s = [RNG.randrange(cv.L) for _ in range(n)]
    s[:5] = [0, 1, cv.L - 1, 1 << 252, 255]
    s[n // 2:n // 2 + n // 8] = [s[n // 2]] * (n // 8)   # a repeated scalar
    return s


def test_native_kernels_match_reference():
    """The port's g++ build of csrc/ristretto.cpp against the reference's
    library: msm, batch_mul, fold and from_uniform_batch from 8 to 300
    points."""
    assert native.get_lib() is not None and rnative.get_lib() is not None
    for n in (8, 33, 300):
        pts = _points(n, 7)
        rpts = [_point(rcv, p) for p in pts]
        sc = _edge_scalars(n)
        assert native.msm(sc, pts).encode() == rnative.msm(sc, rpts).encode()
        got = native.batch_scalar_mul(sc, pts)
        want = rnative.batch_scalar_mul(sc, rpts)
        assert [p.encode() for p in got] == [p.encode() for p in want]
        got = native.fold(pts, pts[::-1], sc[3])
        want = rnative.fold(rpts, rpts[::-1], sc[3])
        assert [p.encode() for p in got] == [p.encode() for p in want]
        raw = RNG.randbytes(64 * n)
        assert ([p.encode() for p in native.from_uniform_batch(raw, n)]
                == [p.encode() for p in rnative.from_uniform_batch(raw, n)])


def test_plain_field_and_point_ops_match_tpu_curve():
    """`cuda_curve.fmul`/`fadd`/`fsub`/`padd` against `tpu_curve`'s, limb
    for limb, on edge and random field elements and points."""
    vals = [0, 1, cv.P - 1, cv.P - 19, (1 << 255) - 1 - 19, 2 ** 254]
    vals += [RNG.randrange(cv.P) for _ in range(26)]
    a = np.array([tc.limbs_from_int(v) for v in vals], dtype=np.uint64)
    b = a[::-1].copy()
    ta, tb = (torch.from_numpy(x.astype(np.int64)) for x in (a, b))
    for ours, theirs in ((cc.fmul, tc.fmul), (cc.fadd, tc.fadd),
                         (cc.fsub, tc.fsub)):
        np.testing.assert_array_equal(
            ours(ta, tb).numpy(),
            np.asarray(theirs(a, b)).astype(np.int64))
    pts = _points(8, 8)
    rp = tc.from_points([_point(rcv, p) for p in pts])
    rq = tc.from_points([_point(rcv, p) for p in pts[::-1]])
    ours = cc.padd(*(torch.stack([torch.from_numpy(np.asarray(d[k]).astype(
        np.int64)) for k in tc.COORDS], dim=-2) for d in (rp, rq)))
    theirs = tc.padd(rp, rq)
    for i, k in enumerate(tc.COORDS):
        np.testing.assert_array_equal(
            ours[:, i].numpy(), np.asarray(theirs[k]).astype(np.int64))


def test_plain_msm_matches_tpu_curve_msm():
    """The plain Pippenger against the reference's device Pippenger at the
    reference test's shape (n = 16, c = 4; one XLA compile)."""
    pts = _points(16, 16)
    sc = [RNG.randrange(1 << 62) ** 2 % cv.L for _ in range(12)]
    sc += [0, 1, 1, cv.L - 1]
    want = tc.msm(sc, [_point(rcv, p) for p in pts], c=4)
    got = cc.point_of(cc.msm(*cc.to_tensors(sc, pts, "cpu"), c=4))
    assert got.encode() == want.encode()


def test_plain_msm_matches_oracle():
    """The plain Pippenger at its own window widths against `cv.msm_py`
    (n = 300, c = 6) and the reference's native MSM (n = 2100, c = 8, past
    the device threshold), with scalars 0, 1, L - 1, 2^252, a repeated
    scalar and repeated points."""
    for n, want_fn in ((300, cv.msm_py),
                       (2100, lambda s, p: rcv.msm(
                           s, [_point(rcv, q) for q in p]))):
        pts = _points(n, 16)
        sc = _edge_scalars(n)
        got = cc.point_of(cc.msm(*cc.to_tensors(sc, pts, "cpu")))
        assert got.encode() == want_fn(sc, pts).encode()


def _programs(z):
    """The programs of tests/test_zkp.py and the fractional range proof of
    benchmarks/zkp_bench.py, in the DSL module z, with (private, public,
    constant) inputs."""
    F, Priv, Pub, Const = z.Field, z.Private, z.Public, z.Constant

    @z.zkp_program()
    def know_factors(a: Priv[F], b: Priv[F], product: Pub[F]):
        (a * b).constrain_eq(product)

    @z.zkp_program()
    def poly_eval(x: Priv[F], y: Pub[F], c: Const[F]):
        (x ** 3 + c * x + 7).constrain_eq(y)

    @z.zkp_program()
    def in_range_0_255(x: Priv[F]):
        x.to_unsigned(8)

    @z.zkp_program()
    def nonzero(x: Priv[F]):
        x.inverse()

    @z.zkp_program()
    def mod7(x: Priv[F], r_expect: Pub[F]):
        _, r = z._ctx().invoke_gadget(z.SignedModulus(7, 16), [x.node])
        F(r).constrain_eq(r_expect)

    @z.zkp_program()
    def in_range(balance: Priv[F, (64, 8)], unshielded: Const[F]):
        def coeff(bits):
            acc = None
            for i, b in enumerate(bits):
                t = b * ((1 << i) if i < 7 else -(1 << 7))
                acc = t if acc is None else acc + t
            return acc

        val = None
        for j, row in enumerate(balance):
            t = coeff(row) * (1 << j)
            val = t if val is None else val + t
        (val - unshielded).to_unsigned(8)

    bal = [0] * 512
    bal[0] = bal[1] = bal[9] = 1          # 3 + 2 * 2 = 7
    return {"small": [
        (know_factors, [17, 23], [391], []),
        (poly_eval, [5], [5 ** 3 + 3 * 5 + 7], [3]),
        (in_range_0_255, [200], [], []),
        (nonzero, [42], [], []),
        (mod7, [100], [100 % 7], [])],
        "fractional_range": [(in_range, bal, [], [4])]}


@pytest.mark.parametrize("which", ["small", "fractional_range"])
def test_proofs_byte_identical_and_cross_verify(monkeypatch, which):
    """Under one seeded source of blindings on each side, the port's proof
    bytes equal the reference's; each package verifies the other's proof;
    a proof with t_x moved by one, or checked against another public or
    constant input, fails on both; a witness out of range raises on both."""
    rt, ref = Runtime.new_zkp(device="cpu"), RefRuntime.new_zkp()
    ported, reference = _programs(pz)[which], _programs(rz)[which]
    for seed, ((pf, priv, pub, const), (rf, *_)) in enumerate(
            zip(ported, reference)):
        monkeypatch.setattr(ref_r1cs, "_rand_scalar", scalar_source(seed))
        blob = rt.backend.prove(pf.build(), priv, pub, const,
                                device=rt.device,
                                rand_scalar=scalar_source(seed)).to_bytes()
        assert blob == ref.prove(rf, priv, pub, const).to_bytes()
        assert ref.verify(rf, RefProof.from_bytes(blob), pub, const)
        assert rt.verify(pf, BulletproofsProof.from_bytes(blob), pub, const)
        bad = BulletproofsProof.from_bytes(blob)
        bad.r1cs.t_x = (bad.r1cs.t_x + 1) % cv.L
        bad_blob = bad.to_bytes()
        assert not rt.verify(pf, bad, pub, const)
        assert not ref.verify(rf, RefProof.from_bytes(bad_blob), pub, const)
        if pub or const:
            moved_pub = [pub[0] + 1] if pub else []
            moved_const = [] if pub else [const[0] + 1]
            assert not rt.verify(pf, BulletproofsProof.from_bytes(blob),
                                 moved_pub or pub, moved_const or const)
    if which == "fractional_range":
        pf, priv, pub, const = ported[0]
        for mod_rt, prog in ((rt, pf), (ref, reference[0][0])):
            with pytest.raises(ValueError, match="does not fit"):
                mod_rt.prove(prog, priv, pub, [8])     # 7 - 8 < 0
    else:
        with pytest.raises(ZkpError):
            rt.prove(ported[0][0], [17, 24], [391])
        with pytest.raises(ZeroDivisionError):
            rt.prove(ported[3][0], [0])


def test_compiler_runtime_and_builders(monkeypatch):
    """`Compiler().zkp_backend().zkp_program(f)` beside an FHE program and
    alone (no FHE params), `get_zkp_program`, the fluent builders (the
    scenario of tests/test_compiler.py and tests/test_zkp.py), and the
    runtime's device: CUDA by default, which raises without a card."""
    from sunscreen_tpu_torch.bfv import BfvParams
    from sunscreen_tpu_torch.compiler import Compiler, fhe_program
    from sunscreen_tpu_torch.runtime import ZkpRuntime
    from sunscreen_tpu_torch.runtime.builders import VerificationError
    from sunscreen_tpu_torch.types import Cipher, Signed

    @pz.zkp_program()
    def is_product(a: pz.Field, b: pz.Field, c: pz.Field):
        (a * b).constrain_eq(c)

    @fhe_program(scheme="bfv")
    def simple_multiply(a: Cipher[Signed], b: Cipher[Signed]):
        return a * b

    params = BfvParams.insecure_u32(256, limbs=2, limb_bits=25)
    app = (Compiler("cpu").fhe_program(simple_multiply).zkp_backend()
           .zkp_program(is_product).with_params(params).compile())
    assert "simple_multiply" in app.programs
    zp = app.get_zkp_program(is_product)
    rt = ZkpRuntime(device="cpu")
    assert rt.verify(zp, rt.prove(zp, [3, 5, 15]))
    app2 = Compiler().zkp_backend().zkp_program(is_product).compile()
    assert app2.params is None and "is_product" in app2.zkp_programs
    with pytest.raises(ValueError, match="duplicate"):
        Compiler().zkp_program(is_product).zkp_program(is_product)

    @pz.zkp_program()
    def affine(x: pz.Private[pz.Field], a: pz.Constant[pz.Field],
               y: pz.Public[pz.Field]):
        (x * a).constrain_eq(y)

    proof = (rt.proof_builder(affine).private_input(6).constant_input(7)
             .public_input(42).prove())
    rt.verification_builder(affine).proof(proof).constant_input(7) \
        .public_input(42).verify()
    with pytest.raises(VerificationError):
        rt.verification_builder(affine).proof(proof).constant_input(7) \
            .public_input(41).verify()
    with pytest.raises(VerificationError):
        rt.verification_builder(affine).constant_input(7) \
            .public_input(42).verify()
    proof2 = (rt.proof_builder(affine).private_inputs([6])
              .constant_inputs([7]).public_inputs([42]).prove())
    rt.verification_builder(affine).proof(proof2).constant_inputs([7]) \
        .public_inputs([42]).verify()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        Runtime.new_zkp()
