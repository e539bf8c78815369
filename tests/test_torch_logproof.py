"""The port's SDLP stack (`sunscreen_tpu_torch.logproof`: lattice,
fastpoly, the ZK inner-product proof, the linear-relation proof) and the
host C++ entries it binds (`zk/native.py`) held against the JAX package on
the CPU (`tests/test_logproof.py`, `test_fastpoly.py` and
`test_golden.py:124-160`).

Polynomial products and digit expansions must equal the reference's
integers; proofs must equal its bytes under one seeded source of
blindings (`rand_fn` on both sides; the reference's `secrets` in
`logproof.linear_relation` patched with it), on the host C++ prover loop
and on the python one (`native.get_lib` patched to None in both
packages); golden_v1.npz's `sdlp_challenges`, `sdlp_v_digest` and
`zk_generators_digest` are reproduced. Everything is exact: no
tolerance."""

import hashlib
import os
import random

import numpy as np
import pytest

import sunscreen_tpu.logproof.linear_relation as ref_lr
from sunscreen_tpu.logproof import fastpoly as ref_fastpoly
from sunscreen_tpu.logproof import inner_product as ref_ipp
from sunscreen_tpu.logproof import lattice as ref_lattice
from sunscreen_tpu.zk import curve25519 as rcv
from sunscreen_tpu.zk import merlin as rmerlin
from sunscreen_tpu.zk import native as rnative
from sunscreen_tpu.zk import pedersen as rpedersen
from sunscreen_tpu_torch.logproof import fastpoly, lattice
from sunscreen_tpu_torch.logproof import inner_product as ipp
from sunscreen_tpu_torch.logproof import linear_relation as lr
from sunscreen_tpu_torch.zk import curve25519 as cv
from sunscreen_tpu_torch.zk import native, pedersen
from sunscreen_tpu_torch.zk.merlin import Transcript
from sunscreen_tpu_torch.zk.r1cs import scalar_source

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden_v1.npz")
L = cv.L
SEED = 29
# tests/test_logproof.py:81-90: round parities, identity padding and the
# virtual g' = coeff o g of the SDLP, alone and together
IPP_MATRIX = [(8, False), (16, False), (11, False), (16, True), (11, True),
              (2, True), (1, True)]


class _Secrets:
    def __init__(self, draw):
        self.randbelow = lambda n: draw()


def _ref_point(p):
    return rcv.Point(p.x, p.y, p.z, p.t)


def test_lattice_matches_reference():
    """Polynomial sums, products, division by X^d + 1, evaluation, signed
    lifts, schoolbook matrix products and the two's-complement digits:
    the port's integers equal the reference's, and the digits recombine
    to their value; a value past its bound raises ValueError."""
    rng = random.Random(1)
    q = 40961
    for d in (1, 4, 17):
        a = [rng.randrange(q) for _ in range(d)]
        b = [rng.randrange(-q, q) for _ in range(d + 2)]
        f = [1] + [0] * (d - 1) + [1]
        for name, args in (("poly_add", (a, b, q)), ("poly_sub", (a, b)),
                           ("poly_mul", (a, b, q)), ("poly_mul", (b, b)),
                           ("poly_divmod", (a + b, f, q)),
                           ("poly_eval", (b, 12345, L))):
            assert getattr(lattice, name)(*args) == \
                getattr(ref_lattice, name)(*args), (name, d)
    A = [[[rng.randrange(q) for _ in range(4)] for _ in range(3)]
         for _ in range(2)]
    S = [[[rng.randrange(q) for _ in range(4)]] for _ in range(3)]
    assert lattice.mat_mul_poly(A, S, q) == ref_lattice.mat_mul_poly(A, S, q)
    assert [lattice.signed_lift(x, q) for x in range(q)] == \
        [ref_lattice.signed_lift(x, q) for x in range(q)]
    for bits in (0, 2, 3, 5, 9):
        ws = lattice.twos_complement_coeffs(bits)
        assert ws == ref_lattice.twos_complement_coeffs(bits)
        for v in range(-(1 << max(bits - 1, 0)), 1 << max(bits - 1, 0)):
            if bits == 0 and v:
                continue
            bs = lattice.twos_complement_bits(v, bits)
            assert bs == ref_lattice.twos_complement_bits(v, bits)
            assert sum(b * (w if w < L // 2 else w - L)
                       for b, w in zip(bs, ws)) == v
    with pytest.raises(ValueError):
        lattice.twos_complement_bits(4, 3)
    assert [lattice.ceil_log2(x) for x in range(1, 70)] == \
        [ref_lattice.ceil_log2(x) for x in range(1, 70)]


def test_fastpoly_matches_reference():
    """`mat_mul_poly_fast` mod a 101-bit q and over signed integers
    (`test_fastpoly.py`) and `mat_mul_poly` past the dispatcher's
    threshold (`test_fastpoly.py:64`, d = 1500): equal to the reference's
    and to a direct convolution."""
    rng = random.Random(2)
    q = (1 << 100) + 277
    a = [[[rng.randrange(q) for _ in range(64)] for _ in range(3)]
         for _ in range(2)]
    s = [[[rng.randrange(q) for _ in range(64)]] for _ in range(3)]
    bound = 3 * 64 * (q - 1) ** 2
    assert fastpoly.mat_mul_poly_fast(a, s, q, bound) == \
        ref_fastpoly.mat_mul_poly_fast(a, s, q, bound)
    assert fastpoly.mat_mul_poly_fast(a, s, q, bound)[1][0] == \
        ref_lattice.mat_mul_poly(a, s, q)[1][0]
    bnd = 1 << 40
    a = [[[rng.randrange(-bnd, bnd) for _ in range(50)]]]
    s = [[[rng.randrange(-bnd, bnd) for _ in range(50)]]]
    got = fastpoly.mat_mul_poly_fast(a, s, None, bound=50 * bnd * bnd)
    assert got == ref_fastpoly.mat_mul_poly_fast(a, s, None,
                                                 bound=50 * bnd * bnd)
    assert got[0][0] == ref_lattice.poly_mul(a[0][0], s[0][0])
    q = (1 << 60) - 93
    d = 1500
    a = [[[rng.randrange(q) for _ in range(d)]]]
    s = [[[rng.randrange(q) for _ in range(d)]]]
    got = lattice.mat_mul_poly(a, s, q)
    assert got == ref_lattice.mat_mul_poly(a, s, q)
    for idx in (0, 1, d - 1, 2 * d - 2):
        lo = max(0, idx - d + 1)
        assert got[0][0][idx] == sum(
            a[0][0][i] * s[0][0][idx - i]
            for i in range(lo, min(d, idx + 1))) % q


def test_golden_sdlp_vectors():
    """golden_v1.npz's `sdlp_challenges`, `sdlp_v_digest` and
    `zk_generators_digest` (`tests/test_golden.py:124-160`)."""
    golden = np.load(GOLDEN)
    vk = lr.VerifierKnowledge(
        a=[[[1, 2, 3, 4], [5, 6, 7, 8]]], t=[[[9, 10, 11, 12]]],
        bounds=[[[3, 3, 3, 3]], [[3, 3, 3, 3]]], f=[1, 0, 0, 0, 1], q=97)
    t = Transcript(b"golden sdlp")
    lr._append_vk(t, vk)
    t.append_point(b"w_shared", cv.BASEPOINT)
    t.append_point(b"w", cv.BASEPOINT * 2)
    alpha, beta, gamma, phi, psi = lr._create_challenges(vk, t)
    assert [alpha, psi, beta[0], gamma[0], phi[0], phi[-1]] == [
        int(s, 16) for s in golden["sdlp_challenges"]]
    h = hashlib.sha256()
    for x in lr._compute_v(vk, alpha, beta, gamma):
        h.update(int(x).to_bytes(32, "little"))
    assert h.hexdigest() == str(golden["sdlp_v_digest"][0])
    gens = lr.LogProofGenerators(16)
    h = hashlib.sha256()
    for p in gens.g + gens.h:
        h.update(p.encode())
    assert h.hexdigest() == str(golden["zk_generators_digest"][0])


def test_native_bindings_match_reference():
    """The host C++ entries the SDLP binds, against the reference's
    library and python: `sc_vec_mul` and `ipp_s_vector` on edge scalars,
    `fork_challenges` at batch remainders (with the strobe state written
    back), `msm_buf` and `batch_scalar_mul_buf` on one buffer; and
    `pedersen.generators_chain`, the lazy chain, against the reference's
    and the batched `_chain_points`."""
    rng = random.Random(4)
    edges = [0, 1, 2, L - 1, L - 2, (L - 1) // 2, 1 << 252,
             rng.randrange(L), rng.randrange(L)]
    assert native.sc_vec_mul(edges, edges[::-1]) == \
        rnative.sc_vec_mul(edges, edges[::-1]) == \
        [x * y % L for x, y in zip(edges, edges[::-1])]
    cs = [1, L - 1, rng.randrange(L)]
    assert native.ipp_s_vector(cs, 8) == rnative.ipp_s_vector(cs, 8)
    for count in (0, 1, 127, 128, 129, 300):
        t_nv, t_ref = Transcript(b"edge"), rmerlin.Transcript(b"edge")
        t_nv.append_u64(b"c", count)
        t_ref.append_u64(b"c", count)
        got = native.fork_challenges(t_nv.strobe, b"x", count)
        lib = rnative._LIB
        rnative._LIB = None
        try:
            want = ref_lr._challenge_scalars(t_ref, b"x", count)
        finally:
            rnative._LIB = lib
        assert got == want, count
        assert bytes(t_nv.strobe.state) == bytes(t_ref.strobe.state)
    pts = [cv.BASEPOINT * (i + 3) for i in range(40)]
    buf = native.points_to_buf(pts)
    sc = [rng.randrange(L) for _ in pts]
    assert native.msm_buf(sc, buf, 40, "cpu") == \
        _ref_point_of(rnative.msm_buf(sc, buf, 40)) == cv.msm_py(sc, pts)
    assert native.batch_scalar_mul_buf(sc, buf, 40) == \
        rnative.batch_scalar_mul_buf(sc, buf, 40)
    chain = pedersen.generators_chain(b"G")
    ref_chain = rpedersen.generators_chain(b"G")
    got = [next(chain) for _ in range(70)]      # past the first 4096 bytes
    assert [p.encode() for p in got] == \
        [next(ref_chain).encode() for _ in range(70)]
    assert got == pedersen._chain_points(b"G", 70)


def _ref_point_of(p):
    return cv.Point(p.x, p.y, p.z, p.t)


def _counter_rand(offset: int):
    state = [0]

    def rand():
        state[0] += 1
        return (state[0] * 0x9E3779B97F4A7C15 + offset) % L
    return rand


@pytest.mark.parametrize("path", ["native", "python"])
def test_ipp_matches_reference(monkeypatch, path):
    """The ZK-IPP over `IPP_MATRIX` (`test_logproof.py:81-90`): the port's
    proof equal to the reference's byte for byte under one `rand_fn`, on
    the host C++ prover loop or the python one, and verifying."""
    if path == "python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(rnative, "get_lib", lambda: None)
    rng = np.random.default_rng(3)
    u = ipp.get_u()
    for n_real, coeff in IPP_MATRIX:
        g = [cv.BASEPOINT * (i + 2) for i in range(n_real)]
        h = [cv.BASEPOINT * (i + 100) for i in range(n_real)]
        v1 = [int(x) for x in rng.integers(1, 1 << 30, n_real)]
        v2 = [int(x) for x in rng.integers(1, 1 << 30, n_real)]
        g_coeff = ([(int(x) * 0x9E3779B97F4A7C15E3779B9 + 1) % L
                    for x in rng.integers(1, 1 << 60, n_real)]
                   if coeff else None)
        geff = [gi * c for gi, c in zip(g, g_coeff)] if coeff else g
        rho = 99
        x = sum(a * b for a, b in zip(v1, v2)) % L
        t = cv.msm(v1 + v2 + [rho], geff + h + [u])
        want = ref_ipp.create(
            rmerlin.Transcript(b"ipd"), v1, v2, rho, _ref_point(t),
            [_ref_point(p) for p in g], [_ref_point(p) for p in h],
            _ref_point(u), rand_fn=_counter_rand(777), g_coeff=g_coeff)
        got = ipp.create(Transcript(b"ipd"), v1, v2, rho, t, g, h, u,
                         rand_fn=_counter_rand(777), g_coeff=g_coeff,
                         device="cpu")
        assert got.to_bytes() == want.to_bytes(), (n_real, coeff)
        assert ipp.verify(got, Transcript(b"ipd"), t, x, g, h, u,
                          g_coeff=g_coeff, device="cpu")
        assert not ipp.verify(got, Transcript(b"ipd"), t, (x + 1) % L, g,
                              h, u, g_coeff=g_coeff, device="cpu")


def _relation(rng, q, d, rows, cols, bound_bits):
    """A rows x cols relation A S = T in Z_q[X]/(X^d + 1) with S below
    2^bound_bits - 1, for both packages."""
    f = [1] + [0] * (d - 1) + [1]
    A = [[[int(x) for x in rng.integers(0, q, d)] for _ in range(cols)]
         for _ in range(rows)]
    S = [[[int(x) for x in rng.integers(0, (1 << bound_bits) - 1, d)]]
         for _ in range(cols)]
    T = []
    for i in range(rows):
        acc = []
        for r in range(cols):
            acc = lattice.poly_add(acc, lattice.poly_mul(A[i][r], S[r][0],
                                                         q), q)
        _, red = lattice.poly_divmod(acc, f, q)
        T.append([red + [0] * (d - len(red))])
    bounds = [[[bound_bits] * d] for _ in range(cols)]
    return ((lr.VerifierKnowledge(A, T, bounds, f, q), S),
            (ref_lr.VerifierKnowledge(A, T, bounds, f, q), S))


@pytest.mark.parametrize("case", ["matrix", "shared"])
def test_sdlp_matches_reference(monkeypatch, case):
    """The SDLP of a 2 x 2 matrix relation (`test_logproof.py:177`) and of
    a 1 x 1 relation with its witness shared (`:201`): the port's proof
    equal to the reference's byte for byte under one seed, verifying,
    refused against another statement, read back from its bytes; the
    shared commitment is <s_1[range], h[range]> + half_rho u."""
    rng = np.random.default_rng(5)
    if case == "matrix":
        (vk, s), (rvk, _) = _relation(rng, 40961, 4, 2, 2, 2)
        shared, half_rho = None, None
    else:
        (vk, s), (rvk, _) = _relation(rng, 12289, 4, 1, 1, 2)
        shared, half_rho = [(0, 0)], 12345
    draw = scalar_source(SEED)
    monkeypatch.setattr(ref_lr, "secrets", _Secrets(draw))
    monkeypatch.setattr(ref_ipp, "_rand", draw)
    rgens = ref_lr.LogProofGenerators(rvk.l)
    want = ref_lr.create(rmerlin.Transcript(b"sdlp"),
                         ref_lr.ProverKnowledge(rvk, s), rgens.g, rgens.h,
                         ref_ipp.get_u(), half_rho=half_rho,
                         shared_indices=shared, gens=rgens)
    gens = lr.LogProofGenerators(vk.l)
    u = ipp.get_u()
    proof = lr.create(Transcript(b"sdlp"), lr.ProverKnowledge(vk, s), gens.g,
                      gens.h, u, half_rho=half_rho, shared_indices=shared,
                      gens=gens, device="cpu", rand_fn=scalar_source(SEED))
    assert proof.to_bytes() == want.to_bytes()
    assert lr.verify(proof, Transcript(b"sdlp"), vk, gens.g, gens.h, u,
                     gens=gens, device="cpu")
    back = lr.LogProof.from_bytes(proof.to_bytes())
    assert lr.verify(back, Transcript(b"sdlp"), vk, gens.g, gens.h, u,
                     device="cpu")
    (other, _), _ = _relation(rng, vk.q, vk.d, vk.n, vk.m, 2)
    assert not lr.verify(proof, Transcript(b"sdlp"), other, gens.g, gens.h,
                         u, gens=gens, device="cpu")
    if case == "shared":
        s_1 = lr._binary_expand(vk, s)
        lo, hi = vk.b_slices()[0][0]
        assert proof.w_shared == cv.msm(s_1[lo:hi] + [half_rho],
                                        gens.h[lo:hi] + [u])


def test_sdlp_refuses_out_of_bound_witness():
    """A witness coefficient of 9 against a 2-bit bound, its relation
    holding (`test_logproof.py:162`): the port raises ValueError where the
    reference's assertion fails."""
    rng = np.random.default_rng(7)
    (vk, s), (rvk, _) = _relation(rng, 12289, 4, 1, 1, 2)
    s[0][0][0] = 9
    _, t_red = lattice.poly_divmod(
        lattice.poly_mul(vk.a[0][0], s[0][0], vk.q), vk.f, vk.q)
    vk.t[0][0] = rvk.t[0][0] = t_red + [0] * (vk.d - len(t_red))
    gens = lr.LogProofGenerators(vk.l)
    with pytest.raises(ValueError):
        lr.create(Transcript(b"sdlp"), lr.ProverKnowledge(vk, s), gens.g,
                  gens.h, ipp.get_u(), device="cpu")
    rgens = ref_lr.LogProofGenerators(rvk.l)
    with pytest.raises(AssertionError):
        ref_lr.create(rmerlin.Transcript(b"sdlp"),
                      ref_lr.ProverKnowledge(rvk, s), rgens.g, rgens.h,
                      ref_ipp.get_u())
