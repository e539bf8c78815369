"""SDLP: short discrete log proof of a lattice linear relation A·S = T
over Z_q[X]/f with per-coefficient bounds on S (port of
`sunscreen_tpu/logproof/linear_relation.py`).

Replaces `logproof/src/linear_relation.rs` (LogProof create/verify,
Pino–Lyubashevsky–Seiler short discrete log proofs with Sunscreen's
per-coefficient-bounds extension): the witness S and the lift factors
R_1, R_2 (with A·S + q·R_1 + f·R_2 = T over Z[X]) are serialized to
2's-complement bits, committed as w = <s_1, h> + <s_2, g> + rho*u with
s_2 = NOT s_1, challenged (alpha, beta, gamma, phi, psi), and reduced to
one ZK inner-product proof <v_1, v_2> = x.

`create` and `verify` run on `device` (None means CUDA; pass "cpu" for the
host): on CUDA every MSM of at least 2048 points outside the native IPP
loop runs the CUDA Pippenger M1 (`native.msm_buf`, `cv.msm`), which the
reference sends to its host C++; `msm_sizes` lists them. The prover's
blindings come from `rand_fn` (the OS by default), the one seeded source
byte-identical proofs need.
"""

from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass

import numpy as np

from sunscreen_tpu_torch import resolve_device
from sunscreen_tpu_torch.logproof import inner_product as ipp
from sunscreen_tpu_torch.logproof.lattice import (ceil_log2, mat_map,
                                            mat_mul_poly, mat_sub,
                                            poly_divmod, poly_eval,
                                            poly_mul, poly_sub,
                                            signed_lift,
                                            twos_complement_bits,
                                            twos_complement_coeffs)
from sunscreen_tpu_torch.zk import curve25519 as cv
from sunscreen_tpu_torch.zk import native
from sunscreen_tpu_torch.zk.merlin import Strobe128, Transcript

L = cv.L


def generators(count: int, label: bytes) -> list[cv.Point]:
    """Shake256 'Generator' chain (reference: `generators.rs`).
    LogProofGenerators uses labels b'g' and b'h'."""
    shake = hashlib.shake_256()
    shake.update(b"Generator")
    shake.update(label)
    buf = shake.digest(64 * count)
    return cv.from_uniform_bytes_batch(buf)


class LogProofGenerators:
    """Fixed g/h generator chains plus their lazily cached native buffers
    (128 bytes of extended coordinates a point) and the sum of h, reused
    across every proof in a process so that the MSMs never re-marshal
    python Points."""

    def __init__(self, count: int):
        self.g = generators(count, b"g")
        self.h = generators(count, b"h")
        self._g_buf = None
        self._h_buf = None
        self._h_sum = None

    @property
    def g_buf(self) -> bytes:
        if self._g_buf is None:
            self._g_buf = native.points_to_buf(self.g)
        return self._g_buf

    @property
    def h_buf(self) -> bytes:
        if self._h_buf is None:
            self._h_buf = native.points_to_buf(self.h)
        return self._h_buf

    @property
    def h_sum_cached(self) -> bool:
        return self._h_sum is not None

    def h_sum(self, device=None) -> cv.Point:
        """The sum of h, computed once (an MSM of len(h) points on
        `device`)."""
        if self._h_sum is None:
            pt = native.msm_buf([1] * len(self.h), self.h_buf, len(self.h),
                                device)
            if pt is None:
                pt = cv.IDENTITY
                for p in self.h:
                    pt = pt + p
            self._h_sum = pt
        return self._h_sum


# identity point in the 128B extended-coordinate buffer layout
IDENTITY_BUF = (b"\x00" * 32 + (1).to_bytes(32, "little") * 2
                + b"\x00" * 32)


def _pad_buf_pow2(buf: bytes, n: int) -> bytes:
    """Pad an n-point buffer with identity points to the next power of
    two (the IPP's generator padding, buffer form)."""
    target = 1 << max(0, (n - 1).bit_length())
    if target == n:
        return buf
    return bytes(buf) + IDENTITY_BUF * (target - n)


@dataclass
class VerifierKnowledge:
    """A (n x m matrix of polys), T (n x k), per-coefficient bounds on S
    (m x k matrix of length-d bit-count lists), f, and q."""

    a: list              # [n][m] polys (coeffs mod q)
    t: list              # [n][k] polys
    bounds: list         # [m][k] lists of d unsigned-bit-counts
    f: list[int]         # quotient polynomial, degree d
    q: int
    # statement structure: how many leading witness columns are MESSAGE
    # columns (set by bfv_statement.build; None for raw statements).
    # Linked-proof verification uses it to reject message ids that
    # point at remainder/noise columns.
    n_messages: int | None = None

    @property
    def n(self) -> int:
        return len(self.a)

    @property
    def m(self) -> int:
        return len(self.a[0])

    @property
    def k(self) -> int:
        return len(self.t[0])

    @property
    def d(self) -> int:
        return len(self.f) - 1

    def b(self) -> list:
        """Bounds bumped by one sign bit (reference `vk.b()`)."""
        return [[[x + 1 if x > 0 else 0 for x in cell] for cell in row]
                for row in self.bounds]

    def b_serialized(self) -> list[int]:
        return [x for row in self.b() for cell in row for x in cell]

    @property
    def b_sum(self) -> int:
        return sum(self.b_serialized())

    @property
    def b_1(self) -> int:
        col_sums = []
        for c in range(self.k):
            s = 0
            for r in range(self.m):
                s += sum(1 << x for x in self.bounds[r][c])
            col_sums.append(s)
        inf_f = max(abs(signed_lift(c, self.q)) for c in self.f)
        return ceil_log2(max(col_sums) + self.d * inf_f)

    @property
    def b_2(self) -> int:
        return ceil_log2(self.q)

    @property
    def l(self) -> int:
        nk = self.n * self.k
        return (self.b_sum + nk * (2 * self.d - 1) * self.b_1
                + nk * (self.d - 1) * self.b_2)

    def b_slices(self) -> list[list[tuple[int, int]]]:
        """Bit ranges of each (i, j) entry of S inside s_1."""
        out = [[None] * self.k for _ in range(self.m)]
        pos = 0
        b = self.b()
        for i in range(self.m):
            for j in range(self.k):
                bits = sum(b[i][j])
                out[i][j] = (pos, pos + bits)
                pos += bits
        return out


@dataclass
class ProverKnowledge:
    vk: VerifierKnowledge
    s: list  # [m][k] polys, coeffs mod q


@dataclass
class LogProof:
    w_shared: cv.Point
    w: cv.Point
    inner_product_proof: ipp.InnerProductProof

    def to_bytes(self) -> bytes:
        return (self.w_shared.encode() + self.w.encode()
                + self.inner_product_proof.to_bytes())

    @staticmethod
    def from_bytes(data: bytes) -> "LogProof":
        return LogProof(
            cv.decode(data[:32]), cv.decode(data[32:64]),
            ipp.InnerProductProof.from_bytes(data[64:]))


# -- transcript protocol ------------------------------------------------------

def _append_vk(t: Transcript, vk: VerifierKnowledge):
    t.append_message(b"dom-sep", b"lr v1")
    t.append_u64(b"m", vk.n)      # reference appends a.rows as "m"
    t.append_u64(b"k", vk.m)      # a.cols as "k"
    t.append_u64(b"n", vk.k)      # t.cols as "n"
    hasher = hashlib.sha3_256()
    for mat, width in ((vk.a, 2 * vk.d - 1), (vk.t, vk.d)):
        for row in mat:
            for p in row:
                for c in p:
                    hasher.update(int(c % vk.q).to_bytes(8, "big"))
    t.append_message(b"a+t", hasher.digest())
    b_msg = b"".join(x.to_bytes(4, "little") for x in vk.b_serialized())
    t.append_message(b"b", b_msg)


def _challenge_scalars(t: Transcript, label: bytes, count: int
                       ) -> list[int]:
    """128-way forked batch challenge generation (reference:
    `transcript.rs` challenge_scalars: fork, draw, re-join); in the host
    C++ where it builds."""
    out = native.fork_challenges(t.strobe, label, count)
    if out is not None:
        return out
    num_batches = 128
    batches = []
    for i in range(num_batches):
        child = Transcript.__new__(Transcript)
        child.strobe = _clone_strobe(t.strobe)
        child.append_u64(b"fork", i)
        batches.append(child)
    out = []
    for i, child in enumerate(batches):
        if i == num_batches - 1:
            size = count - (count // num_batches) * (num_batches - 1)
        else:
            size = count // num_batches
        for _ in range(size):
            out.append(child.challenge_scalar(label))
    for child in batches:
        join = child.challenge_bytes(b"join", 128)
        t.append_message(b"join", join)
    return out


def _clone_strobe(s):
    new = Strobe128.__new__(Strobe128)
    new.state = bytearray(s.state)
    new.pos = s.pos
    new.pos_begin = s.pos_begin
    new.cur_flags = s.cur_flags
    return new


def _create_challenges(vk: VerifierKnowledge, t: Transcript):
    alpha = t.challenge_scalar(b"alpha")
    beta = _challenge_scalars(t, b"beta", vk.k)
    gamma = _challenge_scalars(t, b"gamma", vk.n)
    phi = _challenge_scalars(t, b"phi", vk.l)
    psi = t.challenge_scalar(b"psi")
    return alpha, beta, gamma, phi, psi


# -- serialization of the witness --------------------------------------------

def _serialize_signed(mat, d: int, q: int) -> list[int]:
    """Row-major signed coefficient dump, padded/trimmed to width d
    (coefficients beyond d must be zero)."""
    out = []
    for row in mat:
        for p in row:
            if any(c % q for c in p[d:]):
                raise ValueError("polynomial exceeds the expected degree")
            p = p[:d]
            coeffs = [signed_lift(c, q) for c in p] + [0] * (d - len(p))
            out.extend(coeffs)
    return out


def _compute_factors(vk: VerifierKnowledge, s):
    """R_2 in Z_q[X], R_1 in Z[X] with A·S + q·R_1 + f·R_2 = T over Z[X]
    (all signed lifts)."""
    q = vk.q
    as_q = mat_mul_poly(vk.a, s, q)
    t_as_q = mat_sub(vk.t, as_q, q)
    r_2 = mat_map(t_as_q, lambda p: poly_divmod(p, vk.f, q)[0])
    # integer computation with signed lifts
    lift = lambda p: [signed_lift(c, q) for c in p]  # noqa: E731
    half = q // 2 + 1
    as_z = mat_mul_poly(mat_map(vk.a, lift), mat_map(s, lift),
                        bound=vk.m * vk.d * half * half)
    t_z = mat_map(vk.t, lift)
    r2_z = mat_map(r_2, lift)
    f_z = lift(vk.f)
    r_1 = []
    for i in range(vk.n):
        row = []
        for j in range(vk.k):
            num = poly_sub(poly_sub(t_z[i][j], as_z[i][j]),
                           poly_mul(r2_z[i][j], f_z))
            if any(c % q for c in num):
                raise ValueError("A S + f R_2 - T is not divisible by q")
            row.append([c // q for c in num])
        r_1.append(row)
    return r_2, r_1


def _binary_expand(vk: VerifierKnowledge, s) -> list[int]:
    """s_1 = bits(S) || bits(R_1) || bits(R_2)."""
    q, d = vk.q, vk.d
    r_2, r_1 = _compute_factors(vk, s)
    s_ser = _serialize_signed(s, d, q)
    # r_1 is already integer-valued (signed); dump directly
    r1_ser = []
    for row in r_1:
        for p in row:
            if any(p[2 * d - 1:]):
                raise ValueError("R_1 exceeds degree 2 d - 2")
            p = p[:2 * d - 1]
            r1_ser.extend(list(p) + [0] * (2 * d - 1 - len(p)))
    r2_ser = _serialize_signed(r_2, d - 1, q)

    bits: list[int] = []
    for v, b in zip(s_ser, vk.b_serialized()):
        bits.extend(twos_complement_bits(v, b))
    b_1, b_2 = vk.b_1, vk.b_2
    for v in r1_ser:
        bits.extend(twos_complement_bits(v, b_1))
    for v in r2_ser:
        bits.extend(twos_complement_bits(v, b_2))
    if len(bits) != vk.l:
        raise ValueError(f"{len(bits)} witness bits, the statement has "
                         f"{vk.l}")
    return bits


# -- v / x / t computations ---------------------------------------------------

def _powers(x: int, count: int) -> list[int]:
    out = [1] * count
    for i in range(1, count):
        out[i] = out[i - 1] * x % L
    return out


def _compute_v(vk: VerifierKnowledge, alpha, beta, gamma) -> list[int]:
    d, q = vk.d, vk.q
    alpha_d = _powers(alpha, d)
    # A evaluated at alpha with signed lifts: [n][m] scalars
    a_eval = [[poly_eval([signed_lift(c, q) % L for c in p], alpha, L)
               for p in row] for row in vk.a]
    # (A^T(alpha) * gamma)_r = sum_i a_eval[i][r] * gamma[i]
    a_eval_gamma = [
        sum(a_eval[i][r] * gamma[i] for i in range(vk.n)) % L
        for r in range(vk.m)]
    term_1: list[int] = []
    b = vk.b()
    for r in range(vk.m):
        for j in range(vk.k):
            for c in range(d):
                base = a_eval_gamma[r] * beta[j] % L * alpha_d[c] % L
                for w in twos_complement_coeffs(b[r][j][c]):
                    term_1.append(base * w % L)
    alpha_2d1 = _powers(alpha, 2 * d - 1)
    two_b1 = twos_complement_coeffs(vk.b_1)
    term_2 = []
    for i in range(vk.n):
        gq = gamma[i] * (q % L) % L
        for j in range(vk.k):
            for c in range(2 * d - 1):
                base = gq * beta[j] % L * alpha_2d1[c] % L
                for w in two_b1:
                    term_2.append(base * w % L)
    alpha_d1 = _powers(alpha, d - 1)
    two_b2 = twos_complement_coeffs(vk.b_2)
    f_eval = poly_eval([signed_lift(c, q) % L for c in vk.f], alpha, L)
    term_3 = []
    for i in range(vk.n):
        gf = gamma[i] * f_eval % L
        for j in range(vk.k):
            for c in range(d - 1):
                base = gf * beta[j] % L * alpha_d1[c] % L
                for w in two_b2:
                    term_3.append(base * w % L)
    return term_1 + term_2 + term_3


def _compute_x(vk, gamma, alpha, beta, phi, psi, v) -> int:
    q = vk.q
    t_eval = [[poly_eval([signed_lift(c, q) % L for c in p], alpha, L)
               for p in row] for row in vk.t]
    term_1 = 0
    for i in range(vk.n):
        for j in range(vk.k):
            term_1 = (term_1 + gamma[i] * t_eval[i][j] % L * beta[j]) % L
    term_2 = psi * (sum(v) % L) % L
    term_3 = (psi + psi * psi) % L * (sum(phi) % L) % L
    return (term_1 + term_2 + term_3) % L


def _compute_t(w, g_prime, h, phi, psi, v, device) -> cv.Point:
    v_plus_phi = [(vi + psi * pi) % L for vi, pi in zip(v, phi)]
    t_1 = cv.msm(v_plus_phi, g_prime, device)
    h_sum = cv.IDENTITY
    for pt in h:
        h_sum = h_sum + pt
    return w + t_1 + h_sum * psi


def msm_sizes(l: int, n_shared: int = 0) -> dict[str, list[int]]:
    """The points of each MSM that `create` and `verify` run with cached
    generators (`gens`) outside the native IPP loop, for a statement of l
    bits, n_shared of them shared: create's w_shared, w_unshared and t_1,
    verify's t_1 and the IPP's final MSM, and the sum of h that a
    LogProofGenerators computes once."""
    return {"create": [n_shared + 1, 2 * l - n_shared + 1, l],
            "verify": [l, ipp.final_msm_size(l)], "h_sum": [l]}


def create(transcript: Transcript, pk: ProverKnowledge, g, h, u,
           half_rho: int | None = None,
           shared_indices: list[tuple[int, int]] | None = None,
           gens: "LogProofGenerators | None" = None, device=None,
           rand_fn=None) -> LogProof:
    """Pass `gens` (the LogProofGenerators that produced g/h) to reuse its
    cached point buffers: at production sizes the python Point
    marshalling otherwise costs seconds a proof. `rand_fn` draws half_rho
    when it is None, then the IPP's blindings (the OS by default).
    Raises ValueError when the witness exceeds its bounds."""
    device = resolve_device(device)
    lib = ipp.host_lib(device)
    vk = pk.vk
    shared_indices = shared_indices or []
    if half_rho is None:
        half_rho = rand_fn() if rand_fn is not None else secrets.randbelow(L)
    if not len(g) == len(h) == vk.l:
        raise ValueError(f"need {vk.l} generators, got {len(g)} and "
                         f"{len(h)}")
    l = vk.l
    use_bufs = (lib is not None and gens is not None
                and gens.g is g and gens.h is h)

    _append_vk(transcript, vk)
    s_1 = _binary_expand(vk, pk.s)
    s_2 = [1 - b for b in s_1]

    slices = vk.b_slices()
    shared_mask = [False] * l
    for (i, j) in shared_indices:
        lo, hi = slices[i][j]
        for p in range(lo, hi):
            shared_mask[p] = True

    if use_bufs:
        u_buf = native.points_to_buf([u])
        hb = np.frombuffer(gens.h_buf, np.uint8).reshape(l, 128)
        mask = np.array(shared_mask, dtype=bool)
        n_sh = int(mask.sum())
        w_shared = native.msm_buf(
            [s_1[i] for i in range(l) if shared_mask[i]] + [half_rho],
            hb[mask].tobytes() + u_buf, n_sh + 1, device)
        w_unshared = native.msm_buf(
            [s_1[i] for i in range(l) if not shared_mask[i]]
            + s_2 + [half_rho], hb[~mask].tobytes() + gens.g_buf + u_buf,
            (l - n_sh) + l + 1, device)
    else:
        w_shared = cv.msm(
            [s_1[i] for i in range(l) if shared_mask[i]] + [half_rho],
            [h[i] for i in range(l) if shared_mask[i]] + [u], device)
        w_unshared = cv.msm(
            [s_1[i] for i in range(l) if not shared_mask[i]]
            + s_2 + [half_rho],
            [h[i] for i in range(l) if not shared_mask[i]]
            + list(g) + [u], device)
    w = w_shared + w_unshared

    transcript.append_point(b"w_shared", w_shared)
    transcript.append_point(b"w", w)
    alpha, beta, gamma, phi, psi = _create_challenges(vk, transcript)

    v = _compute_v(vk, alpha, beta, gamma)
    phi_inv = cv.batch_scalar_inv(phi)
    v_plus_phi = [(vi + psi * pi) % L for vi, pi in zip(v, phi)]
    if use_bufs:
        # g' = phi^-1 o g is never materialized: t_1 folds phi^-1 into the
        # MSM's scalars (the verifier's trick), and the IPP prover absorbs
        # it through g_coeff into its deferred generator chains
        g_prime = None
        t_1 = native.msm_buf(
            [vp * pi % L for vp, pi in zip(v_plus_phi, phi_inv)],
            gens.g_buf, l, device)
        t_commit = w + t_1 + gens.h_sum(device) * psi
    else:
        g_prime = cv.batch_mul(phi_inv, g)
        t_commit = _compute_t(w, g_prime, h, phi, psi, v, device)
    v_1 = [(v[i] + phi[i] * s_2[i] + psi * phi[i]) % L
           for i in range(l)]
    v_2 = [(s_1[i] + psi) % L for i in range(l)]
    rho = 2 * half_rho % L

    x = sum(a * b for a, b in zip(v_1, v_2)) % L
    if x != _compute_x(vk, gamma, alpha, beta, phi, psi, v):
        raise RuntimeError("SDLP internal identity failed")

    if use_bufs:
        proof = ipp.create(transcript, v_1, v_2, rho, t_commit, None,
                           None, u, rand_fn=rand_fn,
                           g_buf=_pad_buf_pow2(gens.g_buf, l),
                           h_buf=_pad_buf_pow2(gens.h_buf, l),
                           g_coeff=phi_inv, device=device)
    else:
        proof = ipp.create(transcript, v_1, v_2, rho, t_commit,
                           g_prime, h, u, rand_fn=rand_fn, device=device)
    return LogProof(w_shared, w, proof)


def verify(proof: LogProof, transcript: Transcript,
           vk: VerifierKnowledge, g, h, u,
           gens: "LogProofGenerators | None" = None, device=None) -> bool:
    """Pass `gens` to reuse cached generator buffers. phi^-1 scaling
    is folded into the IPP's MSM scalars (g_coeff) instead of
    materializing g' = phi^-1 o g with l scalar multiplications."""
    device = resolve_device(device)
    lib = ipp.host_lib(device)
    use_bufs = (lib is not None and gens is not None
                and gens.g is g and gens.h is h)
    _append_vk(transcript, vk)
    transcript.append_point(b"w_shared", proof.w_shared)
    transcript.append_point(b"w", proof.w)
    alpha, beta, gamma, phi, psi = _create_challenges(vk, transcript)
    v = _compute_v(vk, alpha, beta, gamma)
    phi_inv = cv.batch_scalar_inv(phi)
    # t_commit = w + <(v + psi*phi) o phi^-1, g> + psi*sum(h)
    #          = w + <v o phi^-1 + psi, g> + psi*sum(h)
    t1_sc = [(vi * pi + psi) % L for vi, pi in zip(v, phi_inv)]
    if use_bufs:
        t_1 = native.msm_buf(t1_sc, gens.g_buf, vk.l, device)
        t_commit = proof.w + t_1 + gens.h_sum(device) * psi
    else:
        h_sum = cv.IDENTITY
        for pt in h:
            h_sum = h_sum + pt
        t_commit = proof.w + cv.msm(t1_sc, g, device) + h_sum * psi
    x = _compute_x(vk, gamma, alpha, beta, phi, psi, v)
    if use_bufs:
        return ipp.verify(proof.inner_product_proof, transcript,
                          t_commit, x, None, None, u, g_coeff=phi_inv,
                          g_buf=gens.g_buf, h_buf=gens.h_buf, device=device)
    return ipp.verify(proof.inner_product_proof, transcript, t_commit,
                      x, g, h, u, g_coeff=phi_inv, device=device)
