"""Zero-knowledge inner product proof, the SDLP's variant (port of
`sunscreen_tpu/logproof/inner_product.py`).

Replaces `logproof/src/inner_product.rs`: proves knowledge of v_1, v_2
with <v_1, v_2> = x (public) against the commitment
t = <v_1, g> + <v_2, h> + rho*u, by log rounds of folding with t_1 / t_-1
cross terms, finished with a Schnorr-style ZK opening (w, w', z_1, z_2,
tau). Unlike the plain Bulletproofs IPP, this variant is itself
zero-knowledge.

`create` and `verify` take the `device` of their MSMs (None means CUDA, as
every entry point of the package; pass "cpu" for the host): on a CUDA
device an MSM of at least 2048 points runs the CUDA Pippenger M1
(`zk/cuda_curve.py`), the rest the host C++ (`zk/native.py`), which must
build there. The prover's loop runs in the host C++ (`native.ipp_prove`)
where it builds, else in python; both give the same bytes.
"""

from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass

from sunscreen_tpu_torch import resolve_device
from sunscreen_tpu_torch.zk import curve25519 as cv
from sunscreen_tpu_torch.zk import native
from sunscreen_tpu_torch.zk.merlin import Transcript

L = cv.L


def get_u() -> cv.Point:
    """Blinding generator (reference: VerifierKnowledge::get_u)."""
    shake = hashlib.shake_256()
    shake.update(b"u")
    return cv.from_uniform_bytes(shake.digest(64))


def _rand() -> int:
    return secrets.randbelow(L)


def host_lib(device):
    """The host library for a proof on `device`: required on CUDA
    (`NativeBuildError` otherwise), optional (None) on the CPU."""
    if device.type == "cuda":
        return native.require_lib()
    return native.get_lib()


@dataclass
class InnerProductProof:
    t_1: list[cv.Point]
    t_minus1: list[cv.Point]
    w: cv.Point
    w_prime: cv.Point
    z_1: int
    z_2: int
    tau: int

    def to_bytes(self) -> bytes:
        out = len(self.t_1).to_bytes(4, "little")
        for a, b in zip(self.t_1, self.t_minus1):
            out += a.encode() + b.encode()
        out += self.w.encode() + self.w_prime.encode()
        out += cv.scalar_to_bytes(self.z_1)
        out += cv.scalar_to_bytes(self.z_2)
        out += cv.scalar_to_bytes(self.tau)
        return out

    @staticmethod
    def from_bytes(data: bytes) -> "InnerProductProof":
        """Raises `cv.DecodeError` on truncated input, absurd round
        counts, or non-canonical point/scalar encodings."""
        if len(data) < 4:
            raise cv.DecodeError("truncated inner-product proof")
        lg = int.from_bytes(data[:4], "little")
        if lg > 64:  # 2^64 elements is unrepresentable: reject early
            raise cv.DecodeError("implausible round count")
        if len(data) != 4 + 64 * lg + 64 + 96:
            raise cv.DecodeError("inner-product proof length mismatch")
        off = 4
        t1, tm1 = [], []
        for _ in range(lg):
            t1.append(cv.decode(data[off:off + 32]))
            tm1.append(cv.decode(data[off + 32:off + 64]))
            off += 64
        w = cv.decode(data[off:off + 32])
        wp = cv.decode(data[off + 32:off + 64])
        off += 64
        z1, z2, tau = (
            cv.scalar_from_canonical_bytes(data[off + 32 * i:
                                                off + 32 * (i + 1)])
            for i in range(3))
        return InnerProductProof(t1, tm1, w, wp, z1, z2, tau)


def _domain_sep(t: Transcript, tv: cv.Point, x: int):
    t.append_message(b"dom-sep", b"ipp v1")
    t.append_message(b"t", tv.encode())
    t.append_scalar(b"x", x)


def _pad_pow2(v, fill):
    n = len(v)
    target = 1 << max(0, (n - 1).bit_length())
    return list(v) + [fill] * (target - n)


def create(transcript: Transcript, v_1, v_2, rho: int, t_commit: cv.Point,
           g, h, u: cv.Point, rand_fn=None,
           g_buf: bytes | None = None, h_buf: bytes | None = None,
           g_coeff=None, device=None) -> InnerProductProof:
    """`rand_fn`: the source of the blinding scalars (the OS by default;
    tests inject a seeded one to pin byte equality). `g_buf`/`h_buf`:
    128-byte-a-point buffers of g/h padded to the power of two (callers
    with cached generator buffers pass g=None/h=None). `g_coeff` (one
    scalar a real g point): the prover's g bases become g_coeff o g
    virtually, absorbed by the native deferred chains, so the SDLP's
    g' = phi^-1 o g costs no pass of its own."""
    device = resolve_device(device)
    lib = host_lib(device)
    if len(v_1) != len(v_2) or (g is not None
                                and not len(v_1) == len(g) == len(h)):
        raise ValueError("v_1, v_2, g and h need one length")
    n_real = len(v_1)
    rand = rand_fn or _rand
    x = sum(a * b for a, b in zip(v_1, v_2)) % L
    v_1 = _pad_pow2([a % L for a in v_1], 0)
    v_2 = _pad_pow2([a % L for a in v_2], 0)
    n = len(v_1)
    if g_coeff is not None:
        g_coeff = _pad_pow2([int(c) % L for c in g_coeff], 1)

    _domain_sep(transcript, t_commit, x)
    a_pt = cv.from_uniform_bytes(transcript.challenge_bytes(b"a", 64))

    if n > 1 and lib is not None:
        lg = n.bit_length() - 1
        rand_scalars = [rand() for _ in range(2 * lg + 4)]
        if g_buf is None:
            g_buf = native.points_to_buf(_pad_pow2(list(g), cv.IDENTITY))
        if h_buf is None:
            h_buf = native.points_to_buf(_pad_pow2(list(h), cv.IDENTITY))
        t1_vec, tm1_vec, w, w_prime, z_1, z_2, tau = native.ipp_prove(
            transcript.strobe, v_1, v_2, g_buf, h_buf, a_pt, u, rho,
            rand_scalars, n, n_real=n_real, g_coeff=g_coeff)
        return InnerProductProof(t1_vec, tm1_vec, w, w_prime, z_1, z_2, tau)

    if g is None:
        g = native.buf_to_points(g_buf, n)
        h = native.buf_to_points(h_buf, n)
    if g_coeff is not None:
        # the python path materializes the coefficient-scaled bases
        g = [gp * c for gp, c in zip(list(g), g_coeff[:len(g)])]
    g = _pad_pow2(list(g), cv.IDENTITY)
    h = _pad_pow2(list(h), cv.IDENTITY)

    t1_vec: list[cv.Point] = []
    tm1_vec: list[cv.Point] = []
    while len(v_1) > 1:
        n2 = len(v_1) // 2
        v1t, v1b = v_1[:n2], v_1[n2:]
        v2t, v2b = v_2[:n2], v_2[n2:]
        gt, gb = g[:n2], g[n2:]
        ht, hb = h[:n2], h[n2:]
        sigma = rand()
        sigma_m1 = rand()
        x_m1 = sum(a * b for a, b in zip(v1b, v2t)) % L
        x_p1 = sum(a * b for a, b in zip(v1t, v2b)) % L
        t_m1 = cv.msm(v1b + v2t + [x_m1, sigma_m1], gt + hb + [a_pt, u],
                      device)
        t_p1 = cv.msm(v1t + v2b + [x_p1, sigma], gb + ht + [a_pt, u],
                      device)
        transcript.append_point(b"t-1", t_m1)
        transcript.append_point(b"t1", t_p1)
        c = transcript.challenge_scalar(b"c")
        c_inv = cv.scalar_inv(c)
        g = cv.fold_points(gt, gb, c)
        h = cv.fold_points(ht, hb, c_inv)
        v_1 = [(v1t[i] + v1b[i] * c_inv) % L for i in range(n2)]
        v_2 = [(v2t[i] + v2b[i] * c) % L for i in range(n2)]
        t1_vec.append(t_p1)
        tm1_vec.append(t_m1)
        rho = (c_inv * sigma_m1 + rho + c * sigma) % L

    y_1, y_2 = rand(), rand()
    sig, sig_p = rand(), rand()
    w = g[0] * y_1 + h[0] * y_2 \
        + a_pt * ((y_1 * v_2[0] + y_2 * v_1[0]) % L) + u * sig
    w_prime = a_pt * (y_1 * y_2 % L) + u * sig_p
    transcript.append_point(b"w", w)
    transcript.append_point(b"w'", w_prime)
    c = transcript.challenge_scalar(b"c")
    z_1 = (y_1 + c * v_1[0]) % L
    z_2 = (y_2 + c * v_2[0]) % L
    tau = (c * rho + sig + cv.scalar_inv(c) * sig_p) % L
    return InnerProductProof(t1_vec, tm1_vec, w, w_prime, z_1, z_2, tau)


def _s_vector(cs, n: int) -> list[int]:
    """s[i] = prod_{j: bit j of i} cs[lg-1-j]: the IPP verifier's
    folded-generator exponents (host C++ where it builds)."""
    out = native.ipp_s_vector(cs, n)
    if out is not None:
        return out
    lg = len(cs)
    s = [1] * n
    for i in range(1, n):
        j = (i & -i).bit_length() - 1
        s[i] = s[i - (1 << j)] * cs[lg - 1 - j] % L
    return s


def final_msm_size(n_raw: int) -> int:
    """Points of `verify`'s one MSM over n_raw unpadded generator pairs
    (the buffer path): g and h, a, u, t, w, w' and the 2 log2 n cross
    terms."""
    return 2 * n_raw + 5 + 2 * (n_raw - 1).bit_length()


def verify(proof: InnerProductProof, transcript: Transcript,
           t_commit: cv.Point, x: int, g, h, u: cv.Point,
           g_coeff=None, h_coeff=None,
           g_buf: bytes | None = None, h_buf: bytes | None = None,
           device=None) -> bool:
    """One MSM: every term of lhs == rhs moved to one side and checked
    against the identity, instead of folded generators (two MSMs) and
    2 log n scalar multiplications. `g_coeff`/`h_coeff` are per-index
    premultipliers (generator i is g_coeff[i] g[i]), which fold the SDLP's
    phi^-1 into the MSM's scalars. `g_buf`/`h_buf` (unpadded) skip the
    point marshalling; g/h may then be None."""
    device = resolve_device(device)
    lib = host_lib(device)
    n_raw = len(g) if g is not None else len(g_buf) // 128
    n = 1 << max(0, (n_raw - 1).bit_length())
    if len(proof.t_1) != len(proof.t_minus1):
        return False
    if (1 << len(proof.t_1)) != n:
        return False

    _domain_sep(transcript, t_commit, x)
    a_pt = cv.from_uniform_bytes(transcript.challenge_bytes(b"a", 64))

    cs = []
    for t_p1, t_m1 in zip(proof.t_1, proof.t_minus1):
        transcript.append_point(b"t-1", t_m1)
        transcript.append_point(b"t1", t_p1)
        cs.append(transcript.challenge_scalar(b"c"))
    transcript.append_point(b"w", proof.w)
    transcript.append_point(b"w'", proof.w_prime)
    c = transcript.challenge_scalar(b"c")
    c_inv = cv.scalar_inv(c)
    cs_inv = cv.batch_scalar_inv(cs) if cs else []

    s = _s_vector(cs, n)
    s_inv = _s_vector(cs_inv, n)
    z_1, z_2 = proof.z_1 % L, proof.z_2 % L
    g_sc = [si * z_1 % L for si in s]
    h_sc = [si * z_2 % L for si in s_inv]
    if g_coeff is not None:
        for i, gc in enumerate(g_coeff):
            g_sc[i] = g_sc[i] * gc % L
    if h_coeff is not None:
        for i, hc in enumerate(h_coeff):
            h_sc[i] = h_sc[i] * hc % L

    # rhs - lhs == 0, as one MSM:
    #   g: s*z1(*coeff)   h: s_inv*z2(*coeff)
    #   a: c_inv*z1*z2 - x*c          u: tau
    #   t_commit: -c    t_m1[r]: -c*c_inv_r    t_1[r]: -c*c_r
    #   w: -1           w': -c_inv
    extra_pts = ([a_pt, u, t_commit, proof.w, proof.w_prime]
                 + list(proof.t_minus1) + list(proof.t_1))
    extra_sc = ([(c_inv * z_1 % L * z_2 - x * c) % L,
                 proof.tau % L, (-c) % L, L - 1, (-c_inv) % L]
                + [(-c * ci) % L for ci in cs_inv]
                + [(-c * cr) % L for cr in cs])
    if g_buf is not None and lib is not None:
        # the padding generators are the identity: left out of the MSM
        buf = (bytes(g_buf) + bytes(h_buf)
               + native.points_to_buf(extra_pts))
        return native.msm_buf(
            g_sc[:n_raw] + h_sc[:n_raw] + extra_sc, buf,
            final_msm_size(n_raw), device) == cv.IDENTITY
    if g is None:
        g = native.buf_to_points(g_buf, n_raw)
        h = native.buf_to_points(h_buf, n_raw)
    g = _pad_pow2(list(g), cv.IDENTITY)
    h = _pad_pow2(list(h), cv.IDENTITY)
    return cv.msm(g_sc + h_sc + extra_sc, g + h + extra_pts,
                  device) == cv.IDENTITY
