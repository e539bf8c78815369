"""Inner-product argument (Bulletproofs core; port of
`sunscreen_tpu/zk/ipp.py`). `device` is passed on to every `c.msm`: the
verifier's final multiexp (2n + 2 lg n + 1 points) runs on the card from
n = 1024 on a CUDA device.

Replaces the reference's dalek-fork `inner_product_proof.rs` as used by
the R1CS proof system (and mirrored by logproof's own ZK variant,
`logproof/src/inner_product.rs`). Proves <a, b> = c against
P = <a, G'> + <b, H'> + c*Q with log2(n) rounds of folding.
"""

from __future__ import annotations

from dataclasses import dataclass

from sunscreen_tpu_torch.zk import curve25519 as c
from sunscreen_tpu_torch.zk.merlin import Transcript

L_FIELD = c.L


@dataclass
class InnerProductProof:
    L_vec: list[c.Point]
    R_vec: list[c.Point]
    a: int
    b: int


def _ipp_domain_sep(t: Transcript, n: int):
    t.append_message(b"dom-sep", b"ipp v1")
    t.append_u64(b"n", n)


def create(transcript: Transcript, Q: c.Point, G_factors, H_factors,
           G, H, a, b, device=None) -> InnerProductProof:
    n = len(G)
    if n & (n - 1) or not len(H) == len(a) == len(b) == n:
        raise ValueError("the IPP needs power-of-two vectors of one length")
    _ipp_domain_sep(transcript, n)
    a = [x % L_FIELD for x in a]
    b = [x % L_FIELD for x in b]
    G = list(G)
    H = list(H)
    gf = [x % L_FIELD for x in G_factors]
    hf = [x % L_FIELD for x in H_factors]
    L_vec: list[c.Point] = []
    R_vec: list[c.Point] = []
    first = True
    while n > 1:
        n //= 2
        a_lo, a_hi = a[:n], a[n:]
        b_lo, b_hi = b[:n], b[n:]
        G_lo, G_hi = G[:n], G[n:]
        H_lo, H_hi = H[:n], H[n:]
        c_L = sum(x * y for x, y in zip(a_lo, b_hi)) % L_FIELD
        c_R = sum(x * y for x, y in zip(a_hi, b_lo)) % L_FIELD
        if first:
            # fold the G/H factors into the first round's exponents
            L_pt = c.msm(
                [x * gf[n + i] % L_FIELD for i, x in enumerate(a_lo)]
                + [x * hf[i] % L_FIELD for i, x in enumerate(b_hi)]
                + [c_L],
                G_hi + H_lo + [Q], device)
            R_pt = c.msm(
                [x * gf[i] % L_FIELD for i, x in enumerate(a_hi)]
                + [x * hf[n + i] % L_FIELD for i, x in enumerate(b_lo)]
                + [c_R],
                G_lo + H_hi + [Q], device)
        else:
            L_pt = c.msm(a_lo + b_hi + [c_L], G_hi + H_lo + [Q], device)
            R_pt = c.msm(a_hi + b_lo + [c_R], G_lo + H_hi + [Q], device)
        L_vec.append(L_pt)
        R_vec.append(R_pt)
        transcript.append_point(b"L", L_pt)
        transcript.append_point(b"R", R_pt)
        u = transcript.challenge_scalar(b"u")
        u_inv = c.scalar_inv(u)
        a = [(a_lo[i] * u + u_inv * a_hi[i]) % L_FIELD for i in range(n)]
        b = [(b_lo[i] * u_inv + u * b_hi[i]) % L_FIELD for i in range(n)]
        if first:
            lo = c.batch_mul([u_inv * gf[i] % L_FIELD for i in range(n)],
                             G_lo)
            hi = c.batch_mul([u * gf[n + i] % L_FIELD for i in range(n)],
                             G_hi)
            G = [x + y for x, y in zip(lo, hi)]
            lo = c.batch_mul([u * hf[i] % L_FIELD for i in range(n)],
                             H_lo)
            hi = c.batch_mul([u_inv * hf[n + i] % L_FIELD
                              for i in range(n)], H_hi)
            H = [x + y for x, y in zip(lo, hi)]
            first = False
        else:
            # G_lo*u_inv + G_hi*u = u_inv*(G_lo + u^2*G_hi)
            u_sq = u * u % L_FIELD
            G = c.batch_mul([u_inv] * n,
                            c.fold_points(G_lo, G_hi, u_sq))
            H = c.batch_mul([u] * n,
                            c.fold_points(H_lo, H_hi,
                                          u_inv * u_inv % L_FIELD))
    if first:
        # n == 1 from the start: factors never folded
        G = [c.msm([gf[0]], [G[0]])]
        H = [c.msm([hf[0]], [H[0]])]
    return InnerProductProof(L_vec, R_vec, a[0], b[0])


def verification_scalars(proof: InnerProductProof, n: int,
                         transcript: Transcript):
    """(u_sq, u_inv_sq, s) — the exponents of L_j, R_j and G_i/H_i in the
    final verification multiexp."""
    lg_n = len(proof.L_vec)
    if n != 1 << lg_n:
        raise ValueError(f"{lg_n} IPP rounds do not fold {n} generators")
    _ipp_domain_sep(transcript, n)
    challenges = []
    for L_pt, R_pt in zip(proof.L_vec, proof.R_vec):
        transcript.append_point(b"L", L_pt)
        transcript.append_point(b"R", R_pt)
        challenges.append(transcript.challenge_scalar(b"u"))
    u_sq = [u * u % L_FIELD for u in challenges]
    u_inv = [c.scalar_inv(u) for u in challenges]
    u_inv_sq = [u * u % L_FIELD for u in u_inv]
    # s_i = prod_j u_j^{±1}: binary expansion of i
    s = []
    all_inv = 1
    for u in u_inv:
        all_inv = all_inv * u % L_FIELD
    for i in range(n):
        si = all_inv
        for j in range(lg_n):
            if (i >> (lg_n - 1 - j)) & 1:
                si = si * u_sq[j] % L_FIELD
        s.append(si)
    return u_sq, u_inv_sq, s


def verify(proof: InnerProductProof, n: int, transcript: Transcript,
           G_factors, H_factors, P: c.Point, Q: c.Point, G, H,
           device=None) -> bool:
    u_sq, u_inv_sq, s = verification_scalars(proof, n, transcript)
    a, b = proof.a % L_FIELD, proof.b % L_FIELD
    g_exp = [a * s[i] % L_FIELD * (G_factors[i] % L_FIELD) % L_FIELD
             for i in range(n)]
    s_inv = s[::-1]
    h_exp = [b * s_inv[i] % L_FIELD * (H_factors[i] % L_FIELD) % L_FIELD
             for i in range(n)]
    expect = c.msm(
        [a * b % L_FIELD] + g_exp + h_exp
        + [(-u) % L_FIELD for u in u_sq]
        + [(-u) % L_FIELD for u in u_inv_sq],
        [Q] + list(G) + list(H) + proof.L_vec + proof.R_vec, device)
    return expect == P
