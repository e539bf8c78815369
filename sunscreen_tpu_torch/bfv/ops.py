"""BFV evaluator ops on int64 torch tensors (port of
`sunscreen_tpu/bfv/ops.py`, along the reference's TPU-default branches:
the fused base extension, `fwd_tensor3` + `inv` and the chained
scale+convert in `multiply`; `fwd_broadcast`, `inv_ks` and the fused
mod-down in `keyswitch`, which relinearization and rotations share).

Ciphertexts are [..., n_comp, k, N] in the coefficient domain;
plaintexts [..., N] with coefficients in [0, t). Multiplication is the
HPS RNS variant with exact fixed-point corrections (`math/rns.py`,
`math/prns.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from sunscreen_tpu_torch.bfv.context import BfvContext
from sunscreen_tpu_torch.bfv.keys import (GaloisKeys, KswKey, PublicKey,
                                          SecretKey)
from sunscreen_tpu_torch.errors import InvalidArgument
from sunscreen_tpu_torch.math import modular as m
from sunscreen_tpu_torch.math import pmntt, rns, sampling


def _q(ctx):
    return ctx.q_base.q


def scale_plain(ctx: BfvContext, pt):
    """[..., N] plaintext (coeffs < t) -> [..., k, N] = [round(Q*m/t)]_Q:
    m*floor(Q/t) plus round(m*frac(Q/t)) by exact 128-bit fixed point."""
    pt = pt.to(torch.int64)
    (_, r_lo), _ = rns.fixed_point_dot(
        pt.unsqueeze(-2), ctx.delta_frac_hi, ctx.delta_frac_lo,
        add_half=True)
    q = _q(ctx)
    base = pt.unsqueeze(-2) * ctx.delta_mod_q % q
    return m.add_mod(base, m.reduce_2q(r_lo.unsqueeze(-2), q), q)


def encrypt(ctx: BfvContext, pk: PublicKey, pt, gen: torch.Generator):
    """c = (pk0*u + e1 + Δm, pk1*u + e2) for every plaintext row of
    `pt` [..., N]; fresh u, e1, e2 per row."""
    pt = pt.to(device=ctx.device, dtype=torch.int64)
    shape, q = tuple(pt.shape), _q(ctx)
    u = ctx.plan_q.fwd(sampling.signed_to_rns(
        sampling.ternary(gen, shape, ctx.device), q))
    c0 = ctx.plan_q.inv(ctx.plan_q.pointwise_mul(pk.p0, u))
    c1 = ctx.plan_q.inv(ctx.plan_q.pointwise_mul(pk.p1, u))
    e1 = sampling.signed_to_rns(sampling.cbd(gen, shape, ctx.device), q)
    e2 = sampling.signed_to_rns(sampling.cbd(gen, shape, ctx.device), q)
    c0 = m.add_mod(m.add_mod(c0, e1, q), scale_plain(ctx, pt), q)
    c1 = m.add_mod(c1, e2, q)
    return torch.stack([c0, c1], dim=-3)


def _ct_dot_s(ctx: BfvContext, ct, sk: SecretKey):
    """v = sum_j c_j * s^j mod Q (NTT-domain Horner)."""
    n_comp = ct.shape[-3]
    q = _q(ctx)
    c_hat = ctx.plan_q.fwd(ct)
    acc = c_hat[..., n_comp - 1, :, :]
    for j in range(n_comp - 2, -1, -1):
        acc = m.add_mod(ctx.plan_q.pointwise_mul(acc, sk.s_ntt_q),
                        c_hat[..., j, :, :], q)
    return ctx.plan_q.inv(acc)


def decrypt(ctx: BfvContext, sk: SecretKey, ct):
    """[..., n_comp, k, N] -> [..., N] plaintext coefficients in [0, t)."""
    msg, _ = ctx.decrypt_scaler.apply(_ct_dot_s(ctx, ct, sk))
    return msg


def invariant_noise_budget(ctx: BfvContext, sk: SecretKey, ct):
    """floor(log2(Q / (2 max|centered(t c(s) mod Q)|))) per ciphertext,
    from an exact CRT composition on the host (float, or an array of
    them for a batch)."""
    v = _ct_dot_s(ctx, ct, sk).cpu().numpy()
    qb = ctx.q_base
    big_q, t = qb.product, int(ctx.t)
    lifts = np.array([p * i % big_q for p, i in
                      zip(qb.punctured, qb.inv_punctured)], dtype=object)
    lead = v.shape[:-2]
    flat = v.reshape((-1, qb.k, v.shape[-1])).astype(object)
    out = np.empty((flat.shape[0],), dtype=np.float64)
    for r in range(flat.shape[0]):
        cs = (flat[r] * lifts[:, None]).sum(axis=0) % big_q
        rem = (cs * t) % big_q
        dist = int(np.maximum(np.minimum(rem, big_q - rem), 1).max())
        out[r] = float((big_q // (2 * dist)).bit_length() - 1) \
            if 2 * dist <= big_q else 0.0
    return out.reshape(lead) if lead else out[0]


def _pad_components(ct, n_comp):
    pad = n_comp - ct.shape[-3]
    if pad == 0:
        return ct
    return torch.cat([ct, ct.new_zeros(*ct.shape[:-3], pad,
                                       *ct.shape[-2:])], dim=-3)


def add(ctx: BfvContext, a, b):
    n_comp = max(a.shape[-3], b.shape[-3])
    return m.add_mod(_pad_components(a, n_comp), _pad_components(b, n_comp),
                     _q(ctx))


def _scale_convert(ctx: BfvContext, tensor):
    """round(t * tensor / Q) mapped into base Q: the chained kernel B7
    on CUDA, scale-and-round into B then the centered conversion to Q
    on the CPU."""
    return ctx.scale_convert_op()(tensor)


def multiply(ctx: BfvContext, a, b):
    """ct×ct tensor multiply with t/Q scaling: centered base extension
    Q -> Q∪B (kernel B6 on CUDA), forward NTTs and component products,
    inverse NTT, then exact scale-and-round into B chained with the
    centered conversion B -> Q (kernel B7 on CUDA). Output has
    n_a + n_b - 1 components."""
    na, nb = a.shape[-3], b.shape[-3]
    plan = ctx.plan_mul
    ext = ctx.conv_q_to_aux.extend(torch.cat([a, b], dim=-3), centered=True)
    if (na == 2 and nb == 2
            and (ext.device.type == "cpu" or ctx.n <= pmntt.TENSOR3_MAX_N)):
        tensor = plan.inv(plan.fwd_tensor3(ext))
    else:
        both = plan.fwd(ext)
        outs = []
        for j in range(na + nb - 1):
            terms = [plan.pointwise_mul(both[..., ia, :, :],
                                        both[..., na + j - ia, :, :])
                     for ia in range(na) if 0 <= j - ia < nb]
            outs.append(sum(terms) % plan.q)
        tensor = plan.inv(torch.stack(outs, dim=-3))
    return _scale_convert(ctx, tensor)


def keyswitch(ctx: BfvContext, d, ksw: KswKey):
    """Switch poly d ([..., k, N], coefficient domain) to the target key:
    (u0, u1) over Q after the special-prime mod-down. The k raw digits
    are transformed under every key modulus (exact for any u32, and the
    NTT is linear mod each modulus), contracted against the key and
    inverse-transformed in one kernel. The mod-down reads the Q limbs
    and the special limb of that output in place."""
    d_hat = ctx.plan_key.fwd_broadcast(d)      # [..., k(digit), k+1, N]
    both = ctx.plan_key.inv_ks(d_hat, ksw.k0, ksw.k1)   # [..., 2, k+1, N]
    u = ctx.mod_down.apply(both[..., :ctx.k, :], both[..., ctx.k, :])
    return u[..., 0, :, :], u[..., 1, :, :]


def relinearize(ctx: BfvContext, ct, rlk: KswKey):
    """3-component -> 2-component."""
    if ct.shape[-3] != 3:
        raise InvalidArgument(
            f"relinearize expects a 3-component ct, got {ct.shape[-3]}")
    u0, u1 = keyswitch(ctx, ct[..., 2, :, :], rlk)
    q = _q(ctx)
    return torch.stack([m.add_mod(ct[..., 0, :, :], u0, q),
                        m.add_mod(ct[..., 1, :, :], u1, q)], dim=-3)


def multiply_relin(ctx: BfvContext, a, b, rlk: KswKey):
    return relinearize(ctx, multiply(ctx, a, b), rlk)


# --------------------------------------------------------------------------
# Galois / rotations
# --------------------------------------------------------------------------

def _permute(ctx: BfvContext, poly, g: int):
    """a(x) -> a(x^g) on [..., k, N] coefficient-domain residues."""
    idx, neg = ctx.galois_table(g)
    gathered = poly[..., idx]
    return torch.where(neg, m.neg_mod(gathered, _q(ctx)), gathered)


def apply_galois(ctx: BfvContext, ct, g: int, gks: GaloisKeys):
    """a(x) -> a(x^g) on a 2-component ct, then keyswitch back to s
    (SEAL: `Evaluator::apply_galois`)."""
    if ct.shape[-3] != 2:
        raise InvalidArgument(
            f"apply_galois expects a 2-component ct, got {ct.shape[-3]}")
    c0p = _permute(ctx, ct[..., 0, :, :], g)
    c1p = _permute(ctx, ct[..., 1, :, :], g)
    u0, u1 = keyswitch(ctx, c1p, gks[g])
    return torch.stack([m.add_mod(c0p, u0, _q(ctx)), u1], dim=-3)


def rotate_rows(ctx: BfvContext, ct, steps: int, gks: GaloisKeys):
    """Cyclically rotate each batching row by `steps` (SEAL:
    `Evaluator::rotate_rows`). Without a key for the exact element, the
    rotation is composed from the power-of-two keys, lowest bit first."""
    steps %= ctx.n // 2
    if steps == 0:
        return ct
    g = ctx.rotate_rows_element(steps)
    if g in gks:
        return apply_galois(ctx, ct, g, gks)
    out, bit = ct, 1
    while steps:
        if steps & 1:
            gb = ctx.rotate_rows_element(bit)
            if gb not in gks:
                raise KeyError(f"missing galois key for rotation {bit}")
            out = apply_galois(ctx, out, gb, gks)
        steps >>= 1
        bit <<= 1
    return out


def rotate_columns(ctx: BfvContext, ct, gks: GaloisKeys):
    """Swap the two batching rows (SEAL: `Evaluator::rotate_columns`)."""
    return apply_galois(ctx, ct, ctx.rotate_columns_element, gks)
