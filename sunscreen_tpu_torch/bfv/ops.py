"""BFV evaluator ops on int64 torch tensors (port of
`sunscreen_tpu/bfv/ops.py`).

Ciphertexts are [..., n_comp, k, N] in the coefficient domain;
plaintexts [..., N] with coefficients in [0, t). Multiplication is the
HPS RNS variant with exact fixed-point corrections (`math/rns.py`,
`math/prns.py`).

The reference picks between fused routes with environment settings,
read at call time; the port reads the same names the same way, so a
deployment's settings carry over (every route gives the same bits):

* `SUNSCREEN_TPU_FUSE_FT3` (default on), `SUNSCREEN_TPU_FUSE_T3`
  (default off), `SUNSCREEN_TPU_FUSE_INV` (default on): the tensor
  product of `multiply` (`multiply_route`); `SUNSCREEN_TPU_FUSE_TFULL=1`
  runs the inverse transforms inside the FT3 kernel (B13);
* `SUNSCREEN_TPU_FUSE_SC` (default on): the scale back to Q
  (`scale_convert_route`);
* `SUNSCREEN_TPU_FUSE_KSFULL` (default off), `SUNSCREEN_TPU_FUSE_KS`
  (default on) and `SUNSCREEN_TPU_FUSE_INV`: the keyswitch
  (`keyswitch_route`); `FUSE_KSFULL=1` runs the megakernel B14;
* `SUNSCREEN_TPU_FUSED_RNS=0` asks for the reference's plain glue, which
  the port runs only on the CPU: it raises for CUDA tensors and changes
  nothing on the CPU, whose path is always the plain twins.

Under the NTT mode "pallas_vpu" (`SUNSCREEN_TPU_NTT`, the context's
`mode`) the routes follow the reference's own behaviour: its
`PallasNttPlan` reports mode "pallas" (`sunscreen_tpu/math/pntt.py:222`)
but lacks the fused methods that mode implies, so its `multiply` works
only under `FUSE_FT3=0` or `FUSE_INV=0` and its keyswitch never does.
The port runs those same routes and raises `NotImplementedError` where
the reference raises `AttributeError`.

On the u64 engine (a modulus above 2^30: `BfvParams.default`) no fusion
setting applies, as in the reference, whose fused paths test for the
u32 dtype: both routes are "pointwise", plain PyTorch on every device
over the context's u64 plan ("unrolled", "compact" or "matmul"). The
same routes serve a u32 context under one of those modes, whose plans
have no fused methods.

Each evaluator op runs in a span of its name (`bfv.multiply`,
`bfv.keyswitch`, `bfv.permute` for the Galois permutation, ...;
`observability.span`), which costs a flag test while span recording is
off.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sunscreen_tpu_torch import observability as obs
from sunscreen_tpu_torch.bfv.context import BfvContext, get_context
from sunscreen_tpu_torch.bfv.keys import (GaloisKeys, KswKey, PublicKey,
                                          SecretKey)
from sunscreen_tpu_torch.bfv.params import BfvParams
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
    if ctx.q_base.u64:
        base = m.reduce_2q(m.mul_mod_shoup(pt.unsqueeze(-2), ctx.delta_mod_q,
                                           ctx.delta_mod_q_sh, q), q)
    else:
        base = pt.unsqueeze(-2) * ctx.delta_mod_q % q
    return m.add_mod(base, m.reduce_2q(r_lo.unsqueeze(-2), q), q)


def _encrypt_noise(ctx: BfvContext, shape, gen: torch.Generator):
    """Fresh (u, e0, e1) small polys of `shape`: ternary, CBD, CBD."""
    return (sampling.ternary(gen, shape, ctx.device),
            sampling.cbd(gen, shape, ctx.device),
            sampling.cbd(gen, shape, ctx.device))


def _encrypt_parts(ctx: BfvContext, pk: PublicKey, pt, u, e0, e1):
    """c = (pk0*u + e0 + Δm, pk1*u + e1) from the small polys."""
    q = _q(ctx)
    u_hat = ctx.plan_q.fwd(sampling.signed_to_rns(u, q))
    c0 = ctx.plan_q.inv(ctx.plan_q.pointwise_mul(pk.p0, u_hat))
    c1 = ctx.plan_q.inv(ctx.plan_q.pointwise_mul(pk.p1, u_hat))
    c0 = m.add_mod(m.add_mod(c0, sampling.signed_to_rns(e0, q), q),
                   scale_plain(ctx, pt), q)
    c1 = m.add_mod(c1, sampling.signed_to_rns(e1, q), q)
    return torch.stack([c0, c1], dim=-3)


def encrypt(ctx: BfvContext, pk: PublicKey, pt, gen: torch.Generator):
    """c = (pk0*u + e1 + Δm, pk1*u + e2) for every plaintext row of
    `pt` [..., N]; fresh u, e1, e2 per row."""
    pt = pt.to(device=ctx.device, dtype=torch.int64)
    return _encrypt_parts(ctx, pk, pt, *_encrypt_noise(ctx, pt.shape, gen))


def encrypt_return_components(ctx: BfvContext, pk: PublicKey, pt,
                              gen: torch.Generator):
    """`encrypt`, also returning its randomness (u, e0, e1) as small
    signed int64 polys (SEAL: `Encryptor::encrypt_return_components`)."""
    pt = pt.to(device=ctx.device, dtype=torch.int64)
    noise = _encrypt_noise(ctx, pt.shape, gen)
    return (_encrypt_parts(ctx, pk, pt, *noise),
            tuple(v.to(torch.int64) for v in noise))


def _encrypt_symmetric_parts(ctx: BfvContext, sk: SecretKey, pt, a, e):
    """c = (-(a*s + e) + Δm, a) from the mask a [..., k, N] and the
    small noise e [..., N]."""
    q = _q(ctx)
    as_ = ctx.plan_q.inv(ctx.plan_q.pointwise_mul(ctx.plan_q.fwd(a),
                                                  sk.s_ntt_q))
    c0 = m.add_mod(m.neg_mod(m.add_mod(as_, sampling.signed_to_rns(e, q),
                                       q), q),
                   scale_plain(ctx, pt), q)
    return torch.stack([c0, a], dim=-3)


def encrypt_symmetric_return_components(ctx: BfvContext, sk: SecretKey,
                                        pt, gen: torch.Generator):
    """Symmetric encryption c = (-(a*s + e) + Δm, a) with a fresh mask
    and noise per plaintext row; returns (ct, e as int64)."""
    pt = pt.to(device=ctx.device, dtype=torch.int64)
    a = sampling.uniform_mod_q(gen, pt.shape, ctx.q_base)
    e = sampling.cbd(gen, pt.shape, ctx.device)
    return _encrypt_symmetric_parts(ctx, sk, pt, a, e), e.to(torch.int64)


def encrypt_symmetric(ctx: BfvContext, sk: SecretKey, pt,
                      gen: torch.Generator):
    """c = (-(a*s + e) + Δm, a). SEAL: `Encryptor::encrypt_symmetric`."""
    return encrypt_symmetric_return_components(ctx, sk, pt, gen)[0]


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


_SIGN = -(1 << 63)


def _umax(x, dim: int):
    """Max of u64 bit patterns in int64 along `dim`."""
    return (x ^ _SIGN).amax(dim) ^ _SIGN


def noise_distance_words(ctx: BfvContext, sk: SecretKey, ct):
    """Max over coefficients of min(f, 1 - f), f the exact 128-bit
    fractional part of t c(s) / Q, as (hi, lo) u64 bit patterns of the
    2^-128-scaled distance, per ciphertext."""
    return decrypt_with_noise(ctx, sk, ct)[1]


def decrypt_with_noise(ctx: BfvContext, sk: SecretKey, ct):
    """`decrypt` and `noise_distance_words` from one pass: (plaintext
    [..., N], (hi, lo) [...])."""
    msg, (f_hi, f_lo) = ctx.decrypt_scaler.apply(_ct_dot_s(ctx, ct, sk))
    neg_lo = ~f_lo + 1                           # 2^128 - f, wrapping
    neg_hi = ~f_hi + (f_lo == 0).to(torch.int64)
    f_smaller = m.ult(f_hi, neg_hi) | ((f_hi == neg_hi)
                                       & ~m.ult(neg_lo, f_lo))
    d_hi = torch.where(f_smaller, f_hi, neg_hi)
    d_lo = torch.where(f_smaller, f_lo, neg_lo)
    m_hi = _umax(d_hi, -1)
    m_lo = _umax(torch.where(d_hi == m_hi.unsqueeze(-1), d_lo,
                             torch.zeros_like(d_lo)), -1)
    return msg, (m_hi, m_lo)


def invariant_noise_budget(ctx: BfvContext, sk: SecretKey, ct):
    """floor(log2(Q / (2 max|centered(t c(s) mod Q)|))) per ciphertext,
    from an exact CRT composition on the host (float, or an array of
    them for a batch)."""
    v = _ct_dot_s(ctx, ct, sk).cpu().numpy()
    qb = ctx.q_base
    big_q, t = qb.product, int(ctx.t)
    lead = v.shape[:-2]
    flat = v.reshape((-1, qb.k, v.shape[-1]))
    out = np.empty((flat.shape[0],), dtype=np.float64)
    for r in range(flat.shape[0]):
        rem = (np.array(qb.compose(flat[r]), dtype=object) * t) % big_q
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
    with obs.span("bfv.add"):
        n_comp = max(a.shape[-3], b.shape[-3])
        return m.add_mod(_pad_components(a, n_comp),
                         _pad_components(b, n_comp), _q(ctx))


def sub(ctx: BfvContext, a, b):
    with obs.span("bfv.sub"):
        n_comp = max(a.shape[-3], b.shape[-3])
        return m.sub_mod(_pad_components(a, n_comp),
                         _pad_components(b, n_comp), _q(ctx))


def negate(ctx: BfvContext, a):
    with obs.span("bfv.negate"):
        return m.neg_mod(a, _q(ctx))


def _plain_c0(ctx: BfvContext, ct, pt, op):
    delta = scale_plain(ctx, pt.to(device=ctx.device, dtype=torch.int64))
    c0 = op(ct[..., 0, :, :], delta, _q(ctx))
    return torch.cat([c0.unsqueeze(-3), ct[..., 1:, :, :]], dim=-3)


def add_plain(ctx: BfvContext, ct, pt):
    with obs.span("bfv.add_plain"):
        return _plain_c0(ctx, ct, pt, m.add_mod)


def sub_plain(ctx: BfvContext, ct, pt):
    with obs.span("bfv.sub_plain"):
        return _plain_c0(ctx, ct, pt, m.sub_mod)


def multiply_plain(ctx: BfvContext, ct, pt):
    """ct * pt, the plaintext lifted verbatim (t < min q_i) and multiplied
    in the NTT domain (SEAL: `Evaluator::multiply_plain`)."""
    with obs.span("bfv.multiply_plain"):
        pt = pt.to(device=ctx.device, dtype=torch.int64)
        pt_hat = ctx.plan_q.fwd(pt.unsqueeze(-2).expand(*pt.shape[:-1],
                                                        ctx.k, ctx.n))
        out = ctx.plan_q.pointwise_mul(ctx.plan_q.fwd(ct),
                                       pt_hat.unsqueeze(-3))
        return ctx.plan_q.inv(out)


def _env_on(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default) != "0"


def _check_fused_rns(device_type: str) -> None:
    """SUNSCREEN_TPU_FUSED_RNS=0, which turns off every fused pipeline in
    the reference, raises for a CUDA tensor: the port has no plain path
    on the card."""
    if (os.environ.get("SUNSCREEN_TPU_FUSED_RNS") == "0"
            and device_type != "cpu"):
        raise NotImplementedError(
            "SUNSCREEN_TPU_FUSED_RNS=0 selects the reference's plain RNS "
            "glue, which the port runs only on CPU tensors")


def _plan_fused(device_type: str) -> bool:
    """True when the fused-inverse kernels (B4, B12, B5) may run: unless
    SUNSCREEN_TPU_FUSE_INV=0 opts out."""
    _check_fused_rns(device_type)
    return _env_on("SUNSCREEN_TPU_FUSE_INV")


def _vpu_missing(method: str, kernels: str, hint: str):
    return NotImplementedError(
        f"the pallas_vpu NTT plan has no {method} ({kernels}): the "
        f"reference's PallasNttPlan reports mode 'pallas' "
        f"(sunscreen_tpu/math/pntt.py:222), so its BFV ops call {method} "
        f"and raise AttributeError, and the port raises here; {hint}")


PLAIN_MODES = ("unrolled", "compact", "matmul")   # plans with no fusion


def multiply_route(n: int, na: int, nb: int, device_type: str,
                   mode: str = "pallas", word: str = m.U32) -> str:
    """How `multiply` forms the tensor product. On the u64 engine, or
    under a mode in PLAIN_MODES, "pointwise": the plan's forward
    transform, the cross terms summed per component and reduced once,
    the inverse transform. Else, in the reference's order:
    "fwd_tensor3" (B4, then B3) unless FUSE_INV or FUSE_FT3 is off or,
    on CUDA, N > pmntt.TENSOR3_MAX_N (every N of a "pallas" plan fits),
    "fwd_tensor3_full" (B13 alone) in its place under FUSE_TFULL=1; else
    "inv_tensor3" (B1, then B12) under FUSE_T3=1; else "tensor3" (B1,
    B10, B3) for 2 x 2 components; else "loop" (B1, plain products per
    component, B3).

    Under mode "pallas_vpu" a 2 x 2 multiply raises unless FUSE_FT3=0 or
    FUSE_INV=0, and also under FUSE_T3=1, as the reference does; else it
    takes "tensor3" (B16, B10, B16) on CUDA, as the reference does on its
    accelerator, and "loop" (B17's twin per product) on the CPU."""
    if word == m.U64 or mode in PLAIN_MODES:
        return "pointwise"
    fused = _plan_fused(device_type)
    pair = na == 2 and nb == 2
    if mode == "pallas_vpu":
        if pair and fused and _env_on("SUNSCREEN_TPU_FUSE_FT3"):
            raise _vpu_missing(
                "fwd_tensor3", "kernels B4/B13",
                "set SUNSCREEN_TPU_FUSE_FT3=0 to multiply")
        if pair and fused and _env_on("SUNSCREEN_TPU_FUSE_T3", default="0"):
            raise _vpu_missing("inv_tensor3", "kernel B12",
                               "leave SUNSCREEN_TPU_FUSE_T3 unset")
        return "tensor3" if pair and device_type != "cpu" else "loop"
    if not pair:
        return "loop"
    if (fused and _env_on("SUNSCREEN_TPU_FUSE_FT3")
            and (device_type == "cpu" or n <= pmntt.TENSOR3_MAX_N)):
        if _env_on("SUNSCREEN_TPU_FUSE_TFULL", default="0"):
            return "fwd_tensor3_full"
        return "fwd_tensor3"
    if fused and _env_on("SUNSCREEN_TPU_FUSE_T3", default="0"):
        return "inv_tensor3"
    return "tensor3"


def scale_convert_route(device_type: str, word: str = m.U32) -> str:
    """"scale_convert" (B7) unless SUNSCREEN_TPU_FUSE_SC=0, then "scale"
    (B9, then the centered conversion B -> Q through B6). The u64 engine
    takes "scale", whose two steps run the plain glue there."""
    if word == m.U64:
        return "scale"
    _check_fused_rns(device_type)
    return ("scale_convert" if _env_on("SUNSCREEN_TPU_FUSE_SC")
            else "scale")


def keyswitch_route(device_type: str, mode: str = "pallas",
                    word: str = m.U32) -> str:
    """"pointwise" on the u64 engine or under a mode in PLAIN_MODES: the
    digits reduced mod every key modulus and transformed, the products
    with the key summed over the digits and reduced once, the inverse
    transform. Else "ks_full" (B14 alone) under FUSE_KSFULL=1 unless
    FUSE_INV is off,
    as the reference checks it first; else "inv_ks" (B2, B5) unless
    FUSE_KS or FUSE_INV is off, then "ks_inner" (B2, B11, B3). Under mode
    "pallas_vpu" it raises, as the reference's keyswitch calls the plan's
    missing `ks_full` or `fwd_broadcast` under every setting."""
    if word == m.U64 or mode in PLAIN_MODES:
        return "pointwise"
    fused = _plan_fused(device_type)
    ksfull = fused and _env_on("SUNSCREEN_TPU_FUSE_KSFULL", default="0")
    if mode == "pallas_vpu":
        raise _vpu_missing(
            "ks_full" if ksfull else "fwd_broadcast",
            "kernel B14" if ksfull else "kernel B2",
            "relinearize and the rotations need NTT mode 'pallas'")
    if ksfull:
        return "ks_full"
    return ("inv_ks" if fused and _env_on("SUNSCREEN_TPU_FUSE_KS")
            else "ks_inner")


def _scale_convert(ctx: BfvContext, tensor):
    """round(t * tensor / Q) mapped into base Q: the chained kernel B7,
    or B9 into B followed by the centered conversion to Q (B6)."""
    if scale_convert_route(tensor.device.type, ctx.word) == "scale_convert":
        return ctx.fused_op("scale_convert")(tensor)
    return ctx.conv_aux_to_q.convert(ctx.scale_mul_to_aux.apply(tensor),
                                     centered=True)


def multiply(ctx: BfvContext, a, b):
    """ct×ct tensor multiply with t/Q scaling: centered base extension
    Q -> Q∪B (B6 on CUDA), the tensor product along `multiply_route`,
    then exact scale-and-round back to Q along `scale_convert_route`.
    Output has n_a + n_b - 1 components."""
    with obs.span("bfv.multiply"):
        na, nb = a.shape[-3], b.shape[-3]
        route = multiply_route(ctx.n, na, nb, a.device.type, ctx.mode,
                               ctx.word)
        plan = ctx.plan_mul
        ext = ctx.conv_q_to_aux.extend(torch.cat([a, b], dim=-3),
                                       centered=True)
        if route == "pointwise":
            return _scale_convert(ctx, _tensor_pointwise(ctx, plan.fwd(ext),
                                                         na, nb))
        if route == "fwd_tensor3":
            return _scale_convert(ctx, plan.inv(plan.fwd_tensor3(ext)))
        if route == "fwd_tensor3_full":
            return _scale_convert(ctx, plan.fwd_tensor3(ext, full=True))
        both = plan.fwd(ext)
        a_hat, b_hat = both[..., :na, :, :], both[..., na:, :, :]
        if route == "inv_tensor3":
            tensor = plan.inv_tensor3(a_hat, b_hat)
        elif route == "tensor3":
            tensor = plan.inv(ctx.fused_op("tensor3")(a_hat, b_hat))
        else:
            outs = []
            for j in range(na + nb - 1):
                terms = [plan.pointwise_mul(a_hat[..., ia, :, :],
                                            b_hat[..., j - ia, :, :])
                         for ia in range(na) if 0 <= j - ia < nb]
                outs.append(sum(terms) % plan.q)
            tensor = plan.inv(torch.stack(outs, dim=-3))
        return _scale_convert(ctx, tensor)


def _tensor_pointwise(ctx: BfvContext, both, na: int, nb: int):
    """The tensor product from the NTT images of both operands' components
    [..., na + nb, km, N]: per output component the cross terms summed
    raw (each below q < 2^56, at most na of them, so the u64 sum cannot
    wrap), one reduction, then the inverse transform."""
    mb, plan = ctx.mul_base, ctx.plan_mul
    outs = []
    for j in range(na + nb - 1):
        acc = None
        for ia in range(na):
            if 0 <= j - ia < nb:
                term = plan.pointwise_mul(both[..., ia, :, :],
                                          both[..., na + j - ia, :, :])
                acc = term if acc is None else acc + term
        outs.append(m.w_reduce(acc, mb.q, mb.c0, mb.c1, mb.word))
    return plan.inv(torch.stack(outs, dim=-3))


def _keyswitch_pointwise(ctx: BfvContext, d, ksw: KswKey):
    """The keyswitch inner products of "pointwise": every digit (a Q
    residue) reduced mod every key modulus, transformed, multiplied with
    both key components, summed over the digits raw (k terms below
    q < 2^56 cannot wrap) and reduced once; then the inverse transform."""
    kb, plan = ctx.key_base, ctx.plan_key
    d_hat = plan.fwd(m.w_reduce(d.unsqueeze(-2), kb.q, kb.c0, kb.c1,
                                kb.word))
    acc = torch.stack([m.w_sum_reduce(plan.pointwise_mul(d_hat, key), kb.q,
                                      kb.c0, kb.c1, kb.word)
                       for key in (ksw.k0, ksw.k1)], dim=-3)
    return plan.inv(acc)


def keyswitch(ctx: BfvContext, d, ksw: KswKey):
    """Switch poly d ([..., k, N], coefficient domain) to the target key:
    (u0, u1) over Q after the special-prime mod-down. The k raw digits
    are transformed under every key modulus (exact for any u32, and the
    NTT is linear mod each modulus), contracted against the key and
    inverse-transformed, in one kernel on the "inv_ks" route; on the
    "ks_full" route one kernel does all of it from the raw digits. The
    mod-down reads the Q limbs and the special limb of that output in
    place."""
    with obs.span("bfv.keyswitch"):
        route = keyswitch_route(d.device.type, ctx.mode, ctx.word)
        if route == "pointwise":
            both = _keyswitch_pointwise(ctx, d, ksw)
            u = ctx.mod_down.apply(both[..., :ctx.k, :], both[..., ctx.k, :])
            return u[..., 0, :, :], u[..., 1, :, :]
        if route == "ks_full":
            both = ctx.plan_key.ks_full(d, ksw.k0, ksw.k1)
            u = ctx.mod_down.apply(both[..., :ctx.k, :], both[..., ctx.k, :])
            return u[..., 0, :, :], u[..., 1, :, :]
        d_hat = ctx.plan_key.fwd_broadcast(d)      # [..., k(digit), k+1, N]
        if route == "inv_ks":
            both = ctx.plan_key.inv_ks(d_hat, ksw.k0, ksw.k1)
        else:
            both = ctx.plan_key.inv(ctx.fused_op("ks_inner")(d_hat, ksw.k0,
                                                             ksw.k1))
        u = ctx.mod_down.apply(both[..., :ctx.k, :], both[..., ctx.k, :])
        return u[..., 0, :, :], u[..., 1, :, :]


def relinearize(ctx: BfvContext, ct, rlk: KswKey):
    """3-component -> 2-component."""
    with obs.span("bfv.relinearize"):
        if ct.shape[-3] != 3:
            raise InvalidArgument(
                f"relinearize expects a 3-component ct, got {ct.shape[-3]}")
        u0, u1 = keyswitch(ctx, ct[..., 2, :, :], rlk)
        q = _q(ctx)
        return torch.stack([m.add_mod(ct[..., 0, :, :], u0, q),
                            m.add_mod(ct[..., 1, :, :], u1, q)], dim=-3)


def multiply_relin(ctx: BfvContext, a, b, rlk: KswKey):
    with obs.span("bfv.multiply_relin"):
        return relinearize(ctx, multiply(ctx, a, b), rlk)


def square(ctx: BfvContext, a):
    return multiply(ctx, a, a)


# --------------------------------------------------------------------------
# Galois / rotations
# --------------------------------------------------------------------------

def _permute(ctx: BfvContext, poly, g: int):
    """a(x) -> a(x^g) on [..., k, N] coefficient-domain residues."""
    with obs.span("bfv.permute"):
        idx, neg = ctx.galois_table(g)
        gathered = poly[..., idx]
        return torch.where(neg, m.neg_mod(gathered, _q(ctx)), gathered)


def apply_galois(ctx: BfvContext, ct, g: int, gks: GaloisKeys):
    """a(x) -> a(x^g) on a 2-component ct, then keyswitch back to s
    (SEAL: `Evaluator::apply_galois`)."""
    with obs.span("bfv.apply_galois"):
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
    with obs.span("bfv.rotate_rows"):
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
    with obs.span("bfv.rotate_columns"):
        return apply_galois(ctx, ct, ctx.rotate_columns_element, gks)


# --------------------------------------------------------------------------
# modulus switching, powers and sums
# --------------------------------------------------------------------------

def mod_switch_to_next(ctx: BfvContext, ct):
    """Drop the last ciphertext modulus: round(c Q'/Q) per component with
    Q' = Q / q_last (SEAL: `Evaluator::mod_switch_to_next`), B8 on CUDA.
    The result lives over k-1 limbs, in `mod_switch_context(ctx)`."""
    if ctx.k < 2:
        raise InvalidArgument("cannot mod-switch below one modulus")
    return ctx.mod_switch_down.apply(ct[..., :ctx.k - 1, :],
                                     ct[..., ctx.k - 1, :])


def mod_switch_context(ctx: BfvContext) -> BfvContext:
    """Context for ciphertexts after one `mod_switch_to_next`: the same
    device and NTT mode."""
    p = ctx.params
    return get_context(BfvParams(p.poly_degree, p.plain_modulus,
                                 p.coeff_modulus[:-1], p.special_modulus,
                                 p.security_level), ctx.device,
                       ctx.requested_mode)


def exponentiate(ctx: BfvContext, ct, power: int, rlk: KswKey):
    """ct^power by square-and-multiply with a relinearization after each
    multiply (SEAL: `Evaluator::exponentiate`)."""
    if power < 1:
        raise InvalidArgument("exponentiate requires power >= 1")
    result, base = None, ct
    while power:
        if power & 1:
            result = base if result is None else multiply_relin(
                ctx, result, base, rlk)
        power >>= 1
        if power:
            base = multiply_relin(ctx, base, base, rlk)
    return result


def add_many(ctx: BfvContext, cts):
    """Sum of a sequence of ciphertexts (SEAL: `Evaluator::add_many`)."""
    cts = list(cts)
    if not cts:
        raise InvalidArgument("add_many requires at least one ciphertext")
    acc = cts[0]
    for c in cts[1:]:
        acc = m.add_mod(acc, c, _q(ctx))
    return acc


def multiply_many(ctx: BfvContext, cts, rlk: KswKey):
    """Product of a sequence of ciphertexts as a balanced tree of
    multiply_relin (SEAL: `Evaluator::multiply_many`)."""
    level = list(cts)
    if not level:
        raise InvalidArgument(
            "multiply_many requires at least one ciphertext")
    while len(level) > 1:
        nxt = [multiply_relin(ctx, level[i], level[i + 1], rlk)
               for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]
