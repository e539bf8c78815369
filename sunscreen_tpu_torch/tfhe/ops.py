"""TFHE operations on int64 torch tensors (port of
`sunscreen_tpu/tfhe/ops.py`): keygen, LWE/GLWE encryption (secret and
public key), LWE arithmetic, GLEV and GGSW ciphertexts, the external
product and CMUX, blind rotation, sample extraction, LWE and GLWE
keyswitching, the private and public functional keyswitches, and the
bootstraps built on them: the univariate, multifunctional, bivariate
and generalized programmable bootstraps (PBS), circuit bootstrapping and
the scheme switch (GLEV -> GGSW).

Conventions are the reference's: a ciphertext is b = <a, s> + m + e over
the 2^64 torus; GLWE masks are the first k rows of [..., k+1, N], the
body last; a GLEV is [l, k+1, N] and a GGSW [k+1, l, k+1, N]. Torus
words are u64 bit patterns in int64 (`tfhe/torus.py`). Batches are
leading axes: where the reference vmaps one ciphertext at a time, the
port takes the batch directly (a blind rotation rotates each row by its
own exponent), and its output for a batch is the reference's vmap over
that axis.

Randomness comes from an explicit `torch.Generator`, so keys and
ciphertexts differ from the reference's threefry bits; `tfhe/keys.py`
carries the reference's over. Every key keeps the reference's layout.
Keygen entry points run on CUDA unless the caller passes `device="cpu"`;
every other op runs where its inputs lie.

On the card a blind-rotation step with an NTT-domain bootstrap key runs
B1 (`ntt_fwd`) then B5 (`inv_ks`), or, under
`SUNSCREEN_TPU_TFHE_KSFULL=1` at GLWE size 1, B15 (`ks_full`) alone,
then the glue kernel `br_glue` (`csrc/br_glue.cu`: the step's add and the
next step's rotated digit residues in one pass); the keyswitches and the
62-bit plan's products are plain PyTorch (the reference's, and its step
glue, are plain XLA).
"""

from __future__ import annotations

import os
from functools import lru_cache, partial

import numpy as np
import torch

from sunscreen_tpu_torch import observability as obs
from sunscreen_tpu_torch import resolve_device
from sunscreen_tpu_torch.math import sampling
from sunscreen_tpu_torch.math.modular import s64, srl, sum_mod
from sunscreen_tpu_torch.tfhe import torus
from sunscreen_tpu_torch.tfhe.params import TORUS_BITS, GlweDef, LweDef, \
    RadixDecomposition
from sunscreen_tpu_torch.tfhe.poly import get_torus_plan, \
    get_torus_plan_u32, negacyclic_monomial_mul


def _gadget(radix: RadixDecomposition) -> list[int]:
    """B_j = 2^(64 - (j+1) radix_log) as int64 bit patterns."""
    return [s64(1 << (TORUS_BITS - (j + 1) * radix.radix_log))
            for j in range(radix.count)]


def _levels(msg, radix: RadixDecomposition):
    """msg [..., N] -> msg B_j [..., l, N] (wrapping mod 2^64)."""
    bj = torch.tensor(_gadget(radix), dtype=torch.int64, device=msg.device)
    return msg.unsqueeze(-2) * bj.unsqueeze(-1)


# --------------------------------------------------------------------------
# key generation
# --------------------------------------------------------------------------

def generate_binary_lwe_sk(params: LweDef, gen: torch.Generator,
                           device=None):
    return sampling.binary(gen, (params.dim,), resolve_device(device))


def generate_binary_glwe_sk(params: GlweDef, gen: torch.Generator,
                            device=None):
    return sampling.binary(gen, (params.size, params.poly_degree),
                           resolve_device(device))


def generate_uniform_lwe_sk(params: LweDef, gen: torch.Generator,
                            device=None):
    """Uniform 64-bit LWE key: the LWE dot wraps mod 2^64, so decryption
    is exact for any key."""
    return sampling.uniform_u64(gen, (params.dim,), resolve_device(device))


def generate_uniform_glwe_sk(params: GlweDef, gen: torch.Generator,
                             device=None):
    """Uniform GLWE key: the mask . key dot runs on the 3-prime plan,
    exact for full torus x torus products."""
    return sampling.uniform_u64(gen, (params.size, params.poly_degree),
                                resolve_device(device))


# --------------------------------------------------------------------------
# LWE
# --------------------------------------------------------------------------

def encrypt_lwe_return_components(msg_torus, sk, params: LweDef,
                                  gen: torch.Generator):
    """`encrypt_lwe` that also returns its noise: (ct [..., n+1], e) with
    b = <a, s> + m + e and e signed int64, the randomness an SDLP
    encryption statement needs."""
    msg = torch.as_tensor(msg_torus, dtype=torch.int64, device=sk.device)
    a = sampling.uniform_u64(gen, tuple(msg.shape) + (params.dim,),
                             sk.device)
    e = sampling.torus_gaussian(gen, msg.shape, params.std, sk.device)
    b = (a * sk).sum(-1) + msg + e                 # wraps mod 2^64
    return torch.cat([a, b.unsqueeze(-1)], dim=-1), e


def encrypt_lwe(msg_torus, sk, params: LweDef, gen: torch.Generator):
    """msg_torus: torus words of any shape. Returns [..., n+1]."""
    return encrypt_lwe_return_components(msg_torus, sk, params, gen)[0]


def trivial_lwe(msg_torus, params: LweDef, device=None):
    msg = torch.as_tensor(msg_torus, dtype=torch.int64,
                          device=resolve_device(device))
    a = msg.new_zeros(tuple(msg.shape) + (params.dim,))
    return torch.cat([a, msg.unsqueeze(-1)], dim=-1)


def decrypt_lwe_torus(ct, sk):
    """Raw phase b - <a, s> mod 2^64."""
    return ct[..., -1] - (ct[..., :-1] * sk).sum(-1)


def decrypt_lwe(ct, sk, plaintext_bits: int):
    return torus.decode(decrypt_lwe_torus(ct, sk), plaintext_bits)


def decrypt_lwe_with_carry(ct, sk, plaintext_bits: int, carry_bits: int):
    """Decode the message below `carry_bits` of headroom: round at bit
    64 - p - c - 1, keep p bits."""
    assert plaintext_bits + carry_bits < TORUS_BITS
    phase = decrypt_lwe_torus(ct, sk)
    shift = TORUS_BITS - plaintext_bits - carry_bits
    round_bit = srl(phase, shift - 1) & 1
    return (srl(phase, shift) + round_bit) & ((1 << plaintext_bits) - 1)


def lwe_add(a, b):
    return a + b


def lwe_sub(a, b):
    return a - b


def lwe_scalar_mul(ct, k: int):
    return ct * s64(k)


def generate_lwe_public_key(sk, params: LweDef, count: int,
                            gen: torch.Generator):
    """`count` encryptions of zero [count, n+1] in one batch (count ~ n
    log n for leftover-hash security)."""
    zeros = torch.zeros(count, dtype=torch.int64, device=sk.device)
    return encrypt_lwe(zeros, sk, params, gen)


def encrypt_lwe_public(msg_torus, pk, params: LweDef, gen: torch.Generator):
    """ct = sum_i r_i pk_i + (0, m + e') with binary r, one r per message
    of msg_torus (any shape). Returns [..., n+1]."""
    msg = torch.as_tensor(msg_torus, dtype=torch.int64, device=pk.device)
    r = sampling.binary(gen, tuple(msg.shape) + (pk.shape[0],), pk.device)
    ct = (r.unsqueeze(-1) * pk).sum(-2)            # wraps mod 2^64
    e = sampling.torus_gaussian(gen, msg.shape, params.std, pk.device)
    ct[..., -1] += msg + e
    return ct


# --------------------------------------------------------------------------
# GLWE
# --------------------------------------------------------------------------

def _glwe_mask_dot_sk(masks, sk, params: GlweDef):
    """sum_j masks[..., j, :] * sk[j] (negacyclic, exact mod 2^64) on the
    3-prime plan (C ~ 2^186), so full torus x torus products, hence
    uniform secret keys, stay exact."""
    plan = get_torus_plan(params.poly_degree, k=3, device=masks.device)
    acc = None
    for j in range(params.size):
        term = plan.pointwise(plan.fwd(plan.torus_to_rns(sk[j])),
                              plan.fwd(plan.torus_to_rns(masks[..., j, :])))
        acc = term if acc is None else plan.add(acc, term)
    return plan.to_torus(plan.plan.inv(acc))


def encrypt_glwe(msg_poly, sk, params: GlweDef, gen: torch.Generator):
    """msg_poly: torus words [..., N]. Returns [..., k+1, N]."""
    msg = torch.as_tensor(msg_poly, dtype=torch.int64, device=sk.device)
    a = sampling.uniform_u64(
        gen, tuple(msg.shape[:-1]) + (params.size, params.poly_degree),
        sk.device)
    e = sampling.torus_gaussian(gen, msg.shape, params.std, sk.device)
    body = _glwe_mask_dot_sk(a, sk, params) + msg + e
    return torch.cat([a, body.unsqueeze(-2)], dim=-2)


def trivial_glwe(msg_poly, params: GlweDef):
    msg = torch.as_tensor(msg_poly, dtype=torch.int64)
    a = msg.new_zeros(tuple(msg.shape[:-1])
                      + (params.size, params.poly_degree))
    return torch.cat([a, msg.unsqueeze(-2)], dim=-2)


def decrypt_glwe_torus(ct, sk, params: GlweDef):
    return ct[..., params.size, :] - _glwe_mask_dot_sk(
        ct[..., :params.size, :], sk, params)


def decrypt_glwe(ct, sk, params: GlweDef, plaintext_bits: int):
    return torus.decode(decrypt_glwe_torus(ct, sk, params), plaintext_bits)


def generate_rlwe_public_key(sk, params: GlweDef, gen: torch.Generator):
    """GLWE encryption of the zero polynomial: [k+1, N]."""
    zeros = torch.zeros(params.poly_degree, dtype=torch.int64,
                        device=sk.device)
    return encrypt_glwe(zeros, sk, params, gen)


def encrypt_glwe_public(msg_poly, pk, params: GlweDef, gen: torch.Generator):
    """c = u pk + (e_1 .. e_k, e_b + m) with a ternary u per message
    polynomial of msg_poly [..., N], the products exact on the 62-bit
    plan. Returns [..., k+1, N]."""
    msg = torch.as_tensor(msg_poly, dtype=torch.int64, device=pk.device)
    plan = get_torus_plan(params.poly_degree, device=pk.device)
    u = sampling.ternary(gen, msg.shape, pk.device)
    u_hat = plan.fwd(plan.signed_to_rns(u)).unsqueeze(-3)  # [..., 1, kp, N]
    pk_hat = plan.fwd(plan.torus_to_rns(pk))               # [k+1, kp, N]
    out = plan.to_torus(plan.plan.inv(plan.pointwise(u_hat, pk_hat)))
    out = out + sampling.torus_gaussian(gen, out.shape, params.std,
                                        pk.device)
    out[..., -1, :] += msg
    return out


# --------------------------------------------------------------------------
# GGSW + external product
# --------------------------------------------------------------------------

def encrypt_glev(msg_poly, sk, params: GlweDef, radix: RadixDecomposition,
                 gen: torch.Generator):
    """GLEV [..., l, k+1, N]: level j encrypts msg B_j, all levels of
    every message polynomial of msg_poly [..., N] in one batch."""
    msg = torch.as_tensor(msg_poly, dtype=torch.int64, device=sk.device)
    return encrypt_glwe(_levels(msg, radix), sk, params, gen)


def trivial_glev(msg_poly, params: GlweDef, radix: RadixDecomposition):
    """Zero-mask GLEV [..., l, k+1, N] of msg_poly [..., N]: constants."""
    return trivial_glwe(_levels(torch.as_tensor(msg_poly, dtype=torch.int64),
                                radix), params)


def encrypt_rlev_public(msg_poly, pk, params: GlweDef,
                        radix: RadixDecomposition, gen: torch.Generator):
    """RLEV (a GLEV at GLWE size 1) of a binary-coefficient message under
    an RLWE public key: level j encrypts msg B_j. [..., l, 2, N]."""
    assert params.size == 1, "RLEV requires GLWE size 1"
    msg = torch.as_tensor(msg_poly, dtype=torch.int64, device=pk.device)
    return encrypt_glwe_public(_levels(msg, radix), pk, params, gen)


def decrypt_glev(glev, sk, params: GlweDef, radix: RadixDecomposition):
    """The level-0 message (scaled by B_1 = 2^(64 - radix_log)), rounded:
    [..., N] of glev [..., l, k+1, N]."""
    t0 = decrypt_glwe_torus(glev[..., 0, :, :], sk, params)
    shift = TORUS_BITS - radix.radix_log
    return srl(t0 + (1 << (shift - 1)), shift) & ((1 << radix.radix_log) - 1)


def _ggsw_units(msg_poly, params: GlweDef, radix: RadixDecomposition,
                zeros):
    """GLWE encryptions of zero [..., k+1, l, k+1, N] plus msg * B_j on
    component i of row (i, j); msg_poly [..., N] broadcasts."""
    unit = _levels(msg_poly, radix)                       # [..., l, N]
    out = zeros.clone()
    for i in range(params.size + 1):
        out[..., i, :, i, :] += unit
    return out


def encrypt_ggsw(msg, sk, params: GlweDef, radix: RadixDecomposition,
                 gen: torch.Generator):
    """msg: a small integer or an integer polynomial [N]. Returns
    [k+1, l, k+1, N]: rows (i, j) = GLWE(0) + msg * B_j * u_i, all
    (k+1) l encryptions drawn in one batch."""
    n, kk = params.poly_degree, params.size
    msg_poly = torch.zeros(n, dtype=torch.int64, device=sk.device)
    msg_t = torch.as_tensor(msg, dtype=torch.int64, device=sk.device)
    if msg_t.dim() == 0:
        msg_poly[0] = msg_t
    else:
        msg_poly = msg_t
    zeros = encrypt_glwe(
        torch.zeros(kk + 1, radix.count, n, dtype=torch.int64,
                    device=sk.device), sk, params, gen)
    return _ggsw_units(msg_poly, params, radix, zeros)


def _poly_dot(digits, rows):
    """sum_t digits[..., t, :] rows[..., t, :, :] (negacyclic, exact mod
    2^64) for small signed digit polynomials [..., T, N] and torus
    polynomials [..., T, C, N] -> [..., C, N], on the 62-bit plan. The
    residue sums mod q are unique, so the bits do not depend on the
    order of the terms."""
    plan = get_torus_plan(digits.shape[-1], device=digits.device)
    d_hat = plan.fwd(plan.signed_to_rns(digits)).unsqueeze(-3)
    r_hat = plan.fwd(plan.torus_to_rns(rows))         # [..., T, C, kp, N]
    acc = sum_mod(plan.pointwise(d_hat, r_hat), -4, plan.base.q)
    return plan.to_torus(plan.plan.inv(acc))


def _gadget_digits(polys, radix: RadixDecomposition):
    """polys [..., K, N] -> gadget digits [..., K l, N], index i l + j."""
    return torus.gadget_digits(polys, radix.radix_log, radix.count)


def external_product(ggsw, glwe, params: GlweDef,
                     radix: RadixDecomposition):
    """GGSW(m) ⊡ GLWE(c) -> GLWE(m c), exact through the 2-prime CRT
    NTT: the gadget digits of every GLWE row against the GGSW rows."""
    return _poly_dot(_gadget_digits(glwe, radix), ggsw.flatten(-4, -3))


def cmux(sel_ggsw, d0, d1, params: GlweDef, radix: RadixDecomposition):
    """d0 + sel ⊡ (d1 - d0)."""
    return d0 + external_product(sel_ggsw, d1 - d0, params, radix)


def glev_cmux(sel_ggsw, d0, d1, params: GlweDef, radix: RadixDecomposition):
    """CMUX over GLEV ciphertexts [..., l, k+1, N], the same selector on
    every level (muxing circuit-bootstrap outputs): the external product
    takes the level axis as a batch axis."""
    return cmux(sel_ggsw, d0, d1, params, radix)


# --------------------------------------------------------------------------
# bootstrap key, blind rotation, sample extraction, keyswitching
# --------------------------------------------------------------------------

def generate_bootstrap_key(lwe_sk, glwe_sk, lwe: LweDef, glwe: GlweDef,
                           radix: RadixDecomposition, gen: torch.Generator):
    """GGSW encryption of every LWE secret bit: [n, k+1, l, k+1, N]. All
    n (k+1) l GLWE encryptions of zero are drawn in one batch, then bit
    i times B_j lands on coefficient 0 of component c in row (c, j)."""
    n = glwe.poly_degree
    zeros = encrypt_glwe(
        torch.zeros(lwe.dim, glwe.size + 1, radix.count, n,
                    dtype=torch.int64, device=glwe_sk.device),
        glwe_sk, glwe, gen)
    bits = torch.zeros(lwe.dim, n, dtype=torch.int64, device=glwe_sk.device)
    bits[:, 0] = lwe_sk.to(glwe_sk.device)
    return _ggsw_units(bits, glwe, radix, zeros)


class NttBootstrapKey:
    """Bootstrap key in the u32 CRT NTT domain (the reference keeps its
    bootstrap keys in Fourier form). rows: int64 [n_lwe, k+1, (k+1) l,
    n_primes, N], component-major, the digit axis ordered (GLWE
    component, level): each blind-rotation step reads the contiguous
    [(k+1) l, n_primes, N] slice of each output component in place. The
    reference stores [n_lwe, (k+1) l, k+1, n_primes, N];
    `tfhe.keys.ntt_bootstrap_key_from_reference` permutes once."""

    def __init__(self, rows, glwe: GlweDef, radix: RadixDecomposition):
        self.rows = rows
        self.glwe = glwe
        self.radix = radix


_BSK_CHUNK = 32     # LWE rows per transform pass (bounds the temporaries)


def bootstrap_key_to_ntt(bsk, glwe: GlweDef,
                         radix: RadixDecomposition) -> NttBootstrapKey:
    """[n, k+1, l, k+1, N] torus GGSW stack -> NttBootstrapKey (a one-time
    cost: B1 on the card)."""
    plan = get_torus_plan_u32(glwe.poly_degree, device=bsk.device)
    n_lwe, kk1, l, kk1b, n = bsk.shape
    rows = bsk.reshape(n_lwe, kk1 * l, kk1b, n)
    out = torch.empty(n_lwe, kk1b, kk1 * l, plan.base.k, n,
                      dtype=torch.int64, device=bsk.device)
    for s in range(0, n_lwe, _BSK_CHUNK):
        hat = plan.fwd(plan.torus_to_rns(rows[s:s + _BSK_CHUNK]))
        out[s:s + _BSK_CHUNK] = hat.transpose(1, 2)
    return NttBootstrapKey(out, glwe, radix)


def _mod_switch_2n(x, n: int, log_v: int = 0):
    """Torus words -> Z_2N with rounding; `log_v > 0` rounds to a
    multiple of 2^log_v."""
    shift = TORUS_BITS - (n.bit_length() - 1) - 1 + log_v
    y = srl(x + (1 << (shift - 1)), shift) << log_v
    return y % (2 * n)


def _blind_rotate_ntt(test_poly, lwe_ct, bsk: NttBootstrapKey,
                      glwe: GlweDef, radix: RadixDecomposition,
                      log_v: int = 0):
    """blind_rotate with an NTT-domain bootstrap key. Per step:
    acc += ToTorus(InvNtt(sum_dig Ntt(decomp(X^a_i acc - acc)) bsk_i)),
    through B1 then B5 at GLWE size 1, B15 alone under
    SUNSCREEN_TPU_TFHE_KSFULL=1 (read once per call, GLWE size 1 only),
    or B1, a plain contraction and B3 at larger GLWE sizes; the glue
    around them (ToTorus, the add, the next step's rotation, digits and
    residues) is one `br_glue` a step, plus one ahead of the first.
    Bit-identical to the raw-key path: both are exact integer pipelines."""
    n, kk = glwe.poly_degree, glwe.size
    a, b = lwe_ct[..., :-1], lwe_ct[..., -1]
    plan = get_torus_plan_u32(n, device=lwe_ct.device)
    b_t = _mod_switch_2n(b, n, log_v)
    a_t = _mod_switch_2n(a, n, log_v)
    acc = trivial_glwe(negacyclic_monomial_mul(
        torch.as_tensor(test_poly, dtype=torch.int64, device=lwe_ct.device),
        2 * n - b_t, n), glwe).contiguous()
    steps = a_t.shape[-1]
    if steps == 0:
        return acc
    # one exponent a GLWE ciphertext (left-aligned with acc's leading axes,
    # as negacyclic_monomial_mul takes it), each step's a contiguous row
    lead = acc.shape[:-2]
    pad = (1,) * (len(lead) - a_t.dim() + 1)
    exps = a_t.reshape(*a_t.shape[:-1], *pad, steps).expand(*lead, steps)
    exps = exps.movedim(-1, 0).contiguous()
    ksfull = kk == 1 and os.environ.get("SUNSCREEN_TPU_TFHE_KSFULL",
                                        "0") != "0"
    q = plan.base.q
    glue = partial(plan.br_glue, radix_log=radix.radix_log,
                   count=radix.count)
    with obs.span("tfhe.br.glue"):
        _, d_rns = glue(acc, None, exps[0])
    for i in range(steps):
        with obs.span("tfhe.br.step"):
            ks = bsk.rows[i]                            # [k+1, kdig, kp, N]
            with obs.span("tfhe.br.kernels"):
                if ksfull:
                    upd = plan.ks_full(d_rns, ks[0], ks[1])
                elif kk == 1:
                    upd = plan.contract_inv(plan.fwd(d_rns), ks[0], ks[1])
                else:
                    # each product < q^2 < 2^60 is reduced before the sum
                    d_hat = plan.fwd(d_rns).unsqueeze(-4)
                    upd = plan.plan.inv((d_hat * ks % q).sum(-3) % q)
            with obs.span("tfhe.br.glue"):
                acc, d_rns = glue(acc, upd,
                                  exps[i + 1] if i + 1 < steps else None)
    return acc


def blind_rotate(test_poly, lwe_ct, bsk, glwe: GlweDef,
                 radix: RadixDecomposition, log_v: int = 0):
    """acc = X^{-b~} v; for each i: acc = CMUX(bsk_i, acc, X^{a~_i} acc).
    Returns GLWE [..., k+1, N] whose phase is v X^{-phase~}. Takes a raw
    torus GGSW stack (the exact 2-prime CRT path per CMUX) or an
    NttBootstrapKey (the kernel path); both give the same bits. Runs in a
    `tfhe.blind_rotate` span, each step in a `tfhe.br.step` span; the
    kernel path opens a `tfhe.br.glue` span (the first step's digits)
    before its steps and splits each into `tfhe.br.kernels` (B1 + B5, B15
    or the contraction) and `tfhe.br.glue` (the `br_glue` kernel: the
    add, then the next step's digits)."""
    with obs.span("tfhe.blind_rotate"):
        if isinstance(bsk, NttBootstrapKey):
            return _blind_rotate_ntt(test_poly, lwe_ct, bsk, glwe, radix,
                                     log_v)
        n = glwe.poly_degree
        a, b = lwe_ct[..., :-1], lwe_ct[..., -1]
        b_t = _mod_switch_2n(b, n, log_v)
        a_t = _mod_switch_2n(a, n, log_v)
        acc = trivial_glwe(negacyclic_monomial_mul(
            torch.as_tensor(test_poly, dtype=torch.int64,
                            device=lwe_ct.device), 2 * n - b_t, n), glwe)
        for i in range(a.shape[-1]):
            with obs.span("tfhe.br.step"):
                rotated = negacyclic_monomial_mul(acc, a_t[..., i], n)
                acc = cmux(bsk[i], acc, rotated, glwe, radix)
        return acc


def sample_extract(glwe_ct, params: GlweDef, coeff: int = 0):
    """GLWE -> LWE of coefficient `coeff` under the flattened key:
    a'_{j,t} = mask_j[(coeff - t) mod N], negated where t > coeff."""
    kk, n = params.size, params.poly_degree
    h = int(coeff)
    assert 0 <= h < n
    with obs.span("tfhe.sample_extract"):
        masks = glwe_ct[..., :kk, :]
        rev = torch.flip(torch.roll(masks, -(h + 1), dims=-1), dims=(-1,))
        a = torch.cat([rev[..., :h + 1], -rev[..., h + 1:]], dim=-1)
        a = a.reshape(*a.shape[:-2], kk * n)
        return torch.cat([a, glwe_ct[..., kk, h:h + 1]], dim=-1)


def flatten_glwe_sk(glwe_sk):
    return glwe_sk.reshape(-1)


def generate_keyswitch_key(from_sk, to_sk, to_params: LweDef,
                           radix: RadixDecomposition, gen: torch.Generator):
    """KSK_{i,j} = LWE_to(from_sk_i B_j): [n_in, l, n_out+1], all
    n_in l encryptions in one batch."""
    bj = torch.tensor(_gadget(radix), dtype=torch.int64, device=to_sk.device)
    msgs = from_sk.to(to_sk.device).unsqueeze(-1) * bj
    return encrypt_lwe(msgs, to_sk, to_params, gen)


_LIMB = 16          # bits per limb of the exact float64 product
_CHUNK = 1 << 20    # rows of K summed per matmul: K 2^32 < 2^53


def _exact_dot(d, words, radix_log: int):
    """d [R, K] signed ints with |d| <= 2^(radix_log - 1), words [K, W]
    torus words -> [R, W] = d @ words mod 2^64, exactly. The words are
    split into four 16-bit limbs and the digits into ceil(radix_log / 16)
    16-bit pieces (the top piece signed), so every piece-limb product is
    below 2^32 in size and every float64 sum over at most 2^20 rows of K
    is exact, whatever order the matmul adds in; the piece-limb products
    are then combined with their weights 2^(16 (i + j)) mod 2^64."""
    n_pieces = max(1, -(-radix_log // _LIMB))
    pieces = [(d >> (_LIMB * i)) & 0xFFFF if i < n_pieces - 1
              else d >> (_LIMB * i) for i in range(n_pieces)]
    limbs = torch.stack([srl(words, _LIMB * j) & 0xFFFF if j else
                         words & 0xFFFF for j in range(64 // _LIMB)], 1)
    k, nl, w = limbs.shape
    lhs = torch.cat(pieces).to(torch.float64)            # [P R, K]
    rhs = limbs.reshape(k, nl * w).to(torch.float64)
    part = None
    for c in range(0, k, _CHUNK):
        p = torch.matmul(lhs[:, c:c + _CHUNK], rhs[c:c + _CHUNK])
        p = p.round().to(torch.int64)                    # exact, < 2^53
        part = p if part is None else part + p           # wraps mod 2^64
    part = part.reshape(n_pieces, d.shape[0], nl, w)
    out = None
    for i in range(n_pieces):
        for j in range(nl - i):
            term = part[i, :, j] * (1 << (_LIMB * (i + j)))  # wraps
            out = term if out is None else out + term
    return out


def keyswitch_lwe_to_lwe(ct, ksk, to_params: LweDef,
                         radix: RadixDecomposition):
    """(0, b) - sum_{i,j} d_{i,j} KSK_{i,j}, with d the gadget digits of
    the mask a. The [batch, n_in l] x [n_in l, n_out+1] product runs as
    exact float64 matmuls over 16-bit limbs (`_exact_dot`): CUDA has
    no int64 matmul, and the broadcast product would hold
    batch n_in l (n_out+1) words."""
    with obs.span("tfhe.keyswitch"):
        a, b = ct[..., :-1], ct[..., -1]
        n_in, w = a.shape[-1], ksk.shape[-1]
        digits = torus.signed_decompose(a, radix.radix_log, radix.count)
        d = torch.movedim(digits, 0, -1).reshape(-1, n_in * radix.count)
        acc = _exact_dot(d, ksk.reshape(n_in * radix.count, w),
                         radix.radix_log)
        out = (-acc).reshape(*a.shape[:-1], w)
        out[..., -1] += b
        return out


# --------------------------------------------------------------------------
# programmable bootstrapping
# --------------------------------------------------------------------------

def test_polynomial_for(fn, plaintext_bits: int, glwe: GlweDef,
                        output_bits: int | None = None, device=None):
    """Test polynomial v whose blocks encode fn over the message space
    [0, 2^bits) (padding bit clear); `output_bits` picks the output
    encoding (`bits - 1` is the reference's unpadded LUT). Returns int64
    torus words [N]."""
    n = glwe.poly_degree
    space = 1 << plaintext_bits
    out_bits = plaintext_bits if output_bits is None else output_bits
    v = np.zeros(n, dtype=np.uint64)
    block = n // (space // 2) if space > 1 else n
    for i in range(n):
        msg = (i // block) % space if space > 1 else 0
        val = int(fn(msg)) % (1 << out_bits)
        v[i] = val << (TORUS_BITS - out_bits)
    half = block // 2
    if half:                       # center the bins (negacyclic rotation)
        rolled = np.roll(v, -half)
        rolled[-half:] = (-rolled[-half:].astype(np.int64)).astype(
            np.uint64)
        v = rolled
    return torch.from_numpy(v.view(np.int64)).to(resolve_device(device))


def programmable_bootstrap_univariate(
        lwe_ct, test_poly, bsk, ksk, lwe: LweDef, glwe: GlweDef,
        pbs_radix: RadixDecomposition, ks_radix: RadixDecomposition):
    """LWE -> blind rotate -> sample extract -> keyswitch -> LWE."""
    with obs.span("tfhe.pbs"):
        rotated = blind_rotate(test_poly, lwe_ct, bsk, glwe, pbs_radix)
        extracted = sample_extract(rotated, glwe)
        return keyswitch_lwe_to_lwe(extracted, ksk, lwe, ks_radix)


def test_polynomial_multi(fns, plaintext_bits: int, glwe: GlweDef,
                          device=None):
    """Multifunctional test polynomial: the v functions interleaved
    within each message block, so that one blind rotation (mod-switched
    with log_v = ceil(log2 v)) evaluates all of them and output j is
    `sample_extract(.., coeff=j)`. The interleave index is assigned after
    centering, so coefficients 0..v-1 land mid-block; needs
    ceil_pow2(v) <= block / 2."""
    n = glwe.poly_degree
    space = 1 << plaintext_bits
    block = n // (space // 2) if space > 1 else n
    half = block // 2
    v = len(fns)
    assert v >= 1
    ceil_v = 1 << (v - 1).bit_length()
    assert ceil_v <= max(1, block // 2), (
        f"{v} functions need blocks >= {2 * ceil_v} coefficients "
        f"(N={n}, bits={plaintext_bits} gives block={block})")
    out = np.zeros(n, dtype=np.uint64)
    for i in range(n):
        idx = i + half
        wrap = idx >= n
        idx_m = idx - n if wrap else idx
        msg = (idx_m // block) % space if space > 1 else 0
        fid = i % ceil_v
        val = int(fns[fid](msg)) % space if fid < v else 0
        enc = val << (TORUS_BITS - plaintext_bits)
        out[i] = (-enc) % (1 << 64) if wrap else enc
    return torch.from_numpy(out.view(np.int64)).to(resolve_device(device))


def programmable_bootstrap_multifunctional(
        lwe_ct, test_poly_multi, n_fns: int, bsk, ksk, lwe: LweDef,
        glwe: GlweDef, pbs_radix: RadixDecomposition,
        ks_radix: RadixDecomposition):
    """One blind rotation, `n_fns` sample extractions at consecutive
    coefficients, one keyswitch of all of them: [..., n_fns, n+1], row j
    encrypting fns[j](m)."""
    log_v = (n_fns - 1).bit_length()
    rotated = blind_rotate(test_poly_multi, lwe_ct, bsk, glwe, pbs_radix,
                           log_v)
    extracted = torch.stack([sample_extract(rotated, glwe, j)
                             for j in range(n_fns)], -2)
    return keyswitch_lwe_to_lwe(extracted, ksk, lwe, ks_radix)


def test_polynomial_torus(fn_torus, plaintext_bits: int, glwe: GlweDef,
                          device=None):
    """`test_polynomial_for` with fn returning raw torus values (circuit
    bootstrapping emits m B_j)."""
    n = glwe.poly_degree
    space = 1 << plaintext_bits
    block = n // (space // 2) if space > 1 else n
    v = np.zeros(n, dtype=np.uint64)
    for i in range(n):
        msg = (i // block) % space if space > 1 else 0
        v[i] = np.uint64(int(fn_torus(msg)) % (1 << 64))
    half = block // 2
    if half:
        rolled = np.roll(v, -half)
        rolled[-half:] = (-rolled[-half:].astype(np.int64)).astype(
            np.uint64)
        v = rolled
    return torch.from_numpy(v.view(np.int64)).to(resolve_device(device))


def bivariate_test_polynomial(fn, plaintext_bits: int, glwe: GlweDef,
                              carry_bits: int | None = None, device=None):
    """Test polynomial of f(a, b) over the packed message
    a 2^carry_bits + b (plaintext_bits <= carry_bits, carry_bits
    defaulting to plaintext_bits)."""
    if carry_bits is None:
        carry_bits = plaintext_bits
    assert plaintext_bits <= carry_bits, \
        "plaintext_bits must be <= carry_bits"
    total_bits = plaintext_bits + carry_bits

    def f2(m):
        return int(fn(m >> carry_bits, m & ((1 << carry_bits) - 1))) \
            % (1 << total_bits)

    return test_polynomial_for(f2, total_bits, glwe, device=device)


def programmable_bootstrap_bivariate(
        ct_a, ct_b, fn, bsk, ksk, lwe: LweDef, glwe: GlweDef,
        pbs_radix: RadixDecomposition, ks_radix: RadixDecomposition,
        plaintext_bits: int, carry_bits: int | None = None,
        test_poly=None):
    """f(a, b) as a univariate PBS of a 2^carry_bits + b over
    plaintext_bits + carry_bits bits. Both inputs must be encrypted at
    that packed precision (`torus.encode(v, plaintext_bits +
    carry_bits)`); pass `test_poly` (`bivariate_test_polynomial`,
    `BivariateLookupTable`) to reuse a table."""
    if carry_bits is None:
        carry_bits = plaintext_bits
    packed = lwe_add(lwe_scalar_mul(ct_a, 1 << carry_bits), ct_b)
    if test_poly is None:
        test_poly = bivariate_test_polynomial(fn, plaintext_bits, glwe,
                                              carry_bits, ct_a.device)
    return programmable_bootstrap_univariate(
        packed, test_poly, bsk, ksk, lwe, glwe, pbs_radix, ks_radix)


def _bootstrap_levels(lwe_ct, test_polys, bsk, glwe: GlweDef,
                      radix: RadixDecomposition):
    """Blind rotation and sample extraction of every ciphertext under each
    of the test polynomials [L, N], as one blind rotation of L times the
    batch: [..., L, kN+1]."""
    levels = test_polys.shape[0]
    tp = test_polys.reshape(levels, *(1,) * (lwe_ct.dim() - 1),
                            test_polys.shape[-1])
    rotated = blind_rotate(tp, lwe_ct.expand(levels, *lwe_ct.shape), bsk,
                           glwe, radix)
    return torch.movedim(sample_extract(rotated, glwe), 0, -2)


def generalized_programmable_bootstrap(
        lwe_ct, fn, plaintext_bits: int, bsk, lwe: LweDef, glwe: GlweDef,
        pbs_radix: RadixDecomposition, out_radix: RadixDecomposition):
    """A LEV-style stack [..., l_out, kN+1] of extracted LWEs, level j
    encrypting f(m) B_j under the extracted GLWE key. `fn` maps
    [0, 2^(bits-1)) into itself (the padding bit stays clear)."""
    tps = torch.stack([
        test_polynomial_torus(lambda mm, bj=bj: fn(mm) * bj, plaintext_bits,
                              glwe, lwe_ct.device)
        for bj in (1 << (TORUS_BITS - (j + 1) * out_radix.radix_log)
                   for j in range(out_radix.count))])
    return _bootstrap_levels(lwe_ct, tps, bsk, glwe, pbs_radix)


# --------------------------------------------------------------------------
# private functional keyswitching (LWE -> GLWE)
# --------------------------------------------------------------------------

def generate_private_functional_keyswitch_key(
        f_poly, from_sk, to_glwe_sk, to_params: GlweDef,
        radix: RadixDecomposition, gen: torch.Generator):
    """K_{i,j} = GLWE(f(s_i) B_j) for the secret linear f(x) = f_poly x
    (f_poly an integer polynomial), and the body keys K_{n,j} =
    GLWE(f(1) B_j): [n_in+1, l, k+1, N], all drawn in one batch."""
    f = torch.as_tensor(f_poly, dtype=torch.int64, device=to_glwe_sk.device)
    s = from_sk.to(f.device)
    msgs = torch.cat([s.unsqueeze(-1) * f, f.unsqueeze(0)])
    return encrypt_glev(msgs, to_glwe_sk, to_params, radix, gen)


def private_functional_keyswitch(ct, pfksk, to_params: GlweDef,
                                 radix: RadixDecomposition):
    """LWE(m) [..., n_in+1] -> GLWE(f(m)) [..., k+1, N]:
    decomp(b) . K_n - sum_i decomp(a_i) . K_i, whose phase is
    f(b) - sum_i a_i f(s_i) ~ f(m). The keys [n_in+1, l, ...] may carry
    several GLWE outputs ahead of [k+1, N] (circuit bootstrapping passes
    all k+1 rows' keys at once). One `_exact_dot` of the negated mask
    digits and the body's digits against the flattened keys."""
    n_in, count = ct.shape[-1] - 1, radix.count
    da = torus.signed_decompose(ct[..., :-1], radix.radix_log, count)
    db = torus.signed_decompose(ct[..., -1], radix.radix_log, count)
    d = torch.cat([-torch.movedim(da, 0, -1).flatten(-2),
                   torch.movedim(db, 0, -1)], -1)     # [..., (n_in+1) l]
    words = pfksk.reshape((n_in + 1) * count, -1)
    out = _exact_dot(d.reshape(-1, d.shape[-1]), words, radix.radix_log)
    return out.reshape(*ct.shape[:-1], *pfksk.shape[2:])


# --------------------------------------------------------------------------
# circuit bootstrapping + scheme switching
# --------------------------------------------------------------------------

def generate_cbs_pfksk(glwe_extracted_sk, to_glwe_sk, glwe: GlweDef,
                       radix: RadixDecomposition, gen: torch.Generator):
    """One private functional keyswitch key per GGSW row, mask row i for
    f_i(x) = -s'_i(X) x, the body row for f(x) = x: [k+1, n_in+1, l,
    k+1, N], every GLWE drawn in one batch."""
    kk, n = glwe.size, glwe.poly_degree
    f = torch.zeros(kk + 1, n, dtype=torch.int64, device=to_glwe_sk.device)
    f[:kk] = -to_glwe_sk
    f[kk, 0] = 1
    s = glwe_extracted_sk.to(f.device)
    msgs = torch.cat([s.unsqueeze(-1) * f.unsqueeze(-2), f.unsqueeze(-2)], -2)
    return encrypt_glev(msgs, to_glwe_sk, glwe, radix, gen)


@lru_cache(maxsize=8)
def _cbs_test_polys(glwe: GlweDef, out_radix: RadixDecomposition,
                    device: torch.device):
    """The test polynomials of m B_j over 2-bit messages, one a level."""
    return torch.stack([
        test_polynomial_torus(lambda m, bj=bj: m * bj, 2, glwe, device)
        for bj in (1 << (TORUS_BITS - (j + 1) * out_radix.radix_log)
                   for j in range(out_radix.count))])


def circuit_bootstrap(lwe_ct, bsk, cbs_pfksk, lwe: LweDef, glwe: GlweDef,
                      pbs_radix: RadixDecomposition,
                      out_radix: RadixDecomposition,
                      pfks_radix: RadixDecomposition):
    """LWE(bit) [..., n+1] -> GGSW(bit) [..., k+1, l_out, k+1, N]: each
    output level j bootstraps to LWE(m B_j) under the extracted key (the
    levels run as one blind rotation of l_out times the batch), then one
    private functional keyswitch a GGSW row maps it into row (i, j); the
    k+1 keyswitches of all levels run as one product."""
    tps = _cbs_test_polys(glwe, out_radix, lwe_ct.device)
    extracted = _bootstrap_levels(lwe_ct, tps, bsk, glwe, pbs_radix)
    keys = torch.movedim(cbs_pfksk, 0, 2)     # [n_in+1, l, k+1 (row), k+1, N]
    return torch.movedim(private_functional_keyswitch(
        extracted, keys, glwe, pfks_radix), -3, -4)


def generate_scheme_switch_key(glwe_sk, glwe: GlweDef,
                               radix: RadixDecomposition,
                               gen: torch.Generator):
    """GGSW(-s_i) for each mask polynomial i: [k, k+1, l, k+1, N], all
    encryptions drawn in one batch."""
    kk, n = glwe.size, glwe.poly_degree
    zeros = encrypt_glwe(
        torch.zeros(kk, kk + 1, radix.count, n, dtype=torch.int64,
                    device=glwe_sk.device), glwe_sk, glwe, gen)
    return _ggsw_units(-glwe_sk, glwe, radix, zeros)


def scheme_switch(glev, ssk, glwe: GlweDef, ssk_radix: RadixDecomposition,
                  out_radix: RadixDecomposition):
    """GLEV(m) [..., l_out, k+1, N] -> GGSW(m) [..., k+1, l_out, k+1, N]:
    mask rows (i, j) = GGSW(-s_i) ⊡ GLEV_j (every level in one external
    product), body rows GLEV_j. `ssk_radix` must be much finer than
    `out_radix`: the decomposition error is amplified by ||s_i||_1 ~ N/2."""
    assert glev.shape[-3] == out_radix.count
    rows = [external_product(ssk[i], glev, glwe, ssk_radix)
            for i in range(glwe.size)]
    return torch.stack(rows + [glev], -4)


# --------------------------------------------------------------------------
# GLWE keyswitch, public functional keyswitch
# --------------------------------------------------------------------------

def generate_glwe_keyswitch_key(from_sk, to_sk, to_params: GlweDef,
                                radix: RadixDecomposition,
                                gen: torch.Generator):
    """GLEV(from_sk_i) under to_sk, one a mask polynomial of the source
    key: [k_from, l, k+1, N]."""
    return encrypt_glev(from_sk.to(to_sk.device), to_sk, to_params, radix,
                        gen)


def keyswitch_glwe_to_glwe(ct, gksk, to_params: GlweDef,
                           radix: RadixDecomposition):
    """GLWE under s [..., k_from+1, N] -> GLWE under s' [..., k+1, N]:
    (0, b) - sum_i <decomp(a_i), GLEV(s_i)>."""
    k_from = gksk.shape[0]
    out = -_poly_dot(_gadget_digits(ct[..., :k_from, :], radix),
                     gksk.flatten(0, 1))
    out[..., -1, :] += ct[..., -1, :]
    return out


def generate_public_functional_keyswitch_key(
        from_sk, to_glwe_sk, to_params: GlweDef, radix: RadixDecomposition,
        gen: torch.Generator):
    """GLEV(s_i) (the constant polynomial s_i) under the target GLWE key,
    one a source LWE mask index: [n_in, l, k+1, N]. The morphism stays
    public and is applied at switch time."""
    msgs = torch.zeros(from_sk.shape[0], to_params.poly_degree,
                       dtype=torch.int64, device=to_glwe_sk.device)
    msgs[:, 0] = from_sk.to(msgs.device)
    return encrypt_glev(msgs, to_glwe_sk, to_params, radix, gen)


def public_functional_keyswitch(cts, pub_ksk, f_weights, to_params: GlweDef,
                                radix: RadixDecomposition):
    """p LWE ciphertexts [..., p, n+1] -> one GLWE [..., k+1, N] of
    f(m_1..m_p) for the public linear f(x)[c] = sum_j x_j f_weights[j][c]
    (integer weight polynomials [p, N]):
    (0, f(b)) - sum_i <decomp(f(a)_i), GLEV(s_i)>. f is a broadcast
    multiply-sum over the p axis, wrapping mod 2^64."""
    w = torch.as_tensor(f_weights, dtype=torch.int64, device=cts.device)
    a, b = cts[..., :-1], cts[..., -1]
    fa = (a.unsqueeze(-1) * w.unsqueeze(-2)).sum(-3)       # [..., n, N]
    fb = (b.unsqueeze(-1) * w).sum(-2)                     # [..., N]
    out = -_poly_dot(_gadget_digits(fa, radix), pub_ksk.flatten(0, 1))
    out[..., -1, :] += fb
    return out
