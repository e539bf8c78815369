"""TFHE operations on int64 torch tensors (port of
`sunscreen_tpu/tfhe/ops.py`): keygen, LWE/GLWE encryption, GGSW and the
external product, CMUX, blind rotation, sample extraction, LWE
keyswitching and the univariate programmable bootstrap (PBS).

Conventions are the reference's: a ciphertext is b = <a, s> + m + e over
the 2^64 torus; GLWE masks are the first k rows of [..., k+1, N], the
body last; a GGSW is [k+1, l, k+1, N]. Torus words are u64 bit patterns
in int64 (`tfhe/torus.py`). Batches are leading axes: where the
reference vmaps one ciphertext at a time, the port takes the batch
directly (a blind rotation rotates each row by its own exponent).

Randomness comes from an explicit `torch.Generator`, so keys and
ciphertexts differ from the reference's threefry bits; `tfhe/keys.py`
carries the reference's over. Keygen entry points run on CUDA unless the
caller passes `device="cpu"`; every other op runs where its inputs lie.

On the card a blind-rotation step with an NTT-domain bootstrap key runs
B1 (`ntt_fwd`) then B5 (`inv_ks`), or, under
`SUNSCREEN_TPU_TFHE_KSFULL=1` at GLWE size 1, B15 (`ks_full`) alone; the
rest of the step is plain PyTorch.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sunscreen_tpu_torch import resolve_device
from sunscreen_tpu_torch.math import sampling
from sunscreen_tpu_torch.math.modular import s64, srl
from sunscreen_tpu_torch.tfhe import torus
from sunscreen_tpu_torch.tfhe.params import TORUS_BITS, GlweDef, LweDef, \
    RadixDecomposition
from sunscreen_tpu_torch.tfhe.poly import get_torus_plan, \
    get_torus_plan_u32, negacyclic_monomial_mul


def _gadget(radix: RadixDecomposition) -> list[int]:
    """B_j = 2^(64 - (j+1) radix_log) as int64 bit patterns."""
    return [s64(1 << (TORUS_BITS - (j + 1) * radix.radix_log))
            for j in range(radix.count)]


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

def encrypt_lwe(msg_torus, sk, params: LweDef, gen: torch.Generator):
    """msg_torus: torus words of any shape. Returns [..., n+1]."""
    msg = torch.as_tensor(msg_torus, dtype=torch.int64, device=sk.device)
    a = sampling.uniform_u64(gen, tuple(msg.shape) + (params.dim,),
                             sk.device)
    e = sampling.torus_gaussian(gen, msg.shape, params.std, sk.device)
    b = (a * sk).sum(-1) + msg + e                 # wraps mod 2^64
    return torch.cat([a, b.unsqueeze(-1)], dim=-1)


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


# --------------------------------------------------------------------------
# GGSW + external product
# --------------------------------------------------------------------------

def _ggsw_units(msg_poly, params: GlweDef, radix: RadixDecomposition,
                zeros):
    """GLWE encryptions of zero [..., k+1, l, k+1, N] plus msg * B_j on
    component i of row (i, j); msg_poly [..., N] broadcasts."""
    bj = torch.tensor(_gadget(radix), dtype=torch.int64,
                      device=zeros.device)
    unit = msg_poly.unsqueeze(-2) * bj.unsqueeze(-1)      # [..., l, N]
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


def external_product(ggsw, glwe, params: GlweDef,
                     radix: RadixDecomposition):
    """GGSW(m) ⊡ GLWE(c) -> GLWE(m c), exact through the 2-prime CRT
    NTT: gadget-decompose each GLWE row, multiply by the GGSW rows."""
    plan = get_torus_plan(params.poly_degree, device=glwe.device)
    acc = None
    for i in range(params.size + 1):
        digits = torus.signed_decompose(glwe[..., i, :], radix.radix_log,
                                        radix.count)
        for j in range(radix.count):
            d_hat = plan.fwd(plan.signed_to_rns(digits[j]))  # [..., kp, N]
            row_hat = plan.fwd(plan.torus_to_rns(ggsw[..., i, j, :, :]))
            term = plan.pointwise(d_hat.unsqueeze(-3), row_hat)
            acc = term if acc is None else plan.add(acc, term)
    return plan.to_torus(plan.plan.inv(acc))


def cmux(sel_ggsw, d0, d1, params: GlweDef, radix: RadixDecomposition):
    """d0 + sel ⊡ (d1 - d0)."""
    return d0 + external_product(sel_ggsw, d1 - d0, params, radix)


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
    or B1, a plain contraction and B3 at larger GLWE sizes. Bit-identical
    to the raw-key path: both are exact integer pipelines."""
    n, kk = glwe.poly_degree, glwe.size
    a, b = lwe_ct[..., :-1], lwe_ct[..., -1]
    plan = get_torus_plan_u32(n, device=lwe_ct.device)
    b_t = _mod_switch_2n(b, n, log_v)
    a_t = _mod_switch_2n(a, n, log_v)
    acc = trivial_glwe(negacyclic_monomial_mul(
        torch.as_tensor(test_poly, dtype=torch.int64, device=lwe_ct.device),
        2 * n - b_t, n), glwe)
    kdig = (kk + 1) * radix.count
    ksfull = kk == 1 and os.environ.get("SUNSCREEN_TPU_TFHE_KSFULL",
                                        "0") != "0"
    q = plan.base.q
    for i in range(a.shape[-1]):
        rotated = negacyclic_monomial_mul(acc, a_t[..., i], n)
        digits = torus.signed_decompose(rotated - acc, radix.radix_log,
                                        radix.count)    # [l, ..., k+1, N]
        d = torch.movedim(digits, 0, -2)                # [..., k+1, l, N]
        d_rns = plan.signed_to_rns(d.reshape(*d.shape[:-3], kdig, n))
        ks = bsk.rows[i]                                # [k+1, kdig, kp, N]
        if ksfull:
            upd = plan.ks_full(d_rns, ks[0], ks[1])
        elif kk == 1:
            upd = plan.contract_inv(plan.fwd(d_rns), ks[0], ks[1])
        else:
            # each product < q^2 < 2^60 is reduced before the digit sum
            d_hat = plan.fwd(d_rns).unsqueeze(-4)       # [..., 1, kdig, kp, N]
            upd = plan.plan.inv((d_hat * ks % q).sum(-3) % q)
        acc = acc + plan.to_torus(upd)                  # wrapping add: CMUX
    return acc


def blind_rotate(test_poly, lwe_ct, bsk, glwe: GlweDef,
                 radix: RadixDecomposition, log_v: int = 0):
    """acc = X^{-b~} v; for each i: acc = CMUX(bsk_i, acc, X^{a~_i} acc).
    Returns GLWE [..., k+1, N] whose phase is v X^{-phase~}. Takes a raw
    torus GGSW stack (the exact 2-prime CRT path per CMUX) or an
    NttBootstrapKey (the kernel path); both give the same bits."""
    if isinstance(bsk, NttBootstrapKey):
        return _blind_rotate_ntt(test_poly, lwe_ct, bsk, glwe, radix, log_v)
    n = glwe.poly_degree
    a, b = lwe_ct[..., :-1], lwe_ct[..., -1]
    b_t = _mod_switch_2n(b, n, log_v)
    a_t = _mod_switch_2n(a, n, log_v)
    acc = trivial_glwe(negacyclic_monomial_mul(
        torch.as_tensor(test_poly, dtype=torch.int64, device=lwe_ct.device),
        2 * n - b_t, n), glwe)
    for i in range(a.shape[-1]):
        rotated = negacyclic_monomial_mul(acc, a_t[..., i], n)
        acc = cmux(bsk[i], acc, rotated, glwe, radix)
    return acc


def sample_extract(glwe_ct, params: GlweDef, coeff: int = 0):
    """GLWE -> LWE of coefficient `coeff` under the flattened key:
    a'_{j,t} = mask_j[(coeff - t) mod N], negated where t > coeff."""
    kk, n = params.size, params.poly_degree
    h = int(coeff)
    assert 0 <= h < n
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
    a, b = ct[..., :-1], ct[..., -1]
    n_in, w = a.shape[-1], ksk.shape[-1]
    digits = torus.signed_decompose(a, radix.radix_log, radix.count)
    d = torch.movedim(digits, 0, -1).reshape(-1, n_in * radix.count)
    acc = _exact_dot(d, ksk.reshape(n_in * radix.count, w), radix.radix_log)
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
    rotated = blind_rotate(test_poly, lwe_ct, bsk, glwe, pbs_radix)
    extracted = sample_extract(rotated, glwe)
    return keyswitch_lwe_to_lwe(extracted, ksk, lwe, ks_radix)
