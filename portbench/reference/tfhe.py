"""Plain TFHE over the 2^64 torus, the check's reference for the TFHE
cells: the keys and ciphertexts a run hands to the program, LWE
decryption, and a textbook programmable bootstrap worked out exactly.

Torus words are u64 bit patterns held in int64, whose products and sums
wrap mod 2^64 as u64 arithmetic does. A ciphertext b = <a, s> + m + e
decrypts to its phase b - <a, s>; a GLWE ciphertext is [..., k+1, N],
its masks first and its body last; a GGSW row (c, j) encrypts zero plus
m B_j on component c, with B_j = 2^(64 - (j+1) radix_log). Products of a
polynomial by torus polynomials run as float64 matmuls over 22-bit limbs
of the words, where every sum is an integer below 2^53 and so exact.
Plain PyTorch, sharing nothing with the program under test.
"""

from __future__ import annotations

import torch

BITS = 64
LIMB = 22       # three limbs of 22, 22 and 20 bits a word


def srl(x, s: int):
    """The logical right shift of 64-bit patterns."""
    return (x >> s) & ((1 << (BITS - s)) - 1) if s else x


def phase(ct, s):
    """b - <a, s> mod 2^64 for every row of `ct`."""
    s = torch.as_tensor(s).to(device=ct.device, dtype=torch.int64)
    return ct[..., -1] - (ct[..., :-1] * s).sum(-1)


def decode(ph, bits: int):
    """The `bits`-bit message nearest to each torus phase."""
    shift = BITS - bits
    return srl(ph + (1 << (shift - 1)), shift) & ((1 << bits) - 1)


def s64(v: int) -> int:
    """The int64 pattern of the u64 value v."""
    return v - (1 << BITS) if v >= 1 << (BITS - 1) else v


def encode(msg, bits: int):
    """msg * 2^(64 - bits) as int64 torus words."""
    return torch.as_tensor(msg).to(torch.int64) * s64(1 << (BITS - bits))


def error_bits(ph, want) -> float:
    """log2 of the largest |phase - want| on the torus (0 where none
    differs)."""
    gap = (ph - want).to(torch.float64).abs().max()
    return float(torch.log2(gap)) if gap else 0.0


# ---------------------------------------------------------------------------
# keys and ciphertexts from a generator
# ---------------------------------------------------------------------------

def uniform_words(gen, shape):
    """Uniform torus words of `shape` on the generator's device."""
    hi = torch.randint(-(1 << 31), 1 << 31, tuple(shape), generator=gen,
                       device=gen.device, dtype=torch.int64)
    lo = torch.randint(0, 1 << 32, tuple(shape), generator=gen,
                       device=gen.device, dtype=torch.int64)
    return hi * (1 << 32) + lo


def gaussian_words(gen, shape, std: float):
    """Rounded Gaussian noise of standard deviation `std` (a share of the
    torus) as torus words."""
    e = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float64) * (std * 2.0 ** BITS)
    return e.round().to(torch.int64)


def lwe_encrypt(msg, s, std: float, gen):
    """LWE ciphertexts [..., n+1] of the torus words `msg` under s [n]."""
    s = s.to(torch.int64)
    a = uniform_words(gen, tuple(msg.shape) + (s.shape[-1],))
    b = (a * s).sum(-1) + msg + gaussian_words(gen, msg.shape, std)
    return torch.cat([a, b.unsqueeze(-1)], -1)


def glwe_encrypt_zero(shape, s, std: float, gen):
    """GLWE encryptions of zero [*shape, k+1, N] under s [k, N]."""
    k, n = s.shape
    a = uniform_words(gen, tuple(shape) + (k, n))
    body = gaussian_words(gen, tuple(shape) + (n,), std)
    for j in range(k):
        body = body + key_mul(a[..., j, :], s[j])
    return torch.cat([a, body.unsqueeze(-2)], -2)


def gadget(radix_log: int, count: int) -> list[int]:
    """B_j = 2^(64 - (j+1) radix_log) as int64 patterns."""
    return [s64(1 << (BITS - (j + 1) * radix_log)) for j in range(count)]


def bootstrap_key(lwe_s, glwe_s, std: float, radix_log: int, count: int,
                  gen):
    """GGSW encryptions of every LWE key bit: [n, k+1, l, k+1, N]."""
    k, n = glwe_s.shape
    out = glwe_encrypt_zero((lwe_s.shape[0], k + 1, count), glwe_s, std,
                            gen)
    bj = torch.tensor(gadget(radix_log, count), device=out.device)
    unit = lwe_s.to(torch.int64).unsqueeze(-1) * bj       # [n, l]
    for c in range(k + 1):
        out[:, c, :, c, 0] += unit
    return out


def keyswitch_key(from_s, to_s, std: float, radix_log: int, count: int,
                  gen):
    """KSK_{i,j} = LWE_to(from_s_i B_j): [n_in, l, n_out+1]."""
    bj = torch.tensor(gadget(radix_log, count), device=from_s.device)
    return lwe_encrypt(from_s.to(torch.int64).unsqueeze(-1) * bj, to_s,
                       std, gen)


# ---------------------------------------------------------------------------
# exact products
# ---------------------------------------------------------------------------

def _limbs(words):
    """[..., W] words -> [..., W, 3] float64 unsigned limbs."""
    m = (1 << LIMB) - 1
    return torch.stack([words & m, srl(words, LIMB) & m,
                        srl(words, 2 * LIMB)], -1).to(torch.float64)


def _join(parts):
    """[..., 3] exact integer limb products -> int64 words mod 2^64."""
    p = parts.round().to(torch.int64)
    return p[..., 0] + p[..., 1] * (1 << LIMB) + p[..., 2] * (1 << 2 * LIMB)


def dot(d, words):
    """d [R, K] small signed integers, words [K, W] -> d @ words mod 2^64
    [R, W]. Exact while K max|d| 2^22 stays under 2^53."""
    w = words.shape[-1]
    prod = d.to(torch.float64) @ _limbs(words).reshape(-1, w * 3)
    return _join(prod.reshape(-1, w, 3))


def _negacyclic(n: int, device):
    """Index (n - m) mod N and sign of the product's term m at n."""
    m = torch.arange(n, device=device)
    diff = m.unsqueeze(0) - m.unsqueeze(1)                # [m, n]: n - m
    sign = torch.where(diff >= 0, 1.0, -1.0).to(torch.float64)
    return diff % n, sign


def key_mul(a, s):
    """a s (negacyclic, mod 2^64) for torus polynomials a [..., N] and
    one small polynomial s [N]."""
    n = s.shape[-1]
    idx, sign = _negacyclic(n, a.device)
    mat = s.to(torch.float64)[idx] * sign                 # [m, n]
    lim = _limbs(a).movedim(-1, -2)                       # [..., 3, N]
    prod = lim.reshape(-1, n) @ mat
    return _join(prod.reshape(*a.shape[:-1], 3, n).movedim(-2, -1))


def poly_mul(d, rows):
    """sum_t d[:, t] * rows[t] (negacyclic, mod 2^64): small signed
    polynomials d [R, T, N] and torus polynomials rows [T, C, N] ->
    [R, C, N]."""
    t, c, n = rows.shape
    idx, sign = _negacyclic(n, rows.device)
    lim = _limbs(rows).permute(0, 2, 1, 3).reshape(t, n, c * 3)
    mat = lim[:, idx, :]                                  # [T, m, n, C 3]
    mat.mul_(sign.unsqueeze(-1))
    prod = d.reshape(d.shape[0], t * n).to(torch.float64) @ mat.reshape(
        t * n, n * c * 3)
    return _join(prod.reshape(-1, n, c, 3)).transpose(1, 2)


# ---------------------------------------------------------------------------
# the programmable bootstrap
# ---------------------------------------------------------------------------

def decompose(x, radix_log: int, count: int):
    """Balanced digits [..., count] of the closest multiple of
    2^(64 - radix_log count) to x, most significant first, each in
    (-B/2, B/2] with B = 2^radix_log; a digit of exactly B/2 carries
    where the digits above it are odd."""
    total = radix_log * count
    r = x
    if total < BITS:
        r = srl(x + (1 << (BITS - total - 1)), BITS - total) \
            & ((1 << total) - 1)
    base, half = 1 << radix_log, 1 << (radix_log - 1)
    out = []
    for _ in range(count):
        d = r & (base - 1)
        r = srl(r, radix_log)
        carry = (d > half) | ((d == half) & ((r & 1) == 1))
        out.append(torch.where(carry, d - base, d))
        r = r + carry.to(torch.int64)
    return torch.stack(out[::-1], -1)


def mod_switch(x, n: int):
    """Torus words -> Z_2N, rounded."""
    shift = BITS - (2 * n).bit_length() + 1
    return srl(x + (1 << (shift - 1)), shift) % (2 * n)


def monomial(p, e):
    """X^e p for polynomials p [R, ..., N] and exponents e [R] in
    [0, 2N)."""
    n = p.shape[-1]
    pos = (torch.arange(n, device=p.device) - e.unsqueeze(-1)) % (2 * n)
    shape = (e.shape[0],) + (1,) * (p.dim() - 2) + (n,)
    src = (pos % n).reshape(shape).expand(p.shape)
    neg = (pos >= n).reshape(shape)
    got = torch.gather(p, -1, src)
    return torch.where(neg, -got, got)


def test_polynomial(lut, plain_bits: int, out_bits: int, n: int, device):
    """v: coefficient i holds lut[m] 2^(64 - out_bits) for the message m
    whose bin of N / 2^(plain_bits - 1) coefficients holds i + half a bin
    (the bins centred), negated where i + half a bin passes N."""
    block = n // (1 << (plain_bits - 1))
    i = torch.arange(n, device=device) + block // 2
    msg = (i % n) // block
    vals = torch.tensor([int(v) % (1 << out_bits) for v in lut],
                        device=device)[msg % len(lut)]
    v = encode(vals, out_bits)
    return torch.where(i >= n, -v, v)


def bootstrap(ct, test_poly, bsk, ksk, pbs_radix: tuple, ks_radix: tuple):
    """The univariate programmable bootstrap of LWE rows ct [R, n+1]:
    blind rotation under the torus GGSW stack bsk [n, k+1, l, k+1, N],
    extraction of coefficient 0 and the keyswitch under ksk
    [kN, l', n+1]: [R, n+1]."""
    n_lwe, k1, lev, _, n = bsk.shape
    rows = ct.shape[0]
    for (radix_log, _), terms in ((pbs_radix, k1 * lev * n),
                                  (ks_radix, ksk.shape[0] * ksk.shape[1])):
        if terms << (radix_log - 1 + LIMB) >= 1 << 53:
            raise ValueError("the float64 sums would not be exact")
    b_t = mod_switch(ct[:, -1], n)
    a_t = mod_switch(ct[:, :-1], n)
    acc = torch.zeros(rows, k1, n, dtype=torch.int64, device=ct.device)
    acc[:, -1] = monomial(test_poly.expand(rows, n), (2 * n - b_t) % (2 * n))
    for i in range(n_lwe):
        diff = monomial(acc, a_t[:, i]) - acc
        d = decompose(diff, *pbs_radix)                  # [R, k+1, N, l]
        d = d.permute(0, 1, 3, 2).reshape(rows, k1 * lev, n)
        acc = acc + poly_mul(d, bsk[i].reshape(k1 * lev, k1, n))
    masks = acc[:, :-1]
    rev = torch.cat([masks[..., :1], -masks[..., 1:].flip(-1)], -1)
    a = rev.reshape(rows, -1)
    d = decompose(a, *ks_radix).reshape(rows, -1)       # index i l + j
    out = -dot(d, ksk.reshape(d.shape[1], -1))
    out[:, -1] += acc[:, -1, 0]
    return out
