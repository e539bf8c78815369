"""Exact modular arithmetic on int64 torch tensors.

Port of `sunscreen_tpu/math/modular.py`: the u32 section (moduli below
2^30), the u64 section (moduli below 2^62: 128-bit products, Barrett
and Shoup reduction) and the word-generic `w_*` wrappers that the RNS,
NTT and BFV layers call. PyTorch has no add,
shift or compare for uint32/uint64 on the CPU, so every word lives in an
int64 tensor:

* a u32 word is an int64 in [0, 2^32); a u64 word is its int64 bit
  pattern (values >= 2^63 read as negative);
* int64 multiply and add wrap mod 2^64, so low words come out right;
* `>>` is arithmetic, so `srl` masks after the shift;
* an overflow or carry test on u64 words is an unsigned compare: `ult`
  flips bit 63 of both sides before comparing. Shoup ratios
  floor(w 2^64 / q) are often >= 2^63, so they are negative as int64:
  they only ever enter `mul_hi`, which reads its operands unsigned.

The reference's `w_*` wrappers dispatch on the dtype of q (uint32 or
uint64). Every word here is an int64 tensor, so they take the engine
word (`U32` or `U64`, from `word_dtype_for`) as an argument instead.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_BIT63 = -(1 << 63)

U32_MAX_MODULUS_BITS = 30  # 4q < 2^32 (lazy headroom) and Shoup q < 2^32/4
MAX_MODULUS_BITS = 62      # u64 engine: lazy [0, 4q) fits a word
U32, U64 = "u32", "u64"    # engine words


def word_dtype_for(moduli) -> str:
    """Engine word of a modulus set: U32 iff every q < 2^30."""
    return (U32 if max(int(q).bit_length() for q in moduli)
            <= U32_MAX_MODULUS_BITS else U64)


def s64(v: int) -> int:
    """A python int in [0, 2^64) as the int64 with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def srl(x, s: int):
    """Logical right shift of u64 bit patterns by a constant 0 < s < 64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def ult(a, b):
    """Unsigned a < b on u64 bit patterns."""
    return (a ^ _BIT63) < (b ^ _BIT63)


def uge(a, b):
    return (a ^ _BIT63) >= (b ^ _BIT63)


# ---------------------------------------------------------------------------
# residue ops (a, b in [0, q))
# ---------------------------------------------------------------------------


def add_mod(a, b, q):
    s = a + b
    return torch.where(s >= q, s - q, s)


def sub_mod(a, b, q):
    d = a - b
    return torch.where(d < 0, d + q, d)


def neg_mod(a, q):
    return torch.where(a == 0, a, q - a)


def sum_mod(x, dim: int, q):
    """Sum of residues in [0, q) along `dim`, mod q, by pairwise modular
    adds (no int64 sum of 62-bit residues can overflow)."""
    x = torch.movedim(x, dim, 0)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        x = add_mod(x[0::2], x[1::2], q)
    return x[0]


def reduce_2q(x, q):
    """A lazy value in [0, 2q) to [0, q)."""
    return torch.where(x >= q, x - q, x)


def tensor3_mod(a, b, q):
    """The BFV tensor of two 2-component stacks [..., 2, k, N] of residues
    a, b < q < 2^30 -> [..., 3, k, N] = (a0 b0, a0 b1 + a1 b0, a1 b1) mod q
    (the middle sum is below 2^61, exact in int64)."""
    a0, a1 = a.unbind(-3)
    b0, b1 = b.unbind(-3)
    return torch.stack([a0 * b0 % q, (a0 * b1 + a1 * b0) % q, a1 * b1 % q],
                       -3)


def ks_inner_mod(d_hat, k0, k1, q):
    """The keyswitch digit contraction: d_hat [..., kdig, k, N] against
    both key components [kdig, k, N] (residues < q < 2^30) ->
    [..., 2, k, N] = sum_i d_i key_c[i] mod q. Each product is reduced
    before the sum, so int64 cannot overflow."""
    return torch.stack([(d_hat * key % q).sum(-3) % q for key in (k0, k1)],
                       -3)


# ---------------------------------------------------------------------------
# u32 engine (q < 2^30)
# ---------------------------------------------------------------------------


def mul_hi32(a, b):
    """High 32 bits of the exact product of two u32 words."""
    return srl(a * b, 32)


def shoup_ratio32(w: int, q: int) -> int:
    """Host: floor(w * 2^32 / q), w < q < 2^30."""
    assert 0 <= w < q < (1 << U32_MAX_MODULUS_BITS)
    return (w << 32) // q


def mul_mod_shoup32(x, w, w_sh, q):
    """(x * w) mod q, lazy: any u32 x, w < q < 2^30 -> [0, 2q)."""
    return (w * x - mul_hi32(x, w_sh) * q) & M32


def barrett32_consts(q: int) -> tuple[int, int]:
    """Host: (mu, s1) for `reduce_long32`: s1 = max(0, 2b - 32),
    mu = floor(2^(s1+32) / q) < 2^32."""
    b = q.bit_length()
    s1 = max(0, 2 * b - 32)
    mu = (1 << (s1 + 32)) // q
    assert mu < (1 << 32)
    return mu, s1


def reduce_long32(x, q, mu, s1):
    """x mod q for 0 <= x < 2^(2 bits(q)), q < 2^30; `s1` a python int
    or an int64 tensor that broadcasts against x."""
    qhat = srl((x >> s1) * mu, 32)
    r = (x - qhat * q) & M32       # true r < 4q < 2^32
    r = torch.where(r >= 2 * q, r - 2 * q, r)
    return torch.where(r >= q, r - q, r)


def mul_mod32(a, b, q, mu, s1):
    """(a * b) mod q exact for a, b in [0, q), q < 2^30."""
    return reduce_long32(a * b, q, mu, s1)


# ---------------------------------------------------------------------------
# u64 helpers (128-bit products and Barrett reduction)
# ---------------------------------------------------------------------------


def mul_wide(a, b):
    """Exact 64x64 -> 128 multiply of u64 bit patterns: (hi, lo)."""
    a0, a1 = a & M32, srl(a, 32)
    b0, b1 = b & M32, srl(b, 32)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = srl(p00, 32) + (p01 & M32) + (p10 & M32)   # < 3 * 2^32
    lo = (p00 & M32) | ((mid & M32) << 32)
    hi = p11 + srl(p01, 32) + srl(p10, 32) + srl(mid, 32)
    return hi, lo


def mul_hi(a, b):
    return mul_wide(a, b)[0]


def barrett_ratio(q: int) -> tuple[int, int]:
    """Host: floor(2^128 / q) as (hi, lo) python ints in [0, 2^64)."""
    assert 1 < q < (1 << 62)
    r = (1 << 128) // q
    return (r >> 64) & ((1 << 64) - 1), r & ((1 << 64) - 1)


def barrett_reduce_128(hi, lo, q, r_hi, r_lo):
    """(hi * 2^64 + lo) mod q for a value below q * 2^64; (r_hi, r_lo)
    is `barrett_ratio(q)` as int64 bit patterns."""
    carry = mul_hi(lo, r_lo)
    h2, l2 = mul_wide(lo, r_hi)
    tmp1 = l2 + carry
    tmp3 = h2 + ult(tmp1, l2).to(torch.int64)
    h3, l3 = mul_wide(hi, r_lo)
    carry2 = h3 + ult(tmp1 + l3, l3).to(torch.int64)
    qhat = hi * r_hi + tmp3 + carry2
    r = lo - qhat * q
    return torch.where(uge(r, q), r - q, r)


def barrett_reduce_64(a, q, r_hi, r_lo):
    """A full u64 word mod q (q < 2^62)."""
    return barrett_reduce_128(torch.zeros_like(a), a, q, r_hi, r_lo)


def mul_mod(a, b, q, r_hi, r_lo):
    """(a * b) mod q, exact, for u64 a, b in [0, q)."""
    hi, lo = mul_wide(a, b)
    return barrett_reduce_128(hi, lo, q, r_hi, r_lo)


def shoup_ratio(w: int, q: int) -> int:
    """Host: floor(w 2^64 / q) for a constant w < q (a python int, often
    >= 2^63; `s64` gives its int64 bit pattern)."""
    assert 0 <= w < q
    return (w << 64) // q


def mul_mod_shoup(x, w, w_sh, q):
    """(x w) mod q, lazy, for any u64 x, w < q < 2^62 and
    w_sh = floor(w 2^64 / q) as a bit pattern: the wrapped difference
    lies in [0, 2q) (Harvey)."""
    return w * x - mul_hi(x, w_sh) * q


# ---------------------------------------------------------------------------
# word-generic wrappers (the reference dispatches on q.dtype)
# ---------------------------------------------------------------------------


def w_shoup_host(w: int, q: int, word: str) -> int:
    return shoup_ratio32(w, q) if word == U32 else shoup_ratio(w, q)


def w_consts_host(q: int, word: str) -> tuple[int, int]:
    """(c0, c1) reduction constants: u32 -> (mu, s1) of
    `barrett32_consts`; u64 -> `barrett_ratio` (hi, lo)."""
    return barrett32_consts(q) if word == U32 else barrett_ratio(q)


def w_shoup_mul(x, w, w_sh, q, word: str):
    """Lazy Shoup multiply: x in [0, 2q) -> [0, 2q)."""
    if word == U32:
        return mul_mod_shoup32(x, w, w_sh, q)
    return mul_mod_shoup(x, w, w_sh, q)


def w_mul_mod(a, b, q, c0, c1, word: str):
    """Exact (a b) mod q for a, b in [0, q)."""
    if word == U32:
        return mul_mod32(a, b, q, c0, c1)
    return mul_mod(a, b, q, c0, c1)


def w_reduce(x, q, c0, c1, word: str):
    """A raw word to [0, q): u32 engine, sums and products below
    2^(2 bits(q)); u64 engine, any u64 bit pattern."""
    if word == U32:
        return reduce_long32(x, q, c0, c1)
    return barrett_reduce_64(x, q, c0, c1)


def w_sum_reduce(x, q, c0, c1, word: str, axis: int = -3):
    """Exact sum of residues along `axis`, then one reduction. The int64
    sum wraps as the u64 sum does, and k q < 2^64 for every caller, so
    the u64 sum never wraps."""
    return w_reduce(x.sum(axis), q, c0, c1, word)


# ---------------------------------------------------------------------------
# host number theory (python ints, plan-build time only)
# ---------------------------------------------------------------------------


def pow_mod_host(base: int, exp: int, q: int) -> int:
    return pow(base, exp, q)


def inv_mod_host(a: int, q: int) -> int:
    return pow(a, -1, q)
