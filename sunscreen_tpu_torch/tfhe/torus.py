"""Torus (Z / 2^64) arithmetic and signed radix decomposition (port of
`sunscreen_tpu/tfhe/torus.py`).

A torus word is a u64 held as its int64 bit pattern: add, subtract,
multiply and sum wrap mod 2^64 exactly as u64 arithmetic does; every
right shift is logical (`modular.srl`), and a left shift is a multiply
by a power of two.
"""

from __future__ import annotations

import torch

from sunscreen_tpu_torch.math.modular import s64, srl
from sunscreen_tpu_torch.tfhe.params import TORUS_BITS


def _words(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def encode(msg, plaintext_bits: int, device=None):
    """Integer message -> torus: m * 2^(64 - bits)."""
    return _words(msg, device) * s64(1 << (TORUS_BITS - plaintext_bits))


def decode(t, plaintext_bits: int):
    """Torus -> integer message with rounding."""
    shift = TORUS_BITS - plaintext_bits
    return srl(_words(t) + (1 << (shift - 1)), shift) \
        & ((1 << plaintext_bits) - 1)


def signed_decompose(t, radix_log: int, count: int):
    """Balanced base-2^radix_log decomposition of the `count` most
    significant digits: int64 digits [count, ...], digit i in
    (-B/2, B/2], most significant first, with
    sum_i d_i 2^(64 - (i+1) radix_log) the closest multiple to t."""
    t = _words(t)
    total = radix_log * count
    shift = TORUS_BITS - total
    rounded = srl(t + (1 << (shift - 1)), shift) if shift > 0 else t
    if total < 64:
        rounded = rounded & ((1 << total) - 1)
    b = 1 << radix_log
    half_b = b // 2
    digits = []
    cur = rounded
    for _ in range(count):                 # least significant first
        d = cur & (b - 1)
        cur = srl(cur, radix_log)
        carry = (d > half_b) | ((d == half_b) & ((cur & 1) == 1))
        d = torch.where(carry, d - b, d)
        cur = cur + carry.to(torch.int64)
        digits.append(d)
    digits.reverse()
    return torch.stack(digits)


def gadget_digits(polys, radix_log: int, count: int):
    """polys [..., K, N] -> gadget digits [..., K count, N], index
    i count + j."""
    digits = signed_decompose(polys, radix_log, count)
    return torch.movedim(digits, 0, -2).flatten(-3, -2)


def recompose(digits, radix_log: int):
    """Inverse of signed_decompose (up to the dropped low bits)."""
    acc = torch.zeros(digits.shape[1:], dtype=torch.int64,
                      device=digits.device)
    for i in range(digits.shape[0]):
        acc = acc + digits[i] * s64(1 << (TORUS_BITS - (i + 1) * radix_log))
    return acc
