"""Plain integer reference of the chi_sq program (upstream Sunscreen's
examples/chi_sq): for counts n0, n1, n2,
alpha = (4 n0 n2 - n1^2)^2, b1 = 2 (2 n0 + n1)^2,
b2 = (2 n0 + n1) (2 n2 + n1), b3 = 2 (2 n2 + n1)^2,
and the decoding of the program's Signed outputs: coefficients centered
mod t, read as binary digits."""

from __future__ import annotations

import numpy as np


def expected(n0: int, n1: int, n2: int) -> tuple[int, int, int, int]:
    a = 4 * n0 * n2 - n1 * n1
    return (a * a, 2 * (2 * n0 + n1) ** 2, (2 * n0 + n1) * (2 * n2 + n1),
            2 * (2 * n2 + n1) ** 2)


def decode_signed(coeffs, t: int, digits: int = 64):
    """Plaintext coefficients (ints in [0, t), [N]) -> the
    integer sum_i c_i 2^i with each c_i centered into (-t/2, t/2], or None
    when a coefficient at or past `digits` is nonzero (no 64-bit Signed
    value decodes from such a polynomial)."""
    vals = np.asarray(coeffs)
    if np.any(vals[digits:]):
        return None
    out = 0
    for i, c in enumerate(vals[:digits].tolist()):
        out += (c - t if c > t // 2 else c) << i
    return out
