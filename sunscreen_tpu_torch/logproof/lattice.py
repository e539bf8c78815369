"""Polynomial/matrix helpers for lattice relations A·S = T over
Z_q[X]/f: exact python-int host math (port of
`sunscreen_tpu/logproof/lattice.py`).

Replaces `logproof/src/{linear_algebra.rs,rings.rs,math.rs}` (Matrix /
Polynomial arithmetic, mod-switch-signed lifts, 2's-complement digit
expansion). These run at proof-build time; the MSMs they feed are the
hot path, on the card from 2048 points.
"""

from __future__ import annotations

from sunscreen_tpu_torch.zk import curve25519 as cv

L = cv.L


# polynomials: list[int] coefficients, little-endian degree order

def poly_trim(p: list[int]) -> list[int]:
    while p and p[-1] == 0:
        p = p[:-1]
    return p


def poly_add(a, b, q=None):
    n = max(len(a), len(b))
    out = [(a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)
           for i in range(n)]
    return [c % q for c in out] if q else out


def poly_sub(a, b, q=None):
    n = max(len(a), len(b))
    out = [(a[i] if i < len(a) else 0) - (b[i] if i < len(b) else 0)
           for i in range(n)]
    return [c % q for c in out] if q else out


def poly_mul(a, b, q=None):
    if not a or not b:
        return []
    # iterate the sparser operand's nonzeros (f = X^d + 1 style
    # quotient polys make one side 2-term)
    nza = sum(1 for x in a if x != 0)
    nzb = sum(1 for x in b if x != 0)
    if nzb < nza:
        a, b = b, a
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        if x == 0:
            continue
        for j, y in enumerate(b):
            out[i + j] += x * y
    return [c % q for c in out] if q else out


def poly_divmod(a, f, q):
    """Division in Z_q[X] by monic-leading f (leading coeff invertible)."""
    a = [c % q for c in a]
    f = poly_trim([c % q for c in f])
    inv_lead = pow(f[-1], -1, q)
    df = len(f) - 1
    quo = [0] * max(1, len(a) - df)
    rem = list(a)
    # iterate only f's nonzero low-order terms: O(d * nnz(f)) — the
    # SDLP quotient ring f = X^d + 1 makes this O(d)
    nz = [(j, c % q) for j, c in enumerate(f[:-1]) if c % q]
    for i in range(len(rem) - 1, df - 1, -1):
        c = rem[i] % q
        if c == 0:
            rem[i] = 0
            continue
        k = c * inv_lead % q
        quo[i - df] = k
        rem[i] = 0
        for j, fc in nz:
            rem[i - df + j] = (rem[i - df + j] - k * fc) % q
    return quo, poly_trim(rem)


def signed_lift(x: int, q: int) -> int:
    x %= q
    return x - q if x > q // 2 else x


def poly_eval(p, x, mod):
    acc = 0
    for c in reversed(p):
        acc = (acc * x + c) % mod
    return acc


# matrices: list[list[poly]]

def mat_mul_poly(A, S, q=None, bound: int | None = None):
    """(n x m) * (m x k) full polynomial product (no mod-f reduction).

    Large products route through the CRT-NTT path
    (`logproof/fastpoly.py`) — required for production-parameter SDLP
    (d = 1024..8192). `bound` is a bound on the true product's max
    |coefficient|; derived from q for the modular case, required for
    the integer (q=None) case on the fast path.
    """
    n, m = len(A), len(A[0])
    k = len(S[0])
    la = max((len(p) for row in A for p in row), default=0)
    lb = max((len(p) for row in S for p in row), default=0)
    work = n * k * m * la * lb
    if work > (1 << 22) and la and lb:
        if bound is None:
            if q is None:
                raise ValueError("the integer mat_mul_poly needs a bound")
            bound = m * min(la, lb) * (q - 1) * (q - 1)
        from sunscreen_tpu_torch.logproof.fastpoly import mat_mul_poly_fast
        return mat_mul_poly_fast(A, S, q, bound)
    out = [[[] for _ in range(k)] for _ in range(n)]
    for i in range(n):
        for j in range(k):
            acc: list[int] = []
            for r in range(m):
                acc = poly_add(acc, poly_mul(A[i][r], S[r][j], q), q)
            out[i][j] = acc
    return out


def mat_map(M, fn):
    return [[fn(p) for p in row] for row in M]


def mat_sub(A, B, q=None):
    return [[poly_sub(a, b, q) for a, b in zip(ra, rb)]
            for ra, rb in zip(A, B)]


# 2's complement digit machinery (reference: to_2s_complement_single)

def twos_complement_bits(v: int, bits: int) -> list[int]:
    """Signed int -> `bits` bits: [b_0..b_{bits-2}, sign], with value
    = sum b_i 2^i - sign*2^(bits-1)."""
    if bits == 0:
        if v != 0:
            raise ValueError(f"value {v} exceeds its zero-bit bound")
        return []
    if bits == 1:
        raise ValueError("a signed digit expansion needs two bits or none")
    is_neg = v < 0
    adjusted = abs(v) - (1 if is_neg else 0)
    if adjusted >= 1 << (bits - 1):
        raise ValueError(f"value {v} exceeds its {bits}-bit bound")
    out = [((adjusted >> i) & 1) ^ (1 if is_neg else 0)
           for i in range(bits - 1)]
    out.append(1 if is_neg else 0)
    return out


def twos_complement_coeffs(bits: int) -> list[int]:
    """Digit weights [1, 2, .., 2^(b-2), -2^(b-1)] mod L."""
    if bits == 0:
        return []
    out = [1 << i for i in range(bits - 1)]
    out.append((-(1 << (bits - 1))) % L)
    return out


def ceil_log2(x: int) -> int:
    if x <= 0:
        raise ValueError("ceil_log2 needs x > 0")
    return (x - 1).bit_length()
