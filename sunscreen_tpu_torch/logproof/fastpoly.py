"""Exact big-integer polynomial products via CRT over vectorized numpy
NTTs: the SDLP host-math hot path at production parameters (port of
`sunscreen_tpu/logproof/fastpoly.py`, the same numpy code: it is host
math, not a kernel, and its results equal the reference's bit for bit).

`logproof/lattice.py`'s schoolbook `poly_mul`/`mat_mul_poly` are
O(d^2) python-int loops; at the reference's proof sizes (SEAL
statements with d = 1024..8192, `logproof/tests/seal.rs:10-56`) the
A·S products alone would take hours. This module computes the same
products exactly by:

1. reducing every coefficient modulo a basis of 30-bit NTT-friendly
   primes whose product exceeds twice the worst-case |coefficient|,
2. cyclic NTTs of size M >= deg(product)+1 per prime — vectorized
   numpy u64 butterflies (p < 2^30 keeps every product < 2^60),
3. pointwise multiply-accumulate in the transform domain,
4. inverse NTTs and per-coefficient Garner/CRT reconstruction back to
   python ints (centered when `signed`).

Bit-exactness against the schoolbook path and the reference is pinned by
tests/test_torch_logproof.py.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from sunscreen_tpu_torch.math import primes as primegen

_P30_CACHE: dict[int, list[int]] = {}


def _ntt_primes(m: int, count: int) -> list[int]:
    """`count` 30-bit primes p = 1 (mod m)."""
    have = _P30_CACHE.setdefault(m, [])
    while len(have) < count:
        # gen_ntt_primes returns the same leading primes for the same
        # args; ask for progressively more
        have[:] = primegen.gen_ntt_primes(30, len(have) + 8, m)
    return have[:count]


@lru_cache(maxsize=32)
def _plan(m: int, p: int):
    """(stage twiddle tables, inverse tables, n_inv) for a cyclic
    size-m NTT mod p, DIF forward / DIT inverse, natural->bitrev->natural."""
    log = m.bit_length() - 1
    w = primegen.root_of_unity(m, p)
    iw = pow(w, -1, p)
    fwd_tabs = []
    inv_tabs = []
    for s in range(log):
        half = m >> (s + 1)
        fwd_tabs.append(np.array(
            [pow(w, (j << s), p) for j in range(half)], np.uint64))
        inv_tabs.append(np.array(
            [pow(iw, (j << s), p) for j in range(half)], np.uint64))
    return fwd_tabs, inv_tabs, pow(m, -1, p)


def _ntt(a: np.ndarray, p: int, m: int) -> np.ndarray:
    """Cyclic NTT over the last axis (length m), DIF, output
    bit-reversed. a: uint64, entries < p."""
    fwd, _, _ = _plan(m, p)
    log = m.bit_length() - 1
    x = a
    for s in range(log):
        nb = 1 << s
        half = m >> (s + 1)
        xv = x.reshape(*x.shape[:-1], nb, 2, half)
        u = xv[..., 0, :]
        v = xv[..., 1, :]
        t = (u + p - v)
        x = np.concatenate(
            (((u + v) % p)[..., None, :],
             (t * fwd[s] % p)[..., None, :]), axis=-2
        ).reshape(*a.shape[:-1], m)
    return x


def _intt(a: np.ndarray, p: int, m: int) -> np.ndarray:
    """Inverse of `_ntt` (bit-reversed input -> natural output)."""
    _, inv, n_inv = _plan(m, p)
    log = m.bit_length() - 1
    x = a
    for s in reversed(range(log)):
        nb = 1 << s
        half = m >> (s + 1)
        xv = x.reshape(*x.shape[:-1], nb, 2, half)
        u = xv[..., 0, :]
        v = xv[..., 1, :] * inv[s] % p
        x = np.concatenate(
            (((u + v) % p)[..., None, :],
             ((u + p - v) % p)[..., None, :]), axis=-2
        ).reshape(*a.shape[:-1], m)
    return x * n_inv % p


def _to_residues(polys: list[list[int]], m: int, ps: list[int]
                 ) -> np.ndarray:
    """[n_polys][coeffs] python ints -> [n_primes, n_polys, m] u64."""
    out = np.zeros((len(ps), len(polys), m), np.uint64)
    for j, poly in enumerate(polys):
        for i, c in enumerate(poly):
            c = int(c)
            if c == 0:
                continue
            for t, p in enumerate(ps):
                out[t, j, i] = c % p
    return out


def _crt_coeffs(res: np.ndarray, ps: list[int], signed: bool
                ) -> list[list[int]]:
    """[n_primes, n_polys, m] residues -> python-int coefficient lists
    (centered in (-P/2, P/2] when signed)."""
    big = 1
    for p in ps:
        big *= p
    weights = []
    for p in ps:
        n_p = big // p
        weights.append(n_p * pow(n_p % p, -1, p))
    n_primes, n_polys, m = res.shape
    out = []
    res_int = res.astype(object)
    half = big // 2
    for j in range(n_polys):
        acc = np.zeros(m, object)
        for t in range(n_primes):
            acc += res_int[t, j] * weights[t]
        acc %= big
        if signed:
            coeffs = [int(c) - big if c > half else int(c) for c in acc]
        else:
            coeffs = [int(c) for c in acc]
        out.append(coeffs)
    return out


def mat_mul_poly_fast(a, s, q: int | None, bound: int,
                      out_len: int | None = None):
    """(n x m)·(m x k) full polynomial product, exact.

    `a`/`s`: matrices of python-int coefficient lists. `bound`: a bound
    on max |coefficient| of the TRUE result (pre-mod); primes are chosen
    with product > 2*bound so CRT is exact. When `q` is given the
    result coefficients are reduced into [0, q).
    """
    n, mm = len(a), len(a[0])
    k = len(s[0])
    la = max((len(p) for row in a for p in row), default=1)
    lb = max((len(p) for row in s for p in row), default=1)
    need = la + lb - 1
    m_size = max(2, 1 << (need - 1).bit_length())
    n_primes = max(1, (2 * bound).bit_length() // 29 + 1)
    ps = _ntt_primes(m_size, n_primes)

    a_res = _to_residues([p for row in a for p in row], m_size, ps)
    s_res = _to_residues([p for row in s for p in row], m_size, ps)
    a_res = a_res.reshape(n_primes, n, mm, m_size)
    s_res = s_res.reshape(n_primes, mm, k, m_size)

    out_res = np.zeros((n_primes, n, k, m_size), np.uint64)
    for t, p in enumerate(ps):
        a_hat = _ntt(a_res[t], p, m_size)
        s_hat = _ntt(s_res[t], p, m_size)
        for i in range(n):
            for j in range(k):
                acc = np.zeros(m_size, np.uint64)
                for r in range(mm):
                    acc = (acc + a_hat[i, r] * s_hat[r, j]) % p
                out_res[t, i, j] = _intt(acc, p, m_size)

    flat = _crt_coeffs(out_res.reshape(n_primes, n * k, m_size), ps,
                       signed=q is None)
    length = out_len if out_len is not None else need
    out = []
    for i in range(n):
        row = []
        for j in range(k):
            coeffs = flat[i * k + j][:length]
            if q is not None:
                coeffs = [c % q for c in coeffs]
            row.append(coeffs)
        out.append(row)
    return out
