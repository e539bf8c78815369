"""Host-side number theory: prime generation and roots of unity.

Replaces SEAL's `util/numth` (prime generation via `get_primes`, primitive
root search) consumed by the reference through
`seal_fhe/src/modulus.rs:18-250` (`CoefficientModulus::bfv_default`,
`PlainModulus::batching`). Pure python ints; runs at parameter/plan build
time only.
"""

from __future__ import annotations

from functools import lru_cache

_SMALL_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin, valid for all n < 3.3e24 (covers u64)."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def gen_ntt_primes(bit_size: int, count: int, ntt_size: int,
                   skip: tuple[int, ...] = ()) -> list[int]:
    """Generate `count` distinct primes of exactly `bit_size` bits with
    p ≡ 1 (mod 2*ntt_size), descending from the top of the range.

    Mirrors the behavior of SEAL's get_primes (used by
    CoefficientModulus::bfv_default / PlainModulus::batching) so that our
    default parameter tables have the same structure as the reference's.
    """
    assert 2 <= bit_size <= 62
    m = 2 * ntt_size
    out: list[int] = []
    # largest candidate = largest value < 2^bit_size congruent to 1 mod m
    cand = ((1 << bit_size) - 1) // m * m + 1
    while cand > (1 << (bit_size - 1)):
        if cand not in skip and is_prime(cand):
            out.append(cand)
            if len(out) == count:
                return out
        cand -= m
    raise ValueError(
        f"not enough {bit_size}-bit NTT primes for ntt_size={ntt_size}")


@lru_cache(maxsize=None)
def _factorize(n: int) -> tuple[int, ...]:
    fs = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            if not fs or fs[-1] != d:
                fs.append(d)
            n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        fs.append(n)
    return tuple(fs)


def primitive_root(q: int) -> int:
    """Smallest primitive root modulo prime q."""
    phi = q - 1
    factors = _factorize(phi)
    g = 2
    while True:
        if all(pow(g, phi // f, q) != 1 for f in factors):
            return g
        g += 1


def root_of_unity(order: int, q: int) -> int:
    """A primitive `order`-th root of unity mod prime q (order | q-1)."""
    assert (q - 1) % order == 0, f"{order} does not divide {q}-1"
    g = primitive_root(q)
    w = pow(g, (q - 1) // order, q)
    assert pow(w, order, q) == 1 and pow(w, order // 2, q) != 1
    return w


def min_root_of_unity(order: int, q: int) -> int:
    """The minimal primitive `order`-th root of unity mod q (matches SEAL's
    choice so twiddle tables are reproducible across builds)."""
    w = root_of_unity(order, q)
    # all primitive roots are w^k for odd k (gcd(k, order) == 1); order is a
    # power of two here so odd k suffices.
    best = w
    cur = w
    w2 = pow(w, 2, q)
    for _ in range(order // 2 - 1):
        cur = cur * w2 % q
        if cur < best:
            best = cur
    return best
