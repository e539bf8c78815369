"""BFV encryption parameters (port of `sunscreen_tpu/bfv/params.py`):
`BfvParams` with the u64-engine defaults (`default`: limbs up to 56
bits), the u32-engine constructors (every modulus below 2^30) and the
tables they need. Host Python only; the values equal the reference's
for the same arguments."""

from __future__ import annotations

import math
from dataclasses import dataclass

from sunscreen_tpu_torch.errors import ParamsError
from sunscreen_tpu_torch.math import primes

# HE-Standard: max log2(q*p) for (security, N), ternary secret, classical.
MAX_LOG_Q = {
    128: {1024: 27, 2048: 54, 4096: 109, 8192: 218, 16384: 438, 32768: 881},
    192: {1024: 19, 2048: 37, 4096: 75, 8192: 152, 16384: 305, 32768: 611},
    256: {1024: 14, 2048: 29, 4096: 58, 8192: 118, 16384: 237, 32768: 476},
}

# u64 engine: limbs of at most 56 bits, the reference's cap (its matmul
# NTT needs n1 q^2 < q 2^64; the port's mode "matmul" keeps the bound).
SEALISH_MAX_LIMB_BITS = 56

# u32 engine: every modulus < 2^30.
U32_MAX_LIMB_BITS = 30


def _split_moduli(poly_degree: int, security: int, cap: int
                  ) -> tuple[tuple[int, ...], int]:
    """Ciphertext primes of at most `cap` bits plus one special
    keyswitch prime inside the HE-standard budget."""
    total = MAX_LOG_Q[security][poly_degree]
    special_bits = min(cap, max(total // 3, 2))
    rem = total - special_bits
    count = max(1, math.ceil(rem / cap))
    base = rem // count
    sizes = [base + (1 if i < rem - base * count else 0)
             for i in range(count)]
    special = primes.gen_ntt_primes(special_bits, 1, poly_degree)[0]
    qs: list[int] = []
    for b in sorted(set(sizes)):
        need = sizes.count(b)
        qs += primes.gen_ntt_primes(b, need, poly_degree,
                                    skip=tuple([special] + qs))
    assert len(qs) == count
    return tuple(sorted(qs)), special


# SEAL's BFVDefault 128-bit modulus chains (published constants of
# seal::util::global_variables), so that users can run on SEAL's exact
# chains, and the single-prime chains at N = 1024 of each security tier.
SEAL_BFV_DEFAULT_128 = {
    1024: (0x7e00001,),
    2048: (0x3fffffff000001,),
    4096: (0xffffee001, 0xffffc4001, 0x1ffffe0001),
    8192: (0x7fffffd8001, 0x7fffffc8001, 0xfffffffc001,
           0xffffff6c001, 0xfffffebc001),
}
SEAL_BFV_DEFAULT_1024 = {128: (0x7e00001,), 192: (520193,),
                         256: (12289,)}


def default_moduli(poly_degree: int, security: int = 128
                   ) -> tuple[tuple[int, ...], int]:
    """(ciphertext moduli, special keyswitch prime) of at most 56 bits
    each inside the HE-standard budget for (N, security) (SEAL's
    `CoeffModulus::BFVDefault` role)."""
    return _split_moduli(poly_degree, security, SEALISH_MAX_LIMB_BITS)


def coefficient_modulus_create(poly_degree: int,
                               bit_sizes: list[int]) -> tuple[int, ...]:
    """SEAL `CoeffModulus::Create`: for each distinct bit size as many
    NTT-friendly primes as asked for, descending from the top of the
    range, handed out smallest-first within each size."""
    by_size = {b: primes.gen_ntt_primes(b, bit_sizes.count(b), poly_degree)
               for b in set(bit_sizes)}
    return tuple(by_size[b].pop() for b in bit_sizes)


def default_moduli_u32(poly_degree: int, security: int = 128
                       ) -> tuple[tuple[int, ...], int]:
    """30-bit-capped ciphertext primes + one 30-bit-capped special
    keyswitch prime inside the HE-standard budget."""
    return _split_moduli(poly_degree, security, U32_MAX_LIMB_BITS)


def batching_plain_modulus(poly_degree: int, bits: int) -> int:
    """Prime of `bits` bits with p = 1 mod 2N (SEAL
    `PlainModulus::batching`)."""
    return primes.gen_ntt_primes(bits, 1, poly_degree)[0]


@dataclass(frozen=True)
class BfvParams:
    """Scheme parameters: ciphertext primes Q (`coeff_modulus`) and the
    key-switching prime P (`special_modulus`)."""

    poly_degree: int
    plain_modulus: int
    coeff_modulus: tuple[int, ...]
    special_modulus: int
    security_level: int = 128

    @staticmethod
    def default(poly_degree: int, plain_modulus: int | None = None,
                security: int = 128, batching: bool = True) -> "BfvParams":
        """u64-engine defaults: limbs of up to 56 bits."""
        if plain_modulus is None:
            plain_modulus = (batching_plain_modulus(poly_degree, 20)
                             if batching else 1 << 18)
        qs, sp = default_moduli(poly_degree, security)
        return BfvParams(poly_degree, plain_modulus, qs, sp, security)

    @staticmethod
    def default_u32(poly_degree: int, plain_modulus: int | None = None,
                    security: int = 128, batching: bool = True
                    ) -> "BfvParams":
        """u32-engine defaults: all moduli < 2^30."""
        if plain_modulus is None:
            plain_modulus = (batching_plain_modulus(poly_degree, 20)
                             if batching else 1 << 18)
        qs, sp = default_moduli_u32(poly_degree, security)
        return BfvParams(poly_degree, plain_modulus, qs, sp, security)

    @staticmethod
    def insecure_u32(poly_degree: int = 1024,
                     plain_modulus: int | None = None,
                     limbs: int = 3, limb_bits: int = 28) -> "BfvParams":
        """Small u32-engine test parameters."""
        assert limb_bits + 2 <= U32_MAX_LIMB_BITS
        if plain_modulus is None:
            plain_modulus = batching_plain_modulus(poly_degree, 16)
        sp = primes.gen_ntt_primes(limb_bits + 2, 1, poly_degree)[0]
        qs = tuple(primes.gen_ntt_primes(limb_bits, limbs, poly_degree,
                                         skip=(sp,)))
        return BfvParams(poly_degree, plain_modulus, qs, sp,
                         security_level=0)

    @staticmethod
    def insecure(poly_degree: int = 1024, plain_modulus: int | None = None,
                 limbs: int = 2, limb_bits: int = 40) -> "BfvParams":
        """Small test parameters; with limbs of at most 30 bits the
        special modulus is capped at 30 bits too."""
        if plain_modulus is None:
            plain_modulus = batching_plain_modulus(poly_degree, 16)
        sp_bits = limb_bits + 4
        if limb_bits <= 30:
            sp_bits = min(sp_bits, 30)
        sp = primes.gen_ntt_primes(sp_bits, 1, poly_degree)[0]
        qs = tuple(primes.gen_ntt_primes(limb_bits, limbs, poly_degree,
                                         skip=(sp,)))
        return BfvParams(poly_degree, plain_modulus, qs, sp,
                         security_level=0)

    def __post_init__(self):
        n = self.poly_degree
        if n & (n - 1) != 0 or n < 8:
            raise ParamsError(f"poly_degree must be a power of two >= 8, "
                              f"got {n}")
        if self.plain_modulus < 2:
            raise ParamsError("plain_modulus must be >= 2")
        if self.plain_modulus >= min(self.coeff_modulus):
            raise ParamsError(
                "plain modulus must be smaller than every coefficient "
                "modulus")
        if self.security_level:
            total = sum(q.bit_length() for q in self.coeff_modulus)
            total += self.special_modulus.bit_length()
            limit = MAX_LOG_Q[self.security_level].get(n, 0)
            if total > limit:
                raise ParamsError(
                    f"log2(Q*P)={total} exceeds {self.security_level}-bit "
                    f"security budget {limit} for N={n}")

    @property
    def word_bits(self) -> int:
        """Engine word: 32 iff every modulus < 2^30."""
        mods = self.coeff_modulus + (self.special_modulus,)
        return 32 if max(q.bit_length() for q in mods) <= 30 else 64

    @property
    def q_product(self) -> int:
        out = 1
        for q in self.coeff_modulus:
            out *= q
        return out

    @property
    def supports_batching(self) -> bool:
        """A prime plain modulus t = 1 mod 2N (`bfv/encoder.py`)."""
        t, n = self.plain_modulus, self.poly_degree
        return t % (2 * n) == 1 and primes.is_prime(t)
