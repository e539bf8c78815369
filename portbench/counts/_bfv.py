"""BFV work of the port's u32 engine at its default fusion settings, per
ciphertext (a batch row), as formulas of the shapes. Multiplies count 3
per Shoup butterfly and per 1/N scaling, 2 per 32x32 -> 64-bit product:
in the RNS steps 2 to normalize a digit, 8 for a digit times a 128-bit
fraction, 2 per term of a limb contraction or correction. Bytes count
each input read once and each output written once, 8-byte words."""

from __future__ import annotations

import math

WORD = 8
AUX_PRIME_BITS = 30


def ntt_muls(n: int) -> int:
    """One length-N transform: N/2 log N Shoup butterflies."""
    return 3 * (n // 2) * (n.bit_length() - 1)


def shape(config: dict, t: int) -> tuple[int, int, int, int]:
    """(N, k limbs of Q, a limbs of the auxiliary base, k + 1 key limbs);
    the auxiliary base holds round(t x / Q) of a tensor coefficient: its
    product over 2 exceeds t N Q / 4."""
    n, qs = config["poly_degree"], config["coeff_modulus"]
    k = len(qs)
    bound_bits = (t.bit_length() + n.bit_length()
                  + math.prod(qs).bit_length() + 2)
    return n, k, max(k + 1, math.ceil(bound_bits / AUX_PRIME_BITS)), k + 1


def ct_bytes(config: dict) -> int:
    """One 2-component ciphertext."""
    return 2 * len(config["coeff_modulus"]) * config["poly_degree"] * WORD


def key_bytes(config: dict) -> int:
    """One key-switching key: k digits x (k + 1) limbs, two components."""
    k = len(config["coeff_modulus"])
    return 2 * k * (k + 1) * config["poly_degree"] * WORD


def multiply_muls(config: dict, t: int) -> int:
    """ct x ct tensor product with the t / Q scale: the centered base
    extension of 4 components from Q to Q + B, 4 forward transforms and
    the products over Q + B, 3 inverse transforms, the scale and
    conversion of 3 components back to Q."""
    n, k, a, _ = shape(config, t)
    km = k + a
    ntt = ntt_muls(n)
    convert = 4 * n * (10 * k + 2 * k * a + 2 * a)
    fwd_tensor = km * (4 * ntt + 8 * n)
    inverse = 3 * km * (ntt + 3 * n)
    scale = 3 * n * (10 * km + 2 * km * a + 10 * a + 2 * a * k + 2 * k)
    return convert + fwd_tensor + inverse + scale


def keyswitch_muls(config: dict, t: int) -> int:
    """One polynomial switched (relinearization, or a rotation's c1): its
    k digits transformed under every key limb, contracted against both
    key components, 2 inverse transforms a key limb, the mod-down."""
    n, k, _, kk = shape(config, t)
    ntt = ntt_muls(n)
    return (k * kk * ntt + kk * (4 * k * n + 2 * (ntt + 3 * n))
            + 2 * n * 2 * k)


def multiply_plain_muls(config: dict, t: int) -> int:
    """ct x pt in the NTT domain, per ciphertext: 2 k forward transforms,
    2 k N products, 2 k inverse transforms (the plaintext's own k
    transforms are counted once a batch, in `plain_transform_muls`)."""
    n, k, _, _ = shape(config, t)
    ntt = ntt_muls(n)
    return 2 * k * ntt + 4 * k * n + 2 * k * (ntt + 3 * n)


def plain_transform_muls(config: dict, t: int) -> int:
    n, k, _, _ = shape(config, t)
    return k * ntt_muls(n)
