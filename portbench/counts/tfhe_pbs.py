"""One batch of univariate PBS, as the port runs it: per LWE mask word a
blind-rotation step on (k + 1) l gadget digits under a CRT of four u32
primes (the forward transforms of the digits, their contraction against
the bootstrap key's two components and the inverse transforms, in the
BFV counts' convention), then the LWE keyswitch as 64-bit word products,
4 multiplies each. Bytes: the input and output LWE ciphertexts, the
bootstrap key as torus words (a GGSW a mask word), the keyswitch key and
the test polynomial, once each."""

from portbench.counts._bfv import WORD, ntt_muls

TORUS_PRIMES = 4


def work(config: dict, traffic: dict) -> tuple[int, int]:
    b = traffic["batch"]
    dim = config["lwe"]["dim"]
    size, n = config["glwe"]["size"], config["glwe"]["poly_degree"]
    levels = config["pbs_radix"]["count"]
    ks_levels = config["ks_radix"]["count"]
    comps, digits = size + 1, (size + 1) * levels
    ntt = ntt_muls(n)
    step = TORUS_PRIMES * (digits * ntt + comps * 2 * digits * n
                           + comps * (ntt + 3 * n))
    keyswitch = size * n * ks_levels * (dim + 1) * 4
    nbytes = WORD * (2 * b * (dim + 1) + dim * comps * levels * comps * n
                     + size * n * ks_levels * (dim + 1) + n)
    return nbytes, b * (dim * step + keyswitch)
