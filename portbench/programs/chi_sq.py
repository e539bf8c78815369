"""chi_sq, upstream Sunscreen's headline FHE program (examples/chi_sq,
timed in sunscreen_docs/src/fhe/compiler/performance.md), written for the
port's compiler. No `from __future__ import annotations` here: the
compiler reads the signature's annotations as objects."""

ARGS = 3


def build():
    """The `@fhe_program` of chi_sq over three Cipher[Signed] counts."""
    from sunscreen_tpu_torch.compiler import fhe_program
    from sunscreen_tpu_torch.types import Cipher, Signed

    @fhe_program(scheme="bfv")
    def chi_sq(n0: Cipher[Signed], n1: Cipher[Signed], n2: Cipher[Signed]):
        a = 4 * n0 * n2 - n1 * n1
        alpha = a * a
        b1 = 2 * n0 + n1
        b1 = 2 * (b1 * b1)
        b2 = (2 * n0 + n1) * (2 * n2 + n1)
        b3 = 2 * n2 + n1
        b3 = 2 * (b3 * b3)
        return alpha, b1, b2, b3

    return chi_sq
