"""One batch of rotate-and-sum: one input and one output ciphertext a
row, each Galois key once, one keyswitch a rotation (the permutations and
additions multiply nothing)."""

from portbench.counts import _bfv


def work(config: dict, traffic: dict) -> tuple[int, int]:
    b, t = traffic["batch"], traffic["plain_modulus"]
    rotations = len(traffic["row_steps"]) + bool(traffic["swap_rows"])
    nbytes = 2 * b * _bfv.ct_bytes(config) + rotations * _bfv.key_bytes(config)
    muls = b * rotations * _bfv.keyswitch_muls(config, t)
    return nbytes, muls
