"""One batch of multiply_relin: two input ciphertexts and one output a
row, the relinearization key once."""

from portbench.counts import _bfv


def work(config: dict, traffic: dict) -> tuple[int, int]:
    b, t = traffic["batch"], traffic["plain_modulus"]
    nbytes = 3 * b * _bfv.ct_bytes(config) + _bfv.key_bytes(config)
    muls = b * (_bfv.multiply_muls(config, t) + _bfv.keyswitch_muls(config, t))
    return nbytes, muls
