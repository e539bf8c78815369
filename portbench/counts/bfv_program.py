"""One batch of a compiled program: its input and output ciphertexts a
row and the relinearization key once, and the work of its operations as
counted in portbench/counts/<program>.json (its IR as the port's
compiler built it when the benchmark was written)."""

import json
import os

from portbench.counts import _bfv


def nodes(program: str) -> dict:
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{program}.json")
    with open(path) as f:
        return json.load(f)


def work(config: dict, traffic: dict) -> tuple[int, int]:
    b, t = traffic["batch"], traffic["plain_modulus"]
    ops = nodes(traffic["program"])
    ct = _bfv.ct_bytes(config)
    nbytes = (b * (ops["input_ciphertext"] + ops["output_ciphertext"]) * ct
              + (ops["relinearize"] > 0) * _bfv.key_bytes(config)
              + ops["literal"] * config["poly_degree"] * _bfv.WORD)
    muls = (b * (ops["multiply"] * _bfv.multiply_muls(config, t)
                 + ops["relinearize"] * _bfv.keyswitch_muls(config, t)
                 + ops["multiply_plain"] * _bfv.multiply_plain_muls(config, t))
            + ops["multiply_plain"] * _bfv.plain_transform_muls(config, t))
    return nbytes, muls
