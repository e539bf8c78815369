"""The benchmark's BFV modulus chains through the port's `multiply_relin`.

`portbench/configs/bfv_n16384_128.json` is `BfvParams.default_u32(16384)`'s
438-bit chain (twelve 29-bit and two 30-bit primes, a 30-bit special
prime) and `bfv_n8192_128.json` is `default_u32(8192)`'s (seven 26-27-bit
primes). Every prime of either is 1 mod 2N at its own N, so also at
N = 1024: the product runs here on the chain's own moduli and plain
modulus, with only N cut, and is judged by the benchmark's plain
reference (`portbench/reference/bfv.py`), which shares no code with the
port.
"""

import json
import os

import pytest
import torch

from portbench.reference import bfv as ref
from sunscreen_tpu_torch.bfv import BfvParams, get_context, keys, ops
from sunscreen_tpu_torch.bfv.params import MAX_LOG_Q

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1024
BATCH = 4


def _load(kind: str, name: str) -> dict:
    with open(os.path.join(ROOT, "portbench", kind, name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("config,traffic", [
    ("bfv_n16384_128", "bfv.mul_relin.t786433.b64"),
    ("bfv_n8192_128", "bfv.mul_relin.b64"),
], ids=["n16384_chain", "n8192_chain"])
def test_multiply_relin_on_the_chain_matches_the_plain_reference(config,
                                                                 traffic):
    c, t = _load("configs", config), _load("traffic", traffic)
    pt_mod = t["plain_modulus"]
    params = BfvParams(N, pt_mod, tuple(c["coeff_modulus"]),
                       c["special_modulus"], security_level=0)
    ctx = get_context(params, "cpu")
    gen = torch.Generator().manual_seed(20_240_016)
    sk = keys.gen_secret_key(ctx, gen)
    pk = keys.gen_public_key(ctx, sk, gen)
    rlk = keys.gen_relin_key(ctx, sk, gen)
    a, b = (torch.randint(0, pt_mod, (BATCH, N), generator=gen)
            for _ in range(2))
    out = ops.multiply_relin(ctx, ops.encrypt(ctx, pk, a, gen),
                             ops.encrypt(ctx, pk, b, gen), rlk)
    assert out.shape == (BATCH, 2, len(c["coeff_modulus"]), N)
    got = ref.Decryptor(sk.s, c["coeff_modulus"], pt_mod).decrypt(out)
    assert ref.wrong_coefficients(got, ref.negacyclic_mod_t(a, b, pt_mod)) \
        == 0


def test_the_n16384_configuration_is_the_default_u32_chain():
    c = _load("configs", "bfv_n16384_128")
    t = _load("traffic", "bfv.mul_relin.t786433.b64")["plain_modulus"]
    want = BfvParams.default_u32(16384)
    assert c["poly_degree"] == 16384 and c["security_level"] == 128
    assert c["coeff_modulus"] == list(want.coeff_modulus)
    assert c["special_modulus"] == want.special_modulus
    assert [q.bit_length() for q in c["coeff_modulus"]] == [29] * 12 + [30] * 2
    assert t == want.plain_modulus and t % (2 * 16384) == 1
    log_qp = (sum(q.bit_length() for q in c["coeff_modulus"])
              + c["special_modulus"].bit_length())
    assert log_qp == c["max_log_qp"] == 438 <= MAX_LOG_Q[128][16384]
