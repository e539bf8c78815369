"""Batches of ct x ct `bfv.ops.multiply_relin` on fresh encryptions of
random plaintexts, under the configuration's relinearization key.

A plaintext of uniform coefficients mod t is a uniform slot vector under
the batching encoding, which is a bijection, so this is the traffic of
random slot vectors. The check decrypts each kept product under the
secret key and compares every coefficient with the plaintext product in
Z_t[x]/(x^N + 1).
"""

from __future__ import annotations

from portbench import generate
from portbench.ops import _bfv
from portbench.reference import bfv as ref


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from sunscreen_tpu_torch.bfv import get_context, ops
        self.ops = ops
        self.config, self.t = config, traffic["plain_modulus"]
        self.ctx = get_context(_bfv.params(config, traffic), device)
        self.keys = _bfv.Keys(self.ctx, seed)
        self.sets, b = traffic["input_sets"], traffic["batch"]
        gen = generate.device_generator(seed, "bfv.plaintexts", device)
        self.pa, self.pb = (
            generate.integers(gen, 0, self.t - 1, (self.sets, b, self.ctx.n))
            for _ in range(2))
        self.ca = self.keys.encrypt(self.pa)
        self.cb = self.keys.encrypt(self.pb)
        self.work_per_batch = self.requests_per_batch = b

    def batch(self, i: int):
        j = i % self.sets
        return self.ops.multiply_relin(self.ctx, self.ca[j], self.cb[j],
                                       self.keys.rlk)

    def release(self) -> None:
        del self.ca, self.cb, self.ctx
        self.keys.pk = self.keys.rlk = self.keys.sk = None

    def check(self, kept) -> tuple[dict, dict]:
        dec = self.keys.decryptor(self.config, self.t)
        wrong = checked = 0
        for i, out in kept:
            j = i % self.sets
            want = ref.negacyclic_mod_t(self.pa[j], self.pb[j], self.t)
            got = dec.decrypt(out)
            wrong += ref.wrong_coefficients(got, want)
            checked += got.numel()
        return ({"wrong_coefficients": (wrong, 0)},
                {"checked_coefficients": checked,
                 "checked_batches": len(kept)})
