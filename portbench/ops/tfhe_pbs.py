"""Batches of univariate programmable bootstraps
(`tfhe.ops.programmable_bootstrap_univariate`): LWE ciphertexts of random
messages of `message_bits` bits, with `padding_bits` of padding above
them, through a blind rotation under the NTT-form bootstrap key, sample
extraction and the keyswitch back to the LWE key, evaluating the lookup
table `lut` (lut[m] for the message m).

The benchmark draws the binary LWE and GLWE secret keys, the bootstrap
key (a torus GGSW stack), the keyswitch key and the input ciphertexts
from the seed on the device (portbench/reference/tfhe.py); the program
takes the bootstrap key to its NTT form and builds its test polynomial.
The check judges every output of each kept batch twice: decrypted under
the LWE key against lut[m], and word for word against the reference's
exact bootstrap of the same input under the same keys, which a path on a
narrower torus (a 32-bit key, an approximate transform) fails.
"""

from __future__ import annotations

from portbench import generate
from portbench.reference import tfhe as ref


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from sunscreen_tpu_torch.tfhe import (GlweDef, LweDef,
                                              RadixDecomposition, ops)
        self.ops = ops
        self.lwe = LweDef(**config["lwe"])
        self.glwe = GlweDef(**config["glwe"])
        self.pbs_radix = RadixDecomposition(**config["pbs_radix"])
        self.ks_radix = RadixDecomposition(**config["ks_radix"])
        self.radixes = [(r["radix_log"], r["count"])
                        for r in (config["pbs_radix"], config["ks_radix"])]
        self.bits = traffic["message_bits"]
        self.plain_bits = self.bits + traffic["padding_bits"]
        self.lut = [int(v) for v in traffic["lut"]]
        if len(self.lut) != 1 << self.bits:
            raise ValueError("the lookup table needs one value a message")
        keys = generate.device_generator(seed, "tfhe.secret", device)
        self.lwe_sk = generate.integers(keys, 0, 1, (self.lwe.dim,))
        glwe_sk = generate.integers(
            keys, 0, 1, (self.glwe.size, self.glwe.poly_degree))
        gen = generate.device_generator(seed, "tfhe.keys", device)
        self.bsk = ref.bootstrap_key(self.lwe_sk, glwe_sk, self.glwe.std,
                                     *self.radixes[0], gen)
        self.ksk = ref.keyswitch_key(glwe_sk.reshape(-1), self.lwe_sk,
                                     self.lwe.std, *self.radixes[1], gen)
        self.bsk_ntt = ops.bootstrap_key_to_ntt(self.bsk, self.glwe,
                                                self.pbs_radix)
        self.sets, b = traffic["input_sets"], traffic["batch"]
        msgs = generate.device_generator(seed, "tfhe.messages", device)
        self.msgs = generate.integers(msgs, 0, (1 << self.bits) - 1,
                                      (self.sets, b))
        self.cts = ref.lwe_encrypt(ref.encode(self.msgs, self.plain_bits),
                                   self.lwe_sk, self.lwe.std, gen)
        lut = self.lut
        self.tp = ops.test_polynomial_for(
            lambda m: lut[m % len(lut)], self.plain_bits, self.glwe,
            output_bits=self.bits, device=device)
        self.work_per_batch = self.requests_per_batch = b
        self.steps_per_batch = self.lwe.dim

    def batch(self, i: int):
        return self.ops.programmable_bootstrap_univariate(
            self.cts[i % self.sets], self.tp, self.bsk_ntt, self.ksk,
            self.lwe, self.glwe, self.pbs_radix, self.ks_radix)

    def release(self) -> None:
        del self.bsk_ntt, self.tp

    def check(self, kept) -> tuple[dict, dict]:
        import torch
        lut = torch.tensor(self.lut, device=self.msgs.device)
        idx = [i % self.sets for i, _ in kept]
        got = torch.cat([out for _, out in kept])
        want = lut[self.msgs[idx].reshape(-1)]
        ph = ref.phase(got, self.lwe_sk)
        wrong = int((ref.decode(ph, self.bits) != want).sum())
        tp = ref.test_polynomial(self.lut, self.plain_bits, self.bits,
                                 self.glwe.poly_degree, got.device)
        exact = ref.bootstrap(self.cts[idx].reshape(got.shape[0], -1), tp,
                              self.bsk, self.ksk, *self.radixes)
        inexact = int((exact != got).any(-1).sum())
        return ({"wrong_outputs": (wrong, 0),
                 "inexact_outputs": (inexact, 0)},
                {"checked_outputs": got.shape[0],
                 "checked_batches": len(kept),
                 "phase_error_bits": ref.error_bits(
                     ph, ref.encode(want, self.bits))})
