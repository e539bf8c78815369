"""A compiled FHE program run through `FheRuntime.run` on batches of
requests: the traffic's `program` (a file of portbench/programs/) compiled
by the port's `Compiler` under `PlainModulusConstraint.Raw(plain_modulus)`
(with "compile": "search" its parameter search, measured model and all,
which must find the configuration's modulus chain; with "fixed" the
configuration's chain as given), each request's Signed arguments drawn
from the traffic's `count_range`, a batch's ciphertexts stacked on a
leading axis. One client waits for each batch's outputs.

The check decrypts every output of each kept batch under the secret key,
decodes it as a Signed value and compares it with the program's plain
integer reference (portbench/reference/<program>.py).
"""

from __future__ import annotations

import importlib

import numpy as np

from portbench import generate
from portbench.ops import _bfv


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import torch
        from sunscreen_tpu_torch.compiler import Compiler, \
            PlainModulusConstraint
        from sunscreen_tpu_torch.runtime import Runtime
        from sunscreen_tpu_torch.runtime.runtime import Ciphertext, \
            PublicKeySet
        from sunscreen_tpu_torch.types import Signed

        name = traffic["program"]
        program = importlib.import_module(f"portbench.programs.{name}")
        self.ref = importlib.import_module(f"portbench.reference.{name}")
        self.config, self.t = config, traffic["plain_modulus"]
        fn = program.build()
        compiler = Compiler(device).fhe_program(fn)
        if traffic["compile"] == "search":
            compiler = compiler.plain_modulus_constraint(
                PlainModulusConstraint.Raw(self.t))
        else:
            compiler = compiler.with_params(_bfv.params(config, traffic))
        self.prog = compiler.compile().get_program(fn)
        _bfv.same_chain(self.prog.params, config)
        self.rt = Runtime.new_fhe(self.prog.params, device)
        self.keys = _bfv.Keys(self.rt.ctx, seed)
        self.pks = PublicKeySet(self.keys.pk, self.keys.rlk, None,
                                self.rt.ctx.requested_mode)
        self.sets, b = traffic["input_sets"], traffic["batch"]
        lo, hi = traffic["count_range"]
        gen = generate.device_generator(seed, "program.arguments", device)
        self.args = generate.integers(gen, lo, hi,
                                      (self.sets, b, program.ARGS)).cpu()
        polys = np.stack([Signed.encode(int(v), self.prog.params)
                          for v in self.args.reshape(-1).tolist()])
        polys = torch.as_tensor(polys.astype(np.int64), device=device)
        cts = self.keys.encrypt(polys.reshape(self.sets, b, program.ARGS, -1))
        tname = Signed._type_name()
        self.inputs = [[Ciphertext(tname, [cts[j, :, a]], self.prog.params)
                        for a in range(program.ARGS)]
                       for j in range(self.sets)]
        self.work_per_batch = self.requests_per_batch = b

    def batch(self, i: int):
        outs = self.rt.run(self.prog, self.inputs[i % self.sets], self.pks)
        return [o.cts[0] for o in outs]

    def release(self) -> None:
        del self.inputs, self.rt, self.prog
        self.keys.pk = self.keys.rlk = self.keys.sk = self.pks = None

    def check(self, kept) -> tuple[dict, dict]:
        dec = self.keys.decryptor(self.config, self.t)
        wrong = checked = 0
        for i, outs in kept:
            args = self.args[i % self.sets].tolist()
            want = [self.ref.expected(*a) for a in args]
            for k, out in enumerate(outs):
                got = dec.decrypt(out).cpu().numpy()
                for r, poly in enumerate(got):
                    checked += 1
                    if self.ref.decode_signed(poly, self.t) != want[r][k]:
                        wrong += 1
        return ({"wrong_outputs": (wrong, 0)},
                {"checked_outputs": checked, "checked_batches": len(kept)})
