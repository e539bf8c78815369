"""Rotate-and-sum on batches of fresh encryptions: for each step of the
traffic's `row_steps`, acc = acc + rotate_rows(acc, step), then, with
`swap_rows`, acc = acc + rotate_columns(acc), under Galois keys for those
elements only. Each rotation is one op of the cell's rate.

With the steps 1, 2, ..., N/4 and the swap every slot ends as the sum of
all slots. The check applies the same automorphisms and additions to the
plaintext polynomial (p(x) -> p(x^g), SEAL's elements 3^step and 2N - 1)
and compares every coefficient of each kept output's decryption.
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
        n = self.ctx.n
        self.steps = [int(s) for s in traffic["row_steps"]]
        self.swap = bool(traffic["swap_rows"])
        elements = [self.ctx.rotate_rows_element(s) for s in self.steps]
        if self.swap:
            elements.append(self.ctx.rotate_columns_element)
        self.keys = _bfv.Keys(self.ctx, seed, galois=elements, relin=False)
        self.sets, b = traffic["input_sets"], traffic["batch"]
        gen = generate.device_generator(seed, "bfv.plaintexts", device)
        self.p = generate.integers(gen, 0, self.t - 1, (self.sets, b, n))
        self.c = self.keys.encrypt(self.p)
        self.requests_per_batch = b
        self.work_per_batch = b * (len(self.steps) + self.swap)

    def batch(self, i: int):
        ops, ctx, gks = self.ops, self.ctx, self.keys.gks
        acc = self.c[i % self.sets]
        for s in self.steps:
            acc = ops.add(ctx, acc, ops.rotate_rows(ctx, acc, s, gks))
        if self.swap:
            acc = ops.add(ctx, acc, ops.rotate_columns(ctx, acc, gks))
        return acc

    def release(self) -> None:
        del self.c, self.ctx
        self.keys.pk = self.keys.gks = self.keys.sk = None

    def expected(self, p):
        """The plaintext of the rotate-and-sum of p [..., N]."""
        n, t = p.shape[-1], self.t
        for s in self.steps:
            g = ref.row_rotation_element(s, n)
            p = (p + ref.automorphism(p, g, t)) % t
        if self.swap:
            p = (p + ref.automorphism(p, ref.column_swap_element(n), t)) % t
        return p

    def check(self, kept) -> tuple[dict, dict]:
        dec = self.keys.decryptor(self.config, self.t)
        wrong = checked = 0
        for i, out in kept:
            got = dec.decrypt(out)
            wrong += ref.wrong_coefficients(
                got, self.expected(self.p[i % self.sets]))
            checked += got.numel()
        return ({"wrong_coefficients": (wrong, 0)},
                {"checked_coefficients": checked,
                 "checked_batches": len(kept)})
