"""Batch (SIMD) encoder: N integers mod t <-> one plaintext polynomial
(port of `sunscreen_tpu/bfv/encoder.py`; SEAL's `BatchEncoder`).

It needs a prime plain modulus t = 1 mod 2N. The slots form a 2 x (N/2)
matrix: slot j of row 0 holds the plaintext's evaluation at
zeta^(3^j), of row 1 at zeta^(-3^j), zeta a primitive 2N-th root of
unity mod t, so row rotations are the Galois elements 3^steps and the
row swap 2N-1. The evaluations come from a small NTT plan over (t,)
in the mode the context was asked for, on its device, degraded for t as
the reference degrades it: kernels B1/B3 under "pallas" (also for a u64
context, whose own plans degrade to "matmul", since t < 2^30), B16
under "pallas_vpu", the plain plans below 17-bit t or under the u64
modes; the slot scatter and gather are torch indexing.
"""

from __future__ import annotations

import numpy as np
import torch

from sunscreen_tpu_torch.bfv.context import BfvContext
from sunscreen_tpu_torch.errors import ParamsError
from sunscreen_tpu_torch.math import ntt, primes


class BatchEncoder:
    def __init__(self, ctx: BfvContext):
        params = ctx.params
        t, n = params.plain_modulus, params.poly_degree
        if not params.supports_batching:
            raise ParamsError(
                "batching requires a prime plain modulus = 1 mod 2N")
        self.t, self.n, self.device = t, n, ctx.device
        self.plan = ntt.get_plan(n, (t,), ctx.device, ctx.requested_mode)
        # which evaluation point each NTT position holds: transform the
        # monomial x, whose evaluation at psi^e is psi^e
        mono = torch.zeros(1, n, dtype=torch.int64, device=self.device)
        mono[0, 1] = 1
        evals = self.plan.fwd(mono)[0].cpu().tolist()
        psi = primes.min_root_of_unity(2 * n, t)
        exp_of, cur = {}, 1
        for e in range(2 * n):
            exp_of[cur] = e
            cur = cur * psi % t
        pos_of_exp = {exp_of[v]: i for i, v in enumerate(evals)}
        pos = np.empty(n, dtype=np.int64)
        g = 1                                        # 3^j mod 2N
        for j in range(n // 2):
            pos[j] = pos_of_exp[g]
            pos[n // 2 + j] = pos_of_exp[2 * n - g]
            g = g * 3 % (2 * n)
        self.slot_pos = torch.as_tensor(pos, device=self.device)

    def encode(self, values):
        """[..., N] integers (reduced mod t) -> plaintext [..., N]."""
        v = torch.as_tensor(values, device=self.device).to(torch.int64)
        ntt_form = torch.zeros_like(v)
        ntt_form[..., self.slot_pos] = v % self.t
        return self.plan.inv(ntt_form.unsqueeze(-2))[..., 0, :]

    def decode(self, poly):
        """Plaintext [..., N] -> slot values [..., N] in [0, t)."""
        poly = torch.as_tensor(poly, device=self.device).to(torch.int64)
        return self.plan.fwd(poly.unsqueeze(-2))[..., 0, :][..., self.slot_pos]

    def encode_signed(self, values):
        """Signed integers in (-t/2, t/2] -> plaintext (SEAL's signed
        encode)."""
        return self.encode(values)

    def decode_signed(self, poly):
        v = self.decode(poly)
        return torch.where(v > self.t // 2, v - self.t, v)
