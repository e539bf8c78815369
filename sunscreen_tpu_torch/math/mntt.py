"""The NTT plan of mode "matmul": the port of
`sunscreen_tpu/math/mntt.py::MatmulNttPlan`.

The reference computes a four-step transform with exact u8-limb integer
matmuls, a layout chosen for the TPU's matrix unit; its NTT domain is
natural evaluation order: position j holds the evaluation at psi^(2j+1)
(`MatmulNttPlan.fwd`). The butterfly stages of `ntt.NttPlan` leave the
same evaluations in bit-reversed order, so this plan runs those stages
in plain PyTorch and gathers by the bit reversal after `fwd` and before
`inv` (an involution): the same NTT-domain arrays as the reference, by
another algorithm. Moduli are below 2^57, the reference's bound.
"""

from __future__ import annotations

import torch

from sunscreen_tpu_torch.math.ntt import NttPlan
from sunscreen_tpu_torch.math.pmntt import _bitrev

MAX_BITS = 57     # the reference's exact u8-limb matmul bound


class MatmulNttPlan:
    """Negacyclic NTT over [..., k, N] int64 stacks, natural-order NTT
    domain; the call surface of the reference's plan: `fwd`, `inv`,
    `pointwise_mul`, `negacyclic_mul`."""

    mode = "matmul"

    def __init__(self, n: int, moduli: tuple[int, ...], device):
        assert max(q.bit_length() for q in moduli) <= MAX_BITS, \
            "q too large for the matmul plan"
        self.stages = NttPlan(n, moduli, device)
        self.n, self.k, self.moduli = n, self.stages.k, self.stages.moduli
        self.q, self.device = self.stages.q, self.stages.device
        self.rev = torch.as_tensor(_bitrev(n), device=self.device)

    def fwd(self, x):
        """[..., k, N] natural coefficients -> natural-order NTT domain."""
        return self.stages.fwd(x)[..., self.rev]

    def inv(self, x):
        """Natural-order NTT domain -> [..., k, N] coefficients."""
        return self.stages.inv(x[..., self.rev])

    def pointwise_mul(self, a, b):
        return self.stages.pointwise_mul(a, b)

    def negacyclic_mul(self, a, b):
        return self.inv(self.pointwise_mul(self.fwd(a), self.fwd(b)))
