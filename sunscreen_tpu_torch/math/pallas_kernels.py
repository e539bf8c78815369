"""Pointwise (a b) mod q on u64 values carried as (hi, lo) 32-bit
halves: the port of `sunscreen_tpu/math/pallas_kernels.py` (kernel B19).

`make_pointwise_mul_mod(q, device)` returns fn(a_hi, a_lo, b_hi, b_lo)
-> (hi, lo), the Barrett product with the ratio of
`modular.barrett_ratio(q)`, the same algorithm as
`modular.barrett_reduce_128`. Halves are int64 tensors holding values
below 2^32 (`split_u64`, `join_u64`). On a CUDA tensor fn launches
`pointwise_mul_mod` in `csrc/u64mod.cu` and counts it in
`_build.LAUNCHES["pointwise_mul_mod"]`; on a CPU tensor it runs the twin
`mul_mod_kernel`, the kernel's oracle on the card.
"""

from __future__ import annotations

import torch

from sunscreen_tpu_torch import _build, resolve_device
from sunscreen_tpu_torch.math import modular as m
from sunscreen_tpu_torch.math.modular import M32, s64, srl


def split_u64(x):
    """u64 words [..., N] -> (hi, lo) halves."""
    return srl(x, 32), x & M32


def join_u64(hi, lo):
    return (hi << 32) | lo


def mul_mod_kernel(a_hi, a_lo, b_hi, b_lo, q: int):
    """The plain twin of the reference's `mul_mod_kernel`: the 128-bit
    product of the joined halves, Barrett-reduced, split again."""
    r_hi, r_lo = m.barrett_ratio(q)
    hi, lo = m.mul_wide(join_u64(a_hi, a_lo), join_u64(b_hi, b_lo))
    return split_u64(m.barrett_reduce_128(hi, lo, q, s64(r_hi), s64(r_lo)))


def make_pointwise_mul_mod(q: int, device=None):
    """fn(a_hi, a_lo, b_hi, b_lo) -> (hi, lo) = (a b) mod q for a, b < q
    < 2^62 given as halves of one shape on `device` (None means CUDA)."""
    dev = resolve_device(device)
    r_hi, r_lo = m.barrett_ratio(q)

    def run(a_hi, a_lo, b_hi, b_lo):
        halves = (a_hi, a_lo, b_hi, b_lo)
        for v in halves:
            if v.device.type != dev.type or v.dtype != torch.int64 \
                    or v.shape != a_hi.shape:
                raise ValueError(f"expected int64 halves of shape "
                                 f"{tuple(a_hi.shape)} on {dev}, got "
                                 f"{v.dtype} {tuple(v.shape)} on {v.device}")
        if dev.type == "cpu":
            return mul_mod_kernel(*halves, q)
        halves = [v.contiguous() for v in halves]
        o_hi, o_lo = torch.empty_like(halves[0]), torch.empty_like(halves[0])
        if o_hi.numel():
            _build.launch("u64mod", "pointwise_mul_mod", *halves, o_hi, o_lo,
                          o_hi.numel(), q, r_hi, r_lo)
            _build.LAUNCHES["pointwise_mul_mod"] += 1
        return o_hi, o_lo

    return run
