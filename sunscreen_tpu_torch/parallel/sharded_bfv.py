"""Coefficient-sharded BFV evaluation over a device mesh (port of
`sunscreen_tpu/parallel/sharded_bfv.py`).

The distributed four-step NTT (`dntt.py`) carries the HPS multiply and
the hybrid keyswitch with the polynomial coefficient axis sharded over a
mesh axis. Everything but the NTT is per coefficient (base conversion,
scale-and-round and mod-down contract over the limb axis only), so each
rank runs the context's RNS ops on its own columns: on a CUDA context
the kernels B6 (`conv_q_to_aux.extend`, `conv_aux_to_q.convert`), B9
(`scale_mul_to_aux.apply`) and B8 (`mod_down.apply`) on N / D columns.
Only the transforms communicate.

Layout: sharded ciphertexts are [n_comp, k, N1, N2] with the last axis
sharded over the `coeff` axis (the four-step matrix view; flat
coefficient index r N2 + c). Each function takes and returns the rank's
blocks [..., N1, N2 / D]; `mesh.local_shard` cuts them from a replicated
array and `mesh.all_gather` joins them. Residues are int64 on both
engines, so the reference's casts at the dntt boundary vanish.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from sunscreen_tpu_torch.bfv.context import BfvContext
from sunscreen_tpu_torch.bfv.keys import KswKey
from sunscreen_tpu_torch.math import modular as m
from sunscreen_tpu_torch.parallel.dntt import DistributedNttPlan, four_step
from sunscreen_tpu_torch.parallel.mesh import local_shard


@lru_cache(maxsize=8)
def _dplan(n: int, moduli: tuple[int, ...],
           device: torch.device) -> DistributedNttPlan:
    return DistributedNttPlan(n, moduli, device)


def to_sharded_layout(ct, ctx: BfvContext):
    """[..., k, N] coefficient-domain ciphertext -> [..., k, N1, N2]
    four-step matrix view."""
    return ct.reshape(*ct.shape[:-1], *four_step(ctx.n))


def from_sharded_layout(ct4, ctx: BfvContext):
    return ct4.reshape(*ct4.shape[:-2], ctx.n)


def _flat(x):
    """[..., k, N1, N2l] -> [..., k, N1 N2l] for the per-coefficient ops."""
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def _mat(x, n1: int):
    return x.reshape(*x.shape[:-1], n1, x.shape[-1] // n1)


def sharded_multiply_relin(ctx: BfvContext, mesh, a4, b4, rlk: KswKey,
                           axis: str = "coeff"):
    """ct x ct multiply and relinearize with the coefficient axis sharded
    over `axis`. a4, b4: the rank's blocks [2, k, N1, N2/D]; rlk: from
    `sharded_relin_key`. Returns the rank's block of the 2-component
    product, bit-identical to `bfv.ops.multiply_relin`.

    The same math as `bops.multiply` and `bops.relinearize` (HPS and the
    hybrid keyswitch), every negacyclic product through the distributed
    NTT: both operands in one forward transform, the 3-component tensor
    in one inverse, every keyswitch digit in one forward and both key
    products in one inverse (four all_to_alls; the reference runs one
    a transform, 16 at 7 limbs)."""
    dp_mul = _dplan(ctx.n, ctx.mul_base.moduli, ctx.device)
    dp_key = _dplan(ctx.n, ctx.key_mods, ctx.device)
    n1, k = dp_mul.n1, ctx.k
    ext = ctx.conv_q_to_aux.extend(_flat(torch.cat([a4, b4])),
                                   centered=True)          # Q -> Q ∪ B (B6)
    hat = dp_mul.fwd_local(_mat(ext, n1), mesh, axis)
    (a0, a1), (b0, b1) = hat[:2], hat[2:]
    mul = dp_mul.pointwise_local
    tensor = torch.stack([mul(a0, b0),
                          m.add_mod(mul(a0, b1), mul(a1, b0), dp_mul.q),
                          mul(a1, b1)])
    tensor = _flat(dp_mul.inv_local(tensor, mesh, axis))
    scaled = ctx.scale_mul_to_aux.apply(tensor)                   # B9
    prod = ctx.conv_aux_to_q.convert(scaled, centered=True)       # B6

    # hybrid keyswitch of component 2: each digit (a Q residue) reduced
    # mod every key modulus; key rows arrive in the distributed domain
    digits = prod[2].unsqueeze(-2) % ctx.key_base.q     # [k, k + 1, cols]
    d_hat = dp_key.fwd_local(_mat(digits, n1), mesh, axis)
    acc = torch.stack([dp_key.mul_sum(d_hat, rlk.k0, 0),
                       dp_key.mul_sum(d_hat, rlk.k1, 0)])
    u = _flat(dp_key.inv_local(acc, mesh, axis))
    u = ctx.mod_down.apply(u[:, :k, :], u[:, k, :])              # B8
    return _mat(m.add_mod(prod[:2], u, ctx.q_base.q), n1)


def sharded_relin_key(ctx: BfvContext, rlk: KswKey, mesh,
                      axis: str = "coeff") -> KswKey:
    """A relin key (the port's KswKey, NTT domain of the context's own
    plan) -> its evaluation form for `sharded_multiply_relin`: back to
    the coefficient domain (B3 on a CUDA context), the four-step view,
    this rank's columns, then the distributed NTT domain, both components
    in one transform. (NTT-domain arrays are plan-specific; the
    distributed domain is another.)"""
    dp = _dplan(ctx.n, ctx.key_mods, ctx.device)
    coeff = ctx.plan_key.inv(torch.stack([rlk.k0, rlk.k1]))
    mat = coeff.reshape(*coeff.shape[:-1], dp.n1, dp.n2)
    hat = dp.fwd_local(local_shard(mat, mesh, axis, -1), mesh, axis)
    return KswKey(hat[0], hat[1])
