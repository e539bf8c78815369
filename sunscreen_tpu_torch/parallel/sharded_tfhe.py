"""Sharded TFHE over a device mesh (port of
`sunscreen_tpu/parallel/sharded_tfhe.py`).

Two parallel axes:

1. **Batch** (`batch_sharded_pbs`): the PBS is independent per
   ciphertext. Each rank bootstraps its block of the LWE stack with the
   keys replicated, through the port's batched PBS (B1 + B5 a
   blind-rotation step on the card, B15 under
   `SUNSCREEN_TPU_TFHE_KSFULL=1`), and returns its block: no collective.
   This is the throughput layout.

2. **Polynomial coefficients** (`coeff_sharded_external_product`): the
   latency layout for one large external product. The GLWE coefficient
   axis is sharded, the transforms run through `DistributedNttPlan` on
   `get_torus_plan(n)`'s two 62-bit primes (one all_to_all each), and
   the rest (gadget decomposition, residue lift, pointwise products and
   the exact CRT -> torus reconstruction) is per coefficient, local to
   each rank. Bit-identical to `tfhe.ops.external_product`.

Blocks are in the four-step view of `dntt.four_step(N)`: a polynomial
[..., N] is [..., N1, N2] and a rank holds [..., N1, N2 / D].
"""

from __future__ import annotations

from functools import lru_cache

import torch

from sunscreen_tpu_torch.math import modular as m
from sunscreen_tpu_torch.parallel.dntt import DistributedNttPlan
from sunscreen_tpu_torch.parallel.mesh import axis_size
from sunscreen_tpu_torch.tfhe import ops as tops
from sunscreen_tpu_torch.tfhe import torus as ttorus
from sunscreen_tpu_torch.tfhe.params import GlweDef, LweDef, RadixDecomposition
from sunscreen_tpu_torch.tfhe.poly import get_torus_plan


def batch_sharded_pbs(mesh, lwe_cts, test_poly, bsk, ksk, lwe: LweDef,
                      glwe: GlweDef, pbs_radix: RadixDecomposition,
                      ks_radix: RadixDecomposition,
                      batch_axis: str = "batch"):
    """Univariate PBS of the rank's block [B / D, n + 1] of an LWE stack
    sharded on its leading axis over `batch_axis`; the keys are
    replicated (a raw GGSW stack or an `NttBootstrapKey`). Returns the
    rank's block of the output."""
    axis_size(mesh, batch_axis)               # the axis must exist
    return tops.programmable_bootstrap_univariate(
        lwe_cts, test_poly, bsk, ksk, lwe, glwe, pbs_radix, ks_radix)


@lru_cache(maxsize=8)
def _dtorus_plan(n: int, moduli: tuple[int, ...],
                 device: torch.device) -> DistributedNttPlan:
    return DistributedNttPlan(n, moduli, device)


def coeff_sharded_external_product(mesh, ggsw, glwe_ct, glwe: GlweDef,
                                   radix: RadixDecomposition,
                                   axis: str = "coeff"):
    """GGSW(m) ⊡ GLWE(c) with the coefficient axis sharded over `axis`.

    ggsw: the rank's block [k+1, l, k+1, N1, N2/D] of a torus GGSW;
    glwe_ct: its block [k+1, N1, N2/D] of one GLWE (no batch axes: this
    is the single-op latency layout). Returns the rank's block [k+1, N1,
    N2/D] of `tfhe.ops.external_product`, bit for bit. The digits of
    every row go through one forward transform, the GGSW rows through
    another and the k+1 output components through one inverse."""
    plan = get_torus_plan(glwe.poly_degree, device=glwe_ct.device)
    base = plan.base
    dplan = _dtorus_plan(glwe.poly_degree, base.moduli, plan.device)
    q3 = dplan.q
    hi3, lo3 = dplan.ratio_hi, dplan.ratio_lo

    def to_rns_local(t):
        """torus words [..., n1, n2/D] -> residues [..., kp, n1, n2/D]."""
        return m.barrett_reduce_64(t.unsqueeze(-3), q3, hi3, lo3)

    def signed_rns_local(d):
        """signed digits [..., n1, n2/D] -> [..., kp, n1, n2/D]."""
        d = d.unsqueeze(-3)
        pos = torch.where(d >= 0, d, 0)
        neg = torch.where(d < 0, -d, 0)
        return m.sub_mod(pos, neg, q3)

    kk1, count = glwe.size + 1, radix.count
    digits = ttorus.signed_decompose(glwe_ct, radix.radix_log, count)
    digits = digits.transpose(0, 1)                 # [k+1, l, n1, n2/D]
    d_hat = dplan.fwd_local(signed_rns_local(digits), mesh, axis)
    rows_hat = dplan.fwd_local(to_rns_local(ggsw), mesh, axis)
    # acc[c] = sum over (i, j) of d_hat[i, j] rows_hat[i, j, c]
    terms = d_hat.reshape(kk1 * count, 1, *d_hat.shape[-3:])
    rows = rows_hat.reshape(kk1 * count, kk1, *rows_hat.shape[-3:])
    acc = dplan.mul_sum(terms, rows, 0)             # [k+1, kp, N2, N1/D]
    prod = dplan.inv_local(acc, mesh, axis)         # [k+1, kp, n1, n2/D]
    # exact CRT -> torus per coefficient, on the limb-axis-at--2 view
    return plan.to_torus(prod.movedim(-3, -2))
