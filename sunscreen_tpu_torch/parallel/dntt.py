"""Distributed negacyclic NTT over a device mesh, the four-step algorithm
(port of `sunscreen_tpu/parallel/dntt.py`).

The coefficient axis is sharded over a mesh axis and each transform is

    twist(psi^i) -> local DFT_N1 -> twiddle(w^{r'c}) -> all_to_all
    transpose -> local DFT_N2

so the exchange between butterfly stages is one `all_to_all` per
transform. With the row-major view M[r][c] = x[r N2 + c] and
w1 = w^N2, the pipeline computes X[r' + N1 c'] = sum x[n] w^{n (r' + N1
c')}, a cyclic DFT with column-major output; the inverse mirrors each
step, so callers never see the permuted order, and pointwise products in
the distributed domain agree between operands.

The local DFTs are modular matrix-vector products in plain PyTorch, as
the reference's are plain JAX: on moduli below 2^31 (the u32 engine's
bases) each product fits int64 and is reduced with `%` before an exact
int64 sum; on larger moduli (the 62-bit torus primes) each product is a
128-bit Barrett product (`modular.mul_mod`) and the sum a tree of
modular additions. Either way the sum is exact mod q whatever its order,
so the terms are taken in one batched product instead of the
reference's loop over A.
"""

from __future__ import annotations

import numpy as np
import torch

from sunscreen_tpu_torch import resolve_device
from sunscreen_tpu_torch.math import modular as m
from sunscreen_tpu_torch.math import primes
from sunscreen_tpu_torch.parallel.mesh import (all_to_all_tiled, axis_index,
                                               axis_size)

SMALL_MODULUS = 1 << 31      # below it a product of residues fits int64


def four_step(n: int) -> tuple[int, int]:
    """(N1, N2) of the four-step matrix view of N coefficients."""
    assert n & (n - 1) == 0
    n2 = 1 << ((n.bit_length()) // 2)
    return n // n2, n2


def _powers(base: int, q: int, count: int) -> np.ndarray:
    out = [1] * count
    for i in range(1, count):
        out[i] = out[i - 1] * base % q
    return np.array(out, dtype=np.uint64)


class DistributedNttPlan:
    """Negacyclic NTT of size n = N1 N2 over RNS moduli, the coefficient
    axis sharded N2 / D a rank. Tables live on `device` (None means
    CUDA) as int64 [k, ...], the same values as the reference's uint64
    tables."""

    def __init__(self, n: int, moduli: tuple[int, ...], device=None):
        self.n = n
        self.moduli = tuple(int(q) for q in moduli)
        self.device = resolve_device(device)
        self.n1, self.n2 = four_step(n)
        n1, n2 = self.n1, self.n2
        k = len(self.moduli)
        r1, c2 = np.arange(n1), np.arange(n2)
        rr, cc = np.outer(r1, r1), np.outer(c2, c2)
        rc = np.outer(r1, c2)
        flat = r1[:, None] * n2 + c2[None, :]                # r N2 + c
        tabs = {name: np.empty((k,) + shape, dtype=np.uint64)
                for name, shape in (
                    ("w1", (n1, n1)), ("w1_inv", (n1, n1)),
                    ("w2", (n2, n2)), ("w2_inv", (n2, n2)),
                    ("tw", (n1, n2)), ("tw_inv", (n1, n2)),
                    ("twist_t", (n1, n2)), ("untwist_t", (n1, n2)))}
        n_inv = np.empty(k, dtype=np.uint64)
        for i, q in enumerate(self.moduli):
            psi = primes.min_root_of_unity(2 * n, q)
            pp = _powers(psi, q, 2 * n)          # psi^e, e < 2N
            wp = pp[0::2]                        # w^e = psi^(2e), e < N
            tabs["w1"][i] = wp[(rr * n2) % n]                 # w1b^(r r')
            tabs["w1_inv"][i] = wp[((-rr) % n1) * n2]
            tabs["w2"][i] = wp[(cc * n1) % n]                 # w2b^(c c')
            tabs["w2_inv"][i] = wp[((-cc) % n2) * n1]
            tabs["tw"][i] = wp[rc % n]                        # w^(r' c)
            tabs["tw_inv"][i] = wp[(-rc) % n]
            tabs["twist_t"][i] = pp[flat]                     # psi^(r N2 + c)
            tabs["untwist_t"][i] = pp[(-flat) % (2 * n)]
            n_inv[i] = pow(n, -1, q)

        def dev(a):
            return torch.from_numpy(a.view(np.int64)).to(self.device)

        for name, tab in tabs.items():
            setattr(self, name, dev(tab))
        self.n_inv = dev(n_inv)
        self.small = max(self.moduli) < SMALL_MODULUS
        col = (k, 1, 1)
        self.q = dev(np.array(self.moduli, dtype=np.uint64)).reshape(col)
        ratios = [m.barrett_ratio(q) for q in self.moduli]
        self.ratio_hi = dev(np.array([r[0] for r in ratios],
                                     dtype=np.uint64)).reshape(col)
        self.ratio_lo = dev(np.array([r[1] for r in ratios],
                                     dtype=np.uint64)).reshape(col)

    # -- local helpers (act on the rank's blocks [..., k, A, B]) -------------

    def _mulmod(self, a, b, q=None, r_hi=None, r_lo=None):
        q = self.q if q is None else q
        if self.small:
            return a * b % q
        return m.mul_mod(a, b, q, self.ratio_hi if r_hi is None else r_hi,
                         self.ratio_lo if r_lo is None else r_lo)

    def mul_sum(self, a, b, dim: int):
        """sum over `dim` of a b mod q, for operands [..., k, A, B] whose
        limb axis is not `dim`."""
        prod = self._mulmod(a, b)
        if self.small:
            return prod.sum(dim) % self.q
        return m.sum_mod(prod, dim, self.q)

    def _dft(self, x, mat):
        """DFT along axis -2 as a modular mat-vec: x [..., k, A, B], mat
        [k, A, A] -> out[..., k, a', B] = sum_a mat[a', a] x[a, B]."""
        q4 = self.q.unsqueeze(-1)
        prod = self._mulmod(mat.unsqueeze(-1), x.unsqueeze(-3), q4,
                            self.ratio_hi.unsqueeze(-1),
                            self.ratio_lo.unsqueeze(-1))
        if self.small:
            return prod.sum(-2) % self.q
        return m.sum_mod(prod, -2, self.q)

    def _cols(self, mesh, axis: str):
        cols = self.n2 // axis_size(mesh, axis)
        start = axis_index(mesh, axis) * cols
        return lambda t: t[..., start:start + cols]

    # -- sharded transforms ---------------------------------------------------

    def fwd_local(self, x, mesh, axis: str):
        """The rank's body: x [..., k, N1, N2/D] (coefficient blocks) ->
        the distributed NTT domain [..., k, N2, N1/D]."""
        sl = self._cols(mesh, axis)
        x = self._mulmod(x, sl(self.twist_t))
        x = self._dft(x, self.w1)
        x = self._mulmod(x, sl(self.tw))
        # transpose [N1, N2] -> [N2, N1]: the all_to_all splits N1 and
        # gathers N2
        x = all_to_all_tiled(x, mesh, axis, split_axis=-2, concat_axis=-1)
        return self._dft(x.transpose(-1, -2), self.w2)

    def inv_local(self, x, mesh, axis: str):
        """[..., k, N2, N1/D] distributed NTT domain -> the rank's
        coefficient blocks [..., k, N1, N2/D]."""
        x = self._dft(x, self.w2_inv).transpose(-1, -2)   # [k, N1/D, N2]
        x = all_to_all_tiled(x, mesh, axis, split_axis=-1, concat_axis=-2)
        sl = self._cols(mesh, axis)
        x = self._mulmod(x, sl(self.tw_inv))
        x = self._dft(x, self.w1_inv)
        x = self._mulmod(x, sl(self.untwist_t))
        return self._mulmod(x, self.n_inv.reshape(-1, 1, 1))

    def pointwise_local(self, a, b):
        return self._mulmod(a, b)


def make_distributed_negacyclic_mul(plan: DistributedNttPlan, mesh,
                                    axis: str = "coeff"):
    """fn(a, b) -> the rank's block of the negacyclic product, where a and
    b are the rank's blocks [k, N1, N2/D] of [k, N1, N2] arrays sharded
    on the last axis over `axis`: three all_to_alls."""

    def fn(a, b):
        fa = plan.fwd_local(a, mesh, axis)
        fb = plan.fwd_local(b, mesh, axis)
        return plan.inv_local(plan.pointwise_local(fa, fb), mesh, axis)

    return fn
