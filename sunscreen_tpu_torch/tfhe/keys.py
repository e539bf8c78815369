"""Carry the JAX package's TFHE keys and ciphertexts over to the port.

The reference holds torus words as uint64 and NTT residues as uint32
numpy arrays; the port holds both as int64 tensors (u64 words as their
bit patterns). Only the NTT bootstrap key changes layout: the reference
stores [n, (k+1) l, k+1, n_primes, N], the port component-major
[n, k+1, (k+1) l, n_primes, N]. Every other key keeps the reference's
layout, so `words` carries it as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from sunscreen_tpu_torch import resolve_device
from sunscreen_tpu_torch.tfhe.ops import NttBootstrapKey
from sunscreen_tpu_torch.tfhe.params import GlweDef, RadixDecomposition


def words(a, device=None) -> torch.Tensor:
    """A reference array -> int64 tensor with the same bits: LWE/GLWE
    secret keys, ciphertexts (LWE, GLWE, GLEV [l, k+1, N], GGSW),
    test polynomials, and the keys: the raw bootstrap key
    [n, k+1, l, k+1, N], the keyswitch key [n_in, l, n_out+1], the
    private functional keyswitch key [n_in+1, l, k+1, N], the circuit
    bootstrap's [k+1, n_in+1, l, k+1, N], the scheme switch key
    [k, k+1, l, k+1, N], the GLWE keyswitch key [k_from, l, k+1, N], the
    public functional keyswitch key [n_in, l, k+1, N], and the LWE and
    RLWE public keys [count, n+1] and [k+1, N]."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a.astype(np.int64)).to(resolve_device(device))


def ntt_bootstrap_key_from_reference(rows, glwe: GlweDef,
                                     radix: RadixDecomposition,
                                     device=None) -> NttBootstrapKey:
    """The reference's `NttBootstrapKey.rows` (uint32 [n, (k+1) l, k+1,
    n_primes, N]) -> the port's component-major NttBootstrapKey."""
    t = words(rows, device).transpose(1, 2).contiguous()
    return NttBootstrapKey(t, glwe, radix)
