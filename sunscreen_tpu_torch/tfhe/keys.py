"""Carry the JAX package's TFHE keys and ciphertexts over to the port.

The reference holds torus words as uint64 and NTT residues as uint32
numpy arrays; the port holds both as int64 tensors (u64 words as their
bit patterns). Only the NTT bootstrap key changes layout: the reference
stores [n, (k+1) l, k+1, n_primes, N], the port component-major
[n, k+1, (k+1) l, n_primes, N].
"""

from __future__ import annotations

import numpy as np
import torch

from sunscreen_tpu_torch import resolve_device
from sunscreen_tpu_torch.tfhe.ops import NttBootstrapKey
from sunscreen_tpu_torch.tfhe.params import GlweDef, RadixDecomposition


def words(a, device=None) -> torch.Tensor:
    """A reference array (LWE/GLWE secret keys, ciphertexts, the raw
    bootstrap key [n, k+1, l, k+1, N], the keyswitch key
    [n_in, l, n_out+1], test polynomials) -> int64 tensor with the same
    bits."""
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
