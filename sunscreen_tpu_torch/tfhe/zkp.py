"""TFHE <-> SDLP bridge: prove that an LWE ciphertext validly encrypts a
bounded message under a binary secret key (port of
`sunscreen_tpu/tfhe/zkp.py`).

Replaces `sunscreen_tfhe/src/zkp.rs:20-60` (links LWE encryptions to
`logproof`). The LWE relation b = <a, s> + m*2^(64-bits) + e becomes a
1-row lattice statement over Z_{2^64}[X]/(X+1) (degree-1 ring = plain
mod-2^64 arithmetic) with witness columns [s_1..s_n, m, e] bounded as
[1 bit each, plaintext_bits, noise_bits]. Ciphertexts and keys are u64
bit patterns in int64 tensors (or arrays); the proof runs on `device`
(None means CUDA).
"""

from __future__ import annotations

import numpy as np
import torch

from sunscreen_tpu_torch.logproof import inner_product as lp_ipp
from sunscreen_tpu_torch.logproof import linear_relation as lr
from sunscreen_tpu_torch.tfhe.params import TORUS_BITS, LweDef
from sunscreen_tpu_torch.zk.merlin import Transcript

Q = 1 << TORUS_BITS
TRANSCRIPT_LABEL = b"sunscreen_tpu tfhe sdlp"


def _words(x) -> list[int]:
    """u64 words (int64 bit patterns, a tensor or an array) as ints."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return [int(w) % Q for w in np.asarray(x).reshape(-1).tolist()]


def lwe_statement(ct, params: LweDef, plaintext_bits: int,
                  noise_bits: int = 16) -> lr.VerifierKnowledge:
    """A = [a_1 .. a_n, 2^(64-bits), 1], T = [b]."""
    ct = _words(ct)
    a_row = [[c] for c in ct[:-1]]
    a_row.append([1 << (TORUS_BITS - plaintext_bits)])
    a_row.append([1])
    bounds = [[[1]] for _ in range(params.dim)]
    bounds.append([[plaintext_bits]])
    bounds.append([[noise_bits]])
    return lr.VerifierKnowledge(
        a=[a_row], t=[[[ct[-1]]]], bounds=bounds, f=[1, 1], q=Q)


def _prove(ct, sk, msg: int, e: int, params: LweDef, plaintext_bits: int,
           noise_bits: int, device, rand_fn
           ) -> tuple[lr.LogProof, lr.VerifierKnowledge]:
    vk = lwe_statement(ct, params, plaintext_bits, noise_bits)
    s_col = [[[b]] for b in _words(sk)]
    s_col.append([[int(msg) % Q]])
    s_col.append([[int(e) % Q]])
    gens = lr.LogProofGenerators(vk.l)
    proof = lr.create(Transcript(TRANSCRIPT_LABEL),
                      lr.ProverKnowledge(vk, s_col), gens.g, gens.h,
                      lp_ipp.get_u(), gens=gens, device=device,
                      rand_fn=rand_fn)
    return proof, vk


def prove_lwe_encryption(ct, sk, msg: int, e: int, params: LweDef,
                         plaintext_bits: int, noise_bits: int = 16,
                         device=None
                         ) -> tuple[lr.LogProof, lr.VerifierKnowledge]:
    """Prove knowledge of (s, m, e) with b = <a,s> + m*Delta + e."""
    return _prove(ct, sk, msg, e, params, plaintext_bits, noise_bits,
                  device, None)


def verify_lwe_encryption(proof: lr.LogProof, vk: lr.VerifierKnowledge,
                          device=None) -> bool:
    gens = lr.LogProofGenerators(vk.l)
    return lr.verify(proof, Transcript(TRANSCRIPT_LABEL), vk, gens.g,
                     gens.h, lp_ipp.get_u(), gens=gens, device=device)
