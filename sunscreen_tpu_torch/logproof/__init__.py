"""SDLP lattice proofs (port of `sunscreen_tpu.logproof`, which replaces
the reference's `logproof` crate): short discrete log proofs of A·S = T
over Z_q[X]/(X^N+1) with per-coefficient bounds, the ZK inner product
argument, and the BFV statement builders (`bfv_statement.BfvStatements`).
On CUDA, the default, their MSMs of 2048 points or more run the CUDA
Pippenger M1."""

from sunscreen_tpu_torch.logproof.bfv_statement import (  # noqa: F401
    BfvStatements)
from sunscreen_tpu_torch.logproof.linear_relation import (  # noqa: F401
    LogProof, LogProofGenerators, ProverKnowledge, VerifierKnowledge,
    create, verify)
