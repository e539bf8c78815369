"""Fluent proof/verification builders for plain ZKP programs (port of
`sunscreen_tpu/runtime/builders.py`).

Replaces `sunscreen_runtime/src/builder.rs:29-200` (`ProofBuilder` /
`VerificationBuilder`) and the `Runtime::proof_builder` /
`Runtime::verification_builder` entry points
(`sunscreen_runtime/src/runtime.rs:728-833`). The SDLP/linked-proof
builder counterpart (`LogProofBuilder`, builder.rs:397+) lives in the
reference's `runtime/linked.py`, not ported yet.

Usage (mirrors the reference's doc examples)::

    proof = (rt.proof_builder(program)
               .private_input(x)
               .public_input(y)
               .prove())
    (rt.verification_builder(program)
       .proof(proof)
       .public_input(y)
       .verify())        # raises VerificationError on failure
"""

from __future__ import annotations

from sunscreen_tpu_torch.errors import SunscreenError


class VerificationError(SunscreenError):
    """The proof did not verify (reference:
    `sunscreen_zkp_backend::Error::VerificationError`)."""


class ProofBuilder:
    """Accumulates constant/public/private inputs for one ZKP program
    and produces a proof (reference: `ProofBuilder`, builder.rs:29)."""

    def __init__(self, runtime, program):
        self._rt = runtime
        self._prog = program
        self._constant: list = []
        self._public: list = []
        self._private: list = []

    def constant_input(self, value) -> "ProofBuilder":
        self._constant.append(value)
        return self

    def constant_inputs(self, values) -> "ProofBuilder":
        self._constant.extend(values)
        return self

    def public_input(self, value) -> "ProofBuilder":
        self._public.append(value)
        return self

    def public_inputs(self, values) -> "ProofBuilder":
        self._public.extend(values)
        return self

    def private_input(self, value) -> "ProofBuilder":
        self._private.append(value)
        return self

    def private_inputs(self, values) -> "ProofBuilder":
        self._private.extend(values)
        return self

    def prove(self):
        return self._rt.prove(self._prog, self._private,
                              public_inputs=self._public,
                              constant_inputs=self._constant)


class VerificationBuilder:
    """Accumulates the proof and constant/public inputs, then verifies
    (reference: `VerificationBuilder`, builder.rs:120). `verify()`
    RAISES `VerificationError` on failure, matching the reference's
    `Result<()>` contract (the boolean form remains on
    `ZkpRuntime.verify`)."""

    def __init__(self, runtime, program):
        self._rt = runtime
        self._prog = program
        self._proof = None
        self._constant: list = []
        self._public: list = []

    def proof(self, proof) -> "VerificationBuilder":
        self._proof = proof
        return self

    def constant_input(self, value) -> "VerificationBuilder":
        self._constant.append(value)
        return self

    def constant_inputs(self, values) -> "VerificationBuilder":
        self._constant.extend(values)
        return self

    def public_input(self, value) -> "VerificationBuilder":
        self._public.append(value)
        return self

    def public_inputs(self, values) -> "VerificationBuilder":
        self._public.extend(values)
        return self

    def verify(self) -> None:
        if self._proof is None:
            raise VerificationError("no proof supplied to the builder")
        ok = self._rt.verify(self._prog, self._proof,
                             public_inputs=self._public,
                             constant_inputs=self._constant)
        if not ok:
            raise VerificationError(
                f"proof for {getattr(self._prog, 'name', self._prog)!r} "
                f"did not verify")
