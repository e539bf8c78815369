"""ZKP backend layer: arithmetic-circuit IR, JIT, gadget protocol, and
the Bulletproofs R1CS backend (port of `sunscreen_tpu/zk/backend.py`;
`BulletproofsBackend.prove`/`verify` take the `device` of the MSMs and the
prover's source of blinding scalars, `r1cs.scalar_source`; the
reference's linked-proof hooks, `prove_with_witness` and its low-level
input prefix, come with the linked proofs).

Replaces `sunscreen_zkp_backend`: frontend IR ops (`src/jit.rs:18-76`),
`jit_prover`/`jit_verifier` (graph execution over the backend field that
fills gadget hidden inputs, `jit.rs:236-330`), the `Gadget` trait
(`lib.rs:79-128`), `ZkpBackend` trait (`lib.rs:380-461`) and
`bulletproofs::BulletproofsBackend` (`src/bulletproofs.rs:24-180`,
mapping executable graphs to dalek-style R1CS LinearCombinations).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

from sunscreen_tpu_torch.zk import curve25519 as cv
from sunscreen_tpu_torch.zk.merlin import Transcript
from sunscreen_tpu_torch.zk.r1cs import (LinearCombination, Prover,
                                         R1CSProof, Verifier)


class ZkpOp(str, Enum):
    PRIVATE_INPUT = "private_input"
    PUBLIC_INPUT = "public_input"
    CONSTANT_INPUT = "constant_input"
    HIDDEN_INPUT = "hidden_input"
    CONSTANT = "constant"
    ADD = "add"
    SUB = "sub"
    MUL = "mul"
    NEG = "neg"
    CONSTRAINT = "constraint"   # operand must equal data (a constant)


@dataclass
class ZkpNode:
    op: ZkpOp
    operands: tuple[int, ...] = ()
    data: int | tuple | None = None


class Gadget:
    """Prover-supplied hidden inputs + constraint subcircuit (reference
    `Gadget` trait: gadget_input_count/hidden_input_count/
    compute_hidden_inputs/gen_circuit)."""

    gadget_input_count: int = 0
    hidden_input_count: int = 0

    def compute_hidden_inputs(self, inputs: list[int],
                              field_modulus: int) -> list[int]:
        raise NotImplementedError

    def gen_circuit(self, ctx: "ZkpProgramContext", gadget_inputs,
                    hidden_inputs):
        """Add constraints tying hidden inputs to gadget inputs; return
        output node ids."""
        raise NotImplementedError


@dataclass
class ZkpProgram:
    nodes: list[ZkpNode] = field(default_factory=list)
    gadgets: list[tuple[Gadget, tuple[int, ...]]] = field(
        default_factory=list)  # (instance, arg node ids)
    num_private: int = 0
    num_public: int = 0
    num_constant: int = 0

    def add(self, op: ZkpOp, operands=(), data=None) -> int:
        self.nodes.append(ZkpNode(op, tuple(operands), data))
        return len(self.nodes) - 1


class ZkpProgramContext:
    """Trace-time node builder (thread-local use managed by
    types.zkp_types)."""

    def __init__(self):
        self.prog = ZkpProgram()

    def emit(self, op: ZkpOp, operands=(), data=None) -> int:
        return self.prog.add(op, operands, data)

    def invoke_gadget(self, gadget: Gadget, arg_nodes) -> list[int]:
        """Reference: `invoke_gadget` (`sunscreen/src/zkp/mod.rs:560-644`):
        allocate hidden-input nodes, then let the gadget build its
        constraint circuit."""
        arg_nodes = tuple(arg_nodes)
        if len(arg_nodes) != gadget.gadget_input_count:
            raise ZkpError(f"gadget takes {gadget.gadget_input_count} "
                           f"inputs, got {len(arg_nodes)}")
        g_idx = len(self.prog.gadgets)
        self.prog.gadgets.append((gadget, arg_nodes))
        hidden = [self.emit(ZkpOp.HIDDEN_INPUT, (), (g_idx, slot))
                  for slot in range(gadget.hidden_input_count)]
        return gadget.gen_circuit(self, arg_nodes, hidden)


class ZkpError(Exception):
    pass


def evaluate(prog: ZkpProgram, field_modulus: int, private_inputs,
             public_inputs, constant_inputs) -> list[int | None]:
    """Execute the graph over the field (the reference's jit_prover
    forward_traverse), filling gadget hidden inputs on demand. Returns
    per-node values. Raises ZkpError on violated constraints."""
    f = field_modulus
    vals: list[int | None] = [None] * len(prog.nodes)
    hidden_cache: dict[int, list[int]] = {}

    def gadget_hidden(g_idx: int) -> list[int]:
        if g_idx not in hidden_cache:
            gadget, arg_ids = prog.gadgets[g_idx]
            args = [vals[i] for i in arg_ids]
            if any(a is None for a in args):
                raise ZkpError("gadget argument not yet evaluated")
            hidden_cache[g_idx] = [
                x % f for x in gadget.compute_hidden_inputs(args, f)]
            if len(hidden_cache[g_idx]) != gadget.hidden_input_count:
                raise ZkpError("gadget returned wrong hidden input count")
        return hidden_cache[g_idx]

    for i, n in enumerate(prog.nodes):
        if n.op == ZkpOp.PRIVATE_INPUT:
            vals[i] = private_inputs[n.data] % f
        elif n.op == ZkpOp.PUBLIC_INPUT:
            vals[i] = public_inputs[n.data] % f
        elif n.op == ZkpOp.CONSTANT_INPUT:
            vals[i] = constant_inputs[n.data] % f
        elif n.op == ZkpOp.HIDDEN_INPUT:
            g_idx, slot = n.data
            vals[i] = gadget_hidden(g_idx)[slot]
        elif n.op == ZkpOp.CONSTANT:
            vals[i] = n.data % f
        elif n.op == ZkpOp.ADD:
            vals[i] = (vals[n.operands[0]] + vals[n.operands[1]]) % f
        elif n.op == ZkpOp.SUB:
            vals[i] = (vals[n.operands[0]] - vals[n.operands[1]]) % f
        elif n.op == ZkpOp.MUL:
            vals[i] = vals[n.operands[0]] * vals[n.operands[1]] % f
        elif n.op == ZkpOp.NEG:
            vals[i] = (-vals[n.operands[0]]) % f
        elif n.op == ZkpOp.CONSTRAINT:
            if vals[n.operands[0]] != n.data % f:
                raise ZkpError(
                    f"constraint violated at node {i}: "
                    f"{vals[n.operands[0]]} != {n.data % f}")
        else:
            raise ZkpError(f"unknown op {n.op}")
    return vals


@dataclass
class BulletproofsProof:
    """Serializable proof: R1CS proof + witness commitments (reference:
    `BulletproofsR1CSProof`)."""

    r1cs: R1CSProof
    commitments: list[cv.Point]

    def to_bytes(self) -> bytes:
        out = len(self.commitments).to_bytes(4, "little")
        out += b"".join(p.encode() for p in self.commitments)
        return out + self.r1cs.to_bytes()

    @staticmethod
    def from_bytes(data: bytes) -> "BulletproofsProof":
        """Raises `cv.DecodeError` on truncated or malformed input."""
        if len(data) < 4:
            raise cv.DecodeError("truncated bulletproofs proof")
        m = int.from_bytes(data[:4], "little")
        if len(data) < 4 + 32 * m:
            raise cv.DecodeError("bulletproofs proof length mismatch")
        pts = [cv.decode(data[4 + 32 * i: 4 + 32 * (i + 1)])
               for i in range(m)]
        return BulletproofsProof(
            R1CSProof.from_bytes(data[4 + 32 * m:]), pts)


class BulletproofsBackend:
    """Field = ristretto255 scalar field (~2^252 modulus, same as the
    reference backend)."""

    FIELD_MODULUS = cv.L
    TRANSCRIPT_LABEL = b"sunscreen_tpu bulletproofs"

    def _gen_circuit(self, prog: ZkpProgram, cs, committed_vars,
                     public_inputs, constant_inputs, vals):
        """Map graph nodes -> LinearCombinations over the constraint
        system (reference: `bulletproofs.rs:144-180`). `committed_vars`
        maps (private/hidden) node index -> R1CS Variable."""
        f = self.FIELD_MODULUS
        lcs: list[LinearCombination | None] = [None] * len(prog.nodes)
        for i, n in enumerate(prog.nodes):
            if n.op in (ZkpOp.PRIVATE_INPUT, ZkpOp.HIDDEN_INPUT):
                lcs[i] = LinearCombination.from_variable(committed_vars[i])
            elif n.op == ZkpOp.PUBLIC_INPUT:
                lcs[i] = LinearCombination.constant(
                    public_inputs[n.data] % f)
            elif n.op == ZkpOp.CONSTANT_INPUT:
                lcs[i] = LinearCombination.constant(
                    constant_inputs[n.data] % f)
            elif n.op == ZkpOp.CONSTANT:
                lcs[i] = LinearCombination.constant(n.data % f)
            elif n.op == ZkpOp.ADD:
                lcs[i] = lcs[n.operands[0]] + lcs[n.operands[1]]
            elif n.op == ZkpOp.SUB:
                lcs[i] = lcs[n.operands[0]] - lcs[n.operands[1]]
            elif n.op == ZkpOp.NEG:
                lcs[i] = -lcs[n.operands[0]]
            elif n.op == ZkpOp.MUL:
                _, _, o = cs.multiply(lcs[n.operands[0]],
                                      lcs[n.operands[1]])
                lcs[i] = LinearCombination.from_variable(o)
            elif n.op == ZkpOp.CONSTRAINT:
                cs.constrain(lcs[n.operands[0]]
                             - LinearCombination.constant(n.data % f))
        return lcs

    def prove(self, prog: ZkpProgram, private_inputs, public_inputs=(),
              constant_inputs=(), device=None,
              rand_scalar=None) -> BulletproofsProof:
        """A proof of `prog` on these inputs: the graph evaluated (raising
        `ZkpError` on a violated constraint), each private and hidden input
        Pedersen-committed, the circuit built and proved. `device` carries
        the MSMs, `rand_scalar` draws the blindings (`r1cs.Prover`)."""
        vals = evaluate(prog, self.FIELD_MODULUS, private_inputs,
                        public_inputs, constant_inputs)
        prover = Prover(Transcript(self.TRANSCRIPT_LABEL), device,
                        rand_scalar)
        node_vars: dict[int, object] = {}
        commitments: list[cv.Point] = []
        for i, n in enumerate(prog.nodes):
            if n.op in (ZkpOp.PRIVATE_INPUT, ZkpOp.HIDDEN_INPUT):
                V, node_vars[i] = prover.commit(vals[i])
                commitments.append(V)
        self._gen_circuit(prog, prover, node_vars, public_inputs,
                          constant_inputs, vals)
        return BulletproofsProof(prover.prove(), commitments)

    def verify(self, prog: ZkpProgram, proof: BulletproofsProof,
               public_inputs=(), constant_inputs=(), device=None) -> bool:
        verifier = Verifier(Transcript(self.TRANSCRIPT_LABEL), device)
        node_vars: dict[int, object] = {}
        idx = 0
        for i, n in enumerate(prog.nodes):
            if n.op in (ZkpOp.PRIVATE_INPUT, ZkpOp.HIDDEN_INPUT):
                if idx >= len(proof.commitments):
                    return False
                node_vars[i] = verifier.commit(proof.commitments[idx])
                idx += 1
        if idx != len(proof.commitments):
            return False
        self._gen_circuit(prog, verifier, node_vars, public_inputs,
                          constant_inputs, None)
        return verifier.verify(proof.r1cs)
