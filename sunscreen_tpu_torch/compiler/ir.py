"""FHE program IR: a typed operation DAG (port of
`sunscreen_tpu/compiler/ir.py`).

Pure Python, the reference's IR node for node: validation, relin
insertion, noise estimation and serialization run on it, and
`compiler/lower.py` runs it op by op on the port's BFV ops. `to_json`
gives the reference's string for the same program, so compiled programs
serialize to the same bytes in both packages.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import Enum


class Op(str, Enum):
    """FHE IR operations — parity with the reference's
    `sunscreen_fhe_program/src/operation.rs` (usage:
    `sunscreen_runtime/src/run.rs:166-336`)."""

    INPUT_CIPHERTEXT = "input_ciphertext"
    INPUT_PLAINTEXT = "input_plaintext"
    LITERAL = "literal"
    ADD = "add"
    ADD_PLAIN = "add_plain"
    SUB = "sub"
    SUB_PLAIN = "sub_plain"
    MULTIPLY = "multiply"
    MULTIPLY_PLAIN = "multiply_plain"
    NEGATE = "negate"
    RELINEARIZE = "relinearize"
    SHIFT_LEFT = "shift_left"      # rotate batching rows left
    SHIFT_RIGHT = "shift_right"
    SWAP_ROWS = "swap_rows"
    OUTPUT_CIPHERTEXT = "output_ciphertext"


UNARY = {Op.NEGATE, Op.RELINEARIZE, Op.SWAP_ROWS, Op.OUTPUT_CIPHERTEXT}
BINARY = {Op.ADD, Op.ADD_PLAIN, Op.SUB, Op.SUB_PLAIN, Op.MULTIPLY,
          Op.MULTIPLY_PLAIN}
SHIFTS = {Op.SHIFT_LEFT, Op.SHIFT_RIGHT}
INPUTS = {Op.INPUT_CIPHERTEXT, Op.INPUT_PLAINTEXT}
COMMUTATIVE = {Op.ADD, Op.MULTIPLY}
CIPHER_OUT = {Op.INPUT_CIPHERTEXT, Op.ADD, Op.ADD_PLAIN, Op.SUB,
              Op.SUB_PLAIN, Op.MULTIPLY, Op.MULTIPLY_PLAIN, Op.NEGATE,
              Op.RELINEARIZE, Op.SHIFT_LEFT, Op.SHIFT_RIGHT, Op.SWAP_ROWS,
              Op.OUTPUT_CIPHERTEXT}


@dataclass
class Node:
    op: Op
    operands: tuple[int, ...] = ()
    # op-specific payload: input index, literal value, or shift steps
    data: int | None = None


class ValidationError(Exception):
    """Reference parity: `sunscreen_fhe_program/src/validation.rs:5-160`
    (cycle check + per-node operand count/type check)."""


@dataclass
class FheProgram:
    """A compiled-frontend FHE program graph.

    Nodes are in insertion order, which tracing guarantees to be
    topological (operands always precede users)."""

    nodes: list[Node] = field(default_factory=list)
    outputs: list[int] = field(default_factory=list)

    def add(self, op: Op, operands: tuple[int, ...] = (),
            data: int | None = None) -> int:
        for o in operands:
            if not 0 <= o < len(self.nodes):
                raise ValidationError(f"operand {o} out of range")
        self.nodes.append(Node(op, tuple(operands), data))
        return len(self.nodes) - 1

    # -- queries (reference: GraphQuery, sunscreen_compiler_common/graph.rs)

    def users(self) -> list[list[int]]:
        out: list[list[int]] = [[] for _ in self.nodes]
        for i, n in enumerate(self.nodes):
            for o in n.operands:
                out[o].append(i)
        return out

    @property
    def num_inputs(self) -> int:
        return sum(1 for n in self.nodes if n.op in INPUTS)

    def count(self, op: Op) -> int:
        return sum(1 for n in self.nodes if n.op == op)

    @property
    def requires_relin_keys(self) -> bool:
        return self.count(Op.RELINEARIZE) > 0

    @property
    def requires_galois_keys(self) -> bool:
        return any(n.op in SHIFTS | {Op.SWAP_ROWS} for n in self.nodes)

    def multiplicative_depth(self) -> int:
        """Longest chain of ct×ct multiplies — drives parameter choice
        (reference: the chain_count/noise interplay in
        `sunscreen/src/params.rs:199-226`)."""
        depth = [0] * len(self.nodes)
        for i, n in enumerate(self.nodes):
            d = max((depth[o] for o in n.operands), default=0)
            depth[i] = d + (1 if n.op == Op.MULTIPLY else 0)
        return max(depth, default=0)

    # -- validation ----------------------------------------------------------

    def validate(self):
        for i, n in enumerate(self.nodes):
            if any(o >= i for o in n.operands):
                raise ValidationError(f"node {i}: non-topological operand")
            if n.op in INPUTS or n.op == Op.LITERAL:
                want = 0
            elif n.op in UNARY or n.op in SHIFTS:
                want = 1
            elif n.op in BINARY:
                want = 2
            else:
                raise ValidationError(f"node {i}: unknown op {n.op}")
            if n.op in SHIFTS:
                if len(n.operands) != 1 or n.data is None:
                    raise ValidationError(f"node {i}: shift needs 1 operand"
                                          " + steps")
                continue
            if len(n.operands) != want:
                raise ValidationError(
                    f"node {i}: {n.op.value} wants {want} operands, got "
                    f"{len(n.operands)}")
            if n.op in INPUTS and n.data is None:
                raise ValidationError(f"node {i}: input without index")
        for o in self.outputs:
            if not 0 <= o < len(self.nodes):
                raise ValidationError(f"output {o} out of range")

    # -- pruning (reference: FheProgramTrait::prune) -------------------------

    def prune(self) -> "FheProgram":
        """Drop nodes not reachable from outputs; remap indices."""
        live = set()
        stack = list(self.outputs)
        while stack:
            i = stack.pop()
            if i in live:
                continue
            live.add(i)
            stack.extend(self.nodes[i].operands)
        remap = {}
        out = FheProgram()
        for i, n in enumerate(self.nodes):
            if i in live:
                remap[i] = out.add(n.op, tuple(remap[o] for o in n.operands),
                                   n.data)
        out.outputs = [remap[o] for o in self.outputs]
        return out

    # -- visualization (reference: Render trait / DotViz,
    #    sunscreen_compiler_common/src/lib.rs:36-41) -------------------------

    def to_dot(self) -> str:
        lines = ["digraph fhe_program {"]
        for i, n in enumerate(self.nodes):
            label = n.op.value
            if n.data is not None:
                label += f"({n.data})"
            shape = "box" if n.op in INPUTS or n.op == Op.LITERAL \
                else "ellipse"
            lines.append(f'  n{i} [label="{label}", shape={shape}];')
            for j, o in enumerate(n.operands):
                lines.append(f"  n{o} -> n{i} [label={j}];")
        lines.append("}")
        return "\n".join(lines)

    # -- serialization (reference: serde on CompilationResult) ---------------

    def to_json(self) -> str:
        return json.dumps({
            "nodes": [[n.op.value, list(n.operands), n.data]
                      for n in self.nodes],
            "outputs": self.outputs,
        })

    @staticmethod
    def from_json(s: str) -> "FheProgram":
        d = json.loads(s)
        p = FheProgram()
        for op, operands, data in d["nodes"]:
            p.nodes.append(Node(Op(op), tuple(operands), data))
        p.outputs = list(d["outputs"])
        p.validate()
        return p
