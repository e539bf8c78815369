"""Backend passes over the FHE IR (port of
`sunscreen_tpu/compiler/passes.py`): common-subexpression elimination,
relinearization after every ct×ct multiply, pruning and validation, in
the reference's order.
"""

from __future__ import annotations

from sunscreen_tpu_torch.compiler.ir import COMMUTATIVE, FheProgram, Op


def insert_relinearizations(prog: FheProgram) -> FheProgram:
    """Insert a Relinearize after every ct×ct Multiply, rewiring the
    multiply's users (and outputs) to the relin node — same policy as the
    reference (every `Operation::Multiply`, `insert_relinearizations.rs:
    17-61`; justification: ct×ct grows the ciphertext while ct×pt does
    not, `seal_fhe/tests/assumptions.rs`)."""
    out = FheProgram()
    remap: dict[int, int] = {}
    for i, n in enumerate(prog.nodes):
        new_ops = tuple(remap[o] for o in n.operands)
        idx = out.add(n.op, new_ops, n.data)
        if n.op == Op.MULTIPLY:
            idx = out.add(Op.RELINEARIZE, (idx,))
        remap[i] = idx
    out.outputs = [remap[o] for o in prog.outputs]
    return out


def common_subexpression_elimination(prog: FheProgram) -> FheProgram:
    """Merge structurally identical nodes (commutative ops normalize
    operand order). Reference parity:
    `sunscreen_compiler_common/src/transforms/common_subexpression_
    elimination.rs`, defined but unwired there; wired here, as in the
    JAX package)."""
    out = FheProgram()
    remap: dict[int, int] = {}
    seen: dict[tuple, int] = {}
    for i, n in enumerate(prog.nodes):
        ops_ = tuple(remap[o] for o in n.operands)
        if n.op in COMMUTATIVE:
            ops_ = tuple(sorted(ops_))
        key = (n.op, ops_, n.data)
        if n.op not in (Op.OUTPUT_CIPHERTEXT,) and key in seen:
            remap[i] = seen[key]
            continue
        idx = out.add(n.op, ops_, n.data)
        seen[key] = idx
        remap[i] = idx
    out.outputs = [remap[o] for o in prog.outputs]
    return out


def compile_program(prog: FheProgram) -> FheProgram:
    """Full backend pipeline: transforms + validation."""
    prog = common_subexpression_elimination(prog)
    prog = insert_relinearizations(prog)
    prog = prog.prune()
    prog.validate()
    return prog
