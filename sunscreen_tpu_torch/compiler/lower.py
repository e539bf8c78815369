"""Lowering: FHE IR -> one Python callable over the port's BFV ops (port
of `sunscreen_tpu/compiler/lower.py`).

The reference traces the DAG into one jitted XLA computation; here the
callable walks the nodes in order and calls `bfv/ops.py` op by op, each
op launching the CUDA kernels of its routes on a CUDA context and running
their plain twins on a CPU one. The literal plaintexts are uploaded to
the context's device once, when the program is lowered. The evaluation
keys are arguments of every call, never bound into the callable, so one
lowered program serves any key set (the reference's round-4 bug kept the
first caller's keys, `runtime/runtime.py:207-252`).
"""

from __future__ import annotations

import numpy as np
import torch

from sunscreen_tpu_torch.bfv import ops as bops
from sunscreen_tpu_torch.compiler.ir import Op


def lower_program(compiled, ctx):
    """compiled: CompiledFheProgram. Returns fn(*args, rlk=None,
    gks=None) -> [outputs].

    Argument order: ciphertext/plaintext inputs in program-input-index
    order. Ciphertext args are int64 [..., n_comp, k, N] on ctx.device;
    plaintext args are [..., N].
    """
    prog = compiled.prog
    literals = [torch.as_tensor(np.asarray(p).astype(np.int64),
                                device=ctx.device)
                for p in compiled.literals]

    def run(*args, rlk=None, gks=None):
        vals: list = [None] * len(prog.nodes)
        for i, node in enumerate(prog.nodes):
            op = node.op
            src = node.operands
            if op in (Op.INPUT_CIPHERTEXT, Op.INPUT_PLAINTEXT):
                vals[i] = args[node.data]
            elif op == Op.LITERAL:
                vals[i] = literals[node.data]
            elif op == Op.ADD:
                vals[i] = bops.add(ctx, vals[src[0]], vals[src[1]])
            elif op == Op.SUB:
                vals[i] = bops.sub(ctx, vals[src[0]], vals[src[1]])
            elif op == Op.ADD_PLAIN:
                vals[i] = bops.add_plain(ctx, vals[src[0]], vals[src[1]])
            elif op == Op.SUB_PLAIN:
                vals[i] = bops.sub_plain(ctx, vals[src[0]], vals[src[1]])
            elif op == Op.MULTIPLY:
                vals[i] = bops.multiply(ctx, vals[src[0]], vals[src[1]])
            elif op == Op.MULTIPLY_PLAIN:
                vals[i] = bops.multiply_plain(ctx, vals[src[0]],
                                              vals[src[1]])
            elif op == Op.NEGATE:
                vals[i] = bops.negate(ctx, vals[src[0]])
            elif op == Op.RELINEARIZE:
                vals[i] = bops.relinearize(ctx, vals[src[0]], rlk)
            elif op == Op.SHIFT_LEFT:
                vals[i] = bops.rotate_rows(ctx, vals[src[0]], node.data,
                                           gks)
            elif op == Op.SHIFT_RIGHT:
                vals[i] = bops.rotate_rows(ctx, vals[src[0]], -node.data,
                                           gks)
            elif op == Op.SWAP_ROWS:
                vals[i] = bops.rotate_columns(ctx, vals[src[0]], gks)
            elif op == Op.OUTPUT_CIPHERTEXT:
                vals[i] = vals[src[0]]
            else:
                raise ValueError(op)
        return [vals[o] for o in prog.outputs]

    return run
