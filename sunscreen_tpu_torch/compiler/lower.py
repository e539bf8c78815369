"""Lowering: FHE IR -> one Python callable over the port's BFV ops (port
of `sunscreen_tpu/compiler/lower.py`).

The reference traces the DAG into one jitted XLA computation; here the
callable walks the nodes in order and calls `bfv/ops.py` op by op, each
op launching the CUDA kernels of its routes on a CUDA context and running
their plain twins on a CPU one. The literal plaintexts are uploaded to
the context's device once, when the program is lowered. The evaluation
keys are arguments of every call, never bound into the callable, so one
lowered program serves any key set (the reference's round-4 bug kept the
first caller's keys, `runtime/runtime.py:207-252`). Each node runs in a
`lower.<op>` span (`observability.span`), inside the runtime's
`runtime.run`.
"""

from __future__ import annotations

import numpy as np
import torch

from sunscreen_tpu_torch import observability as obs
from sunscreen_tpu_torch.bfv import ops as bops
from sunscreen_tpu_torch.compiler.ir import Op
from sunscreen_tpu_torch.math import modular as m


def _literals(compiled, ctx) -> list:
    return [torch.as_tensor(np.asarray(p).astype(np.int64),
                            device=ctx.device) for p in compiled.literals]


def lower_program(compiled, ctx):
    """compiled: CompiledFheProgram. Returns fn(*args, rlk=None,
    gks=None) -> [outputs].

    Argument order: ciphertext/plaintext inputs in program-input-index
    order. Ciphertext args are int64 [..., n_comp, k, N] on ctx.device;
    plaintext args are [..., N].
    """
    prog = compiled.prog
    literals = _literals(compiled, ctx)
    names = ["lower." + node.op.value for node in prog.nodes]

    def run(*args, rlk=None, gks=None):
        vals: list = [None] * len(prog.nodes)
        for i, node in enumerate(prog.nodes):
            with obs.span(names[i]):
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


def lower_program_sharded(compiled, ctx, mesh, ct_spec=None, pt_spec=None):
    """Mesh-aware lowering: fn(*local_args, rlk=None, gks=None) ->
    [local outputs] evaluates the same op graph as `lower_program` on
    this rank's shards, with the same bits whatever the spec.

    `ct_spec` names, for each dim of the ciphertext args [batch?, n_comp,
    k, N], the mesh axis sharding it or None (n_comp stays whole); the
    default, as the reference's, shards the batch over the mesh's first
    axis and the limbs over its second when there is one. `pt_spec` does
    the same for the plaintext args [batch?, N] (default: replicated).
    Args come in, and outputs go out, as the rank's contiguous blocks in
    rank order (`parallel.mesh.local_shard`); the keys are arguments of
    every call, replicated, never bound in.

    The reference lets GSPMD partition the graph. PyTorch has no
    counterpart, so what each rank computes, and which collective it
    needs, is written out per node kind:

    * a sharded batch axis: each rank evaluates its own rows, whatever
      the node; no collective;
    * add, sub, negate, add_plain and sub_plain on any axis: local to the
      block, over the block's own limb moduli (the scaled plaintext is
      computed whole and cut to the block); no collective;
    * multiply, multiply_plain, relinearize and the rotations, with a
      sharded limb or coefficient axis: base conversion and keyswitching
      contract over the limbs, and the NTT and the Galois permutations
      mix coefficients across ranks, so the node's operands are
      all-gathered along those axes (once per value) and the op runs
      whole through `bfv/ops.py` on the rank's device. Its result stays
      whole until a local node or an output takes it, which cuts the
      rank's block back out without a collective. No node takes the
      distributed NTT of `parallel/sharded_bfv.py`: a coefficient spec
      shards N in contiguous blocks, while the four-step layout shards
      the N2 columns of an N1 x N2 view; `sharded_multiply_relin` is
      that layout's multiply.

    Sharded plaintext args are all-gathered once, on entry. A limb or
    coefficient axis that the mesh does not divide raises
    `IndivisibleAxis` here (the reference's jit raises `ValueError`).
    The all-gathers count in `parallel.mesh.COUNTERS`."""
    from sunscreen_tpu_torch.parallel import mesh as pm

    names = tuple(mesh.mesh_dim_names)
    if ct_spec is None:
        ct_spec = (names[0], None, names[1] if len(names) > 1 else None,
                   None)
    ct_spec, pt_spec = tuple(ct_spec), tuple(pt_spec or ())
    for ax in ct_spec + pt_spec:
        if ax is not None and ax not in names:
            raise ValueError(f"{ax!r} is not an axis of the mesh {names}")
    if len(ct_spec) < 3 or ct_spec[-3] is not None:
        raise ValueError("ct_spec must cover [batch?, n_comp, k, N] and "
                         "leave n_comp whole")
    batch_spec = ct_spec[:-3]
    cut = [(d, ax) for d, ax in ((-2, ct_spec[-2]), (-1, ct_spec[-1]))
           if ax is not None]
    for d, ax in cut:
        size = ctx.k if d == -2 else ctx.n
        if size % pm.axis_size(mesh, ax):
            raise pm.IndivisibleAxis(
                f"{size} is not divisible by mesh axis {ax!r} of size "
                f"{pm.axis_size(mesh, ax)}")
    q_local = ctx.q_base.q
    if ct_spec[-2] is not None:
        q_local = pm.local_shard(q_local, mesh, ct_spec[-2], 0)
    literals = _literals(compiled, ctx)
    prog = compiled.prog

    def gather(x):
        for d, ax in cut:
            x = pm.all_gather(x, mesh, ax, d)
        return x

    def block(x):
        for d, ax in cut:
            x = pm.local_shard(x, mesh, ax, d)
        return x

    def batch_rows(x, trailing: int):
        """A whole plaintext [..., N] (trailing 1) or its scaled form
        [..., k, N] (trailing 2) cut to this rank's batch rows."""
        nb = x.ndim - trailing
        for j in range(nb):
            s = len(batch_spec) - nb + j
            if s >= 0 and batch_spec[s] is not None and x.shape[j] > 1:
                x = pm.local_shard(x, mesh, batch_spec[s], j)
        return x

    def run(*args, rlk=None, gks=None):
        shard: dict = {}                # node -> the rank's block
        whole: dict = {}                # node -> whole limbs and coeffs

        def shard_of(i):
            if i not in shard:
                shard[i] = block(whole[i])
            return shard[i]

        def whole_of(i):
            if i not in whole:
                whole[i] = gather(shard[i])
            return whole[i]

        for i, node in enumerate(prog.nodes):
            op, src = node.op, node.operands
            if op == Op.INPUT_CIPHERTEXT:
                shard[i] = args[node.data]
            elif op == Op.INPUT_PLAINTEXT:
                pt = args[node.data]
                for d, ax in enumerate(pt_spec):
                    if ax is not None:
                        pt = pm.all_gather(pt, mesh, ax, d)
                whole[i] = pt
            elif op == Op.LITERAL:
                whole[i] = literals[node.data]
            elif op in (Op.ADD, Op.SUB):
                a, b = shard_of(src[0]), shard_of(src[1])
                n_comp = max(a.shape[-3], b.shape[-3])
                f = m.add_mod if op == Op.ADD else m.sub_mod
                shard[i] = f(bops._pad_components(a, n_comp),
                             bops._pad_components(b, n_comp), q_local)
            elif op == Op.NEGATE:
                shard[i] = m.neg_mod(shard_of(src[0]), q_local)
            elif op in (Op.ADD_PLAIN, Op.SUB_PLAIN):
                ct = shard_of(src[0])
                delta = block(batch_rows(bops.scale_plain(ctx, whole[src[1]]),
                                         2))
                f = m.add_mod if op == Op.ADD_PLAIN else m.sub_mod
                c0 = f(ct[..., 0, :, :], delta, q_local)
                shard[i] = torch.cat([c0.unsqueeze(-3), ct[..., 1:, :, :]],
                                     dim=-3)
            elif op == Op.MULTIPLY:
                whole[i] = bops.multiply(ctx, whole_of(src[0]),
                                         whole_of(src[1]))
            elif op == Op.MULTIPLY_PLAIN:
                whole[i] = bops.multiply_plain(
                    ctx, whole_of(src[0]), batch_rows(whole[src[1]], 1))
            elif op == Op.RELINEARIZE:
                whole[i] = bops.relinearize(ctx, whole_of(src[0]), rlk)
            elif op in (Op.SHIFT_LEFT, Op.SHIFT_RIGHT):
                steps = node.data if op == Op.SHIFT_LEFT else -node.data
                whole[i] = bops.rotate_rows(ctx, whole_of(src[0]), steps,
                                            gks)
            elif op == Op.SWAP_ROWS:
                whole[i] = bops.rotate_columns(ctx, whole_of(src[0]), gks)
            elif op == Op.OUTPUT_CIPHERTEXT:
                shard[i] = shard_of(src[0])
            else:
                raise ValueError(op)
        return [shard[o] for o in prog.outputs]

    return run
