"""The ranks of the port's sharded-execution tests
(tests/test_torch_parallel.py, tests/test_torch_parallel_lower.py).

    python tests/torch_parallel_ranks.py SUITE RANK WORLD DIR

Each rank joins one gloo process group of WORLD ranks through a
`FileStore` in DIR (no network, no fixed port), runs torch on one thread
and every scenario of SUITE on meshes over those ranks, and writes its
blocks to DIR as `<name>_r<rank>.npy` and its collective counts as
`<name>_r<rank>.json`; the test process assembles the blocks and holds
them against the JAX package. Scenarios that need the reference's arrays
wait for DIR/inputs.npz, which the test process writes while the others
run. The ranks import torch and the port only.

Programs are not defined under `from __future__ import annotations`:
the port's `fhe_program` reads the annotations as objects.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from sunscreen_tpu_torch.bfv import BfvParams  # noqa: E402
from sunscreen_tpu_torch.compiler import fhe_program  # noqa: E402
from sunscreen_tpu_torch.types import Batched, Cipher  # noqa: E402

WORLD = 4
INPUTS_WAIT_S = 240
A2A_SHAPE = (3, 8, 4)            # [k, N1, N2 / D] blocks of the exchange
NEG_N, NEG_BITS = 256, 50        # the reference test's distributed product
PBS_BATCH, PBS_SEED = 8, 41
LOWER_PARAMS = BfvParams.insecure(64, limbs=2, limb_bits=40)
LOWER_BATCH = 4
GATE_PARAMS = BfvParams.insecure(256, limbs=2, limb_bits=30)
GATE_BATCH, GATE_SEED = 8, 64


@fhe_program(scheme="bfv")
def workload(a: Cipher[Batched], b: Cipher[Batched]):
    """tests/test_parallel.py's sharded program."""
    prod = a * b
    rot = prod << 1
    return rot + a - b


@fhe_program(scheme="bfv")
def square(a: Cipher[Batched]):
    return a * a


@fhe_program(scheme="bfv")
def square_plus(a: Cipher[Batched]):
    """The multichip dry run's step: multiply_relin(a, a) + a."""
    return a * a + a


LIT = [(5 * i) % 13 for i in range(GATE_PARAMS.poly_degree)]


@fhe_program(scheme="bfv")
def every_op(x: Cipher[Batched], y: Cipher[Batched]):
    """Every node kind that tracing emits: the plain ops on a literal,
    negate, both shifts and the row swap."""
    p = x * y
    return ((x + y) << 1, (x - y) >> 2, p.swap_rows(), x + LIT, y - LIT,
            x * LIT, -y)


def plain_program():
    """A hand-built program over a plaintext argument, which tracing does
    not emit: add_plain, sub_plain and multiply_plain of ciphertext 0 and
    plaintext 1."""
    from types import SimpleNamespace

    from sunscreen_tpu_torch.compiler.ir import FheProgram, Op
    prog = FheProgram()
    x = prog.add(Op.INPUT_CIPHERTEXT, (), 0)
    pt = prog.add(Op.INPUT_PLAINTEXT, (), 1)
    outs = [prog.add(op, (x, pt)) for op in (Op.ADD_PLAIN, Op.SUB_PLAIN,
                                               Op.MULTIPLY_PLAIN)]
    prog.outputs = [prog.add(Op.OUTPUT_CIPHERTEXT, (o,)) for o in outs]
    return SimpleNamespace(prog=prog, literals=[])


def a2a_input(rank: int) -> torch.Tensor:
    return (torch.arange(int(np.prod(A2A_SHAPE)), dtype=torch.int64)
            .reshape(A2A_SHAPE) + 1000 * rank)


def neg_inputs():
    """The distributed product's operands [k, N] and moduli."""
    from sunscreen_tpu_torch.math import primes
    moduli = tuple(primes.gen_ntt_primes(NEG_BITS, 2, NEG_N))
    rng = np.random.default_rng(9)
    a, b = (np.stack([rng.integers(0, q, NEG_N) for q in moduli])
            for _ in range(2))
    return moduli, a, b


def roundtrip_cases():
    """(n, moduli, x [k, n]): a 50-bit modulus at N = 128 (the reference
    test's) and the u32 product base of insecure(64, limbs=2,
    limb_bits=30)."""
    from sunscreen_tpu_torch.bfv import get_context
    from sunscreen_tpu_torch.math import primes
    rng = np.random.default_rng(3)
    out = []
    for n, moduli in ((128, tuple(primes.gen_ntt_primes(50, 1, 128))),
                      (64, get_context(BfvParams.insecure(
                          64, limbs=2, limb_bits=30), "cpu")
                       .mul_base.moduli)):
        out.append((n, moduli, np.stack([rng.integers(0, q, n)
                                         for q in moduli])))
    return out


def pbs_setup():
    """The port's TFHE keys at LWE dim 8, GLWE N = 256 (the reference
    test's), the NTT-domain bootstrap key and PBS_BATCH ciphertexts, all
    from one seeded CPU generator: the same on every rank."""
    from sunscreen_tpu_torch.tfhe import (GlweDef, LweDef,
                                          RadixDecomposition, ops, torus)
    lwe, glwe = LweDef(8, 1e-16), GlweDef(1, 256, 1e-16)
    pbs_radix, ks_radix = RadixDecomposition(3, 4), RadixDecomposition(8, 6)
    gen = torch.Generator().manual_seed(PBS_SEED)
    lwe_sk = ops.generate_binary_lwe_sk(lwe, gen, "cpu")
    glwe_sk = ops.generate_binary_glwe_sk(glwe, gen, "cpu")
    bsk = ops.generate_bootstrap_key(lwe_sk, glwe_sk, lwe, glwe, pbs_radix,
                                     gen)
    ksk = ops.generate_keyswitch_key(ops.flatten_glwe_sk(glwe_sk), lwe_sk,
                                     lwe, ks_radix, gen)
    msgs = torch.arange(PBS_BATCH) % 2
    cts = ops.encrypt_lwe(torus.encode(msgs, 2), lwe_sk, lwe, gen)
    tp = ops.test_polynomial_for(lambda m: (m + 1) % 2, 2, glwe,
                                 device="cpu")
    nbk = ops.bootstrap_key_to_ntt(bsk, glwe, pbs_radix)
    return (cts, tp, nbk, ksk, lwe, glwe, pbs_radix, ks_radix), lwe_sk, msgs


def gate_setup():
    """GATE_PARAMS keys and GATE_BATCH encrypted `Batched` rows from one
    seeded CPU generator (the same on every rank): (ctx, sk, rlk, pts,
    cts)."""
    from sunscreen_tpu_torch.bfv import get_context, keys, ops
    ctx = get_context(GATE_PARAMS, "cpu")
    gen = torch.Generator().manual_seed(GATE_SEED)
    sk = keys.gen_secret_key(ctx, gen)
    pk = keys.gen_public_key(ctx, sk, gen)
    rlk = keys.gen_relin_key(ctx, sk, gen)
    pts = (torch.arange(GATE_BATCH * ctx.n).reshape(GATE_BATCH, ctx.n) * 7
           + 3) % ctx.t
    return ctx, sk, rlk, pts, ops.encrypt(ctx, pk, pts, gen)


def every_setup():
    """Galois keys for every_op's rotations at GATE_PARAMS, and two
    batches of ciphertexts of uniform residues plus one of plaintext rows
    (the ops are deterministic functions of their words), from one seeded
    CPU generator: (ctx, rlk, gks, a, b, pts)."""
    from sunscreen_tpu_torch.bfv import keys
    ctx, sk, rlk, _, _ = gate_setup()
    gen = torch.Generator().manual_seed(GATE_SEED + 1)
    gks = keys.gen_galois_keys(ctx, sk, gen, (
        ctx.rotate_rows_element(1), ctx.rotate_rows_element(ctx.n // 2 - 2),
        ctx.rotate_columns_element))
    a, b = (torch.randint(0, 1 << 62, (GATE_BATCH, 2, ctx.k, ctx.n),
                          generator=gen) % ctx.q_base.q for _ in range(2))
    pts = torch.randint(0, ctx.t, (GATE_BATCH, ctx.n), generator=gen)
    return ctx, rlk, gks, a, b, pts


def compiled(fn, params):
    from sunscreen_tpu_torch.compiler import Compiler
    return (Compiler("cpu").with_params(params).fhe_program(fn).compile()
            .get_program(fn))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

class _Out:
    def __init__(self, workdir: str, rank: int):
        self.workdir, self.rank = workdir, rank

    def save(self, name: str, t: torch.Tensor) -> None:
        np.save(os.path.join(self.workdir, f"{name}_r{self.rank}.npy"),
                t.cpu().numpy())

    def stats(self, name: str, st) -> None:
        with open(os.path.join(self.workdir, f"{name}_r{self.rank}.json"),
                  "w") as f:
            json.dump({"bytes": st.bytes, "count": st.count}, f)

    def inputs(self) -> dict:
        path = os.path.join(self.workdir, "inputs.npz")
        t0 = time.monotonic()
        while not os.path.exists(path):
            if time.monotonic() - t0 > INPUTS_WAIT_S:
                raise TimeoutError(f"{path} never appeared")
            time.sleep(0.1)
        with np.load(path) as f:
            return {k: torch.from_numpy(f[k]) for k in f.files}


def _parallel(out: _Out) -> None:
    from sunscreen_tpu_torch.bfv import get_context
    from sunscreen_tpu_torch.bfv.keys import KswKey
    from sunscreen_tpu_torch.parallel import dntt, ici_model
    from sunscreen_tpu_torch.parallel import mesh as pm
    from sunscreen_tpu_torch.parallel import sharded_bfv as sb
    from sunscreen_tpu_torch.parallel import sharded_tfhe as st
    from sunscreen_tpu_torch.tfhe import GlweDef, RadixDecomposition

    line = pm.make_mesh((WORLD,), ("coeff",), "cpu")
    grid = pm.make_mesh((2, 2), ("batch", "coeff"), "cpu")
    x = a2a_input(out.rank)
    for mesh, tag in ((line, "line"), (grid, "grid")):
        for s, c in ((1, 2), (2, 1)):
            out.save(f"a2a_{tag}_{s}{c}",
                     pm.all_to_all_tiled(x, mesh, "coeff", s, c))

    moduli, a, b = neg_inputs()
    plan = dntt.DistributedNttPlan(NEG_N, moduli, "cpu")
    fn = dntt.make_distributed_negacyclic_mul(plan, line)

    def blocks(v, k):
        return pm.local_shard(torch.from_numpy(v).reshape(
            k, plan.n1, plan.n2), line, "coeff", -1)

    with ici_model.collective_stats() as stats:
        prod = fn(blocks(a, 2), blocks(b, 2))
    out.save("neg", prod)
    out.stats("neg", stats)

    for n, mods, v in roundtrip_cases():
        p = dntt.DistributedNttPlan(n, mods, "cpu")
        blk = pm.local_shard(torch.from_numpy(v).reshape(
            len(mods), p.n1, p.n2), line, "coeff", -1)
        out.save(f"roundtrip_{n}", p.inv_local(p.fwd_local(blk, line,
                                                           "coeff"),
                                               line, "coeff"))

    args, *_ = pbs_setup()
    rows = pm.local_shard(args[0], line, "coeff", 0)
    out.save("pbs", st.batch_sharded_pbs(line, rows, *args[1:],
                                         batch_axis="coeff"))

    inp = out.inputs()
    ctx = get_context(BfvParams.insecure(64, limbs=2, limb_bits=30), "cpu")
    srlk = sb.sharded_relin_key(ctx, KswKey(inp["k0"], inp["k1"]), line)
    ct4 = pm.local_shard(sb.to_sharded_layout(inp["ct"], ctx), line,
                         "coeff", -1)
    out.save("bfv", sb.sharded_multiply_relin(ctx, line, ct4, ct4, srlk))

    glwe = GlweDef(1, 256, 1e-16)
    n1, n2 = dntt.four_step(glwe.poly_degree)
    ggsw = pm.local_shard(inp["ggsw"].reshape(2, 3, 2, n1, n2), grid,
                          "coeff", -1)
    glwe_ct = pm.local_shard(inp["glwe"].reshape(2, n1, n2), grid, "coeff",
                             -1)
    out.save("extprod", st.coeff_sharded_external_product(
        grid, ggsw, glwe_ct, glwe, RadixDecomposition(3, 4)))


def _lower(out: _Out) -> None:
    from sunscreen_tpu_torch.bfv import get_context
    from sunscreen_tpu_torch.bfv.keys import GaloisKeys, KswKey
    from sunscreen_tpu_torch.compiler.lower import lower_program_sharded
    from sunscreen_tpu_torch.parallel import ici_model
    from sunscreen_tpu_torch.parallel import mesh as pm

    bl = pm.make_mesh((2, 2), ("batch", "limb"), "cpu")
    bc = pm.make_mesh((2, 2), ("batch", "coeff"), "cpu")
    batch = pm.make_mesh((WORLD,), ("batch",), "cpu")
    across = pm.make_mesh((1, WORLD), ("batch", "limb"), "cpu")

    ctx, _, rlk, _, cts = gate_setup()
    for name, fn in (("square", square), ("gate", square_plus)):
        mesh = batch if name == "square" else bl
        run = lower_program_sharded(compiled(fn, GATE_PARAMS), ctx, mesh)
        blk = pm.local_shard(cts, mesh, "batch", 0)
        if name == "gate":
            blk = pm.local_shard(blk, mesh, "limb", -2)
        with ici_model.collective_stats() as stats:
            out.save(name, run(blk, rlk=rlk)[0])
        out.stats(name, stats)
    ctx, rlk, gks, a, b, pts = every_setup()
    for mesh, d in ((bl, -2), (bc, -1)):
        axis = mesh.mesh_dim_names[1]
        spec = ("batch", None) + ((None, axis) if d == -1 else (axis, None))

        def blk(x, dim=d):
            return pm.local_shard(pm.local_shard(x, mesh, "batch", 0), mesh,
                                  axis, dim)

        run = lower_program_sharded(compiled(every_op, GATE_PARAMS), ctx,
                                    mesh, ct_spec=spec)
        for i, o in enumerate(run(blk(a), blk(b), rlk=rlk, gks=gks)):
            out.save(f"every_{axis}_{i}", o)
        # the plaintext rows sharded with the batch on one mesh and whole
        # on the other
        shard_pt = axis == "limb"
        run = lower_program_sharded(
            plain_program(), ctx, mesh, ct_spec=spec,
            pt_spec=("batch", None) if shard_pt else None)
        pt = pm.local_shard(pts, mesh, "batch", 0) if shard_pt else pts
        for i, o in enumerate(run(blk(a), pt)):
            out.save(f"plain_{axis}_{i}", o)

    try:
        lower_program_sharded(compiled(square, GATE_PARAMS), ctx, across)
        raised = ""
    except pm.IndivisibleAxis as e:
        raised = str(e)
    with open(os.path.join(out.workdir, f"indivisible_r{out.rank}.txt"),
              "w") as f:
        f.write(raised)

    inp = out.inputs()
    ctx = get_context(LOWER_PARAMS, "cpu")
    prog = compiled(workload, LOWER_PARAMS)
    rlk = KswKey(inp["rlk0"], inp["rlk1"])
    gks = GaloisKeys({int(inp["g"]): KswKey(inp["gk0"], inp["gk1"])})
    for name, mesh, spec, dim in (
            ("batch_limb", bl, None, -2),
            ("batch_coeff", bc, ("batch", None, None, "coeff"), -1)):
        axis = mesh.mesh_dim_names[1]
        a, b = (pm.local_shard(pm.local_shard(inp[v], mesh, "batch", 0),
                               mesh, axis, dim) for v in ("a", "b"))
        run = lower_program_sharded(prog, ctx, mesh, ct_spec=spec)
        with ici_model.collective_stats() as stats:
            out.save(name, run(a, b, rlk=rlk, gks=gks)[0])
        out.stats(name, stats)


SUITES = {"parallel": _parallel, "lower": _lower}


def main(suite: str, rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world)
    try:
        SUITES[suite](_Out(workdir, rank))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the test process's side
# ---------------------------------------------------------------------------

def spawn(suite: str, workdir: str) -> list:
    """Starts the WORLD ranks of `suite` in the background, each logging
    to DIR/rank<r>.log."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), suite, str(r),
                 str(WORLD), workdir], stdout=log, stderr=subprocess.STDOUT,
                env=env, cwd=REPO))
    return procs


def join(procs, workdir: str, timeout: float) -> None:
    """Waits for the ranks; once one fails or the time is up, stops the
    others and raises with every rank's log."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        if (time.monotonic() > deadline
                or any(p.returncode for p in procs if p.poll() is not None)):
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    if any(p.returncode for p in procs):
        logs = []
        for r, p in enumerate(procs):
            with open(os.path.join(workdir, f"rank{r}.log")) as f:
                logs.append(f"--- rank {r} (rc {p.returncode}) ---\n"
                            f"{f.read()[-4000:]}")
        raise RuntimeError("sharded test ranks failed:\n" + "\n".join(logs))


def write_inputs(workdir: str, **arrays) -> None:
    """The reference's arrays for the waiting ranks, made visible at
    once."""
    tmp = os.path.join(workdir, "inputs.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(workdir, "inputs.npz"))


def blocks(workdir: str, name: str) -> list[np.ndarray]:
    return [np.load(os.path.join(workdir, f"{name}_r{r}.npy"))
            for r in range(WORLD)]


def stats(workdir: str, name: str, rank: int = 0) -> dict:
    with open(os.path.join(workdir, f"{name}_r{rank}.json")) as f:
        return json.load(f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
