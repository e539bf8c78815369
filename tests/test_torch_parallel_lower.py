"""`lower_program_sharded` (sunscreen_tpu_torch.compiler.lower) against
the JAX package's `lower_program`, on one gloo process group of 4 CPU
ranks (tests/torch_parallel_ranks.py) started once for the module:
tests/test_parallel.py's program (`a * b`, `<< 1`, `+ a - b`) with batch
x limb and batch x coefficient sharding, a batch-sharded squaring and
the multichip dry run's `multiply_relin(a, a) + a` behind decrypt gates,
every other node kind and plaintext arguments against the port's
unsharded lowering, the collectives each layout needs, and the named
error of an axis the mesh does not divide.

The reference runs its single-device `lower_program` (jitted) at the
reference test's `insecure(64, limbs=2, limb_bits=40)` on ciphertexts
and keys of uniform residues: every node is a deterministic function of
its arrays, so equality on arbitrary words holds the whole graph, and
the decrypt gates hold its meaning on the port's own keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as R

from sunscreen_tpu import types as rtypes
from sunscreen_tpu.bfv import BfvParams as RefParams
from sunscreen_tpu.bfv import get_context as ref_context
from sunscreen_tpu.bfv.keys import GaloisKeys as RefGaloisKeys
from sunscreen_tpu.bfv.keys import KswKey as RefKswKey
from sunscreen_tpu.compiler import Compiler as RefCompiler
from sunscreen_tpu.compiler import fhe_program as ref_fhe_program
from sunscreen_tpu.compiler.lower import lower_program as ref_lower
from sunscreen_tpu_torch.bfv import ops


@ref_fhe_program(scheme="bfv")
def workload(a: rtypes.Cipher[rtypes.Batched],
             b: rtypes.Cipher[rtypes.Batched]):
    prod = a * b
    rot = prod << 1
    return rot + a - b


def _uniform(rng, shape, moduli) -> np.ndarray:
    """Residues below each modulus along axis -2: [..., k, N]."""
    q = np.array(moduli, dtype=np.int64)[:, None]
    return rng.integers(0, 1 << 62, shape, dtype=np.int64) % q


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Starts the 4 ranks (the gate scenarios need nothing from here),
    gives them the reference's arrays, runs the reference's program while
    they work, and waits."""
    workdir = str(tmp_path_factory.mktemp("parallel_lower"))
    procs = R.spawn("lower", workdir)
    try:
        p = R.LOWER_PARAMS
        rp = RefParams(p.poly_degree, p.plain_modulus, p.coeff_modulus,
                       p.special_modulus, p.security_level)
        rctx = ref_context(rp)
        rng = np.random.default_rng(18)
        n, k = p.poly_degree, len(p.coeff_modulus)
        kmods = p.coeff_modulus + (p.special_modulus,)
        arr = {"a": _uniform(rng, (R.LOWER_BATCH, 2, k, n), p.coeff_modulus),
               "b": _uniform(rng, (R.LOWER_BATCH, 2, k, n), p.coeff_modulus),
               "g": np.array(rctx.rotate_rows_element(1))}
        for name in ("rlk0", "rlk1", "gk0", "gk1"):
            arr[name] = _uniform(rng, (k, k + 1, n), kmods)
        R.write_inputs(workdir, **arr)

        def ksw(x, y):
            return RefKswKey(jnp.asarray(arr[x].astype(np.uint64)),
                             jnp.asarray(arr[y].astype(np.uint64)))

        prog = (RefCompiler().with_params(rp).fhe_program(workload)
                .compile().get_program(workload))
        single = ref_lower(prog, rctx, rlk=ksw("rlk0", "rlk1"),
                           gks=RefGaloisKeys({int(arr["g"]):
                                              ksw("gk0", "gk1")}))
        want = np.asarray(single(*(jnp.asarray(arr[v].astype(np.uint64))
                                   for v in ("a", "b")))[0])
        R.join(procs, workdir, timeout=300)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    return workdir, want.view(np.int64)


def _grid(blocks, dim: int) -> np.ndarray:
    """Blocks of a (2, 2) mesh (batch, second axis): the second axis's
    blocks joined along `dim`, then the batch."""
    return np.concatenate([np.concatenate(blocks[2 * i:2 * i + 2], axis=dim)
                           for i in range(2)])


def _negacyclic(a: np.ndarray, b: np.ndarray, t: int) -> np.ndarray:
    n = a.shape[-1]
    full = np.stack([np.convolve(x, y) for x, y in zip(a, b)])
    full = np.pad(full, ((0, 0), (0, 1)))
    return (full[:, :n] - full[:, n:]) % t


def _gathers(stats, nbytes: int, count: int) -> None:
    assert stats == {"bytes": {"all-gather": nbytes},
                     "count": {"all-gather": count}}


@pytest.mark.parametrize("layout,dim", [("batch_limb", -2),
                                        ("batch_coeff", -1)])
def test_lower_program_sharded_matches_reference(run, layout, dim):
    """The program over a (2, 2) mesh, batch x limb (the default spec) or
    batch x coefficient, equals the reference's `lower_program` bit for
    bit; each rank all-gathers a and b once, for the multiply, and the
    rest (relinearize and rotation on whole values, the adds on blocks)
    needs no collective."""
    workdir, want = run
    got = _grid(R.blocks(workdir, layout), dim)
    np.testing.assert_array_equal(got, want)
    half = want[:R.LOWER_BATCH // 2]
    for r in range(R.WORLD):
        _gathers(R.stats(workdir, layout, r), 2 * half.nbytes, 2)


def test_batch_sharded_multiply_decrypts_to_square(run):
    """`a * a` over the batch axis of 4 ranks (2 rows each, no
    collective) decrypts to the negacyclic square of every row."""
    workdir = run[0]
    ctx, sk, _, pts, _ = R.gate_setup()
    got = torch.from_numpy(np.concatenate(R.blocks(workdir, "square")))
    dec = ops.decrypt(ctx, sk, got).numpy()
    p = pts.numpy()
    np.testing.assert_array_equal(dec, _negacyclic(p, p, ctx.t))
    for r in range(R.WORLD):
        assert R.stats(workdir, "square", r) == {"bytes": {}, "count": {}}


def test_dryrun_gate_batch_limb(run):
    """The multichip dry run's step, `multiply_relin(a, a) + a`, over the
    (2, 2) batch x limb mesh decrypts to p p + p on every row; one
    all-gather of a's limbs a rank."""
    workdir = run[0]
    ctx, sk, _, pts, cts = R.gate_setup()
    got = torch.from_numpy(_grid(R.blocks(workdir, "gate"), -2))
    dec = ops.decrypt(ctx, sk, got).numpy()
    p = pts.numpy()
    np.testing.assert_array_equal(dec, (_negacyclic(p, p, ctx.t) + p)
                                  % ctx.t)
    half = cts[:R.GATE_BATCH // 2].numpy()
    for r in range(R.WORLD):
        _gathers(R.stats(workdir, "gate", r), half.nbytes, 1)


@pytest.mark.parametrize("axis,dim", [("limb", -2), ("coeff", -1)])
def test_every_op_and_plaintext_args_match_unsharded(run, axis, dim):
    """Every node kind tracing emits (the plain ops on a literal, negate,
    both shifts, the row swap) and a hand-built program over a plaintext
    argument (batch-sharded on the limb mesh, whole on the coefficient
    mesh), over (2, 2) batch x limb and batch x coefficient meshes, equal
    the port's unsharded `lower_program`, which
    tests/test_torch_compiler.py::test_run_matches_reference pins to the
    reference's."""
    from sunscreen_tpu_torch.compiler.lower import lower_program
    workdir = run[0]
    ctx, rlk, gks, a, b, pts = R.every_setup()
    for name, prog, args in (
            ("every", R.compiled(R.every_op, R.GATE_PARAMS), (a, b)),
            ("plain", R.plain_program(), (a, pts))):
        want = lower_program(prog, ctx)(*args, rlk=rlk, gks=gks)
        for i, w in enumerate(want):
            got = _grid(R.blocks(workdir, f"{name}_{axis}_{i}"), dim)
            np.testing.assert_array_equal(got, w.numpy(),
                                          err_msg=f"{name} output {i}")


def test_indivisible_limb_axis_raises(run):
    """Two limbs over a limb axis of 4 raise `IndivisibleAxis` on every
    rank, as the reference's jit raises `ValueError`."""
    workdir = run[0]
    for r in range(R.WORLD):
        with open(f"{workdir}/indivisible_r{r}.txt") as f:
            assert "not divisible by mesh axis 'limb' of size 4" in f.read()
