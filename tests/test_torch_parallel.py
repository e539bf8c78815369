"""The port's sharded execution (sunscreen_tpu_torch.parallel) against the
JAX package, on one gloo process group of 4 CPU ranks
(tests/torch_parallel_ranks.py) started once for the module: the tiled
all_to_all's index map, the distributed NTT's tables, product and round
trip, coefficient-sharded `multiply_relin`, the batch-sharded PBS, the
coefficient-sharded external product and the collective accounting.

The reference's own sharded calls are not run here: they compile the
unrolled DFTs inside an 8-device shard_map, minutes on this CPU. Each
sharded port result is held, exactly, against the reference's
single-device result at the reference tests' sizes, the equality that
tests/test_parallel.py asserts for the reference itself; the reference's
calls run jitted. The batch-sharded PBS is held against the port's own
single-process PBS, which
tests/test_torch_tfhe.py::test_pbs_matches_reference pins to the
reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as R

from sunscreen_tpu.bfv import BfvParams as RefParams
from sunscreen_tpu.bfv import get_context as ref_context
from sunscreen_tpu.bfv import keys as rkeys
from sunscreen_tpu.bfv import ops as rops
from sunscreen_tpu.math import ntt as rntt
from sunscreen_tpu.parallel import DistributedNttPlan as RefPlan
from sunscreen_tpu.parallel import ici_model as rici
from sunscreen_tpu.tfhe import ops as rtops
from sunscreen_tpu.tfhe import torus as rtorus
from sunscreen_tpu.tfhe.params import GlweDef as RefGlweDef
from sunscreen_tpu.tfhe.params import RadixDecomposition as RefRadix
from sunscreen_tpu_torch.bfv import BfvParams, get_context, keys, ops
from sunscreen_tpu_torch.math import ntt
from sunscreen_tpu_torch.parallel import DistributedNttPlan
from sunscreen_tpu_torch.parallel.ici_model import CollectiveStats
from sunscreen_tpu_torch.tfhe import ops as tops

BFV = (64, 2, 30)                    # tests/test_parallel.py:97's params
N_GLWE = 256


def _i64(a) -> np.ndarray:
    return np.asarray(a).view(np.int64) if np.asarray(a).dtype == np.uint64 \
        else np.asarray(a).astype(np.int64)


def _bfv_inputs():
    """The reference's keys and ciphertext at insecure(64, 2, 30) (its
    test's seeds), jitted; the relin key carried into the port's "pallas"
    domain through the coefficient domain."""
    n, limbs, bits = BFV
    rctx = ref_context(RefParams.insecure(poly_degree=n, limbs=limbs,
                                          limb_bits=bits))
    key = jax.random.key(5)
    sk = jax.jit(lambda k: rkeys.gen_secret_key(rctx, k))(
        jax.random.fold_in(key, 0))
    pk = jax.jit(lambda s, k: rkeys.gen_public_key(rctx, s, k))(
        sk, jax.random.fold_in(key, 1))
    rlk = jax.jit(lambda s, k: rkeys.gen_relin_key(rctx, s, k))(
        sk, jax.random.fold_in(key, 2))
    pt = (np.arange(n, dtype=np.uint64) * 31) % rctx.t
    ct = jax.jit(lambda p, k: rops.encrypt(rctx, p, jnp.asarray(pt), k))(
        pk, jax.random.fold_in(key, 3))
    ctx = get_context(BfvParams.insecure(n, limbs=limbs, limb_bits=bits),
                      "cpu")
    src = ntt.get_plan(n, ctx.key_mods, "cpu", rctx.plan_key.mode)
    carry = [ctx.plan_key.fwd(src.inv(torch.from_numpy(_i64(k))))
             for k in (rlk.k0, rlk.k1)]
    return rctx, ctx, sk, rlk, ct, carry


def _tfhe_inputs():
    """A GGSW of 1 and a GLWE of random bits at N = 256, radix (3, 4), from
    one batched reference `encrypt_glwe` (jitted): GGSW row (i, j) is an
    encryption of 0 with B_j added to coefficient 0 of component i."""
    glwe, radix = RefGlweDef(1, N_GLWE, 1e-16), RefRadix(3, 4)
    key = jax.random.key(43)
    sk = rtops.generate_binary_glwe_sk(glwe, jax.random.fold_in(key, 0))
    bits = np.random.default_rng(9).integers(0, 2, N_GLWE, dtype=np.uint64)
    msgs = jnp.concatenate([jnp.zeros((6, N_GLWE), jnp.uint64),
                            rtorus.encode(jnp.asarray(bits), 2)[None]])
    enc = np.array(jax.jit(rtops.encrypt_glwe, static_argnums=(2,))(
        msgs, sk, glwe, jax.random.fold_in(key, 1)))
    ggsw = enc[:6].reshape(2, 3, 2, N_GLWE)
    for i in range(2):
        for j in range(3):
            ggsw[i, j, i, 0] += np.uint64(1 << (60 - 4 * j))
    return glwe, radix, ggsw, enc[6]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Starts the 4 ranks, gives them the reference's arrays, computes the
    reference's single-device results while they run, and waits."""
    workdir = str(tmp_path_factory.mktemp("parallel"))
    procs = R.spawn("parallel", workdir)
    try:
        rctx, ctx, rsk, rlk, ct, carry = _bfv_inputs()
        glwe, radix, ggsw, glwe_ct = _tfhe_inputs()
        R.write_inputs(workdir, ct=_i64(ct), k0=carry[0].numpy(),
                       k1=carry[1].numpy(), ggsw=_i64(ggsw),
                       glwe=_i64(glwe_ct))
        moduli, a, b = R.neg_inputs()
        ref = {
            "neg": np.asarray(jax.jit(rntt.get_plan(
                R.NEG_N, moduli).negacyclic_mul)(
                jnp.asarray(a.astype(np.uint64)),
                jnp.asarray(b.astype(np.uint64)))),
            "bfv": np.asarray(jax.jit(
                lambda c, r: rops.multiply_relin(rctx, c, c, r))(ct, rlk)),
            "extprod": np.asarray(jax.jit(
                lambda g, c: rtops.external_product(g, c, glwe, radix))(
                ggsw, glwe_ct)),
            "ctx": ctx, "sk": keys.from_reference(
                ctx, s=np.asarray(rsk.s))[0],
        }
        R.join(procs, workdir, timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return workdir, ref


@pytest.mark.parametrize("split,concat", [(1, 2), (2, 1)])
def test_all_to_all_tiled(run, split, concat):
    """`mesh.all_to_all_tiled` gives every rank the blocks that
    `jax.lax.all_to_all(tiled=True)` gives it, on dntt.py's two axis
    pairs, over the 4-rank line and over the (2, 2) grid's second axis."""
    workdir, _ = run
    xs = [R.a2a_input(r).numpy() for r in range(R.WORLD)]
    for tag, groups in (("line", [list(range(R.WORLD))]),
                        ("grid", [[0, 1], [2, 3]])):
        got = R.blocks(workdir, f"a2a_{tag}_{split}{concat}")
        for group in groups:
            d = len(group)
            for j, r in enumerate(group):
                want = np.concatenate(
                    [np.split(xs[src], d, axis=split)[j] for src in group],
                    axis=concat)
                np.testing.assert_array_equal(got[r], want)


def test_plan_tables_match_reference():
    """The distributed plan's tables equal the reference's bit for bit:
    n = 256 on two 50-bit primes, n = 64 on a u32 product base."""
    from sunscreen_tpu.math import primes as rprimes
    ctx = get_context(BfvParams.insecure(64, limbs=2, limb_bits=30), "cpu")
    for n, moduli in ((256, tuple(rprimes.gen_ntt_primes(50, 2, 256))),
                      (64, ctx.mul_base.moduli)):
        ref, got = RefPlan(n, moduli), DistributedNttPlan(n, moduli, "cpu")
        assert (got.n1, got.n2) == (ref.n1, ref.n2)
        for name in ("w1", "w1_inv", "w2", "w2_inv", "tw", "tw_inv",
                     "twist_t", "untwist_t", "n_inv"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), _i64(getattr(ref, name)),
                err_msg=f"{name} at n={n}")


def test_distributed_negacyclic_mul_matches_reference(run):
    """`make_distributed_negacyclic_mul` over 4 ranks at n = 256 on two
    50-bit primes (the 128-bit Barrett DFTs) equals the reference's
    `ntt.get_plan(n, moduli).negacyclic_mul`."""
    workdir, ref = run
    k = ref["neg"].shape[0]
    got = np.concatenate(R.blocks(workdir, "neg"), axis=-1)
    np.testing.assert_array_equal(got.reshape(k, R.NEG_N),
                                  _i64(ref["neg"]))


def test_distributed_roundtrip_is_identity(run):
    """inv_local(fwd_local(x)) == x over 4 ranks: one 50-bit prime at
    n = 128 and the 5-limb u32 product base at n = 64 (int64 DFTs)."""
    workdir, _ = run
    for n, mods, x in R.roundtrip_cases():
        p = DistributedNttPlan(n, mods, "cpu")
        got = np.concatenate(R.blocks(workdir, f"roundtrip_{n}"), axis=-1)
        np.testing.assert_array_equal(got, x.reshape(len(mods), p.n1, p.n2))


def test_sharded_multiply_relin_matches_reference(run):
    """`sharded_relin_key` then `sharded_multiply_relin` over 4 ranks at
    insecure(64, 2, 30) equals the reference's single-device
    `multiply_relin` on its ciphertext and relin key, and decrypts as
    it does."""
    workdir, ref = run
    got = np.concatenate(R.blocks(workdir, "bfv"), axis=-1).reshape(
        ref["bfv"].shape)
    np.testing.assert_array_equal(got, _i64(ref["bfv"]))
    ctx, sk = ref["ctx"], ref["sk"]
    np.testing.assert_array_equal(
        ops.decrypt(ctx, sk, torch.from_numpy(got)).numpy(),
        ops.decrypt(ctx, sk, torch.from_numpy(_i64(ref["bfv"]))).numpy())


def test_batch_sharded_pbs_matches_single_process(run):
    """`batch_sharded_pbs` of 8 ciphertexts, 2 a rank, equals the port's
    PBS of the whole batch in one process (pinned to the reference by
    tests/test_torch_tfhe.py::test_pbs_matches_reference) and decrypts
    to (m + 1) mod 2."""
    workdir, _ = run
    args, lwe_sk, msgs = R.pbs_setup()
    want = tops.programmable_bootstrap_univariate(*args)
    got = torch.from_numpy(np.concatenate(R.blocks(workdir, "pbs")))
    assert torch.equal(got, want)
    assert torch.equal(tops.decrypt_lwe(got, lwe_sk, 2), (msgs + 1) % 2)


def test_coeff_sharded_external_product_matches_reference(run):
    """`coeff_sharded_external_product` on the (2, 2) grid's coefficient
    axis (both groups compute it) equals the reference's
    `tops.external_product`."""
    workdir, ref = run
    blocks = R.blocks(workdir, "extprod")
    for group in ([0, 1], [2, 3]):
        got = np.concatenate([blocks[r] for r in group], axis=-1)
        np.testing.assert_array_equal(got.reshape(2, N_GLWE),
                                      _i64(ref["extprod"]))


def test_collective_accounting(run, monkeypatch):
    """`CollectiveStats.link_seconds` and `predict_efficiency` reproduce
    the reference's ring forms at a given bandwidth, and the counters
    read three all_to_alls for one distributed product, each of the full
    [k, N1, N2] array's bytes."""
    from sunscreen_tpu_torch.parallel.ici_model import predict_efficiency
    workdir, _ = run
    bw = 1.25e11
    monkeypatch.setitem(rici.ICI_BW, "test", bw)
    vols = {"all-to-all": 3 << 20, "all-gather": 5 << 20,
            "all-reduce": 7 << 20, "reduce-scatter": 11 << 20,
            "collective-permute": 13 << 20}
    counts = dict.fromkeys(vols, 1)
    ours = CollectiveStats(bytes=dict(vols), count=dict(counts))
    theirs = rici.CollectiveStats(bytes=dict(vols), count=dict(counts))
    for d in (1, 2, 4, 8):
        assert ours.link_seconds(d, bw) == theirs.ici_seconds(d, "test")
        assert predict_efficiency(1e-3, ours, d, bw, 0.25) == \
            rici.predict_efficiency(1e-3, theirs, d, "test", 0.25)
    assert ours.total_bytes() == theirs.total_bytes()
    full = 2 * R.NEG_N * 8
    for r in range(R.WORLD):
        st = R.stats(workdir, "neg", r)
        assert st == {"bytes": {"all-to-all": 3 * full},
                      "count": {"all-to-all": 3}}
