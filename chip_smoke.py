#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --against OTHER_TREE [--phase msm]

Builds the port's CUDA kernels from `sunscreen_tpu_torch/csrc` (printing
ptxas' registers, stack and spills of the kernels in ntt.cu, tensor3.cu,
inv_ks.cu, ks_full.cu, inv_tensor3.cu, pntt.cu, rns.cu and msm.cu with each
one's threads and shared memory a block, and the IMAD-class and total SASS
instructions of rns_convert, rns_scale and scale_convert), holds each of the
twenty-two kernel entry points bit for bit against its plain
PyTorch twin at the shapes of the main path (N=8192,
`BfvParams.default_u32`, batch 64; the TFHE blind-rotation step for
`ks_full_limbs`; the "pallas_vpu" plan's multiply and encryption shapes
for B16 and B17; [512, 8192] u64 words under a 54-bit limb of
`BfvParams.default(8192)` for B18 and B19) and again at the
`default_u32(16384)` shapes (batch 2; B16 also at N=128 and on the
encoder's (t,) plan, B17 with broadcast operands; B18 and B19 under the
moduli of tests/test_pallas_mod.py and a 61-bit prime, edge values and
broadcast tables included, also against a big-int oracle; B1 and B3
also at the TFHE step's [384, 4, 1024] and B5 at its [64, 6, 4, 1024],
B1 at the 16-digit step's [1024, 4, 1024] and B5 and B15 on its digits
[64, 16, 4, 1024],
B4, B5, B6, B7, B9, B12 and B13 at `default_u32(16384)`'s shapes at batch 64,
B6, B7, B9, B10, B16 and B17 at the "pallas_vpu" multiply's shapes at
`default_u32(32768)` (59 limbs in the product base), all timed with their
bounds; B14 and B15 also timed beside the two kernels each replaces,
B2 + B5 and, at both TFHE steps, B1 + B5, on the same inputs), holds B1-B5,
B12-B15 at every N from 256 to 16384 and B16 from 128 to 32768
(`transform_checks`: edge residues, raw words up to 2^32 - 1, a 30-bit
and three small moduli), holds M1 (the Pippenger MSM over ristretto255,
csrc/msm.cu) against its plain version and the host C++ MSM by ristretto
encoding at n = 2049, 4096 and 65536, a second launch against the first
one's raw bytes, and times the three, each of M1's three kernels and the
chain floor, the join's own time (`check_msm`; after path 23 again at the
SDLP's l and at the largest MSM paths 22-23 launched, `msm_case`),
then drives thirty-one paths, each with the launch counts set to 0 just
before it and read just after:

1. keygen, encryption and batched ct×ct `multiply_relin` at N=8192,
   batch 64, under the default fusion settings;
2. Galois keygen and the rotations `rotate_rows(ct, 1)` and
   `rotate_columns(ct)` on the same ciphertexts;
3. `multiply_relin` at `default_u32(16384)`, batch 64: the tensor
   product runs B4, then B3, as at N=8192; 3b. path 3's `multiply_relin`
   under `SUNSCREEN_TPU_FUSE_TFULL=1` (B13 alone);
4. path 1's `multiply_relin` under the reference's unfused settings
   (`SUNSCREEN_TPU_FUSE_FT3=0`, `_SC=0`, `_KS=0`: kernels B9-B11);
5. path 1's `multiply_relin` under `SUNSCREEN_TPU_FUSE_FT3=0
   SUNSCREEN_TPU_FUSE_T3=1` (kernel B12);
6. path 1's `multiply_relin` under `SUNSCREEN_TPU_FUSE_KSFULL=1` (the
   keyswitch megakernel B14);
7. TFHE: keygen at LWE_512_80 -> GLWE_1_1024_80, the NTT-domain bootstrap
   key, and the univariate programmable bootstrap of 64 ciphertexts
   (512 blind-rotation steps of B1 + B5, sample extraction, keyswitch);
8. path 7's PBS under `SUNSCREEN_TPU_TFHE_KSFULL=1` (B15 per step);
9. `SUNSCREEN_TPU_NTT=pallas_vpu` with `SUNSCREEN_TPU_FUSE_FT3=0` (the
   only setting under which the reference's plan multiplies), batch 64:
   keygen, BatchEncoder, encryption, the 3-component `multiply` and
   `multiply_plain` (B16, B17, no B1-B5); `relinearize` must raise;
10. path 1's `multiply_relin` under `SUNSCREEN_TPU_FUSE_TFULL=1` (B13);
11. the BFV user flow at batch 8 under the default settings: encode,
    encrypt, the plain ops, `exponentiate`, `multiply_many`,
    `rotate_rows`, `mod_switch_to_next`, decode;
12. B18 and B19 through `pallas_mod.shoup_mul_mod`, `pallas_mod.mul_mod`
    and `pallas_kernels.make_pointwise_mul_mod` on [512, 8192] under
    `default(8192)`'s four moduli, full and broadcast tables, against
    the twins and a big-int oracle, with their rates;
13. the u64 engine: `multiply_relin` at `BfvParams.default(8192)`, batch
    64, default settings (mode "pallas", degraded to "matmul" as the
    reference degrades it), plain PyTorch on the card with no kernel
    launch, and `rotate_rows`;
14. golden_v1.npz's `bfv_*` vectors decrypted on the card under
    `SUNSCREEN_TPU_NTT=unrolled` and `=compact`, then path 13's
    `multiply_relin` under "unrolled";
15. path 9 at `default_u32(32768)` (29 limbs in Q, 59 in the product
    base), batch 64: B16 at N=32768 and B7 at 59 limbs; 15b. path 15's
    `multiply` under `SUNSCREEN_TPU_FUSE_SC=0` on its ciphertexts: B9
    from 59 limbs into B, then B6 back to Q, in place of B7;
16. the multifunctional PBS of three functions on path 7's keys and
    ciphertexts (one blind rotation, three outputs a row);
17. keygen at radix (8, 4) (16 digits a blind-rotation step) and the
    bivariate PBS a AND b of 64 pairs;
18. circuit bootstrapping of 64 bits on path 17's keys (out radix
    (2, 8)); 18b. one batch of it under `SUNSCREEN_TPU_TFHE_KSFULL=1`
    (B15 at 16 digits);
19. the rest of TFHE at batch 8 on path 17's keys: the generalized PBS,
    GLEV encryption and CMUX, the scheme switch, the GLWE and public
    functional keyswitches, LWE and RLWE public-key encryption;
20. the compiler and runtime: `@fhe_program` -> `Compiler` (measured
    search on, engine auto) -> `Runtime.new_fhe` on simple_multiply,
    chi_sq and chi_sq_optimized (examples/) and a `Batched` program of
    every IR op kind with the default Galois keys, at the searched
    `default_u32(8192)` chain, batch 1: B1-B8 through `bfv/ops.py`;
21. the ZKP compiler and runtime: benchmarks/zkp_bench.py's fractional
    range proof (1024 gates) through `@zkp_program` -> `Compiler` ->
    `Runtime.new_zkp` on the card, prove and verify, the multiexps of
    2048 points and more on M1; 21b. path 21 under `SUNSCREEN_TPU_MSM=0`
    (every multiexp on the host C++);
22. the SDLP of benchmarks/sdlp_bench.py at
    `BfvParams.insecure(1024, limbs=2, limb_bits=28)`: keygen and
    `encrypt_return_components` on the card, `BfvStatements` ->
    `build` -> `LogProofGenerators(l)` -> `create` and `verify`, every
    MSM of 2048 points or more on M1; 22b. path 22's proof under
    `SUNSCREEN_TPU_MSM=0`;
23. tests/test_linked.py's `prod_balance` linked proof (SDLP,
    Bulletproofs and the compressed bridge) through `Runtime.new_fhe_zkp`
    -> `LogProofBuilder` at path 22's parameters;
24. (run after path 16, on path 7's key) `tfhe/zkp.py`'s SDLP of an
    `LWE_512_80` encryption;
25. (run after path 24, on path 1's, 2's and 7's keys) sharded execution
    (`sunscreen_tpu_torch.parallel`, `lower_program_sharded`) at world
    size 1 under NCCL in this process: the distributed negacyclic product
    at N=8192 on the 15-limb product base, `sharded_relin_key` and
    `sharded_multiply_relin` on one ciphertext, the coefficient-sharded
    external product at GLWE_1_1024_80, `batch_sharded_pbs` of path 7's
    ciphertexts, and tests/test_parallel.py's program and the dry run's
    `multiply_relin(a, a) + a` (`__graft_entry__.py:51`) lowered on a
    batch x limb mesh; 25b. the same at world size 2 under gloo, two
    processes on cuda:0 (`--sharded-rank`, on this process's build and
    inputs), with a limb-sharded run at `insecure_u32(8192, limbs=6,
    limb_bits=28)` and a batch x coefficient run.

Paths 1-3, 7 and 16-18 pass a decrypt (18: CMUX) gate and a card-vs-CPU
bit-exact check on one ciphertext; paths 4-6 and 10 must give path 1's
output, 3b path 3's, 8 path 7's, 15b path 15's and 18b path 18's, bit
for bit; paths 9 and 15 pass a slot-wise gate on every row and a
card-vs-CPU multiply; path 11 a slot-wise gate on every output; paths
13 and 14 the decrypt gate, a card-vs-CPU check and the rotation or
golden gates; path 19 a decrypt gate per op and a card-vs-CPU check per
deterministic op; path 20 the searched-params, decrypt and slot gates, a
card-vs-CPU `run`, two key sets and a serialization round trip; paths 21
and 21b verify, refuse another constant and an out-of-range witness, and
under seeded blindings give the CPU's proof bytes, and each other's;
path 22 verifies, refuses a changed T, a flipped bit of z_1 and a
witness past its bound, gives the CPU's bytes under seeded blindings and
launches M1 as often as `linear_relation.msm_sizes` predicts, 22b gives
its bytes with no M1 launch; path 23 verifies, not with a larger
transfer, with a bridge under 8192 bytes and a ciphertext decrypting to
its balance; path 24 verifies, not after b changes, with M1's predicted
launches; in paths 25 and 25b every sharded result, its blocks joined,
equals the unsharded port's on the card bit for bit, the sharded product
decrypts to the numpy square and the dry run's step to p p + p (also at
N/2, the linearity check of the collective bytes), and B6, B9 and B8 are
held against their twins at the sharded multiply's N/2 columns.
Paths 1-10, 12-15b, 16-18, 20-25b are then timed, and all but 21b,
22b, 24 and 25b profiled; a profile window, bounded on the
device clock by two marker spins, whose kernel events differ from the
launch counts is taken again, and the run fails if three retries differ
too. Kernel times are device times: each timed run is queued behind a
spin that outlasts the host's launches. Prints the card, each kernel's
times and launch counts as one JSON line, the rates, and as the last line
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
no GPU is visible or any check fails.

With --against OTHER_TREE (another checkout of this repo, such as a
`git archive` of the parent commit) it runs that tree's chip_smoke.py and
this one in turns on the same card (other, this, this, other), keeps the
four logs under chiprun_out/compare/ and prints each number both report
(kernel times, rates, each profiled cell's device time by kernel) side
by side, then each side's SASS counts; it fails if any of the four runs
fails. With --phase msm each of the four turns runs only its tree's M1
phase (`check_msm`): the A/B of a change to csrc/msm.cu, in minutes.
"""

import contextlib
import functools
import glob
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

DEV = "cuda"
N = 8192
BATCH = 64
ITERS, REPS = 20, 5          # timed ops: median of REPS x ITERS batches
WIDE_N, WIDE_BATCH = 16384, 2   # kernel checks at the widest bases
VPU_N = 32768                   # path 15: the largest u32 parameter set
GATES = ("SUNSCREEN_TPU_FUSED_RNS", "SUNSCREEN_TPU_FUSE_INV",
         "SUNSCREEN_TPU_FUSE_FT3", "SUNSCREEN_TPU_FUSE_T3",
         "SUNSCREEN_TPU_FUSE_TFULL", "SUNSCREEN_TPU_FUSE_SC",
         "SUNSCREEN_TPU_FUSE_KS", "SUNSCREEN_TPU_FUSE_KSFULL",
         "SUNSCREEN_TPU_TFHE_KSFULL", "SUNSCREEN_TPU_NTT",
         "SUNSCREEN_TPU_COMPACT_NTT", "SUNSCREEN_TPU_MEASURED_SEARCH",
         "SUNSCREEN_TPU_MSM")
UNFUSED = {"SUNSCREEN_TPU_FUSE_FT3": "0", "SUNSCREEN_TPU_FUSE_SC": "0",
           "SUNSCREEN_TPU_FUSE_KS": "0"}
T3 = {"SUNSCREEN_TPU_FUSE_FT3": "0", "SUNSCREEN_TPU_FUSE_T3": "1"}
KSFULL = {"SUNSCREEN_TPU_FUSE_KSFULL": "1"}

# The H100 SXM's published peaks (NVIDIA data sheet): HBM at 3.35 TB/s;
# 67 TFLOP/s fp32 outside the tensor cores, i.e. 33.5 T FMA/s, and
# 32-bit integer multiplies issue at half the FMA rate on compute
# capability 9.0 (64 vs 128 per SM per clock).
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_MULS_PER_S = 16.75e12
WORD = 8                     # residues are int64 in and out


# The H100 SXM's top SM clock: a spin of c cycles (torch.cuda._sleep) lasts
# at least c / SPIN_HZ seconds.
SPIN_HZ = 1.98e9
SPIN_DOUBLINGS = 4
KERNEL_ITERS = 20            # calls per timed run in the kernel phase


def _median_ms(fn, reps: int, iters: int) -> float:
    """Device time of one call of fn in ms: the median over `reps` runs of
    `iters` calls back to back, between two CUDA events. Each run is
    queued behind a spin kernel sized to outlast the host's queueing of
    the run, so the events time the device's work and not the launch
    cost of the wrappers. A run whose spin ended before the host had
    queued it all (the start event already passed) is taken again with
    a spin twice as long, up to SPIN_DOUBLINGS times; after that the
    remaining runs are kept as they are and the line says so."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2 * iters * host_s * SPIN_HZ) + 1
    doublings = 0
    times = []
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if not covered and doublings < SPIN_DOUBLINGS:
            cycles *= 2
            doublings += 1
            continue
        if not covered:
            print(f"timing: the host outran a {cycles / SPIN_HZ * 1e3:.1f} "
                  f"ms spin; this run includes launch gaps", flush=True)
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


def _negacyclic_square(a: np.ndarray, t: int) -> np.ndarray:
    """a*a mod (x^N + 1, t) for 0 <= a < t < 2^20, exact: the plain
    product is one big-integer square with a 64-bit slot per coefficient
    (Kronecker substitution); every slot sum is below N t^2 < 2^54."""
    n = a.shape[0]
    big = int.from_bytes(a.astype("<u8").tobytes(), "little")
    conv = np.frombuffer((big * big).to_bytes(16 * n, "little"), dtype="<u8")
    return np.mod(conv[:n].astype(np.int64) - conv[n:].astype(np.int64), t)


def _automorphism(pts: np.ndarray, g: int, t: int) -> np.ndarray:
    """a(x) -> a(x^g) mod (x^N + 1, t) on plaintext rows [..., N]."""
    n = pts.shape[-1]
    j = np.arange(n) * g % (2 * n)
    out = np.empty_like(pts)
    out[..., j % n] = np.where(j < n, pts, -pts)
    return np.mod(out, t)


def _uniform(gen, shape, q):
    """Residues < q per limb: shape [..., k, N] against q [k, 1]."""
    import torch
    return torch.randint(0, 1 << 62, shape, generator=gen,
                         device=DEV, dtype=torch.int64) % q


def _max_digits(x, base):
    """Sets column 0 of every row of x [..., k, N] to the value whose
    normalized digits y_i are all q_i - 1, the largest limb sums a fused
    conversion can meet, and column 1 to -1 (all q_i - 1)."""
    import torch
    col = [(q - 1) * (p % q) % q for q, p in zip(base.moduli, base.punctured)]
    x[..., :, 0] = torch.tensor(col, dtype=torch.int64, device=x.device)
    x[..., :, 1] = base.q[:, 0] - 1
    return x


def _held(name, kern, plain, args) -> int:
    """Runs a kernel and its plain twin on the same inputs; exits unless
    they agree bit for bit. Returns the max abs error (0)."""
    import torch
    got = kern(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    if isinstance(got, tuple):          # B19's (hi, lo) halves
        got, want = torch.stack(got), torch.stack(want)
    err = int((got - want).abs().max().item())
    exact = torch.equal(got, want)
    print(f"check {name}: shape {tuple(got.shape)} bit-exact={exact} "
          f"(tolerance 0: integer arithmetic)", flush=True)
    if not exact:
        raise SystemExit(f"kernel {name} disagrees with its plain twin "
                         f"(max abs err {err})")
    return err


def _max_residues(x, q):
    """Sets coefficient 0 of every limb of x [..., k, N] to q - 1."""
    x[..., 0] = q[:, 0] - 1
    return x


def _scale_counts(scaler, cols: int) -> tuple[int, int]:
    """B9's bytes and 32-bit multiplies on `cols` columns: each digit
    normalized (2) and times a 128-bit fraction (8), each digit into each
    limb sum (2), r into each limb (2)."""
    return (cols * (scaler.ks + scaler.kd) * WORD,
            cols * (10 * scaler.ks + 2 * scaler.ks * scaler.kd
                    + 2 * scaler.kd))


def _convert_case(conv, x) -> tuple:
    """B6 as the multiply's base extension (centered, the source limbs
    copied ahead) on x [..., ks, N]: (kernel, plain twin, args, bytes,
    32-bit multiplies)."""
    ks, kd = conv.ks, conv.kd
    cols = x.numel() // ks
    return (lambda v: conv(v, include_src=True, centered=True),
            lambda v: conv.call_plain(v, include_src=True, centered=True),
            (x,), cols * (2 * ks + kd) * WORD,
            cols * (10 * ks + 2 * ks * kd + 2 * kd))


def kernel_cases(ctx, gen, batch: int) -> list[tuple]:
    """Every kernel entry point at the shapes `multiply_relin` and the
    rotations give it for `batch` ciphertexts of `ctx`: (name, kernel,
    plain twin, args, source, replaces, bytes, 32-bit multiplies).
    Multiplies count 3 per Shoup butterfly and per 1/N scaling, 2 per
    32x32->64 product: in the RNS kernels 2 to normalize a digit, 8 for a
    digit times a 128-bit fraction, 2 per term of a limb contraction or
    correction."""
    import torch
    from sunscreen_tpu_torch.math import prns

    n, logn = ctx.n, ctx.n.bit_length() - 1
    pm, pk = ctx.plan_mul, ctx.plan_key
    k, km, kk, kdig = ctx.k, pm.k, pk.k, ctx.k
    ntt_muls = 3 * (n // 2) * logn        # Shoup butterfly: 3 multiplies
    conv = prns.fused_converter(ctx.conv_q_to_aux)
    scaler = prns.fused_scaler(ctx.scale_mul_to_aux)
    sc = ctx.fused_op("scale_convert")
    t3 = ctx.fused_op("tensor3")
    ksi = ctx.fused_op("ks_inner")
    mdo = prns.fused_mod_down(ctx.mod_down)
    src_rns = "sunscreen_tpu_torch/csrc/rns.cu"
    src_ntt = "sunscreen_tpu_torch/csrc/ntt.cu"
    src_pw = "sunscreen_tpu_torch/csrc/pointwise.cu"
    x_cv = _max_digits(_uniform(gen, (batch, 4, conv.ks, n), ctx.q_base.q),
                       ctx.q_base)
    x_sc = _max_digits(_uniform(gen, (batch, 3, sc.ks, n), ctx.mul_base.q),
                       ctx.mul_base)
    cols_sc = batch * 3 * n
    both = _uniform(gen, (batch, 2, kk, n), ctx.key_base.q)
    cols_md = batch * 2 * n
    # the multiply's operand stack [batch, 4, km, N]: a and b are its halves
    ab = _max_residues(_uniform(gen, (batch, 4, km, n), pm.q), pm.q)
    a_hat, b_hat = ab[:, :2], ab[:, 2:]
    rows_fi = batch * 4
    x_fi = _uniform(gen, (rows_fi, km, n), pm.q)
    x_fb = torch.randint(0, 1 << 32, (batch * kdig, n), generator=gen,
                         device=DEV, dtype=torch.int64)
    d_ks = _max_residues(_uniform(gen, (batch, kdig, kk, n), pk.q), pk.q)
    k0 = _max_residues(_uniform(gen, (kdig, kk, n), pk.q), pk.q)
    k1 = _uniform(gen, (kdig, kk, n), pk.q)
    polys_fi = rows_fi * km
    cols_pm = batch * km * n
    cols_pk = batch * kk * n
    kernel, plain, args, nbytes, muls = _convert_case(conv, x_cv)
    cases = [
        ("convert", kernel, plain, args, src_rns,
         "sunscreen_tpu/math/prns.py:264", nbytes, muls),
        ("scale_convert", sc, sc.call_plain, (x_sc,), src_rns,
         "sunscreen_tpu/math/prns.py:608",
         cols_sc * (sc.ks + sc.kd) * WORD,
         cols_sc * (10 * sc.ks + 2 * sc.ks * sc.km + 10 * sc.km
                    + 2 * sc.km * sc.kd + 2 * sc.kd)),
        ("mod_down",
         lambda b: mdo(b[..., :k, :], b[..., k, :]),
         lambda b: mdo.call_plain(b[..., :k, :], b[..., k, :]),
         (both,), src_rns, "sunscreen_tpu/math/prns.py:495",
         cols_md * (2 * k + 1) * WORD, cols_md * 2 * k),
        ("scale", scaler, scaler.call_plain, (x_sc,), src_rns,
         "sunscreen_tpu/math/prns.py:264", *_scale_counts(scaler, cols_sc)),
        ("tensor3", t3, t3.call_plain, (a_hat, b_hat), src_pw,
         "sunscreen_tpu/math/prns.py:343",
         (2 + 2 + 3) * cols_pm * WORD, 8 * cols_pm),
        ("ks_inner", ksi, ksi.call_plain, (d_ks, k0, k1), src_pw,
         "sunscreen_tpu/math/prns.py:410",
         (batch * kdig + 2 * kdig + batch * 2) * kk * n * WORD,
         4 * kdig * cols_pk),
        ("fwd", pm.fwd, pm.fwd_plain, (x_fi,), src_ntt,
         "sunscreen_tpu/math/pmntt.py:354",
         2 * polys_fi * n * WORD, polys_fi * ntt_muls),
        ("fwd_broadcast", pk.fwd_broadcast, pk.fwd_broadcast_plain, (x_fb,),
         src_ntt, "sunscreen_tpu/math/pmntt.py:354",
         (batch * kdig * n + batch * kdig * kk * n) * WORD,
         batch * kdig * kk * ntt_muls),
        ("inv", pm.inv, pm.inv_plain, (x_fi,), src_ntt,
         "sunscreen_tpu/math/pmntt.py:354",
         2 * polys_fi * n * WORD, polys_fi * (ntt_muls + 3 * n)),
        ("inv_tensor3", pm.inv_tensor3, pm.inv_tensor3_plain, (a_hat, b_hat),
         "sunscreen_tpu_torch/csrc/inv_tensor3.cu",
         "sunscreen_tpu/math/pmntt.py:427",
         (2 + 2 + 3) * cols_pm * WORD, batch * km * inv_tensor3_muls(n)),
        ("inv_ks", pk.inv_ks, pk.inv_ks_plain, (d_ks, k0, k1),
         "sunscreen_tpu_torch/csrc/inv_ks.cu",
         "sunscreen_tpu/math/pmntt.py:500",
         (batch * kdig + 2 * kdig + batch * 2) * kk * n * WORD,
         # 2 kdig digit products (2 each) + 2 inverse transforms
         batch * kk * (4 * kdig * n + 2 * (ntt_muls + 3 * n))),
        ("ks_full", pk.ks_full, pk.ks_full_plain,
         (x_fb.reshape(batch, kdig, n), k0, k1), SRC_KS_FULL,
         "sunscreen_tpu/math/pmntt.py:620",
         (batch * kdig + 2 * kdig * kk + batch * 2 * kk) * n * WORD,
         ks_full_muls(batch, kdig, kk, n)),
        *tensor3_cases(pm, gen, batch)]
    return cases


SRC_TENSOR3 = "sunscreen_tpu_torch/csrc/tensor3.cu"


def tensor3_cases(pm, gen, batch: int) -> list[tuple]:
    """B4 and B13 on the multiply's operand stack [batch, 4, k, N] of the
    plan `pm`: (name, kernel, plain twin, args, source, replaces, bytes,
    32-bit multiplies)."""
    n = pm.n
    ntt_muls = 3 * (n // 2) * pm.logn
    x = _uniform(gen, (batch, 4, pm.k, n), pm.q)
    nbytes = (4 + 3) * batch * pm.k * n * WORD
    return [("fwd_tensor3", pm.fwd_tensor3, pm.fwd_tensor3_plain, (x,),
             SRC_TENSOR3, "sunscreen_tpu/math/pmntt.py:715", nbytes,
             # 4 transforms + 4 products of 32x32 -> 64 bits (2 each)
             batch * pm.k * (4 * ntt_muls + 8 * n)),
            ("fwd_tensor3_full", lambda v: pm.fwd_tensor3(v, full=True),
             pm.fwd_tensor3_full_plain, (x,), SRC_TENSOR3,
             "sunscreen_tpu/math/pmntt.py:715", nbytes,
             # B4's work + 3 inverse transforms with the 1/N scaling
             batch * pm.k * (4 * ntt_muls + 8 * n + 3 * (ntt_muls + 3 * n)))]


def inv_tensor3_muls(n: int) -> int:
    """B12's 32-bit multiplies per (row, limb): 4 products of 32x32 -> 64
    bits (2 each) and 3 inverse transforms with the 1/N scaling."""
    return 8 * n + 3 * (3 * (n // 2) * (n.bit_length() - 1) + 3 * n)


SRC_PNTT = "sunscreen_tpu_torch/csrc/pntt.cu"


def pntt_checks(plan, gen, rows: int) -> list[tuple]:
    """B16 forward and inverse on [rows, k, N] of a pallas_vpu plan, with
    their bounds: (name, kernel, plain twin, args, source, replaces,
    bytes, 32-bit multiplies)."""
    n, k = plan.n, plan.k
    ntt_muls = 3 * (n // 2) * plan.logn
    x = _max_residues(_uniform(gen, (rows, k, n), plan.q), plan.q)
    nbytes = 2 * rows * k * n * WORD
    return [("pntt_fwd", plan.fwd, plan.fwd_plain, (x,), SRC_PNTT,
             "sunscreen_tpu/math/pntt.py:395", nbytes, rows * k * ntt_muls),
            ("pntt_inv", plan.inv, plan.inv_plain, (x,), SRC_PNTT,
             "sunscreen_tpu/math/pntt.py:395", nbytes,
             rows * k * (ntt_muls + 3 * n))]


def vpu_kernel_cases(params, gen, batch: int) -> list[tuple]:
    """B16 at the pallas_vpu multiply's [4 batch, 15, 8192] and B17 at the
    encryption's [batch, 15, 8192] against a full operand, with `a * b % q`
    on the same tensors as its library call."""
    from sunscreen_tpu_torch.bfv import get_context
    from sunscreen_tpu_torch.math import ntt

    plan = ntt.get_plan(params.poly_degree,
                        get_context(params, DEV).mul_base.moduli, DEV,
                        "pallas_vpu")
    n, k = plan.n, plan.k
    a = _max_residues(_uniform(gen, (batch, k, n), plan.q), plan.q)
    b = _max_residues(_uniform(gen, (batch, k, n), plan.q), plan.q)
    return pntt_checks(plan, gen, 4 * batch) + [
        ("pntt_pmul", plan.pointwise_mul, plan.pointwise_mul_plain, (a, b),
         SRC_PNTT, "sunscreen_tpu/math/pntt.py:452", 3 * batch * k * n * WORD,
         # one 32x32 -> 64-bit product (2) per residue
         2 * batch * k * n, lambda x, y: x * y % plan.q)]


def vpu_extra_checks(params, gen, batch: int) -> None:
    """B16 at the widest and the smallest plans and at the encoder's
    [batch, 1, 8192] over (t,); B17 with a broadcast [k, N] operand (the
    public key against every row) and [batch, 1, k, N] against
    [batch, 3, k, N] (the plaintext against every component)."""
    from sunscreen_tpu_torch.bfv import BfvParams, get_context
    from sunscreen_tpu_torch.math import ntt, primes

    wide = BfvParams.default_u32(WIDE_N)
    plans = [
        (ntt.get_plan(WIDE_N, get_context(wide, DEV).mul_base.moduli, DEV,
                      "pallas_vpu"), batch),
        (ntt.get_plan(128, tuple(primes.gen_ntt_primes(30, 2, 128)), DEV,
                      "pallas_vpu"), 8),
        (ntt.get_plan(params.poly_degree, (params.plain_modulus,), DEV,
                      "pallas_vpu"), batch)]
    for plan, rows in plans:
        for name, kern, plain, args, *_ in pntt_checks(plan, gen, rows):
            _held(f"{name}@[{rows},{plan.k},{plan.n}]", kern, plain, args)
    plan = ntt.get_plan(params.poly_degree,
                        get_context(params, DEV).mul_base.moduli, DEV,
                        "pallas_vpu")
    n, k = plan.n, plan.k
    x = _max_residues(_uniform(gen, (batch, 3, k, n), plan.q), plan.q)
    key = _max_residues(_uniform(gen, (k, n), plan.q), plan.q)
    _held(f"pntt_pmul(broadcast [{k},{n}])", plan.pointwise_mul,
          plan.pointwise_mul_plain, (x, key))
    _held("pntt_pmul(broadcast components)", plan.pointwise_mul,
          plan.pointwise_mul_plain, (x, x[:, :1]))


SRC_KS_FULL = "sunscreen_tpu_torch/csrc/ks_full.cu"


def ks_full_muls(rows: int, kdig: int, k: int, n: int) -> int:
    """32-bit multiplies of B14/B15 per call: per (row, limb) kdig forward
    transforms, 2 kdig digit products (2 each), 2 inverse transforms."""
    ntt_muls = 3 * (n // 2) * (n.bit_length() - 1)
    return rows * k * (kdig * ntt_muls + 4 * kdig * n
                       + 2 * (ntt_muls + 3 * n))


def _pbs_plan():
    """The u32 NTT plan of GLWE_1_1024_80's torus plan (four 30-bit
    primes, N=1024)."""
    from sunscreen_tpu_torch.tfhe import GLWE_1_1024_80, poly

    return poly.get_torus_plan_u32(GLWE_1_1024_80.poly_degree,
                                   device=DEV).plan


def pbs_kernel_case(gen, batch: int, kdig: int = 6) -> tuple:
    """B15 at the blind-rotation step of path 7 (kdig 6) or of paths 17-19
    (16): digit residues [batch, kdig, 4, 1024] against one NTT
    bootstrap-key row [kdig, 4, 1024] per GLWE component."""
    plan = _pbs_plan()
    n, k = plan.n, plan.k
    d = _max_residues(_uniform(gen, (batch, kdig, k, n), plan.q), plan.q)
    k0 = _max_residues(_uniform(gen, (kdig, k, n), plan.q), plan.q)
    k1 = _uniform(gen, (kdig, k, n), plan.q)
    return ("ks_full_limbs", plan.ks_full_limbs, plan.ks_full_limbs_plain,
            (d, k0, k1), SRC_KS_FULL, "sunscreen_tpu/math/pmntt.py:620",
            (batch * kdig * k + 2 * kdig * k + batch * 2 * k) * n * WORD,
            ks_full_muls(batch, kdig, k, n))


def ks_full_extremes(plan, gen, batch: int) -> None:
    """B14 and B15 at 16 and 20 digits with every digit at its largest
    value (2^32 - 1 raw, q - 1 per limb) and every key at q - 1."""
    import torch

    n, k = plan.n, plan.k
    for kdig in (16, 20):
        top = torch.broadcast_to(plan.q - 1, (kdig, k, n)).contiguous()
        raw = torch.full((batch, kdig, n), (1 << 32) - 1, dtype=torch.int64,
                         device=DEV)
        _held(f"ks_full(kdig={kdig})@{n}", plan.ks_full, plan.ks_full_plain,
              (raw, top, top))
        limbs = torch.broadcast_to(top, (batch, kdig, k, n)).contiguous()
        _held(f"ks_full_limbs(kdig={kdig})@{n}", plan.ks_full_limbs,
              plan.ks_full_limbs_plain, (limbs, top, top))


def extra_checks(ctx, gen, batch: int) -> None:
    """Kernel calls off the table's shapes: B6 on the conv_aux_to_q tables
    (the aux -> Q conversion after B9, 8 -> 7 limbs at N=8192, without
    the source copy), and B11 at 20 digits, where its sums fold, with
    every digit and key at q - 1."""
    import torch
    from sunscreen_tpu_torch.math import prns

    n = ctx.n
    aux = prns.fused_converter(ctx.conv_aux_to_q)
    x = _max_digits(_uniform(gen, (batch, 3, aux.ks, n), ctx.aux_base.q),
                    ctx.aux_base)
    _held(f"convert(aux->q)@{n}",
          lambda v: aux(v, centered=True),
          lambda v: aux.call_plain(v, centered=True), (x,))
    ksi = ctx.fused_op("ks_inner")
    kdig, pk = 20, ctx.plan_key
    top = torch.broadcast_to(pk.q - 1, (kdig, pk.k, n)).contiguous()
    d = torch.cat([top.unsqueeze(0),
                   _uniform(gen, (batch, kdig, pk.k, n), pk.q)])
    _held(f"ks_inner(kdig={kdig})@{n}", ksi, ksi.call_plain, (d, top, top))
    ks_full_extremes(pk, gen, 2)


SRC_U64 = "sunscreen_tpu_torch/csrc/u64mod.cu"
U64_ROWS = 512               # B18/B19 operands [512, 8192]
# tests/test_pallas_mod.py's moduli (2^31 - 1 also serves the library
# comparison: its products fit int64)
EDGE_MODULI = ((1 << 31) - 1, (1 << 50) - 27, (1 << 56) - 5,
               0x3FFFFFFFFFFFFFE3)
# 32-bit multiplies per element: a 64-bit low product 4, a high product 8
SHOUP_MULS = 16              # lo(w x), hi(x w_sh), lo(hi q)
BARRETT_MULS = 40            # the 128-bit product 8, Barrett-128 32
ORACLE_SAMPLES = 4096


def _shoup_table(w, q: int):
    """floor(w 2^64 / q) for residues w < q, on w's device: r = w 2^64
    mod q by the 128-bit Barrett reduction, then the exact quotient
    (w 2^64 - r) / q as -r q^-1 mod 2^64 (q is odd)."""
    import torch
    from sunscreen_tpu_torch.math import modular as m
    r_hi, r_lo = m.barrett_ratio(q)
    r = m.barrett_reduce_128(w, torch.zeros_like(w), q, m.s64(r_hi),
                             m.s64(r_lo))
    return -r * m.s64(pow(q, -1, 1 << 64))


def _u64_operands(gen, q: int, rows: int, n: int):
    """x in [0, 2q) and a, w in [0, q), each [rows, n], with the edge
    values x = 2q - 1, a = w = q - 1 and 0 in row 0."""
    import torch
    top = min(2 * q, 1 << 62)

    def draw(high):
        return torch.randint(0, 1 << 62, (rows, n), generator=gen,
                             device=DEV, dtype=torch.int64) % high

    x, a, w = draw(top), draw(q), draw(q)
    x[0, :2] = torch.tensor([2 * q - 1, 0], device=DEV)
    a[0, :2] = torch.tensor([q - 1, 0], device=DEV)
    w[0, :3] = torch.tensor([q - 1, q - 1, 0], device=DEV)
    return x, a, w


def _oracle(label, got, x, w, q: int) -> None:
    """got == x w mod q with python ints on ORACLE_SAMPLES elements
    (the first two and a fixed random sample); exits otherwise."""
    flat = got.numel()
    idx = np.concatenate([[0, 1], np.random.default_rng(12).integers(
        0, flat, ORACLE_SAMPLES - 2)])
    xs, ws, gs = (np.asarray(v.reshape(-1).cpu().numpy()[idx])
                  .view(np.uint64).astype(object)
                  for v in (x.expand_as(got), w.expand_as(got), got))
    if not np.array_equal(gs, xs * ws % q):
        raise SystemExit(f"{label}: differs from the big-int oracle")


def _b19(q: int):
    """B19's entry point and its plain twin, each fn(a_hi, a_lo, b_hi,
    b_lo) -> (hi, lo) on halves."""
    from sunscreen_tpu_torch.math import pallas_kernels as pk
    return (pk.make_pointwise_mul_mod(q, DEV),
            lambda *h: pk.mul_mod_kernel(*h, q))


def _halves(a, b) -> tuple:
    """(a_hi, a_lo, b_hi, b_lo) of u64 words a, b: B19's inputs."""
    from sunscreen_tpu_torch.math import pallas_kernels as pk
    return (*pk.split_u64(a), *pk.split_u64(b))


def u64_kernel_cases(params, gen) -> list[tuple]:
    """B18 and B19 on [512, 8192] under the first 54-bit limb of
    `default(8192)` with full tables: (name, kernel, plain twin, args,
    source, replaces, bytes, 32-bit multiplies). No PyTorch call forms
    the 128-bit product of 54-bit residues, so none has a library call
    here (`u64_checks` times one at 31 bits)."""
    from sunscreen_tpu_torch.math import pallas_mod as pm

    q = params.coeff_modulus[0]
    x, a, w = _u64_operands(gen, q, U64_ROWS, params.poly_degree)
    w_sh = _shoup_table(w, q)
    e = x.numel()
    return [
        ("shoup_mul_mod", lambda *v: pm.shoup_mul_mod(*v, q),
         lambda *v: pm.shoup_mul_mod_plain(*v, q), (x, w, w_sh), SRC_U64,
         "sunscreen_tpu/math/pallas_mod.py:209", 4 * e * WORD,
         SHOUP_MULS * e),
        ("mul_mod", lambda *v: pm.mul_mod(*v, q),
         lambda *v: pm.mul_mod_plain(*v, q), (a, w), SRC_U64,
         "sunscreen_tpu/math/pallas_mod.py:237", 3 * e * WORD,
         BARRETT_MULS * e),
        ("pointwise_mul_mod", *_b19(q), _halves(a, w), SRC_U64,
         "sunscreen_tpu/math/pallas_kernels.py:152", 6 * e * WORD,
         BARRETT_MULS * e)]


def u64_checks(gen) -> dict[str, dict]:
    """B18 and B19 on every modulus of EDGE_MODULI and the 61-bit NTT prime
    of tests/test_pallas.py, [64, 8192] with the edge values, full and
    broadcast [8192] tables, against the twins and the big-int oracle;
    then each entry point's device time at 2^31 - 1 beside the same
    function as a PyTorch expression on the same words (`x * w % q`,
    `a * w % q`: exact there, products below 2^62). B19 takes halves,
    which no PyTorch call does: its line shows `a * w % q` on the words,
    which moves half its bytes."""
    from sunscreen_tpu_torch.math import pallas_mod as pm
    from sunscreen_tpu_torch.math import primes

    for q in EDGE_MODULI + (primes.gen_ntt_primes(61, 1, 128)[0],):
        x, a, w = _u64_operands(gen, q, 64, N)
        for tag, wt in (("full", w), ("broadcast", w[1])):
            ws = _shoup_table(wt, q)
            label = f"@{q.bit_length()}b {tag}"
            got = pm.shoup_mul_mod(x, wt, ws, q)
            _held(f"shoup_mul_mod{label}", lambda *v: pm.shoup_mul_mod(*v, q),
                  lambda *v: pm.shoup_mul_mod_plain(*v, q), (x, wt, ws))
            _oracle(f"shoup_mul_mod{label}", got, x, wt, q)
            got = pm.mul_mod(a, wt, q)
            _held(f"mul_mod{label}", lambda *v: pm.mul_mod(*v, q),
                  lambda *v: pm.mul_mod_plain(*v, q), (a, wt))
            _oracle(f"mul_mod{label}", got, a, wt, q)
        halves = _halves(a, w)
        _held(f"pointwise_mul_mod@{q.bit_length()}b", *_b19(q), halves)
        hi, lo = _b19(q)[0](*halves)
        _oracle(f"pointwise_mul_mod@{q.bit_length()}b", hi * (1 << 32) + lo,
                a, w, q)
    q = EDGE_MODULI[0]
    x, a, w = _u64_operands(gen, q, U64_ROWS, N)
    w_sh = _shoup_table(w, q)
    fn, halves = _b19(q)[0], _halves(a, w)
    # (kernel call, the same function as one PyTorch expression on words,
    # or None where the kernel's operands are halves)
    at31 = {"shoup_mul_mod": (lambda: pm.shoup_mul_mod(x, w, w_sh, q),
                              lambda: x * w % q),
            "mul_mod": (lambda: pm.mul_mod(a, w, q), lambda: a * w % q),
            "pointwise_mul_mod": (lambda: fn(*halves), None)}
    out = {}
    for name, (kern, lib) in at31.items():
        ms = _median_ms(kern, reps=5, iters=KERNEL_ITERS)
        lib_ms = (_median_ms(lib, reps=5, iters=KERNEL_ITERS)
                  if lib else None)
        print(f"time {name} at q = 2^31 - 1 [{U64_ROWS}, {N}]: kernel "
              f"{ms:.4f} ms, "
              + (f"library {lib_ms:.4f} ms" if lib else
                 f"no library call on halves (a * b % q on words, half "
                 f"the bytes: {out['mul_mod']['library_ms']:.4f} ms)"),
              flush=True)
        out[name] = {"ms": ms, "library_ms": lib_ms}
    return out


def _timing(label, kern, plain, args, nbytes: int, muls: int,
            library=None) -> dict:
    """A kernel's device time on prepared inputs beside its plain twin's,
    its bound (bytes or 32-bit multiplies, whichever takes longer) and,
    where given, one PyTorch call computing the same function."""
    ms = _median_ms(lambda: kern(*args), reps=5, iters=KERNEL_ITERS)
    plain_ms = _median_ms(lambda: plain(*args), reps=3, iters=2)
    library_ms = (_median_ms(lambda: library(*args), reps=5,
                             iters=KERNEL_ITERS) if library else None)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = muls / PEAK_INT_MULS_PER_S * 1e3
    print(f"time {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB "
          f"= {t_bytes:.4f} ms, {muls / 1e9:.4f} G 32-bit multiplies "
          f"= {t_ops:.4f} ms)"
          + (f", library {library_ms:.4f} ms" if library else ""),
          flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def _inv_ks_case(plan, gen, batch: int, kdig: int) -> tuple:
    """B5 on digits [batch, kdig, k, N] and keys [kdig, k, N] of `plan`,
    the first digit row and key row at q - 1: (args, bytes, 32-bit
    multiplies: 2 kdig digit products (2 each) + 2 inverse transforms)."""
    k, n = plan.k, plan.n
    ntt_muls = 3 * (n // 2) * plan.logn
    d = _max_residues(_uniform(gen, (batch, kdig, k, n), plan.q), plan.q)
    k0 = _max_residues(_uniform(gen, (kdig, k, n), plan.q), plan.q)
    k1 = _uniform(gen, (kdig, k, n), plan.q)
    return ((d, k0, k1),
            (batch * kdig + 2 * kdig + batch * 2) * k * n * WORD,
            batch * k * (4 * kdig * n + 2 * (ntt_muls + 3 * n)))


def pbs_transform_cases(gen, batch: int) -> list[tuple]:
    """B1 and B3 at the blind-rotation step's [6 batch, 4, 1024] and B5 at
    its digits [batch, 6, 4, 1024] (path 7 runs B1 and B5 there 512 times
    per PBS): (name, kernel, plain twin, args, bytes, 32-bit
    multiplies)."""
    plan = _pbs_plan()
    rows, k, n = 6 * batch, plan.k, plan.n
    ntt_muls = 3 * (n // 2) * plan.logn
    x = _max_residues(_uniform(gen, (rows, k, n), plan.q), plan.q)
    nbytes = 2 * rows * k * n * WORD
    return [("fwd", plan.fwd, plan.fwd_plain, (x,), nbytes,
             rows * k * ntt_muls),
            ("inv", plan.inv, plan.inv_plain, (x,), nbytes,
             rows * k * (ntt_muls + 3 * n)),
            ("inv_ks", plan.inv_ks, plan.inv_ks_plain,
             *_inv_ks_case(plan, gen, batch, 6))]


FINE_KDIG = 16               # digits a step at the bootstrap radix (8, 4)


def fine_pbs_cases(gen, batch: int) -> list[tuple]:
    """B1 at the blind-rotation step of paths 17-19 ([16 batch, 4, 1024]),
    and B5 and B15 on its digits [batch, 16, 4, 1024] (name, kernel,
    plain twin, args, bytes, 32-bit multiplies)."""
    plan = _pbs_plan()
    rows, k, n = FINE_KDIG * batch, plan.k, plan.n
    x = _max_residues(_uniform(gen, (rows, k, n), plan.q), plan.q)
    b15 = pbs_kernel_case(gen, batch, FINE_KDIG)
    return [("fwd", plan.fwd, plan.fwd_plain, (x,), 2 * rows * k * n * WORD,
             rows * k * 3 * (n // 2) * plan.logn),
            ("inv_ks", plan.inv_ks, plan.inv_ks_plain,
             *_inv_ks_case(plan, gen, batch, FINE_KDIG)),
            (b15[0], b15[1], b15[2], b15[3], b15[6], b15[7])]


def wide_cases(gen, batch: int) -> list[tuple]:
    """B4, B5, B6, B7, B9, B12 and B13 at path 3's shapes
    (`default_u32(16384)`, `batch` ciphertexts): digits [batch, 14, 15,
    16384] with 1024 threads a task, the extension [batch, 4, 14, 16384]
    -> [batch, 4, 29, 16384], the 29-limb tensor base [batch, 3, 29,
    16384] -> [batch, 3, 14, 16384] (B7; B9 into the 15 limbs of B, as
    under `SUNSCREEN_TPU_FUSE_SC=0`), B12's operands, the halves of
    [batch, 4, 29, 16384], and B4's and B13's [batch, 4, 29, 16384]
    (1024 threads and 192 KB a task), the all-(q_i - 1) digit columns and
    residues included (name, kernel, plain twin, args, bytes, 32-bit
    multiplies)."""
    from sunscreen_tpu_torch.bfv import BfvParams, get_context
    from sunscreen_tpu_torch.math import prns

    ctx = get_context(BfvParams.default_u32(WIDE_N), DEV)
    sc = ctx.fused_op("scale_convert")
    scaler = prns.fused_scaler(ctx.scale_mul_to_aux)
    conv = prns.fused_converter(ctx.conv_q_to_aux)
    x = _max_digits(_uniform(gen, (batch, 3, sc.ks, WIDE_N), ctx.mul_base.q),
                    ctx.mul_base)
    x_cv = _max_digits(_uniform(gen, (batch, 4, conv.ks, WIDE_N),
                                ctx.q_base.q), ctx.q_base)
    cols = batch * 3 * WIDE_N
    pm = ctx.plan_mul
    ab = _max_residues(_uniform(gen, (batch, 4, pm.k, WIDE_N), pm.q), pm.q)
    return [("inv_ks", ctx.plan_key.inv_ks, ctx.plan_key.inv_ks_plain,
             *_inv_ks_case(ctx.plan_key, gen, batch, ctx.k)),
            ("convert", *_convert_case(conv, x_cv)),
            ("scale_convert", sc, sc.call_plain, (x,),
             cols * (sc.ks + sc.kd) * WORD,
             cols * (10 * sc.ks + 2 * sc.ks * sc.km + 10 * sc.km
                     + 2 * sc.km * sc.kd + 2 * sc.kd)),
            ("scale", scaler, scaler.call_plain, (x,),
             *_scale_counts(scaler, cols)),
            ("inv_tensor3", pm.inv_tensor3, pm.inv_tensor3_plain,
             (ab[:, :2], ab[:, 2:]),
             (2 + 2 + 3) * batch * pm.k * WIDE_N * WORD,
             batch * pm.k * inv_tensor3_muls(WIDE_N)),
            *((name, kern, plain, args, nbytes, muls) for
              name, kern, plain, args, _, _, nbytes, muls in
              tensor3_cases(pm, gen, batch))]


def vpu_wide_cases(gen, batch: int) -> list[tuple]:
    """Path 15's kernels at its shapes (`default_u32(32768)` under
    "pallas_vpu", `batch` ciphertexts): the extension [batch, 4, 29, N]
    -> [batch, 4, 59, N], B16 on [4 batch, 59, N] (1024 threads of 32
    coefficients and 128 KB a polynomial), B10 on the halves of
    [batch, 4, 59, N], the 59-limb tensor base [batch, 3, 59, N] ->
    [batch, 3, 29, N] (B7, B9 into the 30 limbs of B), and B17 on the
    plaintext against both components, [batch, 2, 29, N] by
    [batch, 1, 29, N], with `a * b % q` as its library call (name,
    kernel, plain twin, args, bytes, 32-bit multiplies[, library])."""
    from sunscreen_tpu_torch.bfv import BfvParams, get_context
    from sunscreen_tpu_torch.math import ntt, prns

    ctx = get_context(BfvParams.default_u32(VPU_N), DEV, "pallas_vpu")
    n, qb, mb = VPU_N, ctx.q_base, ctx.mul_base
    conv = prns.fused_converter(ctx.conv_q_to_aux)
    sc = ctx.fused_op("scale_convert")
    scaler = prns.fused_scaler(ctx.scale_mul_to_aux)
    t3 = ctx.fused_op("tensor3")
    x_cv = _max_digits(_uniform(gen, (batch, 4, qb.k, n), qb.q), qb)
    x_sc = _max_digits(_uniform(gen, (batch, 3, mb.k, n), mb.q), mb)
    ab = _max_residues(_uniform(gen, (batch, 4, mb.k, n), mb.q), mb.q)
    cols = batch * 3 * n
    pq = ntt.get_plan(n, qb.moduli, DEV, "pallas_vpu")
    ct = _max_residues(_uniform(gen, (batch, 2, qb.k, n), qb.q), qb.q)
    pt = _uniform(gen, (batch, 1, qb.k, n), qb.q)
    return [("convert", *_convert_case(conv, x_cv)),
            *((name, kern, plain, args, nbytes, muls) for
              name, kern, plain, args, _, _, nbytes, muls in
              pntt_checks(ctx.plan_mul, gen, 4 * batch)),
            ("tensor3", t3, t3.call_plain, (ab[:, :2], ab[:, 2:]),
             (2 + 2 + 3) * batch * mb.k * n * WORD, 8 * batch * mb.k * n),
            ("scale_convert", sc, sc.call_plain, (x_sc,),
             cols * (sc.ks + sc.kd) * WORD,
             cols * (10 * sc.ks + 2 * sc.ks * sc.km + 10 * sc.km
                     + 2 * sc.km * sc.kd + 2 * sc.kd)),
            ("scale", scaler, scaler.call_plain, (x_sc,),
             *_scale_counts(scaler, cols)),
            ("pntt_pmul", pq.pointwise_mul, pq.pointwise_mul_plain, (ct, pt),
             (2 + 1 + 2) * batch * qb.k * n * WORD, 2 * 2 * batch * qb.k * n,
             lambda x, y: x * y % pq.q)]


def unfused_pairs(ctx) -> dict[str, tuple]:
    """The two kernels each megakernel replaces, as one call on the
    megakernel's inputs: B14 = B2 then B5 under the key plan, B15 = B1
    then B5 under the TFHE step's plan ({name: (label, call)})."""
    pk, pbs = ctx.plan_key, _pbs_plan()
    return {"ks_full": ("fwd_broadcast + inv_ks",
                        lambda d, k0, k1: pk.inv_ks(pk.fwd_broadcast(d),
                                                    k0, k1)),
            "ks_full_limbs": ("fwd + inv_ks",
                              lambda d, k0, k1: pbs.inv_ks(pbs.fwd(d),
                                                           k0, k1))}


def check_kernels(ctx, gen) -> list[dict]:
    """Each kernel entry point against its plain twin at the main-path
    shapes, bit for bit, with both times, the bound and, where one
    PyTorch expression computes the same function, its time; B14 and B15
    also against the pair of kernels each replaces, on the same inputs,
    bit for bit and timed; B1 and B3 also at the PBS step's shape, B5
    there too, B4-B7, B9, B12 and B13 at path 3's shapes, and B6, B7, B9,
    B10, B16 and B17 at path 15's."""
    rows = []
    from sunscreen_tpu_torch.bfv import BfvParams

    pairs = unfused_pairs(ctx)
    for (name, kern, plain, args, src, repl, nbytes, muls,
         *library) in (kernel_cases(ctx, gen, BATCH)
                       + [pbs_kernel_case(gen, BATCH)]
                       + vpu_kernel_cases(ctx.params, gen, BATCH)
                       + u64_kernel_cases(BfvParams.default(N), gen)):
        err = _held(name, kern, plain, args)
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": 0, "max_abs_err": err,
            **_timing(name, kern, plain, args, nbytes, muls,
                      library[0] if library else None)})
        if name in pairs:
            label, pair = pairs[name]
            _held(f"{name} == {label}", kern, pair, args)
            pair_ms = _median_ms(lambda: pair(*args), reps=5,
                                 iters=KERNEL_ITERS)
            print(f"time {name} beside {label}: kernel "
                  f"{rows[-1]['ms']:.4f} ms, the pair {pair_ms:.4f} ms "
                  f"(kernel / pair {rows[-1]['ms'] / pair_ms:.4f})",
                  flush=True)
            rows[-1]["unfused_pair"] = {"kernels": label, "ms": pair_ms}
    at = {}
    for where, cases in (("at_pbs_step", pbs_transform_cases),
                         ("at_pbs_step_16", fine_pbs_cases),
                         (f"at_{WIDE_N}", wide_cases),
                         (f"at_{VPU_N}", vpu_wide_cases)):
        for name, kern, plain, args, nbytes, muls, *library in cases(
                gen, BATCH):
            shape = list(args[0].shape)
            _held(f"{name}@{shape}", kern, plain, args)
            at.setdefault(name, {})[where] = {
                "shape": shape, **_timing(f"{name} at {shape}", kern, plain,
                                          args, nbytes, muls, *library)}
            if name == "ks_full_limbs":        # beside B1 + B5 at 16 digits
                label, pair = pairs[name]
                _held(f"{name}@{shape} == {label}", kern, pair, args)
                at[name][where]["unfused_pair"] = {
                    "kernels": label,
                    "ms": _median_ms(lambda: pair(*args), reps=5,
                                     iters=KERNEL_ITERS)}
                print(f"time {name} at {shape} beside {label}: the pair "
                      f"{at[name][where]['unfused_pair']['ms']:.4f} ms",
                      flush=True)
    extra_checks(ctx, gen, BATCH)
    ks_full_extremes(_pbs_plan(), gen, 2)
    vpu_extra_checks(ctx.params, gen, BATCH)
    at31 = u64_checks(gen)
    for row in rows:
        if row["name"] in at31:
            row["at_q_2_31_minus_1"] = at31[row["name"]]
        row.update(at.get(row["name"], {}))
    return rows


def check_wide(gen) -> None:
    """Every kernel but fwd_tensor3 at the default_u32(16384) shapes:
    N=16384 transforms (128 KB of shared memory per block for B1-B3 and
    B5, 192 KB for B12), a 29-limb multiply base whose limb
    sums fold, and 14 keyswitch digits."""
    from sunscreen_tpu_torch.bfv import BfvParams, get_context

    ctx = get_context(BfvParams.default_u32(WIDE_N), DEV)
    print(f"wide bases: N={WIDE_N} k={ctx.k} mul base {ctx.mul_base.k} "
          f"limbs, batch {WIDE_BATCH}", flush=True)
    for name, kern, plain, args, *_ in kernel_cases(ctx, gen, WIDE_BATCH):
        _held(f"{name}@{WIDE_N}", kern, plain, args)
    extra_checks(ctx, gen, WIDE_BATCH)


def transform_checks(gen, rows: int = 3) -> None:
    """B1-B5, B12-B16 wherever the schedule of csrc/transform.cuh changes:
    fwd, fwd_broadcast, inv, inv_ks, inv_tensor3 (operands the halves
    of one stack, read through their row strides), fwd_tensor3 and
    fwd_tensor3_full at every N from 256 to 16384, pntt_fwd and pntt_inv
    (the [t', s'] exchange) from 128 to 32768 (radix-8 groups at 256,
    radix-16 above, radix-32 and one exchange buffer at 32768, 2 to 4
    groups, several polynomials per block below 8192, a block's spare
    slots when rows * k is not a multiple of them; inv_ks in both of its
    block shapes, with 16 digits and every key word of k0 at q - 1),
    ks_full and ks_full_limbs at every N (6 digits, both block shapes);
    under one limb at the largest 30-bit NTT prime (the
    lazy butterflies' values reach 4q - 1 < 2^32) and three small ones
    (17 + log2 N - 8 bits).
    Residues include 0 and q - 1 in every polynomial and a polynomial of
    q - 1 only, and one word above 2^62 in the others (the loads' 64-bit
    reduction; below 2^32 they take a 32-bit one); fwd_broadcast's raw
    words include 2^32 - 1 and a row of them."""
    import torch
    from sunscreen_tpu_torch.math import pmntt, pntt, primes

    for logn in range(7, 16):
        n = 1 << logn
        for k, bits in ((1, 30), (3, max(17, 17 + logn - 8))):
            plan = pntt.PallasNttPlan(
                n, tuple(primes.gen_ntt_primes(bits, k, n)), DEV)
            x = _uniform(gen, (rows, k, n), plan.q)
            x[..., 0] = plan.q[:, 0] - 1
            x[..., 2] = (1 << 62) + 12345   # the loads' 64-bit reduction
            x[0] = plan.q - 1
            for name, kern, plain in (("pntt_fwd", plan.fwd, plan.fwd_plain),
                                      ("pntt_inv", plan.inv, plan.inv_plain)):
                _held(f"{name}@[{rows},{k},{n}] {bits}b", kern, plain, (x,))
    for logn in range(8, 15):
        n = 1 << logn
        for k, bits in ((1, 30), (3, 17 + logn - 8)):
            plan = pmntt.NttPlanU32(
                n, tuple(primes.gen_ntt_primes(bits, k, n)), DEV)
            x = _uniform(gen, (rows, k, n), plan.q)
            x[..., 0] = plan.q[:, 0] - 1
            x[..., 1] = 0
            x[..., 2] = (1 << 62) + 12345   # the loads' 64-bit reduction
            x[0] = plan.q - 1
            raw = torch.randint(0, 1 << 32, (rows, n), generator=gen,
                                device=DEV, dtype=torch.int64)
            raw[:, 0] = (1 << 32) - 1
            raw[0] = (1 << 32) - 1
            tag = f"@[{rows},{k},{n}] {bits}b"
            _held(f"fwd{tag}", plan.fwd, plan.fwd_plain, (x,))
            _held(f"fwd_broadcast{tag}", plan.fwd_broadcast,
                  plan.fwd_broadcast_plain, (raw,))
            _held(f"inv{tag}", plan.inv, plan.inv_plain, (x,))
            d = _uniform(gen, (rows, 16, k, n), plan.q)
            d[0] = plan.q - 1
            d[..., 0] = plan.q[:, 0] - 1
            top = torch.broadcast_to(plan.q - 1, (16, k, n)).contiguous()
            _held(f"inv_ks{tag}", plan.inv_ks, plan.inv_ks_plain,
                  (d, top, _uniform(gen, (16, k, n), plan.q)))
            k1 = _uniform(gen, (6, k, n), plan.q)
            digits = torch.randint(0, 1 << 32, (rows, 6, n), generator=gen,
                                   device=DEV, dtype=torch.int64)
            digits[:, 0] = raw
            _held(f"ks_full{tag}", plan.ks_full, plan.ks_full_plain,
                  (digits, top[:6], k1))
            _held(f"ks_full_limbs{tag}", plan.ks_full_limbs,
                  plan.ks_full_limbs_plain, (d[:, :6], top[:6], k1))
            ab = _uniform(gen, (rows, 4, k, n), plan.q)
            ab[0] = plan.q - 1
            _held(f"inv_tensor3{tag}", plan.inv_tensor3,
                  plan.inv_tensor3_plain, (ab[:, :2], ab[:, 2:]))
            ext = _uniform(gen, (rows, 4, k, n), plan.q)
            ext[..., 0] = plan.q[:, 0] - 1
            ext[..., 2] = (1 << 62) + 12345
            ext[0] = plan.q - 1
            _held(f"fwd_tensor3{tag}", plan.fwd_tensor3,
                  plan.fwd_tensor3_plain, (ext,))
            _held(f"fwd_tensor3_full{tag}",
                  lambda e, p=plan: p.fwd_tensor3(e, full=True),
                  plan.fwd_tensor3_full_plain, (ext,))


def transform_shape(n: int) -> tuple[int, int]:
    """(threads per block, polynomials per block) of csrc/transform.cuh's
    Shape for N = n: N/4 threads a polynomial at N = 128, N/8 at 256, N/32
    at 32768, N/16 between, as many polynomials as fill 512 threads."""
    threads = n // {128: 4, 256: 8, 32768: 32}.get(n, 16)
    polys = max(1, 512 // threads)
    return threads * polys, polys


# Per source whose kernels print_ptxas reports: (threads a block, dynamic
# shared memory in bytes) from an instantiation's template arguments.
# ntt.cu and pntt.cu's B16 take two exchange buffers a polynomial (B16 one
# at N = 32768),
# tensor3.cu and inv_tensor3.cu an exchange buffer and two stashes,
# inv_ks.cu (<LOGN, SPLIT>) two exchange buffers a component with twice
# the threads of a transform (SPLIT) or two and a stash; rns.cu's kernels
# run 256 threads with static shared memory only (ptxas' "smem").
def _ntt_block(logn, *_):
    threads, polys = transform_shape(1 << logn)
    return threads, (1 if logn == 15 else 2) * polys * (1 << logn) * 4


def _tensor3_block(logn, *_):
    threads, polys = transform_shape(1 << logn)
    return threads, 3 * polys * (1 << logn) * 4


def _inv_ks_block(logn, split):
    threads = (1 << logn) // (8 if logn == 8 else 16) * (1 + split)
    return threads, (3 + split) * (1 << logn) * 4


# ks_full.cu (<LOGN, PER_LIMB, SPLIT>) takes inv_ks.cu's two shapes,
# pntt.cu's B17 (no template) 256 threads and no shared memory.
PTXAS_SOURCES = {"ntt": _ntt_block, "tensor3": _tensor3_block,
                 "inv_tensor3": _tensor3_block,
                 "pntt": lambda *a: _ntt_block(*a) if a else (256, 0),
                 "inv_ks": _inv_ks_block,
                 "ks_full": lambda logn, _, split: _inv_ks_block(logn, split),
                 "rns": lambda *_: (256, 0)}


def _demangle(symbol: str) -> tuple[str, list[int]]:
    """(function name, integer and bool template arguments) of a mangled
    kernel symbol: "_Z13inv_ks_kernelILi13ELi1EEv..." -> ("inv_ks_kernel",
    [13, 1])."""
    m = re.match(r"_Z(\d+)(\w+)", symbol)
    name = m.group(2)[:int(m.group(1))]
    tmpl = re.match(r"I((?:L[ib]\d+E)+)E", m.group(2)[len(name):])
    return name, [int(a) for a in
                  re.findall(r"L[ib](\d+)E", tmpl.group(1) if tmpl else "")]


def print_ptxas() -> None:
    """ptxas' registers, stack, spills and static shared memory of every
    kernel instantiation in PTXAS_SOURCES, with the block's threads and
    dynamic shared memory."""
    from sunscreen_tpu_torch import _build

    for src, block in PTXAS_SOURCES.items():
        kernel = spill = None
        for line in _build.build_log(src).splitlines():
            m = re.search(r"entry function '(_Z\w+)'", line)
            if m:
                kernel = _demangle(m.group(1))
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and kernel:
                spill = m.groups()
                continue
            m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?",
                          line)
            if m and kernel and spill:
                name, args = kernel
                threads, dyn = block(*args)
                print(f"ptxas {name}<{', '.join(map(str, args))}>: "
                      f"{m.group(1)} registers, {spill[0]} B stack, "
                      f"{spill[1]}/{spill[2]} B spill stores/loads; "
                      f"{threads} threads, {dyn} B dynamic and "
                      f"{m.group(2) or 0} B static shared memory a block",
                      flush=True)
                kernel = spill = None


IMAD_RE = re.compile(r"\bIMAD(?:\.\w+)*\b")


def sass_counts(so: str, kernel: str) -> dict[str, tuple[int, int]]:
    """{instantiation: (IMAD-class instructions, all instructions)} of
    `kernel`'s functions in the SASS of the shared library `so`
    (cuobjdump -sass), counted statically: each unrolled loop once per
    iteration, each loop left rolled once."""
    from sunscreen_tpu_torch import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    out: dict[str, tuple[int, int]] = {}
    name = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                out[name] = (0, 0)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\S*)",
                     line)
        if name and m:
            imad, total = out[name]
            out[name] = (imad + bool(IMAD_RE.match(m.group(1))), total + 1)
    return out


SASS_KERNELS = ("rns_convert_kernel", "rns_scale_kernel",
                "scale_convert_kernel")


def print_sass(so: str, label: str) -> None:
    """Prints the SASS counts of rns.cu's redesigned kernels in `so`."""
    for kernel in SASS_KERNELS:
        for sym, (imad, total) in sorted(sass_counts(so, kernel).items()):
            name, args = _demangle(sym)
            print(f"sass {label} {name}<{', '.join(map(str, args))}>: "
                  f"{imad} IMAD-class of {total} instructions", flush=True)


# Each CUDA kernel function of the port and the `_build.LAUNCHES` keys whose
# wrappers launch it, once per count.
KERNEL_KEYS = {
    "ntt_fwd_kernel": ("fwd", "fwd_broadcast"), "ntt_inv_kernel": ("inv",),
    "fwd_tensor3_kernel": ("fwd_tensor3", "fwd_tensor3_full"),
    "inv_ks_kernel": ("inv_ks",), "rns_convert_kernel": ("convert",),
    "scale_convert_kernel": ("scale_convert",),
    "mod_down_kernel": ("mod_down",), "rns_scale_kernel": ("scale",),
    "tensor3_kernel": ("tensor3",), "ks_inner_kernel": ("ks_inner",),
    "inv_tensor3_kernel": ("inv_tensor3",),
    "ks_full_kernel": ("ks_full", "ks_full_limbs"),
    "pntt_fwd_kernel": ("pntt_fwd",), "pntt_inv_kernel": ("pntt_inv",),
    "pntt_pmul_kernel": ("pntt_pmul",),
    "u64_shoup_kernel": ("shoup_mul_mod",),
    "u64_mul_mod_kernel": ("mul_mod",),
    "pointwise_mul_mod_kernel": ("pointwise_mul_mod",),
    "msm_digit_kernel": ("msm",), "msm_sort_kernel": ("msm",),
    "msm_bucket_kernel": ("msm",)}
PROFILE_RETRIES = 5
MARK_CYCLES = 200_000        # a 0.1 ms spin marks each end of a profile window
WARMUP_SPINS, WARMUP_STEPS = 4, 2   # traced ahead of the window, not counted
# Host wait after a trace starts: the events of a fresh trace's first
# milliseconds can be lost (up to the first 16 spins, 1.6 ms, in one run).
# A trace can also lose all but its last events (cell 12 kept 1 of its 6
# spins four times running in one run); each retry doubles the wait and
# the warm-up spins.
TRACE_SETTLE_S = 0.3


def _kernel_fn(event_name: str) -> str:
    """The function name of a device event ("void f<...>(...)" -> "f")."""
    name = event_name.strip()
    if name.startswith("void "):
        name = name[5:]
    end = len(name)
    for c in "<( ":
        i = name.find(c)
        if i != -1:
            end = min(end, i)
    return name[:end]


@functools.cache
def _spin_name() -> str:
    """The device event name of a `torch.cuda._sleep` spin, read from a
    trace of spins alone (taken again, up to PROFILE_RETRIES times, if
    it records none)."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_RETRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_SETTLE_S)
            for _ in range(WARMUP_SPINS):
                torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        names = collections.Counter(ev.name for ev in prof.events()
                                    if ev.device_type == DeviceType.CUDA)
        if names:
            return names.most_common(1)[0][0]
    raise SystemExit("profile: no trace of spins held a device event")


def _window(events, mark: str):
    """The device events strictly between the last two spins named
    `mark`, by the device clock, and those spins (those of the warm-up
    come earlier)."""
    marks = sorted((ev for ev in events if ev.name == mark),
                   key=lambda ev: ev.time_range.start)[-2:]
    if len(marks) != 2:
        return [], marks
    lo, hi = marks[0].time_range.end, marks[1].time_range.start
    return [ev for ev in events if ev is not marks[0] and ev is not marks[1]
            and lo <= ev.time_range.start and ev.time_range.end <= hi], marks


def profile_breakdown(label, step, batches: int = 3, warmup=None) -> dict:
    """Device time per kernel name over a few batches of `step`
    (torch.profiler), the device's busy share of the wall time and the
    device operations (kernels, copies, fills) per batch. The window is
    bounded on the device clock by two spin kernels queued with the
    stream idle on each side, after a host wait and a traced warm-up of
    `warmup` (default `step`; a fresh trace can lose the events of its
    first milliseconds), so no event of the warm-up or of the trace's
    end is counted in it. The
    window must hold one event per launch that `_build.LAUNCHES` counted
    in it, for every port kernel: a window that differs is profiled
    again, up to PROFILE_RETRIES times, after a longer wait and warm-up,
    and then the run fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sunscreen_tpu_torch import _build

    mark = _spin_name()
    for attempt in range(PROFILE_RETRIES + 1):
        warmup_spins = WARMUP_SPINS << attempt
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_SETTLE_S * 2 ** attempt)
            for _ in range(warmup_spins):
                torch.cuda._sleep(MARK_CYCLES)
            for _ in range(WARMUP_STEPS):
                (warmup or step)()
            torch.cuda.synchronize()
            time.sleep(0.05)
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            for _ in range(batches):
                step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
            time.sleep(0.2)      # the trace's end stays clear of the window
        launched = {fn: sum(_build.LAUNCHES[k] - before[k] for k in keys)
                    for fn, keys in KERNEL_KEYS.items()}
        device = [ev for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA]
        window, marks = _window(device, mark)
        per_name: dict[str, float] = {}
        events = dict.fromkeys(KERNEL_KEYS, 0)
        for ev in window:
            per_name[ev.name] = (per_name.get(ev.name, 0.0)
                                 + ev.time_range.elapsed_us())
            fn = _kernel_fn(ev.name)
            if fn in events:
                events[fn] += 1
        count = len(window)
        lost = {fn: (events[fn], n) for fn, n in launched.items()
                if events[fn] != n}
        if len(marks) == 2 and not lost:
            break
        spins = sum(ev.name == mark for ev in device)
        print(f"profile {label}: window {attempt + 1} discarded: "
              f"{spins} of {warmup_spins + 2} spins and {len(device)} "
              f"device events in the trace, kernel events "
              f"against launches {json.dumps(lost)} (events, launches), "
              f"device busy "
              f"{sum(per_name.values()) / batches / 1e3:.3f} ms per "
              f"batch", flush=True)
    else:
        raise SystemExit(f"profile {label}: no window of "
                         f"{PROFILE_RETRIES + 1} held one kernel event per "
                         f"launch")
    busy = sum(per_name.values())
    if busy == 0:
        raise SystemExit(f"profile {label}: no device time recorded")
    ours = sum(v for k, v in per_name.items() if _kernel_fn(k) in events)
    print(f"profile {label}: per batch {wall_us / batches / 1e3:.3f} ms "
          f"wall, device busy {busy / batches / 1e3:.3f} ms "
          f"({100 * busy / wall_us:.1f}% of wall), port kernels "
          f"{ours / batches / 1e3:.3f} ms ({100 * ours / busy:.1f}% of "
          f"device time), {count / batches:.0f} device ops; kernel events "
          f"{sum(events.values())} == launches {sum(launched.values())} "
          f"over {batches} batches (window {attempt + 1})", flush=True)
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"profile {label}:   {us / batches / 1e3:8.3f} ms  "
              f"{100 * us / busy:5.1f}%  {name[:110]}", flush=True)
    per_kernel: dict[str, float] = {}
    for name, us in per_name.items():
        fn = _kernel_fn(name)
        per_kernel[fn] = per_kernel.get(fn, 0.0) + us / batches / 1e3
    return {"wall_ms": wall_us / batches / 1e3,
            "busy_ms": busy / batches / 1e3, "ops": count / batches,
            "per_kernel": per_kernel}


def _rate(step, per_step: int = BATCH) -> float:
    """Ops per second of `step`, which does `per_step` of them: median
    of REPS x ITERS."""
    import torch
    step()
    torch.cuda.synchronize()
    rates = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            step()
        torch.cuda.synchronize()
        rates.append(per_step * ITERS / (time.perf_counter() - t0))
    return sorted(rates)[REPS // 2]


def _latency_ms(step) -> float:
    """Wall ms of one synchronized call of `step`: median of REPS."""
    import torch
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[REPS // 2]


def _per_op(step) -> dict[str, int]:
    """Kernel launches of one call of `step`."""
    from sunscreen_tpu_torch import _build
    before = dict(_build.LAUNCHES)
    step()
    return {k: v - before[k] for k, v in _build.LAUNCHES.items()}


def _path_counts(label, launches, needed, absent=()) -> None:
    missing = [k for k in needed if launches[k] == 0]
    if missing:
        raise SystemExit(f"{label} path never launched: {missing}")
    stray = [k for k in absent if launches[k] != 0]
    if stray:
        raise SystemExit(f"{label} path launched {stray}, which its "
                         f"settings route around")
    print(f"launches {label}: {json.dumps(launches)}", flush=True)


@contextlib.contextmanager
def _gates(settings: dict[str, str]):
    """The fusion settings of one path, restored afterwards."""
    saved = {name: os.environ.get(name) for name in settings}
    os.environ.update(settings)
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


DEFAULT_MUL = ("fwd", "fwd_broadcast", "inv", "fwd_tensor3", "inv_ks",
               "convert", "scale_convert", "mod_down")
MEGAKERNELS = ("ks_full", "ks_full_limbs")     # opt-in B14, B15
NEW_KERNELS = ("scale", "tensor3", "ks_inner", "inv_tensor3") + MEGAKERNELS
TFULL = {"SUNSCREEN_TPU_FUSE_TFULL": "1"}
TFULL_NEEDED = ("fwd_tensor3_full", "convert", "scale_convert",
                "fwd_broadcast", "inv_ks", "mod_down")
TFULL_ABSENT = ("fwd_tensor3", "inv", "fwd", "tensor3", "inv_tensor3",
                "scale", "ks_inner", "pntt_fwd", "pntt_inv",
                "pntt_pmul") + MEGAKERNELS


def multiply_path(label, ctx, seed: int, smi: str, needed, absent):
    """Keygen, encryption, a decrypt gate on every product of the batch
    and a card-vs-CPU bit-exact check on one ciphertext, then the rate,
    launch counts and profile of batched `multiply_relin`. Returns the
    keys and ciphertexts, the gate's product, the path's launches and the
    launches of one op."""
    import torch
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.bfv import get_context, keys, ops

    n, t = ctx.n, ctx.t
    at = "" if n == N else f" at N={n}"
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    sk = keys.gen_secret_key(ctx, gen)
    pk = keys.gen_public_key(ctx, sk, gen)
    rlk = keys.gen_relin_key(ctx, sk, gen)
    pts = torch.arange(BATCH * n, dtype=torch.int64,
                       device=DEV).reshape(BATCH, n) % t
    cts = ops.encrypt(ctx, pk, pts, gen)
    pts_np = pts.cpu().numpy()

    # decrypt gate before timing: every product of the batch
    prod = ops.multiply_relin(ctx, cts, cts, rlk)
    dec = ops.decrypt(ctx, sk, prod).cpu().numpy()
    for r in range(BATCH):
        if not np.array_equal(dec[r], _negacyclic_square(pts_np[r], t)):
            raise SystemExit(f"decrypt gate{at} FAILED at batch row {r}")
    print(f"decrypt gate{at}: {BATCH} products decrypt to the numpy "
          f"negacyclic oracle", flush=True)

    # the same multiply_relin through the kernels and on the CPU
    one = ops.multiply_relin(ctx, cts[0], cts[0], rlk).cpu()
    ctx_cpu = get_context(ctx.params, "cpu", ctx.requested_mode)
    rlk_cpu = keys.KswKey(rlk.k0.cpu(), rlk.k1.cpu())
    ct_cpu = cts[0].cpu()
    want = ops.multiply_relin(ctx_cpu, ct_cpu, ct_cpu, rlk_cpu)
    if not torch.equal(one, want):
        raise SystemExit(f"{label} on the card differs from the CPU")
    print(f"{label}: card == CPU plain path, bit for bit", flush=True)

    state = {"out": ops.multiply_relin(ctx, cts, cts, rlk)}

    def mul_step():
        state["out"] = ops.multiply_relin(ctx, state["out"], cts, rlk)

    ops_per_s = _rate(mul_step)
    per_op = _per_op(mul_step)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"{label}: {ops_per_s:.1f} ops/s (N={n}, batch {BATCH}, "
          f"median of {REPS} x {ITERS}) on {smi}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    _path_counts(label, launches, needed, absent)
    print(f"launches per {label}: {json.dumps(per_op)}", flush=True)
    profile_breakdown(label, mul_step)
    inputs = {"sk": sk, "rlk": rlk, "cts": cts, "pts_np": pts_np,
              "ct_cpu": ct_cpu, "ctx_cpu": ctx_cpu, "gen": gen}
    return inputs, prod, launches, per_op


def gated_path(label, settings, ctx, inputs, want, smi: str, needed,
               absent):
    """Path 1's multiply_relin under other fusion settings: its output
    must be path 1's bit for bit, as every route is exact integer
    arithmetic. Then the rate, launch counts and profile."""
    import torch
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.bfv import ops

    cts, rlk = inputs["cts"], inputs["rlk"]
    with _gates(settings):
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        if not torch.equal(ops.multiply_relin(ctx, cts, cts, rlk), want):
            raise SystemExit(f"{label}: multiply_relin differs from the "
                             f"default settings' output")
        print(f"{label} ({json.dumps(settings)}): {BATCH} products == "
              f"path 1's multiply_relin, bit for bit", flush=True)
        state = {"out": want}

        def step():
            state["out"] = ops.multiply_relin(ctx, state["out"], cts, rlk)

        ops_per_s = _rate(step)
        per_op = _per_op(step)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        print(f"{label}: {ops_per_s:.1f} ops/s (N={ctx.n}, batch {BATCH}, "
              f"median of {REPS} x {ITERS}) on {smi}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        _path_counts(label, launches, needed, absent)
        print(f"launches per {label}: {json.dumps(per_op)}", flush=True)
        profile_breakdown(label, step)
    return launches, per_op


PBS_REPS = 3                 # PBS timing: median of 3 calls


def _median_s(fn, reps: int) -> float:
    """Median wall seconds of `reps` synchronized calls, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[reps // 2]


def pbs_keys(seed: int) -> dict:
    """Path 7's set-up on the card: binary LWE_512_80 and GLWE_1_1024_80
    keys, the bootstrap key and its NTT form, the keyswitch key, the
    benchmark's test polynomial and BATCH encrypted bits."""
    import torch
    from sunscreen_tpu_torch.tfhe import (GLWE_1_1024_80, LWE_512_80,
                                          RadixDecomposition, ops, torus)

    lwe, glwe = LWE_512_80, GLWE_1_1024_80
    pbs_radix = RadixDecomposition(count=3, radix_log=4)
    ks_radix = RadixDecomposition(count=8, radix_log=6)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    t0 = time.perf_counter()
    lwe_sk = ops.generate_binary_lwe_sk(lwe, gen, DEV)
    glwe_sk = ops.generate_binary_glwe_sk(glwe, gen, DEV)
    bsk = ops.generate_bootstrap_key(lwe_sk, glwe_sk, lwe, glwe, pbs_radix,
                                     gen)
    ksk = ops.generate_keyswitch_key(ops.flatten_glwe_sk(glwe_sk), lwe_sk,
                                     lwe, ks_radix, gen)
    nbk = ops.bootstrap_key_to_ntt(bsk, glwe, pbs_radix)
    torch.cuda.synchronize()
    print(f"pbs keygen: {time.perf_counter() - t0:.2f} s on the card; "
          f"bootstrap key {tuple(bsk.shape)}, NTT form "
          f"{tuple(nbk.rows.shape)} ({nbk.rows.numel() * 8 / 1e6:.1f} MB), "
          f"keyswitch key {tuple(ksk.shape)}", flush=True)
    msgs = torch.arange(BATCH, device=DEV) % 2
    cts = ops.encrypt_lwe(torus.encode(msgs, 2), lwe_sk, lwe, gen)
    tp = ops.test_polynomial_for(lambda m: (m + 1) % 2, 2, glwe,
                                 output_bits=1, device=DEV)
    return {"lwe": lwe, "glwe": glwe, "pbs_radix": pbs_radix,
            "ks_radix": ks_radix, "lwe_sk": lwe_sk, "nbk": nbk, "ksk": ksk,
            "msgs": msgs, "cts": cts, "tp": tp}


def _pbs(s: dict, cts, nbk=None, ksk=None, tp=None):
    from sunscreen_tpu_torch.tfhe import ops
    return ops.programmable_bootstrap_univariate(
        cts, s["tp"] if tp is None else tp, s["nbk"] if nbk is None else nbk,
        s["ksk"] if ksk is None else ksk, s["lwe"], s["glwe"],
        s["pbs_radix"], s["ks_radix"])


def pbs_path(label, smi: str, needed, absent, s=None, want=None):
    """The univariate PBS of BATCH LWE_512_80 ciphertexts through
    GLWE_1_1024_80 with the NTT-domain bootstrap key, after keygen
    (`pbs_keys`) unless given path 7's keys `s`: the decrypt gate
    ((m + 1) mod 2 on every row), a card-vs-CPU bit-exact PBS of one
    ciphertext (or, given `want`, equality with path 7's batch output),
    then PBS/s at batch BATCH, single-PBS latency, launches per PBS and
    per blind-rotation step, the profile and peak memory. Returns the
    keys, the batch output, the path's launches and the launches of one
    PBS."""
    import torch
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.tfhe import ops

    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    if s is None:
        s = pbs_keys(7)
    out = _pbs(s, s["cts"])
    dec = ops.decrypt_lwe(out, s["lwe_sk"], 1)
    if not torch.equal(dec, (s["msgs"] + 1) % 2):
        bad = int((dec != (s["msgs"] + 1) % 2).nonzero()[0, 0])
        raise SystemExit(f"{label} decrypt gate FAILED at batch row {bad}")
    print(f"{label} decrypt gate: {BATCH} PBS outputs decrypt to "
          f"(m + 1) mod 2", flush=True)
    if want is None:
        _card_vs_cpu(f"{label} (one ciphertext)",
                     lambda c, k, kk, tp: _pbs(s, c, k, kk, tp),
                     (s["cts"][:1], s["nbk"], s["ksk"], s["tp"]), out[:1])
    else:
        if not torch.equal(out, want):
            raise SystemExit(f"{label}: PBS differs from path 7's output")
        print(f"{label}: {BATCH} PBS outputs == path 7's, bit for bit",
              flush=True)
    launches, per_pbs = _tfhe_timing(
        label, smi, "PBS/s", lambda c: _pbs(s, c), s["cts"], needed, absent)
    return s, out, launches, per_pbs


WARMUP_LWE_DIM = 8           # blind-rotation steps of a profile's warm-up


def _tfhe_timing(label, smi: str, unit: str, op, cts, needed, absent):
    """A TFHE path's numbers once its gates have passed: the rate of `op`
    on the BATCH ciphertexts `cts` (a tuple for several operands) in
    `unit`, the latency of one ciphertext, launches per op and per
    blind-rotation step, the path's launch counts, the profile and peak
    memory. The profile's warm-up runs `op` on one ciphertext cut to its
    last WARMUP_LWE_DIM mask words: the same kernels at 1/64 of the
    steps, as a blind rotation runs one step a mask word. Returns the
    path's launches and those of one op."""
    import torch
    from sunscreen_tpu_torch import _build

    cts = cts if isinstance(cts, tuple) else (cts,)
    steps = cts[0].shape[-1] - 1
    warm = tuple(c[:1, -WARMUP_LWE_DIM - 1:] for c in cts)

    def step():
        return op(*cts)

    batch_s = _median_s(step, PBS_REPS)
    one_s = _median_s(lambda: op(*(c[:1] for c in cts)), PBS_REPS)
    per_op = _per_op(step)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"{label}: {BATCH / batch_s:.1f} {unit} (batch {BATCH}, "
          f"{batch_s * 1e3:.2f} ms per batch), latency "
          f"{one_s * 1e3:.2f} ms for one (medians of {PBS_REPS}) on "
          f"{smi}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    _path_counts(label, launches, needed, absent)
    print(f"launches per {label}: {json.dumps(per_op)}; per "
          f"blind-rotation step: "
          f"{json.dumps({k: v / steps for k, v in per_op.items() if v})}",
          flush=True)
    prof = profile_breakdown(label, step, batches=1,
                             warmup=lambda: op(*warm))
    print(f"{label}: {prof['ops'] / steps:.1f} device ops per blind-rotation "
          f"step", flush=True)
    return launches, per_op


PBS_NEEDED = ("fwd", "inv_ks")
PBS_ABSENT = ("ks_full", "ks_full_limbs", "fwd_broadcast", "inv", "ks_inner")
KSFULL_ABSENT = ("fwd", "inv_ks", "ks_full", "fwd_broadcast", "inv")
# tests/test_tfhe.py's three functions of one multifunctional table
MULTI_FNS = (lambda m: (m + 1) % 2, lambda m: m, lambda m: 1 - m)


def _card_vs_cpu(label, op, args, want) -> None:
    """`op` on the CPU copies of `args` (tensors, NTT bootstrap keys,
    anything else as it is) must give `want`, the card's output, bit for
    bit."""
    import torch
    from sunscreen_tpu_torch.tfhe import ops

    def cpu(a):
        if isinstance(a, torch.Tensor):
            return a.cpu()
        if isinstance(a, ops.NttBootstrapKey):
            return ops.NttBootstrapKey(a.rows.cpu(), a.glwe, a.radix)
        return a

    t0 = time.perf_counter()
    got = op(*[cpu(a) for a in args])
    if not torch.equal(got, want.cpu()):
        raise SystemExit(f"{label} on the card differs from the CPU")
    print(f"{label}: card == CPU plain path, bit for bit "
          f"({time.perf_counter() - t0:.1f} s on the CPU)", flush=True)


def multi_path(s: dict, smi: str):
    """Path 16: the multifunctional PBS of tests/test_tfhe.py's three
    functions ((m + 1) mod 2, m, 1 - m; 2 plaintext bits, log_v = 2) on
    path 7's keys and ciphertexts, through the high-level table and
    evaluation entry points: every output of every row decodes to its
    function of m; a card-vs-CPU bit-exact PBS of one ciphertext; then
    the rate, latency, launches, profile and peak memory."""
    import torch
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.tfhe import high_level, ops

    label = "pbs_multi"
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    lut = high_level.UnivariateLookupTable.trivial_multifunctional(
        MULTI_FNS, s["glwe"], 2, device=DEV)
    args = (lut, s["nbk"], s["ksk"], s["lwe"], s["glwe"], s["pbs_radix"],
            s["ks_radix"])

    def op(cts, lut, *rest):
        return high_level.evaluation.multifunctional_programmable_bootstrap(
            cts, lut, *rest)

    out = op(s["cts"], *args)
    dec = ops.decrypt_lwe(out, s["lwe_sk"], 2)
    want = torch.stack([fn(s["msgs"]) % 4 for fn in MULTI_FNS], 1)
    if not torch.equal(dec, want):
        bad = int((dec != want).any(1).nonzero()[0, 0])
        raise SystemExit(f"{label} decrypt gate FAILED at batch row {bad}")
    print(f"{label} decrypt gate: {BATCH} rows x {len(MULTI_FNS)} outputs "
          f"decrypt to (m + 1) mod 2, m, 1 - m", flush=True)
    cpu_lut = high_level.UnivariateLookupTable(lut.poly.cpu(), 2, lut.n_fns)
    _card_vs_cpu(f"{label} (one ciphertext)", op,
                 (s["cts"][:1], cpu_lut, *args[1:]), out[:1])
    return _tfhe_timing(label, smi, "PBS/s", lambda c: op(c, *args),
                        s["cts"], PBS_NEEDED, PBS_ABSENT)


def fine_keys(seed: int) -> dict:
    """Paths 17-19's set-up on the card at LWE_512_80 -> GLWE_1_1024_80:
    binary keys, the bootstrap key at radix (8, 4) (16 digits a
    blind-rotation step, as circuit bootstrapping needs) and its NTT
    form, the keyswitch key and the circuit bootstrap's private
    functional keyswitch keys at radix (8, 6); each key drawn in one
    batched encryption."""
    import torch
    from sunscreen_tpu_torch.tfhe import (GLWE_1_1024_80, LWE_512_80,
                                          RadixDecomposition, ops)

    lwe, glwe = LWE_512_80, GLWE_1_1024_80
    fine = RadixDecomposition(count=8, radix_log=4)
    ks = RadixDecomposition(count=8, radix_log=6)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    t0 = time.perf_counter()
    lwe_sk = ops.generate_binary_lwe_sk(lwe, gen, DEV)
    glwe_sk = ops.generate_binary_glwe_sk(glwe, gen, DEV)
    ext = ops.flatten_glwe_sk(glwe_sk)
    nbk = ops.bootstrap_key_to_ntt(ops.generate_bootstrap_key(
        lwe_sk, glwe_sk, lwe, glwe, fine, gen), glwe, fine)
    ksk = ops.generate_keyswitch_key(ext, lwe_sk, lwe, ks, gen)
    cbs = ops.generate_cbs_pfksk(ext, glwe_sk, glwe, ks, gen)
    torch.cuda.synchronize()
    print(f"fine keygen: {time.perf_counter() - t0:.2f} s on the card; NTT "
          f"bootstrap key {tuple(nbk.rows.shape)} "
          f"({nbk.rows.numel() * 8 / 1e6:.1f} MB), keyswitch key "
          f"{tuple(ksk.shape)}, cbs keys {tuple(cbs.shape)} "
          f"({cbs.numel() * 8 / 1e6:.1f} MB)", flush=True)
    return {"lwe": lwe, "glwe": glwe, "fine": fine, "ks": ks,
            "out": RadixDecomposition(count=2, radix_log=8), "gen": gen,
            "lwe_sk": lwe_sk, "glwe_sk": glwe_sk, "nbk": nbk, "ksk": ksk,
            "cbs": cbs}


def bivariate_path(f: dict, smi: str):
    """Path 17: a AND b through `evaluation.bivariate_programmable_bootstrap`
    on the fine keys, one data bit an operand encrypted at 4 bits (as in
    tests/test_tfhe_advanced.py), the BATCH rows cycling through the four
    (a, b) pairs: every row decrypts to a AND b; a card-vs-CPU bit-exact
    PBS of one pair; then the rate, latency, launches, profile and peak
    memory."""
    import torch
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.tfhe import high_level, ops, torus

    label = "pbs_bivariate"
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    lut = high_level.BivariateLookupTable.trivial_from_fn(
        lambda x, y: x & y, f["glwe"], 2, device=DEV)
    rows = torch.arange(BATCH, device=DEV)
    a, b = (rows >> 1) & 1, rows & 1
    ca = ops.encrypt_lwe(torus.encode(a, 4), f["lwe_sk"], f["lwe"], f["gen"])
    cb = ops.encrypt_lwe(torus.encode(b, 4), f["lwe_sk"], f["lwe"], f["gen"])
    args = (f["nbk"], f["ksk"], f["lwe"], f["glwe"], f["fine"], f["ks"])

    def op(ca, cb, lut, *rest):
        return high_level.evaluation.bivariate_programmable_bootstrap(
            ca, cb, lut, *rest)

    out = op(ca, cb, lut, *args)
    dec = ops.decrypt_lwe(out, f["lwe_sk"], 4)
    if not torch.equal(dec, a & b):
        bad = int((dec != (a & b)).nonzero()[0, 0])
        raise SystemExit(f"{label} decrypt gate FAILED at batch row {bad}")
    print(f"{label} decrypt gate: {BATCH} rows decrypt to a AND b",
          flush=True)
    cpu_lut = high_level.BivariateLookupTable(lut.poly.cpu(), 2, 2)
    _card_vs_cpu(f"{label} (one pair)", op,
                 (ca[3:4], cb[3:4], cpu_lut, *args), out[3:4])
    return _tfhe_timing(label, smi, "PBS/s",
                        lambda a_, b_: op(a_, b_, lut, *args), (ca, cb),
                        PBS_NEEDED, PBS_ABSENT)


def _cmux_gate(label, ggsws, bits, sk, glwe, radix, gen) -> None:
    """Each GGSW(bit) of ggsws [..., k+1, l, k+1, N] drives a CMUX between
    a GLWE of zeros and a GLWE of seeded 2-bit data: the result decrypts
    to the data where the bit is 1 and to zeros where it is 0."""
    import torch
    from sunscreen_tpu_torch.tfhe import ops, torus

    n = glwe.poly_degree
    data = torch.randint(0, 4, (*bits.shape, n), generator=gen,
                         device=gen.device).to(sk.device)
    c0 = ops.encrypt_glwe(torch.zeros_like(data), sk, glwe, gen)
    c1 = ops.encrypt_glwe(torus.encode(data, 2), sk, glwe, gen)
    got = ops.decrypt_glwe(ops.cmux(ggsws, c0, c1, glwe, radix), sk, glwe, 2)
    want = data * bits.unsqueeze(-1)
    if not torch.equal(got, want):
        bad = int((got != want).any(-1).nonzero()[0, 0])
        raise SystemExit(f"{label} CMUX gate FAILED at batch row {bad}")
    print(f"{label} CMUX gate: {bits.numel()} GGSWs select between zeros "
          f"and seeded 2-bit data as their bits say", flush=True)


def cbs_path(f: dict, smi: str):
    """Path 18: circuit bootstrapping of BATCH encrypted bits on the fine
    keys, out radix (2, 8): every bootstrapped GGSW drives a CMUX as
    tests/test_tfhe_advanced.py's gate asks (`_cmux_gate`); a card-vs-CPU
    bit-exact circuit bootstrap of one ciphertext; then circuit
    bootstraps/s, latency, launches, profile and peak memory. Returns the
    ciphertexts, the batch's GGSWs, the path's launches and those of one
    op."""
    import torch
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.tfhe import high_level, ops, torus

    label = "cbs"
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    bits = torch.arange(BATCH, device=DEV) % 2
    cts = ops.encrypt_lwe(torus.encode(bits, 2), f["lwe_sk"], f["lwe"],
                          f["gen"])
    args = (f["nbk"], f["cbs"], f["lwe"], f["glwe"], f["fine"], f["out"],
            f["ks"])
    op = high_level.evaluation.circuit_bootstrap
    out = op(cts, *args)
    _cmux_gate(label, out, bits, f["glwe_sk"], f["glwe"], f["out"], f["gen"])
    _card_vs_cpu(f"{label} (one ciphertext)", op, (cts[1:2], *args),
                 out[1:2])
    launches, per_op = _tfhe_timing(label, smi, "ops/s",
                                    lambda c: op(c, *args), cts, PBS_NEEDED,
                                    PBS_ABSENT)
    return cts, out, launches, per_op


def cbs_ksfull_path(f: dict, cts, want):
    """Path 18b: one batch of path 18 under SUNSCREEN_TPU_TFHE_KSFULL=1:
    B15 at 16 digits a step in place of B1 + B5, the GGSWs equal to path
    18's bit for bit. No timing."""
    import torch
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.tfhe import ops

    label = "cbs_ksfull"
    with _gates({"SUNSCREEN_TPU_TFHE_KSFULL": "1"}):
        _build.reset_launches()
        out = ops.circuit_bootstrap(cts, f["nbk"], f["cbs"], f["lwe"],
                                    f["glwe"], f["fine"], f["out"], f["ks"])
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    if not torch.equal(out, want):
        raise SystemExit(f"{label}: GGSWs differ from path 18's")
    print(f"{label}: {BATCH} circuit-bootstrapped GGSWs == path 18's, bit "
          f"for bit", flush=True)
    _path_counts(label, launches, ("ks_full_limbs",), KSFULL_ABSENT)
    return launches, launches


def _decode_gate(label, got, want) -> None:
    import torch
    if not torch.equal(got, want):
        raise SystemExit(f"{label} gate FAILED: "
                         f"{int((got != want).sum())} values differ")
    print(f"{label} gate: {tuple(want.shape)} values decode as they should",
          flush=True)


def tfhe_flow_path(f: dict, smi: str, batch: int = 8):
    """Path 19, the rest of TFHE at batch 8 on the fine keys, correctness
    only: the generalized PBS of 1 - m (each of 2 levels decodes); GLEV
    encryption, trivial GLEVs, decrypt_glev and glev_cmux; the scheme
    switch of GLEVs of bits (radices of tests/test_tfhe_advanced.py:
    GLEV (3, 4), switch key (8, 4)) into GGSWs that drive a CMUX; the
    GLWE keyswitch to a second GLWE_1_1024_80 key and the public
    functional keyswitch from the LWE key, both at radix (8, 6); LWE and
    RLWE public-key encryption and encrypt_rlev_public. Each op is
    behind a decrypt gate, each deterministic op has a card-vs-CPU
    bit-exact check on one input."""
    import torch
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.tfhe import RadixDecomposition, ops, torus

    label = "tfhe_flow"
    _build.reset_launches()
    lwe, glwe, gen = f["lwe"], f["glwe"], f["gen"]
    lwe_sk, gsk, n = f["lwe_sk"], f["glwe_sk"], glwe.poly_degree
    coarse = RadixDecomposition(count=3, radix_log=4)
    fine, ks, out_r = f["fine"], f["ks"], f["out"]
    rng = np.random.default_rng(19)

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(DEV)

    m = dev(rng.integers(0, 2, batch))
    cts = ops.encrypt_lwe(torus.encode(m, 2), lwe_sk, lwe, gen)
    gpbs = (lambda c, k: ops.generalized_programmable_bootstrap(
        c, lambda x: 1 - x, 2, k, lwe, glwe, fine, out_r))
    lev = gpbs(cts, f["nbk"])
    ext = ops.flatten_glwe_sk(gsk)
    _decode_gate(f"{label} generalized_programmable_bootstrap", torch.stack(
        [torus.decode(ops.decrypt_lwe_torus(lev[:, j], ext),
                      (j + 1) * out_r.radix_log) % (1 << out_r.radix_log)
         for j in range(out_r.count)], 1), (1 - m).unsqueeze(1).expand(
             batch, out_r.count))
    _card_vs_cpu(f"{label} generalized_programmable_bootstrap", gpbs,
                 (cts[:1], f["nbk"]), lev[:1])

    msgs = dev(rng.integers(0, 4, (batch, n)))
    glev = ops.encrypt_glev(msgs, gsk, glwe, coarse, gen)
    _decode_gate(f"{label} encrypt_glev", ops.decrypt_glev(
        glev, gsk, glwe, coarse), msgs)
    _decode_gate(f"{label} trivial_glev", ops.decrypt_glev(
        ops.trivial_glev(msgs, glwe, coarse), gsk, glwe, coarse), msgs)
    _card_vs_cpu(f"{label} decrypt_glev", lambda g, k: ops.decrypt_glev(
        g, k, glwe, coarse), (glev[:1], gsk), ops.decrypt_glev(
            glev[:1], gsk, glwe, coarse))
    sel_bits = dev(rng.integers(0, 2, batch))
    sel = torch.stack([ops.encrypt_ggsw(int(b), gsk, glwe, fine, gen)
                       for b in sel_bits.tolist()])
    other = ops.encrypt_glev(dev(rng.integers(0, 4, (batch, n))), gsk, glwe,
                             coarse, gen)
    gmux = (lambda s_, a_, b_: ops.glev_cmux(s_.unsqueeze(-5), a_, b_, glwe,
                                             fine))
    muxed = gmux(sel, glev, other)
    _decode_gate(f"{label} glev_cmux", ops.decrypt_glev(
        muxed, gsk, glwe, coarse), torch.where(
            sel_bits.unsqueeze(-1) == 1, ops.decrypt_glev(
                other, gsk, glwe, coarse), msgs))
    _card_vs_cpu(f"{label} glev_cmux", gmux, (sel[:1], glev[:1], other[:1]),
                 muxed[:1])

    ssk = ops.generate_scheme_switch_key(gsk, glwe, fine, gen)
    bit_glev = ops.encrypt_glev(sel_bits.unsqueeze(-1) * (torch.arange(
        n, device=DEV) == 0), gsk, glwe, coarse, gen)
    switch = (lambda g, k: ops.scheme_switch(g, k, glwe, fine, coarse))
    ggsw = switch(bit_glev, ssk)
    _cmux_gate(f"{label} scheme_switch", ggsw, sel_bits, gsk, glwe, coarse,
               gen)
    _card_vs_cpu(f"{label} scheme_switch", switch, (bit_glev[:1], ssk),
                 ggsw[:1])

    to_sk = ops.generate_binary_glwe_sk(glwe, gen, DEV)
    gksk = ops.generate_glwe_keyswitch_key(gsk, to_sk, glwe, ks, gen)
    m16 = dev(rng.integers(0, 16, (batch, n)))
    gks = (lambda c, k: ops.keyswitch_glwe_to_glwe(c, k, glwe, ks))
    gct = ops.encrypt_glwe(torus.encode(m16, 4), gsk, glwe, gen)
    switched = gks(gct, gksk)
    _decode_gate(f"{label} keyswitch_glwe_to_glwe", ops.decrypt_glwe(
        switched, to_sk, glwe, 4), m16)
    _card_vs_cpu(f"{label} keyswitch_glwe_to_glwe", gks, (gct[:1], gksk),
                 switched[:1])

    pksk = ops.generate_public_functional_keyswitch_key(lwe_sk, gsk, glwe, ks,
                                                        gen)
    w = torch.zeros(3, n, dtype=torch.int64, device=DEV)
    w[0, 0], w[1, 1], w[2, 2] = 1, 2, 1          # x1 + 2 x2 X + x3 X^2
    m3 = dev(rng.integers(0, 8, (batch, 3)))
    pfks = (lambda c, k, w_: ops.public_functional_keyswitch(c, k, w_, glwe,
                                                             ks))
    pcts = ops.encrypt_lwe(torus.encode(m3, 4), lwe_sk, lwe, gen)
    glwes = pfks(pcts, pksk, w)
    want = torch.zeros(batch, n, dtype=torch.int64, device=DEV)
    want[:, :3] = m3 * torch.tensor([1, 2, 1], device=DEV)
    _decode_gate(f"{label} public_functional_keyswitch",
                 ops.decrypt_glwe(glwes, gsk, glwe, 4), want)
    _card_vs_cpu(f"{label} public_functional_keyswitch", pfks,
                 (pcts[:1], pksk, w), glwes[:1])

    m4 = dev(rng.integers(0, 16, batch))
    lpk = ops.generate_lwe_public_key(lwe_sk, lwe, 4096, gen)
    _decode_gate(f"{label} encrypt_lwe_public", ops.decrypt_lwe(
        ops.encrypt_lwe_public(torus.encode(m4, 4), lpk, lwe, gen), lwe_sk,
        4), m4)
    ct_e, e = ops.encrypt_lwe_return_components(torus.encode(m4, 4), lwe_sk,
                                                lwe, gen)
    _decode_gate(f"{label} encrypt_lwe_return_components",
                 ops.decrypt_lwe_torus(ct_e, lwe_sk) - torus.encode(m4, 4), e)
    rpk = ops.generate_rlwe_public_key(gsk, glwe, gen)
    _decode_gate(f"{label} encrypt_glwe_public", ops.decrypt_glwe(
        ops.encrypt_glwe_public(torus.encode(msgs, 2), rpk, glwe, gen), gsk,
        glwe, 2), msgs)
    bin_msgs = msgs & 1
    _decode_gate(f"{label} encrypt_rlev_public", ops.decrypt_glev(
        ops.encrypt_rlev_public(bin_msgs, rpk, glwe, coarse, gen), gsk, glwe,
        coarse), bin_msgs)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"{label}: every op of the rest of TFHE passed its gate at batch "
          f"{batch} on {smi}", flush=True)
    _path_counts(label, launches, PBS_NEEDED, PBS_ABSENT)
    return launches, launches


VPU = {"SUNSCREEN_TPU_NTT": "pallas_vpu", "SUNSCREEN_TPU_FUSE_FT3": "0"}
U32_PLAN = ("fwd", "fwd_broadcast", "inv", "fwd_tensor3", "inv_ks")  # B1-B5


def _slot_gate(label, enc, sk, ctx, ct, want) -> None:
    """Decrypts and decodes every row of `ct`; exits unless each equals
    the numpy slot vector of `want`."""
    from sunscreen_tpu_torch.bfv import ops
    got = enc.decode(ops.decrypt(ctx, sk, ct)).cpu().numpy()
    for r in range(want.shape[0]):
        if not np.array_equal(got[r], want[r]):
            raise SystemExit(f"{label}: slot gate FAILED at batch row {r}")


def vpu_path(params, smi: str):
    """Paths 9 (N = 8192) and 15 (N = 32768), under
    SUNSCREEN_TPU_NTT=pallas_vpu (with FUSE_FT3=0, the one setting under
    which the reference's plan multiplies): keygen, BatchEncoder encode,
    encryption of BATCH slot vectors twice, the 3-component `multiply`
    and `multiply_plain`, both decrypted and decoded against numpy
    slot-wise products mod t; `multiply` on the card against the CPU, bit
    for bit; `relinearize` must raise the port's error. Then both rates,
    launch counts and profiles. Returns (the path's launches, those of one
    `multiply`) and the context, ciphertexts and `multiply` product."""
    import torch
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.bfv import BatchEncoder, get_context, keys, ops

    t, n = params.plain_modulus, params.poly_degree
    label, at = ("vpu", "") if n == N else (f"vpu@{n}", f"@{n}")
    with _gates(VPU):
        ctx = get_context(params, DEV)
        if ctx.mode != "pallas_vpu":
            raise SystemExit(f"vpu path got NTT mode {ctx.mode}")
        print(f"{label}: N={n} k={ctx.k}, B16 at log2 N = "
              f"{ctx.plan_mul.logn} on {ctx.mul_base.k} limbs, B7 from "
              f"{ctx.fused_op('scale_convert').ks} limbs", flush=True)
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=DEV).manual_seed(9)
        sk = keys.gen_secret_key(ctx, gen)
        pk = keys.gen_public_key(ctx, sk, gen)
        rlk = keys.gen_relin_key(ctx, sk, gen)
        enc = BatchEncoder(ctx)
        slots = np.random.default_rng(9).integers(0, t, (2, BATCH, n))
        pts = enc.encode(slots)
        cta = ops.encrypt(ctx, pk, pts[0], gen)
        ctb = ops.encrypt(ctx, pk, pts[1], gen)
        want = slots[0] * slots[1] % t
        prod = ops.multiply(ctx, cta, ctb)
        _slot_gate(f"{label} multiply", enc, sk, ctx, prod, want)
        mp = ops.multiply_plain(ctx, cta, pts[1])
        _slot_gate(f"{label} multiply_plain", enc, sk, ctx, mp, want)
        print(f"{label} decrypt gate: {BATCH} multiply and {BATCH} "
              f"multiply_plain results decode to the numpy slot-wise "
              f"products mod t", flush=True)
        ctx_cpu = get_context(params, "cpu")
        if not torch.equal(ops.multiply(ctx, cta[:1], ctb[:1]).cpu(),
                           ops.multiply(ctx_cpu, cta[:1].cpu(),
                                        ctb[:1].cpu())):
            raise SystemExit(f"{label} multiply on the card differs from "
                             f"the CPU")
        print(f"{label} multiply: card kernels == CPU plain path, bit for "
              f"bit", flush=True)
        try:
            ops.relinearize(ctx, prod, rlk)
        except NotImplementedError as e:
            if "pntt.py:222" not in str(e):
                raise SystemExit(f"{label} relinearize raised the wrong "
                                 f"error: {e}") from e
            print(f"{label} relinearize raises as the reference does: "
                  f"{str(e)[:72]}...", flush=True)
        else:
            raise SystemExit(f"{label} relinearize did not raise")

        def mul_step():
            ops.multiply(ctx, cta, ctb)

        def mp_step():
            ops.multiply_plain(ctx, cta, pts[1])

        mul_rate, mp_rate = _rate(mul_step), _rate(mp_step)
        per_op = _per_op(mul_step)
        per_mp = _per_op(mp_step)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        print(f"{label} multiply: {mul_rate:.1f} ops/s, multiply_plain{at}: "
              f"{mp_rate:.1f} ops/s (N={n}, batch {BATCH}, median of "
              f"{REPS} x {ITERS}) on {smi}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        _path_counts(label, launches,
                     ("pntt_fwd", "pntt_inv", "pntt_pmul", "convert",
                      "tensor3", "scale_convert"),
                     U32_PLAN + ("fwd_tensor3_full", "inv_tensor3", "mod_down")
                     + MEGAKERNELS)
        print(f"launches per {label} multiply: {json.dumps(per_op)}; per "
              f"multiply_plain: {json.dumps(per_mp)}", flush=True)
        profile_breakdown(f"{label} multiply", mul_step)
        profile_breakdown(f"{label} multiply_plain", mp_step)
    return (launches, per_op), {"ctx": ctx, "cta": cta, "ctb": ctb,
                                "prod": prod}


VPU_SC = {**VPU, "SUNSCREEN_TPU_FUSE_SC": "0"}


def vpu_sc_path(label, state, smi: str):
    """Path 15b: path 15's `multiply` on its ciphertexts under
    SUNSCREEN_TPU_FUSE_SC=0, a setting of the reference at any N: the
    scale back to Q runs B9 into B, then the centered conversion B -> Q
    through B6, in place of B7. Its products must be path 15's, bit for
    bit, as both routes compute the same exact function; then the rate,
    launch counts (B6 twice and B9 once an op, no B7) and profile."""
    import torch
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.bfv import ops

    ctx, cta, ctb = state["ctx"], state["cta"], state["ctb"]
    with _gates(VPU_SC):
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        if not torch.equal(ops.multiply(ctx, cta, ctb), state["prod"]):
            raise SystemExit(f"{label}: multiply differs from path 15's "
                             f"product")
        print(f"{label} ({json.dumps(VPU_SC)}): {BATCH} products == path "
              f"15's multiply, bit for bit", flush=True)

        def step():
            ops.multiply(ctx, cta, ctb)

        rate = _rate(step)
        per_op = _per_op(step)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        print(f"{label}: {rate:.1f} ops/s (N={ctx.n}, batch {BATCH}, median "
              f"of {REPS} x {ITERS}) on {smi}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        _path_counts(label, launches,
                     ("pntt_fwd", "pntt_inv", "convert", "tensor3", "scale"),
                     U32_PLAN + ("scale_convert", "pntt_pmul",
                                 "fwd_tensor3_full", "inv_tensor3",
                                 "mod_down", "ks_inner") + MEGAKERNELS)
        if (per_op["convert"], per_op["scale"]) != (2, 1):
            raise SystemExit(f"{label}: an op launched B6 "
                             f"{per_op['convert']} and B9 {per_op['scale']} "
                             f"times, not 2 and 1")
        print(f"launches per {label} multiply: {json.dumps(per_op)}",
              flush=True)
        profile_breakdown(label, step)
    return launches, per_op


def flow_path(ctx, smi: str, batch: int = 8):
    """Path 11, the BFV user flow under the default settings at batch 8:
    encode, encrypt, add_plain, sub, negate, multiply_plain,
    exponentiate(ct, 3), multiply_many of 4, rotate_rows(ct, 1),
    mod_switch_to_next and decryption under mod_switch_context, each
    decoded and held slot-wise against numpy; every noise budget > 0.
    The encoder's (t,) plan must run B1/B3. A correctness path: no
    rate."""
    import torch
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.bfv import BatchEncoder, keys, ops

    t, half = ctx.t, N // 2
    _build.reset_launches()
    gen = torch.Generator(device=DEV).manual_seed(11)
    sk = keys.gen_secret_key(ctx, gen)
    pk = keys.gen_public_key(ctx, sk, gen)
    rlk = keys.gen_relin_key(ctx, sk, gen)
    gks = keys.gen_galois_keys(ctx, sk, gen, (ctx.rotate_rows_element(1),))
    enc = BatchEncoder(ctx)
    slots = np.random.default_rng(11).integers(0, t, (4, batch, N))
    codec = _per_op(lambda: enc.decode(enc.encode(slots)))
    if codec["fwd"] == 0 or codec["inv"] == 0:
        raise SystemExit(f"encoder launched no B1/B3: {codec}")
    pts = enc.encode(slots)
    cts = ops.encrypt(ctx, pk, pts.reshape(4 * batch, N),
                      gen).reshape(4, batch, 2, ctx.k, N)
    x, y = slots[0], slots[1]
    many = ops.multiply_many(ctx, list(cts), rlk)
    checks = [
        ("add_plain", ops.add_plain(ctx, cts[0], pts[1]), x + y),
        ("sub", ops.sub(ctx, cts[0], cts[1]), x - y),
        ("negate", ops.negate(ctx, cts[0]), -x),
        ("multiply_plain", ops.multiply_plain(ctx, cts[0], pts[1]), x * y),
        ("exponentiate(3)", ops.exponentiate(ctx, cts[0], 3, rlk), x ** 3),
        ("multiply_many(4)", many,
         functools.reduce(lambda a, b: a * b % t, slots)),
        ("rotate_rows(1)", ops.rotate_rows(ctx, cts[0], 1, gks),
         np.concatenate([np.roll(x[:, :half], -1, 1),
                         np.roll(x[:, half:], -1, 1)], 1))]
    for label, ct, want in checks:
        _slot_gate(f"flow {label}", enc, sk, ctx, ct, np.mod(want, t))
    ctx2 = ops.mod_switch_context(ctx)
    sk2, _, _ = keys.from_reference(ctx2, s=sk.s.cpu().numpy())
    _slot_gate("flow mod_switch_to_next", enc, sk2, ctx2,
               ops.mod_switch_to_next(ctx, cts[0]), x)
    budgets = ops.invariant_noise_budget(ctx, sk, many)
    if not (budgets > 0).all():
        raise SystemExit(f"flow noise budget exhausted: {budgets}")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"flow gate: {batch} rows of add_plain, sub, negate, "
          f"multiply_plain, exponentiate(3), multiply_many(4), "
          f"rotate_rows(1) and mod_switch_to_next ({ctx.k} -> {ctx2.k} "
          f"limbs) decode to numpy; noise budgets after multiply_many "
          f"{sorted(set(budgets.tolist()))} bits; encoder round trip "
          f"launched B1 {codec['fwd']}x, B3 {codec['inv']}x; on {smi}",
          flush=True)
    _path_counts("flow", launches,
                 ("fwd", "inv", "fwd_tensor3", "convert", "scale_convert",
                  "fwd_broadcast", "inv_ks", "mod_down"),
                 ("pntt_fwd", "pntt_inv", "pntt_pmul", "fwd_tensor3_full"))
    return launches, launches


U64_KERNELS = ("shoup_mul_mod", "mul_mod", "pointwise_mul_mod")


def u64_mulmod_path(params, smi: str):
    """Path 12: B18 (both entry points) and B19 through
    `pallas_mod.shoup_mul_mod`, `pallas_mod.mul_mod` and
    `pallas_kernels.make_pointwise_mul_mod`, the counterparts of the
    reference's only callers (its tests), on [512, 8192] under each of
    `default(8192)`'s 54-bit limbs and its 56-bit special prime, with full
    and broadcast [8192] tables. Each result equals its plain twin and the
    big-int oracle; then each entry point's rate at the first limb and the
    profile of one call of each."""
    import torch
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.math import pallas_mod as pm

    n = params.poly_degree
    gen = torch.Generator(device=DEV).manual_seed(12)
    _build.reset_launches()
    timed = None
    for q in params.coeff_modulus + (params.special_modulus,):
        x, a, w = _u64_operands(gen, q, U64_ROWS, n)
        fn, twin = _b19(q)
        for tag, wt in (("full", w), ("broadcast", w[1])):
            ws = _shoup_table(wt, q)
            outs = (pm.shoup_mul_mod(x, wt, ws, q), pm.mul_mod(a, wt, q))
            torch.cuda.synchronize()
            for name, got, want, lhs in (
                    ("shoup_mul_mod", outs[0],
                     pm.shoup_mul_mod_plain(x, wt, ws, q), x),
                    ("mul_mod", outs[1], pm.mul_mod_plain(a, wt, q), a)):
                label = f"u64_mulmod {name}@{q.bit_length()}b {tag}"
                if not torch.equal(got, want):
                    raise SystemExit(f"{label}: differs from its plain twin")
                _oracle(label, got, lhs, wt, q)
        halves = _halves(a, w)
        hi, lo = fn(*halves)
        if not torch.equal(torch.stack((hi, lo)), torch.stack(twin(*halves))):
            raise SystemExit(f"u64_mulmod pointwise_mul_mod@"
                             f"{q.bit_length()}b: differs from its twin")
        _oracle(f"u64_mulmod pointwise_mul_mod@{q.bit_length()}b",
                hi * (1 << 32) + lo, a, w, q)
        if timed is None:
            timed = (q, x, a, w, _shoup_table(w, q), fn, halves)
    print(f"u64_mulmod gate: shoup_mul_mod and mul_mod (full and broadcast "
          f"tables) and pointwise_mul_mod on [{U64_ROWS}, {n}] under "
          f"{len(params.coeff_modulus) + 1} moduli of 54-56 bits equal "
          f"their twins and the big-int oracle on {ORACLE_SAMPLES} "
          f"elements each", flush=True)
    q, x, a, w, w_sh, fn, halves = timed
    steps = {"shoup_mul_mod": lambda: pm.shoup_mul_mod(x, w, w_sh, q),
             "mul_mod": lambda: pm.mul_mod(a, w, q),
             "pointwise_mul_mod": lambda: fn(*halves)}
    for name, step in steps.items():
        ms = _median_ms(step, reps=REPS, iters=ITERS)
        print(f"u64_mulmod {name}: {x.numel() / ms * 1e3:.4g} elements/s, "
              f"{ms:.4f} ms of device time per [{U64_ROWS}, {n}] call at "
              f"{q.bit_length()} bits on {smi}", flush=True)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    _path_counts("u64_mulmod", launches, U64_KERNELS,
                 [k for k in launches if k not in U64_KERNELS])
    profile_breakdown("u64_mulmod",
                      lambda: [step() for step in steps.values()])
    return launches, {k: int(k in U64_KERNELS) for k in launches}


def _assert_modes(ctx, mode: str, limbs: tuple[int, int, int]) -> None:
    got = [(p.mode, p.k) for p in (ctx.plan_q, ctx.plan_mul, ctx.plan_key)]
    if got != [(mode, k) for k in limbs]:
        raise SystemExit(f"u64 context plans {got}, expected mode {mode} "
                         f"with {limbs} limbs")


def u64_rotation_gate(label, ctx, inputs) -> None:
    """rotate_rows(ct, 1) of the path's ciphertexts decrypts to the numpy
    automorphism."""
    from sunscreen_tpu_torch.bfv import keys, ops

    g = ctx.rotate_rows_element(1)
    gks = keys.gen_galois_keys(ctx, inputs["sk"], inputs["gen"], (g,))
    dec = ops.decrypt(ctx, inputs["sk"], ops.rotate_rows(
        ctx, inputs["cts"], 1, gks)).cpu().numpy()
    if not np.array_equal(dec, _automorphism(inputs["pts_np"], g, ctx.t)):
        raise SystemExit(f"{label}: rotation decrypt gate FAILED")
    print(f"{label}: {BATCH} rotate_rows(1) results decrypt to the numpy "
          f"automorphism", flush=True)


def u64_multiply_path(params, smi: str):
    """Path 13: `default(8192)` (three 54-bit limbs, a 56-bit special
    prime) at batch 64 under the default settings on CUDA, "pallas"
    degraded to "matmul" as in the reference: plain PyTorch on the card,
    as the reference's u64 engine is plain XLA, so no kernel launches.
    Keygen, encryption, the decrypt gate and a card-vs-CPU check of
    `multiply_relin` (`multiply_path`), then `rotate_rows` behind the
    automorphism gate."""
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.bfv import get_context

    ctx = get_context(params, DEV)
    _assert_modes(ctx, "matmul", (3, 7, 4))
    plans = (ctx.plan_q, ctx.plan_mul, ctx.plan_key)
    print(f"u64 params: N={ctx.n} t={ctx.t} limbs "
          f"{[q.bit_length() for q in params.coeff_modulus]} bits, special "
          f"{params.special_modulus.bit_length()} bits; plans (mode, limbs) "
          f"{[(p.mode, p.k) for p in plans]}", flush=True)
    inputs, _, launches, per_op = multiply_path(
        "multiply_relin_u64", ctx, 13, smi, (), tuple(_build.LAUNCHES))
    u64_rotation_gate("multiply_relin_u64", ctx, inputs)
    if any(_build.LAUNCHES.values()):
        raise SystemExit(f"u64 path launched kernels: {_build.LAUNCHES}")
    return launches, per_op


def golden_u64_path(params, smi: str):
    """Path 14: under SUNSCREEN_TPU_NTT=unrolled and again =compact,
    `insecure(1024, limbs=2)` on the card decrypts golden_v1.npz's
    bfv_mul_relin to bfv_dec_mul and bfv_rot1 and bfv_swap to the
    automorphisms of the decrypted bfv_ct, with bfv_noise_budget; then
    `default(8192)` multiply_relin at batch 64 under "unrolled" (gates,
    rate, profile), and "compact" and "unrolled" forward transforms equal
    on [64, 4, 8192]."""
    import torch
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.bfv import BfvParams, get_context, keys, ops
    from sunscreen_tpu_torch.math import ntt

    here = os.path.dirname(os.path.abspath(__file__))
    golden = np.load(os.path.join(here, "tests", "golden_v1.npz"))

    def dev(name):
        return torch.from_numpy(golden[name].view(np.int64)).to(DEV)

    _build.reset_launches()
    small = BfvParams.insecure(1024, limbs=2)
    if [small.poly_degree, small.plain_modulus, *small.coeff_modulus,
            small.special_modulus] != golden["bfv_params"].tolist():
        raise SystemExit("golden_u64: parameters differ from bfv_params")
    for mode in ("unrolled", "compact"):
        with _gates({"SUNSCREEN_TPU_NTT": mode}):
            ctx = get_context(small, DEV)
            if ctx.mode != mode:
                raise SystemExit(f"golden_u64 got NTT mode {ctx.mode}")
            sk, _, _ = keys.from_reference(ctx, s=golden["bfv_sk"])
            dec = ops.decrypt(ctx, sk, dev("bfv_mul_relin")).cpu().numpy()
            pts = ops.decrypt(ctx, sk, dev("bfv_ct")).cpu().numpy()
            checks = [
                ("bfv_dec_mul", dec, golden["bfv_dec_mul"].astype(np.int64)),
                ("bfv_rot1",
                 ops.decrypt(ctx, sk, dev("bfv_rot1")).cpu().numpy(),
                 _automorphism(pts, ctx.rotate_rows_element(1), ctx.t)),
                ("bfv_swap",
                 ops.decrypt(ctx, sk, dev("bfv_swap")).cpu().numpy(),
                 _automorphism(pts, ctx.rotate_columns_element, ctx.t))]
            for name, got, want in checks:
                if not np.array_equal(got, want):
                    raise SystemExit(f"golden_u64 ({mode}): {name} FAILED")
            budget = ops.invariant_noise_budget(ctx, sk,
                                                dev("bfv_mul_relin"))
            if budget != float(golden["bfv_noise_budget"][0]):
                raise SystemExit(f"golden_u64 ({mode}): noise budget "
                                 f"{budget} != {golden['bfv_noise_budget']}")
        print(f"golden_u64 ({mode}): bfv_mul_relin decrypts to bfv_dec_mul, "
              f"bfv_rot1 and bfv_swap to the automorphisms of bfv_ct, noise "
              f"budget {budget} bits == bfv_noise_budget", flush=True)
    key_mods = params.coeff_modulus + (params.special_modulus,)
    x = _uniform(torch.Generator(device=DEV).manual_seed(14),
                 (BATCH, len(key_mods), params.poly_degree),
                 ntt.get_plan(params.poly_degree, key_mods, DEV,
                              "unrolled").q)
    fwd = {mode: ntt.get_plan(params.poly_degree, key_mods, DEV,
                              mode).fwd(x) for mode in ("unrolled", "compact")}
    if not torch.equal(fwd["unrolled"], fwd["compact"]):
        raise SystemExit("golden_u64: compact and unrolled fwd differ")
    print(f"golden_u64: compact fwd == unrolled fwd on {tuple(x.shape)}",
          flush=True)
    with _gates({"SUNSCREEN_TPU_NTT": "unrolled"}):
        ctx = get_context(params, DEV)
        _assert_modes(ctx, "unrolled", (3, 7, 4))
        _, _, launches, per_op = multiply_path(
            "multiply_relin_u64_unrolled", ctx, 14, smi, (),
            tuple(_build.LAUNCHES))
    return launches, per_op


CHI_IN = (2, 7, 9)
CHI_WANT = (529, 242, 275, 1250)     # examples/chi_sq.py expected(2, 7, 9)
EVERY_LIT = 3                        # the every-op program's literal slots


def compiler_programs():
    """The programs path 20 compiles under the port's `fhe_program`: the
    bodies of examples/simple_multiply.py and of examples/chi_sq.py's
    chi_sq and chi_sq_optimized, and a `Batched` program that emits every
    op kind of the IR."""
    from sunscreen_tpu_torch.compiler import fhe_program
    from sunscreen_tpu_torch.types import Batched, Cipher, Signed

    @fhe_program(scheme="bfv")
    def simple_multiply(a: Cipher[Signed], b: Cipher[Signed]):
        return a * b

    @fhe_program(scheme="bfv")
    def chi_sq(n0: Cipher[Signed], n1: Cipher[Signed], n2: Cipher[Signed]):
        a = 4 * n0 * n2 - n1 * n1
        alpha = a * a
        b1 = 2 * n0 + n1
        b1 = 2 * (b1 * b1)
        b2 = (2 * n0 + n1) * (2 * n2 + n1)
        b3 = 2 * n2 + n1
        b3 = 2 * (b3 * b3)
        return alpha, b1, b2, b3

    @fhe_program(scheme="bfv")
    def chi_sq_optimized(n0: Cipher[Signed], n1: Cipher[Signed],
                         n2: Cipher[Signed]):
        x = n0 + n0 + n1
        y = n2 + n2 + n1
        n0n2 = n0 * n2
        n0n2 = n0n2 + n0n2
        n0n2 = n0n2 + n0n2
        n1sq = n1 * n1
        alpha = n0n2 - n1sq
        alpha = alpha * alpha
        b1 = x * x
        b1 = b1 + b1
        b2 = x * y
        b3 = y * y
        b3 = b3 + b3
        return alpha, b1, b2, b3

    lit = [EVERY_LIT] * N

    @fhe_program(scheme="bfv")
    def every_op(x: Cipher[Batched], y: Cipher[Batched]):
        p = x * y
        return ((x + y) << 1, (x - y) >> 2, p.swap_rows(), x + lit,
                y - lit, x * lit, -y)

    return {f.name: f for f in (simple_multiply, chi_sq, chi_sq_optimized,
                                every_op)}


def _every_op_want(x, y, t: int) -> list:
    """every_op's outputs in numpy, centered mod t (the signed decode)."""
    half = N // 2

    def rot(v, k):
        return np.concatenate([np.roll(v[:half], -k), np.roll(v[half:], -k)])

    p = x * y
    wants = [rot(x + y, 1), rot(x - y, -2),
             np.concatenate([p[half:], p[:half]]), x + EVERY_LIT,
             y - EVERY_LIT, x * EVERY_LIT, -y]
    out = []
    for w in wants:
        w = np.mod(w, t)
        out.append(np.where(w > t // 2, w - t, w))
    return out


def _same_chain(label, params, want) -> None:
    if (params.poly_degree, params.coeff_modulus,
            params.special_modulus) != (want.poly_degree, want.coeff_modulus,
                                        want.special_modulus):
        raise SystemExit(f"{label}: searched params {params} are not "
                         f"{want}'s chain")


def _bits_equal(label, got, want) -> None:
    """Ciphertext lists equal bit for bit, on the host."""
    import torch
    for a, b in zip(got, want, strict=True):
        for x, y in zip(a.cts, b.cts, strict=True):
            if not torch.equal(x.cpu(), y.cpu()):
                raise SystemExit(f"{label}: ciphertexts differ")


def compiler_path(smi: str):
    """Path 20: `@fhe_program` -> `Compiler` -> `Runtime.new_fhe` on the
    card. simple_multiply compiled with the defaults (measured search on,
    engine auto) must find `default_u32(N)`, chi_sq and chi_sq_optimized
    under `PlainModulusConstraint.Raw(64)` its chain; keygen, encrypt,
    `run` and `decrypt_many` must give 15 * 5 and chi_sq(2, 7, 9) for
    both variants; chi_sq on a CPU runtime, with the card's keys and
    inputs, must give the card's ciphertexts bit for bit; it must run
    under two key sets; its keys, inputs and program must round-trip
    through bytes and run again to the same outputs; and the every-op
    `Batched` program, with the 25 default Galois keys, must decode slot
    by slot to numpy. Then the rate and latency of one `run` of chi_sq
    and of simple_multiply (batch 1), their launches and chi_sq's
    profile. Returns the path's launches and those of one chi_sq run."""
    import torch
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.bfv import BfvParams
    from sunscreen_tpu_torch.compiler import Compiler, PlainModulusConstraint
    from sunscreen_tpu_torch.runtime import Runtime
    from sunscreen_tpu_torch.runtime import serialization as ser
    from sunscreen_tpu_torch.types import Batched, Signed

    label = "compiler"
    progs = compiler_programs()
    default = BfvParams.default_u32(N)
    _build.reset_launches()
    t0 = time.perf_counter()
    app = Compiler(DEV).fhe_program(progs["simple_multiply"]).compile()
    if app.params != default:
        raise SystemExit(f"{label}: simple_multiply searched {app.params}, "
                         f"not default_u32({N})")
    chi = {}
    for name in ("chi_sq", "chi_sq_optimized"):
        chi[name] = (Compiler(DEV).fhe_program(progs[name])
                     .plain_modulus_constraint(
                         PlainModulusConstraint.Raw(64))
                     .compile().get_program(name))
        _same_chain(f"{label} {name}", chi[name].params, default)
    print(f"{label}: measured search found default_u32({N}) for "
          f"simple_multiply (t = {app.params.plain_modulus}) and its chain "
          f"at t = 64 for chi_sq and chi_sq_optimized, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rt = Runtime.new_fhe(app.params, DEV)
    pub, priv = rt.generate_keys(galois=False)
    mul = app.get_program("simple_multiply")
    mul_args = [rt.encrypt(Signed(v), pub) for v in (15, 5)]
    if rt.decrypt_many(rt.run(mul, mul_args, pub), priv) != [75]:
        raise SystemExit(f"{label}: simple_multiply(15, 5) != 75")

    params64 = chi["chi_sq"].params
    rt64 = Runtime.new_fhe(params64, DEV)
    pub64, priv64 = rt64.generate_keys(galois=False)
    args = [rt64.encrypt(Signed(v), pub64) for v in CHI_IN]
    outs = {}
    for name, prog in chi.items():
        outs[name] = rt64.run(prog, args, pub64)
        got = tuple(rt64.decrypt_many(outs[name], priv64))
        if got != CHI_WANT:
            raise SystemExit(f"{label}: {name}{CHI_IN} = {got}, not "
                             f"{CHI_WANT}")
    print(f"{label} decrypt gate: simple_multiply(15, 5) = 75, chi_sq and "
          f"chi_sq_optimized{CHI_IN} = {CHI_WANT}", flush=True)

    rt_cpu = Runtime.new_fhe(params64, "cpu")
    _bits_equal(f"{label} chi_sq card vs CPU", outs["chi_sq"], rt_cpu.run(
        chi["chi_sq"], [c.to("cpu") for c in args], pub64.to("cpu")))
    print(f"{label}: chi_sq on the card == CPU plain path, bit for bit",
          flush=True)

    pub2, priv2 = rt64.generate_keys(galois=False)
    args2 = [rt64.encrypt(Signed(v), pub2) for v in CHI_IN]
    for pk, sk, a in ((pub2, priv2, args2), (pub64, priv64, args)):
        got = tuple(rt64.decrypt_many(rt64.run(chi["chi_sq"], a, pk), sk))
        if got != CHI_WANT:
            raise SystemExit(f"{label}: chi_sq under a second key set = "
                             f"{got}")
    print(f"{label}: one compiled chi_sq under two key sets decrypts "
          f"under each", flush=True)

    prog_l = ser.program_from_bytes(ser.program_to_bytes(chi["chi_sq"]))
    pub_l, _ = ser.public_keys_from_bytes(
        ser.public_keys_to_bytes(pub64, params64), params64, DEV)
    args_l = [ser.ciphertext_from_bytes(ser.ciphertext_to_bytes(c),
                                        params64, DEV) for c in args]
    outs_l = rt64.run(prog_l, args_l, pub_l)
    _bits_equal(f"{label} serialization", outs_l, outs["chi_sq"])
    _bits_equal(f"{label} output bytes", [
        ser.ciphertext_from_bytes(ser.ciphertext_to_bytes(c), params64, DEV)
        for c in outs_l], outs_l)
    print(f"{label}: chi_sq's program, public keys and inputs through "
          f"bytes run to the same ciphertexts, bit for bit", flush=True)

    every = (Compiler(DEV).with_params(default)
             .fhe_program(progs["every_op"]).compile()
             .get_program("every_op"))
    ops_used = {node.op.value for node in every.nodes}
    rtb = Runtime.new_fhe(default, DEV)
    t0 = time.perf_counter()
    pubb, privb = rtb.generate_keys()
    keygen_s = time.perf_counter() - t0
    rng = np.random.default_rng(20)
    x, y = rng.integers(-1000, 1000, (2, N))
    got = rtb.decrypt_many(rtb.run(every, [rtb.encrypt(Batched(x), pubb),
                                           rtb.encrypt(Batched(y), pubb)],
                                   pubb), privb)
    for i, (g, w) in enumerate(zip(got, _every_op_want(
            x, y, default.plain_modulus), strict=True)):
        if not np.array_equal(g, w):
            raise SystemExit(f"{label}: every_op output {i} FAILED the "
                             f"slot gate")
    print(f"{label} slot gate: every_op's {len(got)} outputs decode to "
          f"numpy slot by slot; ops {sorted(ops_used)}; keygen with "
          f"{len(pubb.galois_keys.keys)} Galois keys {keygen_s:.1f} s",
          flush=True)

    def chi_step():
        rt64.run(chi["chi_sq"], args, pub64)

    def mul_step():
        rt.run(mul, mul_args, pub)

    for name, step in (("chi_sq", chi_step), ("simple_multiply", mul_step)):
        rate = _rate(step, per_step=1)
        print(f"{name} run: {rate:.1f} ops/s (N={N}, batch 1, median of "
              f"{REPS} x {ITERS}); latency {_latency_ms(step):.3f} ms "
              f"(median of {REPS}) on {smi}", flush=True)
    per_op = _per_op(chi_step)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if per_op["fwd_tensor3"] != 6 or per_op["inv_ks"] != 6:
        raise SystemExit(f"{label}: one chi_sq run launched fwd_tensor3 "
                         f"{per_op['fwd_tensor3']}x and inv_ks "
                         f"{per_op['inv_ks']}x, not 6x each")
    _path_counts(label, launches, DEFAULT_MUL,
                 NEW_KERNELS + ("fwd_tensor3_full", "pntt_fwd", "pntt_inv",
                                "pntt_pmul") + U64_KERNELS)
    print(f"launches per chi_sq run: {json.dumps(per_op)}", flush=True)
    profile_breakdown("chi_sq_run", chi_step)
    return launches, per_op


# --- M1 and path 21: the ZKP stack ----------------------------------------
MSM_NS = (2049, 4096, 65536)   # the prover's A_I1 and S1 at 1024 gates,
#                                benchmarks/zkp_bench.py's MSM_N, a large MSM
MSM_DISTINCT = 64              # distinct points of a kernel-phase MSM, tiled
# 32-bit multiplies of a point addition: 9 field multiplies of 64 products
# and 8 for the fold by 38, each 32 x 32 -> 64 bits counting 2
MSM_ADD_MULS = 9 * 72 * 2
JOIN_REPS = 5                  # launches whose join times give the median
SRC_MSM = "sunscreen_tpu_torch/csrc/msm.cu"
ZKP_CONST, ZKP_OUT_OF_RANGE = 4, 8   # the balance 7 against 4, and 7 - 8 < 0
ZKP_SEED = 21                  # blindings of the seeded proofs
ZKP_REPS = 5                   # prove and verify times: median of 5


def _wall_ms(fn, reps: int) -> float:
    """Host ms of one synchronized call of fn: the median of `reps` after a
    warm call (for host-bound work, which `_median_ms`'s spin cannot
    cover)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def msm_inputs(n: int, seed: int):
    """Seeded scalars holding 0, 1, L - 1 and 2^252, an eighth of bits (as
    the prover's witnesses) and a sixteenth of one repeated scalar (repeated
    digits), and MSM_DISTINCT points tiled (repeated points)."""
    import random
    from sunscreen_tpu_torch.zk import curve25519 as cv
    from sunscreen_tpu_torch.zk import native
    rng = random.Random(seed)
    sc = [rng.randrange(cv.L) for _ in range(n)]
    sc[:4] = [0, 1, cv.L - 1, 1 << 252]
    sc[4:n // 8] = [rng.randrange(2) for _ in range(4, n // 8)]
    sc[n // 2:n // 2 + n // 16] = [sc[n // 2]] * (n // 16)
    base = native.batch_scalar_mul(
        [rng.randrange(1, cv.L) for _ in range(MSM_DISTINCT)],
        [cv.BASEPOINT] * MSM_DISTINCT)
    return sc, [base[i % MSM_DISTINCT] for i in range(n)]


def msm_ptxas() -> dict[str, dict[str, int]]:
    """ptxas' registers, stack and spills of msm.cu's kernels."""
    from sunscreen_tpu_torch import _build
    out, kernel, spill = {}, None, None
    for line in _build.build_log("msm").splitlines():
        m = re.search(r"entry function '(_Z\w+)'", line)
        if m:
            kernel = _demangle(m.group(1))[0]
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads", line)
        if m and kernel:
            spill = [int(v) for v in m.groups()]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel and spill:
            out[kernel] = {"registers": int(m.group(1)), "stack": spill[0],
                           "spill_stores": spill[1], "spill_loads": spill[2]}
            print(f"ptxas {kernel}: {m.group(1)} registers, {spill[0]} B "
                  f"stack, {spill[1]}/{spill[2]} B spill stores/loads",
                  flush=True)
            kernel = spill = None
    return out


def msm_case(n: int) -> dict:
    """M1 (`cuda_curve.msm`, csrc/msm.cu) on `msm_inputs(n, n)`: the
    kernel's sum, its plain version's on the card and the host C++
    Pippenger's (`ristretto_msm`, threaded) must encode to the same
    ristretto bytes, and a second launch must give the first one's raw
    bytes (at n = MSM_NS[-1] also the kernel at c = MAX_C against the host
    C++); then the kernel's device time, the plain version's and the host
    C++'s wall time, the bound (32-bit multiplies of ceil(253 / c)
    (n + 2^(c + 1)) point additions at the c that needs the fewest,
    whatever the kernel's own limit on c, or the bytes of the scalars and
    points, whichever takes longer), each of M1's kernels' device time
    (profile) and the chain floor: the join's own time as the kernel reads
    it from the globaltimer (`cuda_curve.join_times`, the median of
    JOIN_REPS launches), c (nwin - 1) doublings and nwin - 1 additions one
    after another, without its waits for lower windows, with its latency a
    point operation. Returns the numbers of M1's row at n."""
    import torch
    from sunscreen_tpu_torch.zk import cuda_curve as cc
    from sunscreen_tpu_torch.zk import native

    sc, pts = msm_inputs(n, n)
    s, p = cc.to_tensors(sc, pts, DEV)
    del sc, pts
    c = cc.window_bits(n)
    got = cc.msm(s, p)
    again = cc.msm(s, p)
    torch.cuda.synchronize()
    plain = cc.msm_plain(s, p, c)
    torch.cuda.empty_cache()
    sb, pb = bytes(s.cpu().numpy()), bytes(p.cpu().numpy())
    enc = [cc.point_of(got).encode(), cc.point_of(plain).encode(),
           native.msm_bufs(sb, pb, n).encode()]
    err = max(abs(a - b) for a, b in zip(enc[0], enc[1]))
    exact = enc[0] == enc[1] == enc[2]
    same = torch.equal(got, again)
    print(f"check msm@{n} (c = {c}): kernel == plain == host C++ by "
          f"ristretto encoding: {exact} (tolerance 0: exact group "
          f"arithmetic); two launches give the same raw bytes: {same}",
          flush=True)
    if not exact:
        raise SystemExit(f"kernel msm@{n} disagrees: kernel "
                         f"{enc[0].hex()}, plain {enc[1].hex()}, host "
                         f"C++ {enc[2].hex()}")
    if not same:
        raise SystemExit(f"kernel msm@{n}: two launches gave "
                         f"{got.cpu().numpy().tobytes().hex()} and "
                         f"{again.cpu().numpy().tobytes().hex()}")
    if n == MSM_NS[-1]:            # the widest window the kernel takes
        wide = cc.point_of(cc.msm(s, p, cc.MAX_C)).encode()
        print(f"check msm@{n} at c = MAX_C = {cc.MAX_C}: kernel == host "
              f"C++: {wide == enc[2]}", flush=True)
        if wide != enc[2]:
            raise SystemExit(f"kernel msm@{n} at c = {cc.MAX_C} "
                             f"disagrees: {wide.hex()}")
    ms = _median_ms(lambda: cc.msm(s, p), reps=5, iters=KERNEL_ITERS)
    plain_ms = _wall_ms(lambda: cc.msm_plain(s, p, c), reps=1)
    torch.cuda.empty_cache()
    host_ms = _wall_ms(lambda: native.msm_bufs(sb, pb, n), reps=3)
    adds = cc.fewest_additions(n)
    t_ops = adds * MSM_ADD_MULS / PEAK_INT_MULS_PER_S * 1e3
    t_bytes = (160 * n + 128) / PEAK_BYTES_PER_S * 1e3
    kernels = profile_breakdown(f"msm@{n}", lambda: cc.msm(s, p),
                                batches=3)["per_kernel"]
    kernels = {k: v for k, v in kernels.items() if k.startswith("msm_")}
    nwin = -(-cc.SCALAR_BITS // c)
    chain_ops = c * (nwin - 1) + nwin - 1
    joins = sorted(cc.join_times(s, p) for _ in range(JOIN_REPS))
    floor, waited = joins[JOIN_REPS // 2]
    total = sum(kernels.values())
    print(f"time msm@{n}: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, "
          f"host C++ {host_ms:.3f} ms ({os.cpu_count()} cores), bound "
          f"{max(t_ops, t_bytes):.4f} ms ({adds} point additions "
          f"= {adds * MSM_ADD_MULS / 1e9:.4f} G 32-bit multiplies "
          f"= {t_ops:.4f} ms, {160 * n + 128} B = {t_bytes:.5f} ms), "
          f"chain floor {floor:.4f} ms (the join: {c * (nwin - 1)} "
          f"doublings and {nwin - 1} additions, "
          f"{1e3 * floor / chain_ops:.3f} us a point operation; it "
          f"also waited {waited:.4f} ms for lower windows)", flush=True)
    print(f"time msm@{n} by kernel (profile, ms a call): "
          + ", ".join(f"{k} {v:.4f} ({100 * v / total:.1f}%)"
                      for k, v in kernels.items()), flush=True)
    return {"n": n, "c": c, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "host_cpp_ms": host_ms,
            "chain_floor_ms": floor, "join_wait_ms": waited,
            "kernels_ms": kernels}


def check_msm() -> dict:
    """M1 at each of MSM_NS (`msm_case`). Returns M1's row of the kernels
    line (its main shape n = 2049, path 21's)."""
    at = {n: msm_case(n) for n in MSM_NS}
    main_n, *others = MSM_NS
    return {"name": "msm", "route": "cuda", "source": SRC_MSM,
            "replaces": "sunscreen_tpu/zk/tpu_curve.py:240", "launches": 0,
            **at[main_n], **{f"at_{n}": at[n] for n in others},
            "ptxas": msm_ptxas()}


def fractional_range_program():
    """benchmarks/zkp_bench.py's fractional range proof (upstream
    `benches/fractional_range_proof.rs`) under the port's `@zkp_program`:
    [[Field; 8]; 64] private two's-complement bits recombined into a
    value, minus a constant, must fit 8 bits. Returns the program and the
    bits of the balance 7 = 3 * 1 + 2 * 2."""
    from sunscreen_tpu_torch.types.zkp_types import (Constant, Field,
                                                     Private, zkp_program)

    @zkp_program()
    def in_range(balance: Private[Field, (64, 8)],
                 unshielded: Constant[Field]):
        def coeff(bits):
            acc = None
            for i, b in enumerate(bits):
                t = b * ((1 << i) if i < 7 else -(1 << 7))
                acc = t if acc is None else acc + t
            return acc

        val = None
        for j, row in enumerate(balance):
            t = coeff(row) * (1 << j)
            val = t if val is None else val + t
        (val - unshielded).to_unsigned(8)

    bal = [[0] * 8 for _ in range(64)]
    bal[0][0] = bal[0][1] = bal[1][1] = 1
    return in_range, [b for row in bal for b in row]


def zkp_path(label, smi: str, device_msm: bool, want=None):
    """Path 21 (device_msm) or 21b (under SUNSCREEN_TPU_MSM=0): the
    fractional range proof through `@zkp_program` ->
    `Compiler(DEV).zkp_backend().zkp_program(f).compile()` ->
    `Runtime.new_zkp()` on the card -> prove and verify (1024 gates). Gates:
    the proof verifies, not against another constant, and a witness out of
    range raises; under blindings seeded with ZKP_SEED the proof's bytes
    equal those of the port on device="cpu" (and `want`, path 21's), and it
    verifies on the CPU; a proof launches M1 twice and a verification twice
    (21b: never). Then prove and verify ms (median of ZKP_REPS), proofs/s
    and, on path 21, the device's busy share of a proof (profile). Returns
    the path's launches and those of one proof, and the seeded proof's
    bytes."""
    import torch
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.compiler import Compiler
    from sunscreen_tpu_torch.runtime import Runtime
    from sunscreen_tpu_torch.zk.backend import BulletproofsProof
    from sunscreen_tpu_torch.zk.r1cs import scalar_source

    prog, flat = fractional_range_program()
    const = [ZKP_CONST]
    _build.reset_launches()
    t0 = time.perf_counter()
    zp = (Compiler(DEV).zkp_backend().zkp_program(prog).compile()
          .get_zkp_program(prog))
    rt = Runtime.new_zkp(device=DEV)
    setup_s = time.perf_counter() - t0
    proof = rt.prove(zp, flat, constant_inputs=const)
    if not rt.verify(zp, proof, constant_inputs=const):
        raise SystemExit(f"{label}: the proof does not verify")
    if rt.verify(zp, proof, constant_inputs=[ZKP_CONST + 1]):
        raise SystemExit(f"{label}: the proof verifies against another "
                         f"constant")
    try:
        rt.prove(zp, flat, constant_inputs=[ZKP_OUT_OF_RANGE])
    except ValueError:
        pass
    else:
        raise SystemExit(f"{label}: a witness out of range was proved")
    print(f"{label} gates: the proof verifies, not against the constant "
          f"{ZKP_CONST + 1}, and 7 - {ZKP_OUT_OF_RANGE} raises (compile and "
          f"runtime {setup_s:.1f} s)", flush=True)

    def prove(on=rt):
        return on.backend.prove(zp.build(), flat, constant_inputs=const,
                                device=on.device,
                                rand_scalar=scalar_source(ZKP_SEED))

    def verify():
        return rt.verify(zp, seeded, constant_inputs=const)

    before = _build.LAUNCHES["msm"]
    seeded = prove()
    per_prove = _build.LAUNCHES["msm"] - before
    before = _build.LAUNCHES["msm"]
    ok = verify()
    per_verify = _build.LAUNCHES["msm"] - before
    want_per = 2 if device_msm else 0
    if not ok or (per_prove, per_verify) != (want_per, want_per):
        raise SystemExit(f"{label}: seeded proof verifies {ok}; msm "
                         f"launches {per_prove} a proof and {per_verify} a "
                         f"verification, not {want_per}")
    blob = seeded.to_bytes()
    cpu = Runtime.new_zkp(device="cpu")
    if prove(cpu).to_bytes() != blob:
        raise SystemExit(f"{label}: seeded proof bytes differ from the CPU's")
    if want is not None and blob != want:
        raise SystemExit(f"{label}: seeded proof bytes differ from path 21's")
    if not cpu.verify(zp, BulletproofsProof.from_bytes(blob),
                      constant_inputs=const):
        raise SystemExit(f"{label}: the card's proof does not verify on the "
                         f"CPU")
    print(f"{label}: seeded proof == the CPU's{' == path 21' if want else ''}"
          f", byte for byte ({len(blob)} B), and verifies on the CPU; msm "
          f"launches {per_prove} a proof, {per_verify} a verification",
          flush=True)
    prove_ms = _wall_ms(prove, ZKP_REPS)
    verify_ms = _wall_ms(verify, ZKP_REPS)
    print(f"{label}: {1e3 / prove_ms:.4f} proofs/s; prove {prove_ms:.1f} ms, "
          f"verify {verify_ms:.1f} ms (median of {ZKP_REPS}, 1024 gates) on "
          f"{smi}", flush=True)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    _path_counts(label, launches, ("msm",) if device_msm else (),
                 tuple(k for k in launches if k != "msm" or not device_msm))
    if device_msm:
        prof = profile_breakdown(label, prove, batches=1, warmup=verify)
        print(f"{label}: the device is busy {prof['busy_ms']:.3f} ms of a "
              f"proof's {prof['wall_ms']:.1f} ms "
              f"({100 * prof['busy_ms'] / prof['wall_ms']:.2f}%)", flush=True)
    per_op = dict.fromkeys(launches, 0)
    per_op["msm"] = per_prove
    return (launches, per_op), blob



# --- paths 22-24: the SDLP, linked proofs and TFHE's SDLP ----------------
SDLP_PARAMS = {"poly_degree": 1024, "limbs": 2, "limb_bits": 28}
#              benchmarks/sdlp_bench.py (upstream logproof/tests/seal.rs)
SDLP_SEED = 7                  # path 22's keys, plaintext and encryption
SDLP_BLIND = 22                # blindings of the seeded proofs
SDLP_REPS = 3                  # create and verify times: median of 3
SDLP_LABEL = b"bfv-sdlp"
SDLP_OUT_OF_BOUND = 64         # added to e0's first coefficient (< 2^5)
LINKED_KEYS, LINKED_ENC = 4, 41    # tests/test_linked.py:234-265
LINKED_BALANCE, LINKED_TX, LINKED_OVER = 1000, 400, 40000
LWE_BITS, LWE_MSG, LWE_SEED = 2, 1, 24


def _m1_launches(sizes, device_msm: bool) -> int:
    """The M1 launches the code predicts for MSMs of `sizes` points."""
    from sunscreen_tpu_torch.zk.curve25519 import DEVICE_MSM_MIN
    return sum(n >= DEVICE_MSM_MIN for n in sizes) if device_msm else 0


@contextlib.contextmanager
def _msm_sizes(out: list):
    """Records the points of every M1 launch in `out` (the launch counts
    are the wrapper's own)."""
    from sunscreen_tpu_torch.zk import cuda_curve as cc
    launch = cc._launch

    def record(scalars, points, c):
        out.append(scalars.shape[0])
        return launch(scalars, points, c)

    cc._launch = record
    try:
        yield out
    finally:
        cc._launch = launch


def sdlp_setup() -> dict:
    """Path 22's statement, as benchmarks/sdlp_bench.py builds it, on the
    card: keys at SDLP_PARAMS, `encrypt_return_components` of a seeded
    plaintext behind a decrypt gate, `BfvStatements.add_public_encryption`
    and `build`, then `LogProofGenerators(l)`."""
    import torch
    from sunscreen_tpu_torch.bfv import BfvParams, get_context, keys, ops
    from sunscreen_tpu_torch.logproof import (BfvStatements,
                                              LogProofGenerators)
    from sunscreen_tpu_torch.math import sampling

    ctx = get_context(BfvParams.insecure(**SDLP_PARAMS), DEV)
    rng = sampling.key_from_seed(SDLP_SEED)
    t0 = time.perf_counter()
    sk = keys.gen_secret_key(ctx, rng)
    pk = keys.gen_public_key(ctx, sk, rng)
    pt = torch.as_tensor(rng.integers(0, ctx.t, ctx.n), device=DEV)
    ct, comps = ops.encrypt_return_components(ctx, pk, pt, rng)
    if not torch.equal(ops.decrypt(ctx, sk, ct), pt):
        raise SystemExit("sdlp: the ciphertext does not decrypt")
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    st = BfvStatements(ctx)
    st.add_public_encryption(st.add_message(pt), ct, pk, *comps)
    t0 = time.perf_counter()
    vk, know = st.build()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gens = LogProofGenerators(vk.l)
    gens_s = time.perf_counter() - t0
    print(f"sdlp: N = {ctx.n}, k = {ctx.k} ({ctx.mode}), l = {vk.l} bits "
          f"(n={vk.n} m={vk.m} k={vk.k} d={vk.d}); keygen, encryption and "
          f"decrypt gate {enc_s:.2f} s on the card, statement build "
          f"{build_s:.2f} s, generators {gens_s:.2f} s", flush=True)
    return {"st": st, "vk": vk, "know": know, "gens": gens}


def _tampered_t(vk, delta: int):
    """vk with T's first coefficient moved by delta."""
    from sunscreen_tpu_torch.logproof import VerifierKnowledge
    t = [[list(p) for p in row] for row in vk.t]
    t[0][0][0] = (t[0][0][0] + delta) % vk.q
    return VerifierKnowledge(vk.a, t, vk.bounds, vk.f, vk.q, vk.n_messages)


def sdlp_path(label, smi: str, state: dict, device_msm: bool, want=None):
    """Path 22 (device_msm) or 22b (under SUNSCREEN_TPU_MSM=0, on path 22's
    statement): `linear_relation.create` and `verify` on the card with the
    statement's cached generators. Gates: the seeded proof verifies; M1
    launches in one create and in one verify what `msm_sizes` predicts
    (22b: none); the proof's bytes equal the CPU's (22b: path 22's). On
    path 22 also: refused against a changed T and after a flipped bit of
    its z_1, and a witness past its bound (e0 + SDLP_OUT_OF_BOUND, T moved
    with it so that the relation holds) raises ValueError, as the
    reference refuses it (`tests/test_logproof.py:162`); then create and
    verify times (median of SDLP_REPS) and the device's busy share of a
    create (profile). Returns the path's launches and those of one create,
    and the seeded proof's bytes."""
    import torch
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.logproof import inner_product as ipp
    from sunscreen_tpu_torch.logproof import linear_relation as lr
    from sunscreen_tpu_torch.zk.curve25519 import DecodeError
    from sunscreen_tpu_torch.zk.merlin import Transcript
    from sunscreen_tpu_torch.zk.r1cs import scalar_source

    vk, know, gens = state["vk"], state["know"], state["gens"]
    u = ipp.get_u()
    sizes = lr.msm_sizes(vk.l)
    want_create = _m1_launches(
        sizes["create"] + ([] if gens.h_sum_cached else sizes["h_sum"]),
        device_msm)
    want_verify = _m1_launches(sizes["verify"], device_msm)

    def create(device=DEV, k=None):
        return lr.create(Transcript(SDLP_LABEL), k or know, gens.g, gens.h,
                         u, gens=gens, device=device,
                         rand_fn=scalar_source(SDLP_BLIND))

    def verify(proof, statement=vk):
        return lr.verify(proof, Transcript(SDLP_LABEL), statement, gens.g,
                         gens.h, u, gens=gens, device=DEV)

    before = _build.LAUNCHES["msm"]
    t0 = time.perf_counter()
    proof = create()
    create_s = time.perf_counter() - t0
    per_create = _build.LAUNCHES["msm"] - before
    before = _build.LAUNCHES["msm"]
    t0 = time.perf_counter()
    ok = verify(proof)
    verify_s = time.perf_counter() - t0
    per_verify = _build.LAUNCHES["msm"] - before
    print(f"{label}: msm launches {per_create} in a create (predicted "
          f"{want_create}: MSMs of {sizes['create']} points"
          f"{'' if gens.h_sum_cached else ' and the sum of h'}), "
          f"{per_verify} in a verify (predicted {want_verify}: "
          f"{sizes['verify']} points); first create {create_s:.2f} s, "
          f"verify {verify_s:.2f} s", flush=True)
    if not ok or (per_create, per_verify) != (want_create, want_verify):
        raise SystemExit(f"{label}: the proof verifies {ok}; msm launches "
                         f"{per_create} and {per_verify}, predicted "
                         f"{want_create} and {want_verify}")
    blob = proof.to_bytes()
    if want is not None:
        if blob != want:
            raise SystemExit(f"{label}: proof bytes differ from path 22's")
        print(f"{label}: seeded proof == path 22's, byte for byte "
              f"({len(blob)} B)", flush=True)
        return _sdlp_counts(label, device_msm, per_create), blob
    if create(device="cpu").to_bytes() != blob:
        raise SystemExit(f"{label}: seeded proof bytes differ from the CPU's")
    if verify(proof, _tampered_t(vk, 1)):
        raise SystemExit(f"{label}: the proof verifies against a changed T")
    raw = bytearray(blob)
    raw[-96] ^= 1                       # z_1's lowest bit
    try:
        flipped = verify(lr.LogProof.from_bytes(bytes(raw)))
    except DecodeError:
        flipped = False
    if flipped:
        raise SystemExit(f"{label}: the proof verifies with z_1 flipped")
    cu, ce0, _ = state["st"]._layout()[2][0]
    s = [[list(p) for p in col] for col in know.s]
    s[ce0][0][0] = (s[ce0][0][0] + SDLP_OUT_OF_BOUND) % vk.q
    try:
        create(k=lr.ProverKnowledge(_tampered_t(vk, SDLP_OUT_OF_BOUND), s))
    except ValueError as e:
        refused = str(e)
    else:
        raise SystemExit(f"{label}: a witness past its bound was proved")
    print(f"{label} gates: seeded proof == the CPU's, byte for byte "
          f"({len(blob)} B); refused against a changed T and with z_1 "
          f"flipped; e0 + {SDLP_OUT_OF_BOUND} refused ({refused})",
          flush=True)

    def timed(fn):
        times = []
        for _ in range(SDLP_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[SDLP_REPS // 2]

    create_ms = timed(create)
    verify_ms = timed(lambda: verify(proof))
    print(f"{label}: l = {vk.l}, create {create_ms:.1f} ms, verify "
          f"{verify_ms:.1f} ms (median of {SDLP_REPS}), proof {len(blob)} B "
          f"on {smi}", flush=True)
    prof = profile_breakdown(label, create, batches=1,
                             warmup=lambda: verify(proof))
    print(f"{label}: the device is busy {prof['busy_ms']:.3f} ms of a "
          f"create's {prof['wall_ms']:.1f} ms "
          f"({100 * prof['busy_ms'] / prof['wall_ms']:.2f}%), "
          f"{prof['ops']:.0f} device ops", flush=True)
    return _sdlp_counts(label, device_msm, per_create), blob


def _sdlp_counts(label, device_msm: bool, per_create: int):
    """The path's launches (M1 needed, or absent under 22b) and those of
    one create."""
    import torch
    from sunscreen_tpu_torch import _build
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    _path_counts(label, launches, ("msm",) if device_msm else (),
                 () if device_msm else ("msm",))
    per_op = dict.fromkeys(launches, 0)
    per_op["msm"] = per_create
    return launches, per_op


def linked_path(label, smi: str) -> tuple:
    """Path 23: tests/test_linked.py:234-265's linked proof at SDLP_PARAMS
    through `Runtime.new_fhe_zkp` -> `LogProofBuilder` on the card:
    `encrypt_returning_link(Signed(1000))`, `build_linked(prod_balance,
    public_inputs=[400])` (SDLP + Bulletproofs + the compressed bridge).
    Gates: it verifies, not with 40000, its bridge is under 8192 bytes,
    the ciphertext decrypts to 1000, and M1 launched. Then the device's
    busy share of a proof (profile, after a warm-up M1 launch). Returns
    the path's launches and those of one proof, and the statement's
    l."""
    import torch
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.bfv import BfvParams
    from sunscreen_tpu_torch.runtime import Runtime
    from sunscreen_tpu_torch.runtime.linked import LogProofBuilder
    from sunscreen_tpu_torch.types import Signed
    from sunscreen_tpu_torch.types.zkp_types import (BfvSigned, Field,
                                                     Linked, Public,
                                                     zkp_program)
    from sunscreen_tpu_torch.zk import cuda_curve, curve25519

    @zkp_program()
    def prod_balance(balance: Linked[BfvSigned], unshielded: Public[Field]):
        balance.constrain_fresh_encoding()
        diff = balance.into_field_elem() - unshielded
        diff.to_unsigned(16)
        unshielded.to_unsigned(16)

    rt = Runtime.new_fhe_zkp(BfvParams.insecure(**SDLP_PARAMS), device=DEV)
    pub, priv = rt.generate_keys(seed=LINKED_KEYS, galois=False, relin=False)
    builder = LogProofBuilder(rt)
    ct, _ = builder.encrypt_returning_link(Signed(LINKED_BALANCE), pub,
                                           seed=LINKED_ENC)
    def prove():
        return builder.build_linked(prod_balance, public_inputs=[LINKED_TX])

    before = _build.LAUNCHES["msm"]
    t0 = time.perf_counter()
    proof = prove()
    prove_s = time.perf_counter() - t0
    per_prove = _build.LAUNCHES["msm"] - before
    before = _build.LAUNCHES["msm"]
    t0 = time.perf_counter()
    ok = proof.verify(prod_balance, public_inputs=[LINKED_TX])
    verify_s = time.perf_counter() - t0
    per_verify = _build.LAUNCHES["msm"] - before
    over = proof.verify(prod_balance, public_inputs=[LINKED_OVER])
    sizes = proof.size_bytes()
    dec = rt.decrypt(ct, priv)
    print(f"{label}: l = {proof.vk.l}, prove {prove_s:.2f} s ({per_prove} "
          f"msm launches), verify {verify_s:.2f} s ({per_verify} msm "
          f"launches), proof bytes {json.dumps(sizes)} on {smi}", flush=True)
    if not ok or over or sizes["bridge"] >= 8192 or dec != LINKED_BALANCE \
            or per_prove + per_verify == 0:
        raise SystemExit(f"{label}: verifies {ok}, with {LINKED_OVER} "
                         f"{over}, bridge {sizes['bridge']} B, decrypts to "
                         f"{dec}, msm launches {per_prove + per_verify}")
    print(f"{label} gates: verifies with {LINKED_TX}, not with "
          f"{LINKED_OVER}; bridge {sizes['bridge']} B < 8192; decrypts to "
          f"{dec}", flush=True)
    warm = cuda_curve.to_tensors([1] * curve25519.DEVICE_MSM_MIN,
                                 [curve25519.BASEPOINT]
                                 * curve25519.DEVICE_MSM_MIN, DEV)
    prof = profile_breakdown(label, prove, batches=1,
                             warmup=lambda: cuda_curve.msm(*warm))
    print(f"{label}: the device is busy {prof['busy_ms']:.3f} ms of a "
          f"proof's {prof['wall_ms']:.1f} ms "
          f"({100 * prof['busy_ms'] / prof['wall_ms']:.2f}%), "
          f"{prof['ops']:.0f} device ops", flush=True)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    _path_counts(label, launches, ("msm",))
    per_op = dict.fromkeys(launches, 0)
    per_op["msm"] = per_prove
    return (launches, per_op), proof.vk.l


def lwe_path(label, s: dict, smi: str):
    """Path 24: TFHE's SDLP (`tfhe/zkp.py`) on an LWE_512_80 encryption of
    LWE_MSG under path 7's key, its noise bound 8 sigma: the proof verifies
    on the card, not after the ciphertext's b changes, and M1 launches what
    `msm_sizes` predicts from l (fresh generators each call, so the sum of
    h in both). Returns the path's launches and those of one proof."""
    import math

    import torch
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.logproof import linear_relation as lr
    from sunscreen_tpu_torch.tfhe import ops, torus, zkp
    from sunscreen_tpu_torch.zk import native

    native.require_lib()                # its g++ build is not timed
    lwe = s["lwe"]
    gen = torch.Generator(device=DEV).manual_seed(LWE_SEED)
    _build.reset_launches()
    ct, e = ops.encrypt_lwe_return_components(
        torus.encode(LWE_MSG, LWE_BITS, DEV), s["lwe_sk"], lwe, gen)
    noise_bits = math.ceil(math.log2(8 * lwe.std * 2.0 ** 64))
    if abs(int(e)) >= 1 << noise_bits:
        raise SystemExit(f"{label}: noise {int(e)} past 8 sigma")
    vk = zkp.lwe_statement(ct, lwe, LWE_BITS, noise_bits)
    sizes = lr.msm_sizes(vk.l)
    want = (_m1_launches(sizes["create"] + sizes["h_sum"], True),
            _m1_launches(sizes["verify"] + sizes["h_sum"], True))
    t0 = time.perf_counter()
    proof, vk = zkp.prove_lwe_encryption(ct, s["lwe_sk"], LWE_MSG, int(e),
                                         lwe, LWE_BITS, noise_bits,
                                         device=DEV)
    prove_ms = (time.perf_counter() - t0) * 1e3
    per_prove = _build.LAUNCHES["msm"]
    t0 = time.perf_counter()
    ok = zkp.verify_lwe_encryption(proof, vk, device=DEV)
    verify_ms = (time.perf_counter() - t0) * 1e3
    per_verify = _build.LAUNCHES["msm"] - per_prove
    moved = ct.clone()
    moved[-1] += 1
    bad = zkp.verify_lwe_encryption(
        proof, zkp.lwe_statement(moved, lwe, LWE_BITS, noise_bits),
        device=DEV)
    print(f"{label}: l = {vk.l} ({lwe.dim} key bits, {noise_bits}-bit "
          f"noise), prove {prove_ms:.1f} ms, verify {verify_ms:.1f} ms, msm "
          f"launches {per_prove} and {per_verify} (predicted {want[0]} and "
          f"{want[1]}: MSMs of {sizes['create']} and {sizes['verify']} "
          f"points, the sum of h {sizes['h_sum']}) on {smi}", flush=True)
    if not ok or bad or (per_prove, per_verify) != want:
        raise SystemExit(f"{label}: verifies {ok}, with b moved {bad}, msm "
                         f"launches {per_prove} and {per_verify}")
    print(f"{label} gates: verifies, not with b + 1", flush=True)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    _path_counts(label, launches, ("msm",) if any(want) else ())
    per_op = dict.fromkeys(launches, 0)
    per_op["msm"] = per_prove
    return launches, per_op


# --- path 25: multi-GPU (parallel/ and lower_program_sharded) ---------------

SHARD_BATCH = 4              # the compiled programs' batch (test_parallel.py)
SHARD_REPS = 3               # sharded multiply_relin and PBS: median of 3
SHARD_WORLD = 2              # 25b: gloo ranks on the one card
SHARD_TIMEOUT_S = 300
LIMB_SHARDED = {"poly_degree": N, "limbs": 6, "limb_bits": 28}
SHARD_NEEDED = ("inv", "convert", "scale", "mod_down", "fwd", "inv_ks",
                "fwd_tensor3", "scale_convert", "fwd_broadcast")
SHARD_ABSENT = ("ks_full", "ks_full_limbs", "pntt_fwd", "pntt_inv",
                "pntt_pmul", "msm")


def sharded_programs():
    """tests/test_parallel.py's program (`a * b`, `<< 1`, `+ a - b`) and
    `__graft_entry__.py`'s dry-run step, `multiply_relin(a, a) + a`."""
    from sunscreen_tpu_torch.compiler import fhe_program
    from sunscreen_tpu_torch.types import Batched, Cipher

    @fhe_program(scheme="bfv")
    def workload(a: Cipher[Batched], b: Cipher[Batched]):
        prod = a * b
        rot = prod << 1
        return rot + a - b

    @fhe_program(scheme="bfv")
    def dryrun_step(a: Cipher[Batched]):
        return a * a + a

    return workload, dryrun_step


def _shard_params() -> dict:
    """Path 25's parameter sets: the main path's, the limb-sharded run's
    (7 limbs do not split over 2 ranks; `__graft_entry__.py:75` picks a
    limb count its mesh divides) and the main path's limb count at N / 2
    (the linearity check)."""
    from sunscreen_tpu_torch.bfv import BfvParams
    main = BfvParams.default_u32(N)
    t = main.plain_modulus               # batching at N, so at N / 2 too
    return {"main": main,
            "limb": BfvParams.insecure_u32(plain_modulus=t, **LIMB_SHARDED),
            "half": BfvParams.insecure_u32(
                N // 2, plain_modulus=t, limbs=len(main.coeff_modulus),
                limb_bits=28)}


def _lowered(name: str, params):
    from sunscreen_tpu_torch.compiler import Compiler
    fn = dict(zip(("workload", "dryrun_step"), sharded_programs()))[name]
    return (Compiler(DEV).with_params(params).fhe_program(fn).compile()
            .get_program(fn))


def sharded_inputs(ctx, inputs: dict, gks, s: dict) -> tuple[dict, dict]:
    """Path 25's inputs, whole, on the card: path 1's keys and
    ciphertexts, path 2's rotation key, path 7's PBS keys and
    ciphertexts, a GGSW and GLWE at GLWE_1_1024_80, and fresh keys and
    ciphertexts at the limb-sharded and half-N parameters; and, kept in
    this process, the half-N secret key and plaintexts."""
    import torch
    from sunscreen_tpu_torch.bfv import get_context, keys, ops
    from sunscreen_tpu_torch.tfhe import GLWE_1_1024_80, ops as tops, torus

    gen = torch.Generator(device=DEV).manual_seed(25)
    g = ctx.rotate_rows_element(1)
    cts = inputs["cts"]
    inp = {"neg_a": _uniform(gen, (ctx.mul_base.k, N), ctx.mul_base.q),
           "neg_b": _uniform(gen, (ctx.mul_base.k, N), ctx.mul_base.q),
           "ct": cts[0], "rlk0": inputs["rlk"].k0, "rlk1": inputs["rlk"].k1,
           "a": cts[:SHARD_BATCH], "b": cts[SHARD_BATCH:2 * SHARD_BATCH],
           "g": g, "gk0": gks[g].k0, "gk1": gks[g].k1,
           "pbs_rows": s["nbk"].rows, "pbs_ksk": s["ksk"],
           "pbs_tp": s["tp"], "pbs_cts": s["cts"]}
    glwe, radix = GLWE_1_1024_80, s["pbs_radix"]
    sk = tops.generate_binary_glwe_sk(glwe, gen, DEV)
    inp["ggsw"] = tops.encrypt_ggsw(1, sk, glwe, radix, gen)
    inp["glwe"] = tops.encrypt_glwe(torus.encode(
        torch.arange(glwe.poly_degree, device=DEV) % 2, 2, DEV), sk, glwe,
        gen)
    for tag in ("limb", "half"):
        c = get_context(_shard_params()[tag], DEV)
        sk_t = keys.gen_secret_key(c, gen)
        pk = keys.gen_public_key(c, sk_t, gen)
        rlk = keys.gen_relin_key(c, sk_t, gen)
        pts = torch.arange(2 * SHARD_BATCH * c.n, device=DEV).reshape(
            2 * SHARD_BATCH, c.n) % c.t
        both = ops.encrypt(c, pk, pts, gen)
        inp |= {f"{tag}_a": both[:SHARD_BATCH], f"{tag}_b": both[SHARD_BATCH:],
                f"{tag}_rlk0": rlk.k0, f"{tag}_rlk1": rlk.k1}
        if tag == "limb":
            gl = c.rotate_rows_element(1)
            gk = keys.gen_galois_keys(c, sk_t, gen, (gl,))[gl]
            inp |= {"limb_g": gl, "limb_gk0": gk.k0, "limb_gk1": gk.k1}
        else:
            keep = {"half_sk": sk_t,
                    "half_pts": pts[:SHARD_BATCH].cpu().numpy()}
    return inp, keep


def _meshes(world: int) -> dict:
    """Path 25's meshes over `world` ranks: (world,) coefficient and batch
    lines, the batch x limb grid (world, 1) and, at world 2, the
    limb-sharded (1, 2) and batch x coefficient (1, 2) grids."""
    from sunscreen_tpu_torch.parallel import mesh as pm
    out = {"coeff": pm.make_mesh((world,), ("coeff",), DEV),
           "batch": pm.make_mesh((world,), ("batch",), DEV),
           "bl": pm.make_mesh((world, 1), ("batch", "limb"), DEV)}
    if world > 1:
        out["limb"] = pm.make_mesh((1, world), ("batch", "limb"), DEV)
        out["bc"] = pm.make_mesh((1, world), ("batch", "coeff"), DEV)
    return out


# (name, mesh, ct_spec, params tag, program, operands): the lowered runs;
# the limb-sharded and coefficient runs need two ranks
SHARD_PROGRAMS = (
    ("batch_limb", "bl", None, "main", "workload", ("a", "b")),
    ("limb", "limb", None, "limb", "workload", ("limb_a", "limb_b")),
    ("batch_coeff", "bc", ("batch", None, None, "coeff"), "main",
     "workload", ("a", "b")),
    ("dryrun", "bl", None, "main", "dryrun_step", ("a",)),
    ("dryrun_half", "bl", None, "half", "dryrun_step", ("half_a",)))


def _barrier_ms(fn, world: int) -> float:
    """Wall ms of one synchronized call of fn on every rank, between two
    barriers (the slowest rank's time)."""
    import torch
    import torch.distributed as dist
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    dist.barrier()
    return (time.perf_counter() - t0) * 1e3


def sharded_run(inp: dict, world: int) -> dict:
    """Every scenario of path 25 on this rank of a `world`-rank group
    (the process group is up): the rank's output blocks, each scenario's
    collectives, the sharded multiply_relin's times and one call's
    launches, and the batch-sharded PBS's time."""
    import torch
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.bfv import get_context
    from sunscreen_tpu_torch.bfv.keys import GaloisKeys, KswKey
    from sunscreen_tpu_torch.compiler.lower import lower_program_sharded
    from sunscreen_tpu_torch.parallel import dntt, ici_model
    from sunscreen_tpu_torch.parallel import mesh as pm
    from sunscreen_tpu_torch.parallel import sharded_bfv as sb
    from sunscreen_tpu_torch.parallel import sharded_tfhe as st
    from sunscreen_tpu_torch.tfhe import (GLWE_1_1024_80, LWE_512_80,
                                          RadixDecomposition, ops as tops)

    meshes = _meshes(world)
    coeff = meshes["coeff"]
    params = _shard_params()
    ctx = get_context(params["main"], DEV)
    out: dict = {"blocks": {}, "stats": {}}

    def record(name, fn):
        with ici_model.collective_stats() as stats:
            out["blocks"][name] = fn()
        torch.cuda.synchronize()
        out["stats"][name] = {"bytes": stats.bytes, "count": stats.count}

    def cols(x):
        return pm.local_shard(x, coeff, "coeff", -1)

    plan = dntt.DistributedNttPlan(N, ctx.mul_base.moduli, DEV)
    mul = dntt.make_distributed_negacyclic_mul(plan, coeff)
    n1, n2 = plan.n1, plan.n2
    record("neg", lambda: mul(cols(inp["neg_a"].reshape(-1, n1, n2)),
                              cols(inp["neg_b"].reshape(-1, n1, n2))))

    before = dict(_build.LAUNCHES)
    srlk = sb.sharded_relin_key(ctx, KswKey(inp["rlk0"], inp["rlk1"]), coeff)
    ct4 = cols(sb.to_sharded_layout(inp["ct"], ctx))
    record("bfv", lambda: sb.sharded_multiply_relin(ctx, coeff, ct4, ct4,
                                                    srlk))
    out["per_op"] = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    out["mul_ms"] = sorted(
        _barrier_ms(lambda: sb.sharded_multiply_relin(ctx, coeff, ct4, ct4,
                                                      srlk), world)
        for _ in range(SHARD_REPS))[SHARD_REPS // 2]

    g1, g2 = dntt.four_step(GLWE_1_1024_80.poly_degree)
    record("extprod", lambda: st.coeff_sharded_external_product(
        coeff, cols(inp["ggsw"].reshape(2, 3, 2, g1, g2)),
        cols(inp["glwe"].reshape(2, g1, g2)), GLWE_1_1024_80,
        RadixDecomposition(count=3, radix_log=4)))

    nbk = tops.NttBootstrapKey(inp["pbs_rows"], GLWE_1_1024_80,
                               RadixDecomposition(count=3, radix_log=4))
    rows = pm.local_shard(inp["pbs_cts"], meshes["batch"], "batch", 0)

    def pbs():
        return st.batch_sharded_pbs(
            meshes["batch"], rows, inp["pbs_tp"], nbk, inp["pbs_ksk"],
            LWE_512_80, GLWE_1_1024_80,
            RadixDecomposition(count=3, radix_log=4),
            RadixDecomposition(count=8, radix_log=6))

    record("pbs", pbs)
    out["pbs_ms"] = sorted(_barrier_ms(pbs, world)
                           for _ in range(SHARD_REPS))[SHARD_REPS // 2]

    for name, mesh_name, spec, tag, prog, operands in SHARD_PROGRAMS:
        if mesh_name not in meshes:
            continue
        mesh = meshes[mesh_name]
        c = get_context(params[tag], DEV)
        key = "" if tag == "main" else f"{tag}_"
        rlk = KswKey(inp[f"{key}rlk0"], inp[f"{key}rlk1"])
        gks = (GaloisKeys({int(inp[f"{key}g"]): KswKey(inp[f"{key}gk0"],
                                                        inp[f"{key}gk1"])})
               if prog == "workload" else None)
        run = lower_program_sharded(_lowered(prog, params[tag]), c, mesh,
                                    ct_spec=spec)
        names = mesh.mesh_dim_names
        spec = spec or (names[0], None, names[1], None)
        args = []
        for v in operands:
            x = inp[v]
            for d, ax in enumerate(spec):
                if ax is not None:
                    x = pm.local_shard(x, mesh, ax, d)
            args.append(x)
        record(name, lambda: run(*args, rlk=rlk, gks=gks)[0])
    return out


def _assemble(blocks: list, mesh_shape: tuple, dims: tuple):
    """The whole array from the ranks' blocks of a mesh of `mesh_shape`
    (rank r at row-major mesh coordinates), mesh axis i sharding tensor
    dim dims[i] (None: replicated, the first rank's block)."""
    import torch
    if len(mesh_shape) == 1:
        return blocks[0] if dims[0] is None else torch.cat(blocks, dims[0])
    inner = mesh_shape[1]
    rows = [_assemble(blocks[i * inner:(i + 1) * inner], mesh_shape[1:],
                      dims[1:]) for i in range(mesh_shape[0])]
    return _assemble(rows, mesh_shape[:1], dims[:1])


def _shard_layouts(world: int) -> dict:
    """name -> (mesh shape, the tensor dim each mesh axis shards)."""
    lay = {"neg": ((world,), (-1,)), "bfv": ((world,), (-1,)),
           "extprod": ((world,), (-1,)), "pbs": ((world,), (0,)),
           "batch_limb": ((world, 1), (0, -2)),
           "dryrun": ((world, 1), (0, -2)),
           "dryrun_half": ((world, 1), (0, -2))}
    if world > 1:
        lay |= {"limb": ((1, world), (0, -2)),
                "batch_coeff": ((1, world), (0, -1))}
    return lay


def sharded_wants(ctx, inp: dict, s: dict, pbs_out) -> dict:
    """The port's unsharded results on the card for every scenario of path
    25, computed before the path's counts start."""
    from sunscreen_tpu_torch.bfv import get_context, ops
    from sunscreen_tpu_torch.bfv.keys import GaloisKeys, KswKey
    from sunscreen_tpu_torch.compiler.lower import lower_program
    from sunscreen_tpu_torch.tfhe import GLWE_1_1024_80, ops as tops

    pm = ctx.plan_mul
    params = _shard_params()
    rlk = KswKey(inp["rlk0"], inp["rlk1"])
    want = {"neg": pm.inv(pm.pointwise_mul(pm.fwd(inp["neg_a"]),
                                           pm.fwd(inp["neg_b"]))),
            "bfv": ops.multiply_relin(ctx, inp["ct"], inp["ct"], rlk),
            "extprod": tops.external_product(inp["ggsw"], inp["glwe"],
                                             GLWE_1_1024_80, s["pbs_radix"]),
            "pbs": pbs_out}
    for name, _, _, tag, prog, operands in SHARD_PROGRAMS:
        c = get_context(params[tag], DEV)
        key = "" if tag == "main" else f"{tag}_"
        gk = (GaloisKeys({int(inp[f"{key}g"]): KswKey(inp[f"{key}gk0"],
                                                       inp[f"{key}gk1"])})
              if prog == "workload" else None)
        want[name] = lower_program(_lowered(prog, params[tag]), c)(
            *(inp[v] for v in operands),
            rlk=KswKey(inp[f"{key}rlk0"], inp[f"{key}rlk1"]), gks=gk)[0]
    return want


def _shard_gates(label, results: list, world: int, want: dict, ctx,
                 sk, pts_np, keep: dict) -> None:
    """Each scenario's blocks, joined, against the unsharded port's result
    bit for bit; the sharded product and both dry-run steps against their
    decryptions."""
    import torch
    from sunscreen_tpu_torch.bfv import get_context, ops

    t = ctx.t
    for name, (shape, dims) in _shard_layouts(world).items():
        got = _assemble([r["blocks"][name] for r in results], shape, dims)
        w = want[name]
        if name in ("neg", "bfv", "extprod"):
            got = got.reshape(w.shape)
        if not torch.equal(got, w):
            raise SystemExit(f"{label} {name}: the sharded result differs "
                             f"from the unsharded port's")
        print(f"{label} {name}: == the unsharded port on the card, bit for "
              f"bit; collectives {json.dumps(results[0]['stats'][name])}",
              flush=True)
        if name == "bfv":
            dec = ops.decrypt(ctx, sk, got).cpu().numpy()
            if not np.array_equal(dec, _negacyclic_square(pts_np[0], t)):
                raise SystemExit(f"{label}: sharded product decrypt gate "
                                 f"FAILED")
        if name.startswith("dryrun"):
            c = ctx if name == "dryrun" else get_context(
                _shard_params()["half"], DEV)
            key = sk if name == "dryrun" else keep["half_sk"]
            p = pts_np[:SHARD_BATCH] if name == "dryrun" else keep["half_pts"]
            dec = ops.decrypt(c, key, got).cpu().numpy()
            for r in range(SHARD_BATCH):
                if not np.array_equal(dec[r], (_negacyclic_square(p[r], c.t)
                                               + p[r]) % c.t):
                    raise SystemExit(f"{label} {name}: decrypt gate FAILED "
                                     f"at row {r}")
    print(f"{label}: the sharded product decrypts to the numpy square; the "
          f"dry run's step decrypts to p p + p at N={N} and N={N // 2}",
          flush=True)
    full = results[0]["stats"]
    ratio = (sum(full["dryrun"]["bytes"].values())
             / max(sum(full["dryrun_half"]["bytes"].values()), 1))
    print(f"{label} linearity check: collective bytes of the dry run's step "
          f"at N={N} / N={N // 2} = {ratio:.2f} (linear model predicts "
          f"2.00)", flush=True)


def sharded_rank(rank: int, world: int, workdir: str) -> int:
    """One rank of path 25b: joins the gloo group through a FileStore in
    `workdir`, loads the parent's kernels and inputs, runs every scenario
    on cuda:0 and writes its blocks, collectives, times and launches."""
    import torch
    import torch.distributed as dist
    from sunscreen_tpu_torch import _build

    torch.cuda.set_device(0)
    _build.build_all()                  # the parent's build: no nvcc
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world)
    try:
        inp = torch.load(os.path.join(workdir, "inputs.pt"),
                         map_location=DEV)
        _build.reset_launches()
        out = sharded_run(inp, world)
        out["launches"] = dict(_build.LAUNCHES)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def _spawn_ranks(inp: dict, world: int) -> list:
    """Path 25b's ranks, each `chip_smoke.py --sharded-rank` on the one
    card, on inputs this process wrote; every rank is stopped if one
    fails or the time runs out. Returns their results."""
    import shutil
    import tempfile

    import torch
    workdir = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    try:
        torch.save({k: v.cpu() if isinstance(v, torch.Tensor) else v
                    for k, v in inp.items()},
                   os.path.join(workdir, "inputs.pt"))
        procs = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.log"), "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--sharded-rank", str(r), str(world), workdir],
                    stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + SHARD_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if (time.monotonic() > deadline or any(
                    p.returncode for p in procs if p.poll() is not None)):
                break
            time.sleep(0.1)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if any(p.returncode for p in procs):
            for r, p in enumerate(procs):
                with open(os.path.join(workdir, f"rank{r}.log")) as f:
                    print(f"--- rank {r} (rc {p.returncode}) ---\n"
                          f"{f.read()[-6000:]}", file=sys.stderr)
            raise SystemExit(f"path 25b: ranks failed (rc "
                             f"{[p.returncode for p in procs]})")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           map_location=DEV) for r in range(world)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def sharded_path(ctx, inputs: dict, gks, s: dict, pbs_out, smi: str):
    """Paths 25 and 25b, the counterpart of `__graft_entry__.py:51`
    `dryrun_multichip` on the one card: at world size 1 under NCCL in
    this process (a FileStore in a temporary directory), then at world
    size 2 under gloo, two processes on cuda:0, each scenario against
    the unsharded port bit for bit. Returns both paths' (launches,
    launches of one sharded multiply_relin)."""
    import tempfile

    import torch
    import torch.distributed as dist
    from sunscreen_tpu_torch import _build

    t0 = time.perf_counter()
    inp, keep = sharded_inputs(ctx, inputs, gks, s)
    want = sharded_wants(ctx, inp, s, pbs_out)
    torch.cuda.synchronize()
    print(f"path 25 set-up: {time.perf_counter() - t0:.1f} s (inputs and "
          f"the unsharded results)", flush=True)
    paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        t0 = time.perf_counter()
        dist.init_process_group(
            "nccl" if DEV == "cuda" else "gloo",
            store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
            world_size=1)
        try:
            _build.reset_launches()
            res = sharded_run(inp, 1)
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            _shard_report("sharded", [res], 1, want, ctx, inputs, keep, smi)
            _path_counts("sharded", launches, SHARD_NEEDED, SHARD_ABSENT)
            paths["sharded"] = (launches, res["per_op"])
            _shard_profiles(ctx, inp)
        finally:
            dist.destroy_process_group()
        print(f"path 25 (world size 1, nccl): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    results = _spawn_ranks(inp, SHARD_WORLD)
    launches = {k: sum(r["launches"][k] for r in results)
                for k in _build.LAUNCHES}
    _shard_report("sharded_ws2", results, SHARD_WORLD, want, ctx, inputs,
                  keep, smi)
    _path_counts("sharded_ws2", launches, SHARD_NEEDED, SHARD_ABSENT)
    paths["sharded_ws2"] = (launches, results[0]["per_op"])
    print(f"path 25b (world size {SHARD_WORLD}, gloo on one card): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return paths


def _shard_report(label, results, world, want, ctx, inputs, keep, smi):
    _shard_gates(label, results, world, want, ctx, inputs["sk"],
                 inputs["pts_np"], keep)
    r0 = results[0]
    n_pbs = sum(r["blocks"]["pbs"].shape[0] for r in results)
    per = {k: r0["per_op"][k] for k in ("inv", "convert", "scale",
                                        "mod_down")}
    print(f"{label}: sharded multiply_relin at N={N}, world size {world}: "
          f"{r0['mul_ms']:.3f} ms (median of {SHARD_REPS}, one ciphertext); "
          f"launches of the key and one product (B3 inv, B6 convert, B9 "
          f"scale, B8 mod_down): {json.dumps(per)}; batch_sharded_pbs: "
          f"{n_pbs} PBS in {r0['pbs_ms']:.1f} ms (median of {SHARD_REPS}), "
          f"{n_pbs / r0['pbs_ms'] * 1e3:.1f} PBS/s on {smi}", flush=True)


def _shard_profiles(ctx, inp: dict) -> None:
    """Device time and busy share at world size 1 of one distributed
    negacyclic product (three transforms and a pointwise product: the
    device ops of a transform), one sharded multiply_relin and one batch
    x limb program run."""
    from sunscreen_tpu_torch.bfv.keys import GaloisKeys, KswKey
    from sunscreen_tpu_torch.compiler.lower import lower_program_sharded
    from sunscreen_tpu_torch.parallel import dntt
    from sunscreen_tpu_torch.parallel import mesh as pm
    from sunscreen_tpu_torch.parallel import sharded_bfv as sb

    coeff = pm.make_mesh((1,), ("coeff",), DEV)
    bl = pm.make_mesh((1, 1), ("batch", "limb"), DEV)
    plan = dntt.DistributedNttPlan(N, ctx.mul_base.moduli, DEV)
    mul = dntt.make_distributed_negacyclic_mul(plan, coeff)
    a, b = (inp[v].reshape(-1, plan.n1, plan.n2) for v in ("neg_a", "neg_b"))
    prof = profile_breakdown("sharded_negacyclic_mul", lambda: mul(a, b))
    print(f"sharded_negacyclic_mul: {prof.get('ops', 0):.0f} device ops a "
          f"product of three distributed transforms and one pointwise "
          f"product (two device ops) at N={N}, {ctx.mul_base.k} limbs",
          flush=True)
    srlk = sb.sharded_relin_key(ctx, KswKey(inp["rlk0"], inp["rlk1"]), coeff)
    ct4 = sb.to_sharded_layout(inp["ct"], ctx)
    profile_breakdown("sharded_multiply_relin", lambda: (
        sb.sharded_multiply_relin(ctx, coeff, ct4, ct4, srlk)))
    run = lower_program_sharded(_lowered("workload", ctx.params), ctx, bl)
    rlk = KswKey(inp["rlk0"], inp["rlk1"])
    gks = GaloisKeys({int(inp["g"]): KswKey(inp["gk0"], inp["gk1"])})
    profile_breakdown("sharded_program", lambda: run(
        inp["a"], inp["b"], rlk=rlk, gks=gks))


def shard_col_cases(ctx, gen) -> list[tuple]:
    """B6, B9 and B8 at the shapes `sharded_multiply_relin` gives them at
    path 25b's world size, N / 2 columns a rank: (name, where, kernel,
    plain twin, args, bytes, 32-bit multiplies). B6 twice: the base
    extension Q -> Q u B with the source limbs copied ahead, and the
    centered conversion B -> Q."""
    from sunscreen_tpu_torch.math import prns

    cols, k = N // SHARD_WORLD, ctx.k
    ext = prns.fused_converter(ctx.conv_q_to_aux)
    back = prns.fused_converter(ctx.conv_aux_to_q)
    scaler = prns.fused_scaler(ctx.scale_mul_to_aux)
    mdo = prns.fused_mod_down(ctx.mod_down)
    x_ext = _max_digits(_uniform(gen, (4, ext.ks, cols), ctx.q_base.q),
                        ctx.q_base)
    x_back = _max_digits(_uniform(gen, (3, back.ks, cols), ctx.aux_base.q),
                         ctx.aux_base)
    x_sc = _max_digits(_uniform(gen, (3, scaler.ks, cols), ctx.mul_base.q),
                       ctx.mul_base)
    both = _uniform(gen, (2, ctx.key_base.k, cols), ctx.key_base.q)
    n_back = 3 * cols
    return [
        ("convert", "at_shard", *_convert_case(ext, x_ext)),
        ("convert", "at_shard_aux_to_q",
         lambda v: back(v, centered=True),
         lambda v: back.call_plain(v, centered=True), (x_back,),
         n_back * (back.ks + back.kd) * WORD,
         n_back * (10 * back.ks + 2 * back.ks * back.kd + 2 * back.kd)),
        ("scale", "at_shard", scaler, scaler.call_plain, (x_sc,),
         *_scale_counts(scaler, 3 * cols)),
        ("mod_down", "at_shard",
         lambda b: mdo(b[..., :k, :], b[..., k, :]),
         lambda b: mdo.call_plain(b[..., :k, :], b[..., k, :]), (both,),
         2 * cols * (2 * k + 1) * WORD, 2 * cols * 2 * k)]


def check_shard_cols(ctx, gen, table: list[dict]) -> None:
    """B6, B9 and B8 held against their twins, bit for bit, and timed at
    the sharded multiply's N / 2 columns; each row gets the numbers under
    its `where` key."""
    rows = {row["name"]: row for row in table}
    for name, where, kern, plain, args, nbytes, muls in shard_col_cases(
            ctx, gen):
        shape = list(args[0].shape)
        _held(f"{name}@{shape}", kern, plain, args)
        rows[name][where] = {"shape": shape, **_timing(
            f"{name} at {shape}", kern, plain, args, nbytes, muls)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.bfv import BfvParams, get_context, keys, ops

    for name in GATES:                 # each path sets only its own
        os.environ.pop(name, None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    print_ptxas()
    print_sass(_build.build_all()["rns"], "this")

    params = BfvParams.default_u32(N)
    ctx = get_context(params, DEV)
    print(f"params: N={N} t={params.plain_modulus} k={ctx.k} "
          f"mul base {ctx.mul_base.k} limbs, key base {ctx.key_base.k} "
          f"limbs", flush=True)
    gen = torch.Generator(device=DEV).manual_seed(0)
    table = check_kernels(ctx, gen)
    check_shard_cols(ctx, gen, table)
    check_wide(gen)
    transform_checks(gen)
    msm_row = check_msm()
    table.append(msm_row)
    t = params.plain_modulus
    paths: dict[str, tuple[dict, dict]] = {}

    # --- path 1: keygen, encrypt, multiply_relin ----------------------
    inputs, prod, launches, per_mul = multiply_path(
        "multiply_relin", ctx, 1, smi, DEFAULT_MUL, NEW_KERNELS)
    paths["multiply_relin"] = (launches, per_mul)
    sk, cts, pts_np = inputs["sk"], inputs["cts"], inputs["pts_np"]
    ctx_cpu, ct_cpu = inputs["ctx_cpu"], inputs["ct_cpu"]

    # --- path 2: Galois keygen, rotate_rows, rotate_columns -------------
    _build.reset_launches()
    gen = inputs["gen"]
    g_row, g_col = ctx.rotate_rows_element(1), ctx.rotate_columns_element
    gks = keys.gen_galois_keys(ctx, sk, gen, (g_row, g_col))
    for label, got, g in (
            ("rotate_rows(1)", ops.rotate_rows(ctx, cts, 1, gks), g_row),
            ("rotate_columns", ops.rotate_columns(ctx, cts, gks), g_col)):
        dec = ops.decrypt(ctx, sk, got).cpu().numpy()
        if not np.array_equal(dec, _automorphism(pts_np, g, t)):
            raise SystemExit(f"rotation decrypt gate FAILED: {label}")
    print(f"rotation decrypt gate: {BATCH} rotate_rows(1) and "
          f"rotate_columns results decrypt to the numpy automorphism",
          flush=True)
    one = ops.rotate_rows(ctx, cts[0], 1, gks).cpu()
    gks_cpu = keys.GaloisKeys({g: keys.KswKey(v.k0.cpu(), v.k1.cpu())
                               for g, v in gks.keys.items()})
    if not torch.equal(one, ops.rotate_rows(ctx_cpu, ct_cpu, 1, gks_cpu)):
        raise SystemExit("rotate_rows on the card differs from the CPU")
    print("rotate_rows: card kernels == CPU plain path, bit for bit",
          flush=True)
    state = {"rot": cts}

    def rot_step():
        state["rot"] = ops.rotate_rows(ctx, state["rot"], 1, gks)

    rot_per_s = _rate(rot_step)
    per_rot = _per_op(rot_step)
    torch.cuda.synchronize()
    launches_rot = dict(_build.LAUNCHES)
    print(f"rotate_rows: {rot_per_s:.1f} rotations/s (N={N}, batch "
          f"{BATCH}, median of {REPS} x {ITERS}) on {smi}", flush=True)
    _path_counts("rotate", launches_rot,
                 ("fwd", "fwd_broadcast", "inv", "inv_ks", "mod_down"))
    print(f"launches per rotation: {json.dumps(per_rot)}", flush=True)
    profile_breakdown("rotate_rows", rot_step)
    paths["rotate"] = (launches_rot, per_rot)

    # --- path 3: multiply_relin at default_u32(16384) ----------------
    wide = get_context(BfvParams.default_u32(WIDE_N), DEV)
    inputs3, prod3, launches, per_op = multiply_path(
        f"multiply_relin@{WIDE_N}", wide, 3, smi, DEFAULT_MUL, NEW_KERNELS)
    paths[f"multiply_relin@{WIDE_N}"] = (launches, per_op)
    # --- path 3b: path 3's multiply under FUSE_TFULL=1 (B13) -------------
    paths[f"tfull@{WIDE_N}"] = gated_path(
        f"tfull@{WIDE_N}", TFULL, wide, inputs3, prod3, smi, TFULL_NEEDED,
        TFULL_ABSENT)
    del inputs3, prod3

    # --- paths 4 and 5: path 1's multiply under other settings -----------
    paths["unfused"] = gated_path(
        "unfused", UNFUSED, ctx, inputs, prod, smi,
        ("scale", "tensor3", "ks_inner", "convert", "fwd", "fwd_broadcast",
         "inv", "mod_down"),
        ("fwd_tensor3", "scale_convert", "inv_ks", "inv_tensor3")
        + MEGAKERNELS)
    paths["t3"] = gated_path(
        "t3", T3, ctx, inputs, prod, smi,
        ("inv_tensor3", "fwd", "convert", "scale_convert", "fwd_broadcast",
         "inv_ks", "mod_down"),
        ("fwd_tensor3", "tensor3", "scale", "ks_inner") + MEGAKERNELS)

    # --- path 6: path 1's multiply under FUSE_KSFULL=1 (B14) -------------
    paths["ksfull"] = gated_path(
        "ksfull", KSFULL, ctx, inputs, prod, smi,
        ("ks_full", "fwd_tensor3", "inv", "convert", "scale_convert",
         "mod_down"),
        ("fwd_broadcast", "inv_ks", "ks_inner", "ks_full_limbs"))

    # --- paths 7 and 8: TFHE PBS, then under TFHE_KSFULL=1 (B15) ---------
    s, out, launches, per_pbs = pbs_path("pbs", smi, PBS_NEEDED, PBS_ABSENT)
    paths["pbs"] = (launches, per_pbs)
    with _gates({"SUNSCREEN_TPU_TFHE_KSFULL": "1"}):
        *_, launches, per_pbs = pbs_path(
            "pbs_ksfull", smi, ("ks_full_limbs",), KSFULL_ABSENT, s=s,
            want=out)
    paths["pbs_ksfull"] = (launches, per_pbs)
    # --- path 16: the multifunctional PBS on path 7's keys --------------
    paths["pbs_multi"] = multi_path(s, smi)
    # --- path 24: TFHE's SDLP on an LWE encryption under path 7's key ----
    paths["lwe_sdlp"] = lwe_path("lwe_sdlp", s, smi)
    # --- paths 25 and 25b: multi-GPU (parallel/, lower_program_sharded)
    # at world size 1 under NCCL, then 2 under gloo on the one card, on
    # path 1's, 2's and 7's keys ------------------------------------------
    paths.update(sharded_path(ctx, inputs, gks, s, out, smi))
    del s, out

    # --- path 9: the pallas_vpu NTT plan (B16, B17) ----------------------
    paths["vpu"], _ = vpu_path(params, smi)

    # --- path 10: path 1's multiply under FUSE_TFULL=1 (B13) -------------
    paths["tfull"] = gated_path("tfull", TFULL, ctx, inputs, prod, smi,
                                TFULL_NEEDED, TFULL_ABSENT)

    # --- path 11: the BFV user flow, default settings, batch 8 ----------
    paths["flow"] = flow_path(ctx, smi)

    # --- paths 12-14: the u64 engine (B18, B19, BfvParams.default) -------
    u64 = BfvParams.default(N)
    paths["u64_mulmod"] = u64_mulmod_path(u64, smi)
    paths["multiply_relin_u64"] = u64_multiply_path(u64, smi)
    paths["golden_u64"] = golden_u64_path(u64, smi)

    # --- path 15: path 9 at default_u32(32768) (B16 at N=32768, B7 at 59
    # limbs) ---------------------------------------------------------------
    paths[f"vpu@{VPU_N}"], vpu15 = vpu_path(BfvParams.default_u32(VPU_N),
                                            smi)
    # --- path 15b: path 15's multiply under FUSE_SC=0 (B9 from 59 limbs,
    # then B6, in place of B7) -----------------------------------------------
    paths[f"vpu_sc@{VPU_N}"] = vpu_sc_path(f"vpu_sc@{VPU_N}", vpu15, smi)
    del vpu15

    # --- paths 17-19: the rest of TFHE on the fine keys (16 digits a
    # blind-rotation step): the bivariate PBS, circuit bootstrapping (18b:
    # under TFHE_KSFULL=1, B15), the other ops at batch 8 -----------------
    fine = fine_keys(17)
    paths["pbs_bivariate"] = bivariate_path(fine, smi)
    cbs_cts, ggsws, launches, per_op = cbs_path(fine, smi)
    paths["cbs"] = (launches, per_op)
    paths["cbs_ksfull"] = cbs_ksfull_path(fine, cbs_cts, ggsws)
    del cbs_cts, ggsws
    paths["tfhe_flow"] = tfhe_flow_path(fine, smi)
    del fine

    # --- path 20: @fhe_program -> Compiler -> Runtime.new_fhe: the
    # searched default_u32(8192) chain, B1-B8 through bfv/ops.py --------
    paths["compiler"] = compiler_path(smi)

    # --- paths 21 and 21b: @zkp_program -> Compiler -> Runtime.new_zkp,
    # the fractional range proof with the device MSM (M1), then on the host
    # C++ alone ----------------------------------------------------------
    paths["zkp"], blob = zkp_path("zkp", smi, device_msm=True)
    with _gates({"SUNSCREEN_TPU_MSM": "0"}):
        paths["zkp_host"], _ = zkp_path("zkp_host", smi, device_msm=False,
                                        want=blob)

    # --- paths 22, 22b and 23: the SDLP at benchmarks/sdlp_bench.py's
    # N = 1024, k = 2 with M1 on every MSM of 2048 points or more, then on
    # the host C++ alone, and a linked proof at the same parameters; then
    # M1 at the SDLP's l and at the largest MSM the paths launched --------
    with _msm_sizes([]) as launched:
        _build.reset_launches()
        sdlp = sdlp_setup()
        paths["sdlp"], blob = sdlp_path("sdlp", smi, sdlp, device_msm=True)
        _build.reset_launches()
        with _gates({"SUNSCREEN_TPU_MSM": "0"}):
            paths["sdlp_host"], _ = sdlp_path("sdlp_host", smi, sdlp,
                                              device_msm=False, want=blob)
        sdlp_l = sdlp["vk"].l
        del sdlp
        _build.reset_launches()
        paths["linked"], linked_l = linked_path("linked", smi)
    print(f"msm sizes of paths 22-23: l = {sdlp_l} (path 23: {linked_l}), "
          f"{len(launched)} launches, the largest {max(launched)} points",
          flush=True)
    for n in (sdlp_l, max(launched)):
        msm_row[f"at_{n}"] = msm_case(n)

    for row in table:
        name = row["name"]
        row["launches_by_path"] = {p: v[0][name] for p, v in paths.items()}
        row["launches_per_op_by_path"] = {p: v[1][name]
                                          for p, v in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    never = [row["name"] for row in table if row["launches"] == 0]
    if never or len(table) != len(_build.LAUNCHES):
        raise SystemExit(f"kernels no path launched: {never}")
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


COMPARE_TURNS = ("against", "this", "this", "against")
# --phase msm: each turn runs that tree's M1 phase alone (with a build of
# every source, as `check_msm` reads the ptxas log) and prints its row
PHASES = {"msm": "import json, sys, torch, chip_smoke as s; "
                 "sys.exit('no CUDA device') "
                 "if not torch.cuda.is_available() else None; "
                 "print(json.dumps({'kernels': [s.check_msm()]}))"}
RATE_RE = re.compile(r"(?:^|, )([A-Za-z_][\w@ ()]*?): ([0-9.e+]+) "
                     r"(ops/s|rotations/s|PBS/s|elements/s|proofs/s)")
PROFILE_RE = re.compile(r"profile (\S+):\s+([0-9.]+) ms\s+[0-9.]+%\s+(.*)")


def _parse_run(text: str) -> dict[str, float]:
    """The numbers of one run's log that a comparison reads: every entry
    point's kernel ms (at the PBS step and at WIDE_N where the run timed
    them, and the unfused pair beside B14 and B15), every rate, and each
    profiled cell's device ms per batch by kernel function."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        if line.startswith('{"kernels"'):
            for row in json.loads(line)["kernels"]:
                out[f"kernel {row['name']} ms"] = row["ms"]
                for where in ("at_pbs_step", "at_pbs_step_16",
                              f"at_{WIDE_N}", f"at_{VPU_N}",
                              *(f"at_{n}" for n in MSM_NS[1:])):
                    if where in row:
                        out[f"kernel {row['name']}@{where[3:]} ms"] = (
                            row[where]["ms"])
                if "unfused_pair" in row:
                    out[f"kernel {row['name']} pair "
                        f"({row['unfused_pair']['kernels']}) ms"] = (
                        row["unfused_pair"]["ms"])
        for m in RATE_RE.finditer(line):
            out[f"rate {m.group(1)} {m.group(3)}"] = float(m.group(2))
        m = PROFILE_RE.match(line)
        if m:
            key = f"profile {m.group(1)} {_kernel_fn(m.group(3))} ms"
            out[key] = out.get(key, 0.0) + float(m.group(2))
    return out


def compare(against: str, phase: str | None = None) -> int:
    """Runs `against`/chip_smoke.py (another tree of this repo, say the
    parent commit's `git archive`) and this one in turns, against, this,
    this, against, each in its own process on the same card, keeps each
    log under chiprun_out/compare/, and prints every number both runs
    report as the two readings of each side, their means and this / against,
    and the SASS counts of each side's rns_convert, rns_scale and
    scale_convert kernels. With `phase` ("msm") each turn runs only that
    phase of its tree (`PHASES`). Fails if any run fails."""
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"against": os.path.abspath(against), "this": here}
    logs = os.path.join(os.getcwd(), "chiprun_out", "compare")
    os.makedirs(logs, exist_ok=True)
    runs: dict[str, list[dict[str, float]]] = {"against": [], "this": []}
    failed = []
    for i, side in enumerate(COMPARE_TURNS):
        t0 = time.perf_counter()
        cmd = ["-c", PHASES[phase]] if phase else ["chip_smoke.py"]
        proc = subprocess.run([sys.executable, *cmd], cwd=trees[side],
                              capture_output=True, text=True)
        log = os.path.join(logs, f"{i}_{side}.log")
        with open(log, "w") as f:
            f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        print(f"compare run {i} ({side}, {trees[side]}): rc "
              f"{proc.returncode}, {time.perf_counter() - t0:.1f} s, {log}",
              flush=True)
        if proc.returncode:
            failed.append(i)
            print(proc.stderr[-2000:], flush=True)
        runs[side].append(_parse_run(proc.stdout))
    for side, tree in trees.items():      # each side's build of rns.cu
        for so in sorted(glob.glob(os.path.join(
                tree, "sunscreen_tpu_torch", "_kbuild", "*", "librns.so"))):
            print_sass(so, side)
    for key in sorted(set().union(*runs["this"], *runs["against"])):
        vals = {side: [r[key] for r in runs[side] if key in r]
                for side in runs}
        mean = {side: sum(v) / len(v) for side, v in vals.items() if v}
        ratio = (f", this / against {mean['this'] / mean['against']:.4f}"
                 if len(mean) == 2 and mean["against"] else "")
        print(f"compare {key}: against "
              f"{' '.join(f'{v:g}' for v in vals['against']) or '-'}, this "
              f"{' '.join(f'{v:g}' for v in vals['this']) or '-'}{ratio}",
              flush=True)
    if failed:
        print(f"compare: runs {failed} failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--sharded-rank":
        sys.exit(sharded_rank(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4]))
    if len(sys.argv) == 3 and sys.argv[1] == "--against":
        sys.exit(compare(sys.argv[2]))
    if (len(sys.argv) == 5 and sys.argv[1] == "--against"
            and sys.argv[3] == "--phase" and sys.argv[4] in PHASES):
        sys.exit(compare(sys.argv[2], sys.argv[4]))
    if len(sys.argv) != 1:
        sys.exit("usage: chip_smoke.py [--against OTHER_TREE "
                 f"[--phase {'|'.join(PHASES)}]]")
    sys.exit(main())
