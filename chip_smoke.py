#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `sunscreen_tpu_torch/csrc`, holds
each kernel bit for bit against its plain PyTorch twin at the shapes of
the main path, then drives the main path: BFV keygen, encryption and
batched ct×ct `multiply_relin` at N=8192 with `BfvParams.default_u32`,
batch 64. A decrypt gate checks the products against a numpy
negacyclic oracle before timing, and one product is checked bit for bit
against the same op on the CPU. Prints the card, each kernel's times and
launch counts as one JSON line, the ops/s, and as the last line
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
no GPU is visible or any check fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N = 8192
BATCH = 64
ITERS, REPS = 20, 5          # timed multiply_relin: median of REPS x ITERS

# The H100 SXM's published peaks (NVIDIA data sheet): HBM at 3.35 TB/s;
# 67 TFLOP/s fp32 outside the tensor cores, i.e. 33.5 T FMA/s, and
# 32-bit integer multiplies issue at half the FMA rate on compute
# capability 9.0 (64 vs 128 per SM per clock).
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_MULS_PER_S = 16.75e12
WORD = 8                     # residues are int64 in and out


def _median_ms(fn, reps: int, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


def _negacyclic_square(a: np.ndarray, t: int) -> np.ndarray:
    """a*a mod (x^N + 1, t); exact in int64 for t < 2^20."""
    conv = np.convolve(a, a)
    n = a.shape[0]
    res = conv[:n].copy()
    res[:n - 1] -= conv[n:]
    return np.mod(res, t)


def _uniform(gen, shape, q):
    """Residues < q per limb: shape [..., k, N] against q [k, 1]."""
    import torch
    return torch.randint(0, 1 << 62, shape, generator=gen,
                         device="cuda", dtype=torch.int64) % q


def check_kernels(ctx, gen) -> list[dict]:
    """Each kernel entry point against its plain twin at the main-path
    shapes, bit for bit, with both times and the bound."""
    import torch

    pq, pm, pk = ctx.plan_q, ctx.plan_mul, ctx.plan_key
    n, logn = N, N.bit_length() - 1
    kdig = ctx.k
    ntt_muls = 3 * (n // 2) * logn        # Shoup butterfly: 3 multiplies
    src_ntt = "sunscreen_tpu_torch/csrc/ntt.cu"
    rows_fi = BATCH * 4
    x_fi = _uniform(gen, (rows_fi, pm.k, n), pm.q)
    x_fb = torch.randint(0, 1 << 32, (BATCH * kdig, n), generator=gen,
                         device="cuda", dtype=torch.int64)
    x_t3 = _uniform(gen, (BATCH, 4, pm.k, n), pm.q)
    d_ks = _uniform(gen, (BATCH, kdig, pk.k, n), pk.q)
    k0 = _uniform(gen, (kdig, pk.k, n), pk.q)
    k1 = _uniform(gen, (kdig, pk.k, n), pk.q)
    polys_fi = rows_fi * pm.k
    cases = [
        # name, kernel, plain, args, source, replaces, bytes, multiplies
        ("fwd", pm.fwd, pm.fwd_plain, (x_fi,), src_ntt,
         "sunscreen_tpu/math/pmntt.py:354",
         2 * polys_fi * n * WORD, polys_fi * ntt_muls),
        ("fwd_broadcast", pk.fwd_broadcast, pk.fwd_broadcast_plain, (x_fb,),
         src_ntt, "sunscreen_tpu/math/pmntt.py:354",
         (BATCH * kdig * n + BATCH * kdig * pk.k * n) * WORD,
         BATCH * kdig * pk.k * ntt_muls),
        ("inv", pm.inv, pm.inv_plain, (x_fi,), src_ntt,
         "sunscreen_tpu/math/pmntt.py:354",
         2 * polys_fi * n * WORD, polys_fi * (ntt_muls + 3 * n)),
        ("fwd_tensor3", pm.fwd_tensor3, pm.fwd_tensor3_plain, (x_t3,),
         "sunscreen_tpu_torch/csrc/tensor3.cu",
         "sunscreen_tpu/math/pmntt.py:715",
         (4 + 3) * BATCH * pm.k * n * WORD,
         # 4 transforms + 4 products of 32x32 -> 64 bits (2 each)
         BATCH * pm.k * (4 * ntt_muls + 8 * n)),
        ("inv_ks", pk.inv_ks, pk.inv_ks_plain, (d_ks, k0, k1),
         "sunscreen_tpu_torch/csrc/inv_ks.cu",
         "sunscreen_tpu/math/pmntt.py:500",
         (BATCH * kdig + 2 * kdig + BATCH * 2) * pk.k * n * WORD,
         # 2 kdig digit products (2 each) + 2 inverse transforms
         BATCH * pk.k * (4 * kdig * n + 2 * (ntt_muls + 3 * n))),
    ]
    rows = []
    for name, kern, plain, args, src, repl, nbytes, muls in cases:
        got = kern(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        err = int((got - want).abs().max().item())
        exact = torch.equal(got, want)
        print(f"check {name}: shape {tuple(got.shape)} bit-exact={exact} "
              f"(tolerance 0: integer arithmetic)", flush=True)
        if not exact:
            raise SystemExit(f"kernel {name} disagrees with its plain twin "
                             f"(max abs err {err})")
        ms = _median_ms(lambda: kern(*args), reps=5, iters=10)
        plain_ms = _median_ms(lambda: plain(*args), reps=3, iters=2)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = muls / PEAK_INT_MULS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
        print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB "
              f"= {t_bytes:.4f} ms, {muls / 1e9:.4f} G 32-bit multiplies "
              f"= {t_ops:.4f} ms)", flush=True)
    return rows


def profile_breakdown(ctx, out, cts, rlk, batches: int = 3) -> None:
    """Device time per kernel name over a few multiply_relin batches
    (torch.profiler), and the device's busy share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sunscreen_tpu_torch.bfv import ops

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            out = ops.multiply_relin(ctx, out, cts, rlk)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            per_name[ev.name] = (per_name.get(ev.name, 0.0)
                                 + ev.time_range.elapsed_us())
    busy = sum(per_name.values())
    if busy == 0:
        print("profile: no device time recorded", flush=True)
        return
    ours = sum(v for k, v in per_name.items()
               if k.startswith(("ntt_fwd_kernel", "ntt_inv_kernel",
                                "fwd_tensor3_kernel", "inv_ks_kernel")))
    print(f"profile: per multiply_relin batch {wall_us / batches / 1e3:.3f}"
          f" ms wall, device busy {busy / batches / 1e3:.3f} ms "
          f"({100 * busy / wall_us:.1f}% of wall), port kernels "
          f"{ours / batches / 1e3:.3f} ms ({100 * ours / busy:.1f}% of "
          f"device time)", flush=True)
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"profile:   {us / batches / 1e3:8.3f} ms  "
              f"{100 * us / busy:5.1f}%  {name[:110]}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch.bfv import BfvParams, get_context, keys, ops
    from sunscreen_tpu_torch.math import pmntt

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

    params = BfvParams.default_u32(N)
    ctx = get_context(params, "cuda")
    print(f"params: N={N} t={params.plain_modulus} k={ctx.k} "
          f"mul base {ctx.mul_base.k} limbs, key base {ctx.key_base.k} "
          f"limbs", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = check_kernels(ctx, gen)

    # --- the main path: keygen, encrypt, multiply_relin -----------------
    pmntt.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(1)
    sk = keys.gen_secret_key(ctx, gen)
    pk = keys.gen_public_key(ctx, sk, gen)
    rlk = keys.gen_relin_key(ctx, sk, gen)
    t = params.plain_modulus
    pts = torch.arange(BATCH * N, dtype=torch.int64,
                       device="cuda").reshape(BATCH, N) % t
    cts = ops.encrypt(ctx, pk, pts, gen)

    # decrypt gate before timing: every product of the batch
    dec = ops.decrypt(ctx, sk, ops.multiply_relin(ctx, cts, cts, rlk))
    dec = dec.cpu().numpy()
    pts_np = pts.cpu().numpy()
    for r in range(BATCH):
        if not np.array_equal(dec[r], _negacyclic_square(pts_np[r], t)):
            raise SystemExit(f"decrypt gate FAILED at batch row {r}")
    print(f"decrypt gate: {BATCH} products decrypt to the numpy "
          f"negacyclic oracle", flush=True)

    # the same multiply_relin through the kernels and on the CPU
    one = ops.multiply_relin(ctx, cts[0], cts[0], rlk).cpu()
    ctx_cpu = get_context(params, "cpu")
    rlk_cpu = keys.KswKey(rlk.k0.cpu(), rlk.k1.cpu())
    ct_cpu = cts[0].cpu()
    want = ops.multiply_relin(ctx_cpu, ct_cpu, ct_cpu, rlk_cpu)
    if not torch.equal(one, want):
        raise SystemExit("multiply_relin on the card differs from the CPU")
    print("multiply_relin: card kernels == CPU plain path, bit for bit",
          flush=True)

    out = ops.multiply_relin(ctx, cts, cts, rlk)
    torch.cuda.synchronize()
    rates = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            out = ops.multiply_relin(ctx, out, cts, rlk)
        torch.cuda.synchronize()
        rates.append(BATCH * ITERS / (time.perf_counter() - t0))
    ops_per_s = sorted(rates)[REPS // 2]
    launches = dict(pmntt.LAUNCHES)
    print(f"multiply_relin: {ops_per_s:.1f} ops/s (N={N}, batch {BATCH}, "
          f"median of {REPS} x {ITERS}) on {smi}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise SystemExit(f"main path never launched: {missing}")
    profile_breakdown(ctx, out, cts, rlk)
    for row in table:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
