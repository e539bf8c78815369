"""Cells of BENCHMARK.json cut to a size the CPU runs in a second or two,
for rehearsals of the harness on the CPU: BFV at N = 1024 over three
28-bit primes (no security level), TFHE with 16 LWE mask words and
GLWE N = 256, batches of 4 and 32."""

import os

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ("bfv8192.mul_relin.b64", "tfhe80.pbs.b2048", "bfv8192.chi_sq.b128",
         "bfv8192.rotsum.b256")
# BfvParams.insecure_u32(1024): its primes, special prime and batching t
N = 1024
PRIMES = [268369921, 268367873, 268361729]
SPECIAL = 1073707009
BATCHING_T = 61441


def spec(workload: str) -> dict:
    s = harness.load_spec(ROOT, workload)
    c, t = s["config"], s["traffic"]
    if c["scheme"] == "bfv":
        c.update(poly_degree=N, coeff_modulus=PRIMES,
                 special_modulus=SPECIAL, security_level=0)
        if t["op"] == "bfv_program":
            t["compile"] = "fixed"
        else:
            t["plain_modulus"] = BATCHING_T
        if "row_steps" in t:
            t["row_steps"] = [1 << i for i in range(9)]      # N/2 slots
        t.update(batch=4)
    else:
        c.update(lwe={"dim": 16, "std": 1e-12},
                 glwe={"size": 1, "poly_degree": 256, "std": 1e-15})
        # 32 rows: half a batch of 1-bit messages never matches the other
        # half by chance (2^-16 a batch), so the fault tests see copies
        t.update(batch=32)
    t.update(input_sets=2, warmup_batches=1, checked_batches=2,
             trace_batches=1)
    return s


def run(workload: str, traced: bool = False, seconds: float = 0.3,
        seed: int = 4_000_000_007, s: dict | None = None):
    """One rehearsal run on the CPU: (result, banned modules, notes)."""
    import time
    return harness.run(s or spec(workload), seed, seconds, traced, "cpu",
                       time.perf_counter())
