#!/usr/bin/env python3
"""Runs one cell of the benchmark of sunscreen_tpu_torch once, on the
CUDA devices of this machine:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cells, their configurations, traffic and
metrics are BENCHMARK.json's (portbench/harness.py). The last line of
standard output is one JSON object: "correct", "attempted", "failed",
"metrics" (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), "device", with --trace 1 "breakdown", and last "checks", each
number the correctness check compared beside its limit; the same numbers
end standard error. Exits non-zero, printing no result, without the CUDA
devices the cell asks for, or if the JAX stack or the JAX package
(`sunscreen_tpu`) was imported.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, in place of this script's directory, whose module
# names would shadow others
sys.path[0] = ROOT


def card_note() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi: {e}"
    return out.splitlines()[0] if out else "nvidia-smi: no output"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness
    spec = harness.load_spec(ROOT, args.workload)
    import torch
    need = spec["cell"]["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"portbench: {args.workload} needs {need} CUDA device(s), "
              f"{have} visible", file=sys.stderr)
        return 2
    result, banned, notes = harness.run(spec, args.seed, args.seconds,
                                        bool(args.trace), "cuda", T0)
    if banned:
        print(f"portbench: the process imported {', '.join(banned)}",
              file=sys.stderr)
        return 3
    print(f"portbench: {args.workload} seed {args.seed} on {card_note()}",
          file=sys.stderr)
    for key, value in notes.items():
        print(f"portbench: {key} {value}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
