"""The general harness: one run of one cell, driven by data.

BENCHMARK.json names each cell's configuration (a file of sizes under
portbench/configs/), its traffic mix (portbench/traffic/<traffic>.json,
whose "op" names the module in portbench/ops/ that runs it) and its
metrics (each per-layer metric read by portbench/metrics/<name>.py, or
by its family's reader there). A
run sets the program's environment to the configuration's, builds the
cell (keys and inputs from the seed), warms it up, and then runs a closed
loop of whole batches for the window: "ahead" dispatches batch after
batch with no wait, "client" waits for each batch's outputs, timing each
on the card's clock from the call to the outputs being ready. The window
ends at the synchronize after the batch that crossed `seconds`; a rate is
the work of all its batches over all its time. A uniform sample of the
window's batches, drawn from the seed, keeps its outputs; once the window
has closed and the program's state is freed the cell checks them
against the plain reference. With tracing on, the same window runs, then
a traced window (portbench/devtrace.py) gives the per-layer metrics.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time

from portbench import devtrace, generate, peaks

HERE = os.path.dirname(os.path.abspath(__file__))
BANNED = ("jax", "jaxlib", "flax", "sunscreen_tpu")
PROGRAM_ENV = "SUNSCREEN_TPU_"


def load_spec(root: str, workload: str) -> dict:
    """The cell `workload` of root/BENCHMARK.json: its entry, its
    configuration and traffic files, and the metrics it reports."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise ValueError(f"no cell {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return {"workload": workload, "cell": cell, "config": config,
            "traffic": traffic, "end_to_end": e2e, "per_layer": layer}


def program_environment(config: dict) -> None:
    """The program reads its settings (SUNSCREEN_TPU_*) from the
    environment at call time: exactly the configuration's, none other."""
    for key in [k for k in os.environ if k.startswith(PROGRAM_ENV)]:
        del os.environ[key]
    os.environ.update(config.get("environment", {}))


def new_cell(spec: dict, seed: int, device):
    kind = importlib.import_module(f"portbench.ops.{spec['traffic']['op']}")
    return kind.Cell(spec["config"], spec["traffic"], seed, device)


def _on_card(device) -> bool:
    import torch
    return torch.device(device).type == "cuda"


def synchronize(device) -> None:
    import torch
    if _on_card(device):
        torch.cuda.synchronize()


class Reservoir:
    """A uniform sample of `size` (index, output) pairs of a stream."""

    def __init__(self, size: int, rng):
        self.size, self.rng = size, rng
        self.items: list = []
        self.seen = 0

    def offer(self, i: int, out) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append((i, out))
        else:
            r = self.rng.randrange(self.seen)
            if r < self.size:
                self.items[r] = (i, out)


def window(cell, traffic: dict, seconds: float, seed: int, device) -> dict:
    """The measured closed loop."""
    import torch
    card = _on_card(device)
    client = traffic["loop"] == "client"
    keep = Reservoir(traffic["checked_batches"],
                     generate.host_rng(seed, "checked batches"))
    if client and card:
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
    latency_ms, enqueue_s = [], []
    synchronize(device)
    start = time.perf_counter()
    i = 0
    while True:
        if client and card:
            ev0.record()
        h0 = time.perf_counter()
        out = cell.batch(i)
        h1 = time.perf_counter()
        enqueue_s.append(h1 - h0)
        if client:
            if card:
                ev1.record()
                ev1.synchronize()
                latency_ms.append(ev0.elapsed_time(ev1))
            else:
                latency_ms.append((time.perf_counter() - h0) * 1e3)
        keep.offer(i, out)
        i += 1
        if time.perf_counter() - start >= seconds:
            break
    synchronize(device)
    return {"batches": i, "elapsed_s": time.perf_counter() - start,
            "latency_ms": latency_ms, "enqueue_s": enqueue_s,
            "kept": keep.items}


def nearest_rank(values, q: float) -> float:
    """The q-quantile by nearest rank."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def end_to_end(spec: dict, cell, win: dict, setup_s: float) -> dict:
    traffic = spec["traffic"]
    values = {"setup_s": setup_s}
    if "rate_metric" in traffic:
        values[traffic["rate_metric"]] = (
            win["batches"] * cell.work_per_batch / win["elapsed_s"])
    if "latency_metric" in traffic:
        # every request of a batch waits for the whole batch
        values[traffic["latency_metric"]] = nearest_rank(
            win["latency_ms"], traffic["latency_quantile"])
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in spec["end_to_end"]}


def reader_path(name: str) -> str:
    """The file that reads the metric `name` (portbench/metrics/)."""
    family = "roofline" if name.endswith("_roofline") else name.split(".")[0]
    for stem in (name, family):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no reader for the metric {name!r}")


def reader(name: str):
    path = reader_path(name)
    mod_spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def least_seconds(spec: dict) -> float:
    """The least time one batch of the cell could take on the card."""
    counts = importlib.import_module(
        f"portbench.counts.{spec['traffic']['op']}")
    return peaks.least_seconds(*counts.work(spec["config"], spec["traffic"]))


def per_layer(spec: dict, cell, win: dict, prof: dict) -> dict:
    rec = dict(prof, work_per_batch=cell.work_per_batch,
               steps_per_batch=getattr(cell, "steps_per_batch", None),
               enqueue_s=win["enqueue_s"], least_s=least_seconds(spec))
    out = {}
    for m in spec["per_layer"]:
        value = reader(m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _top(table: dict) -> list:
    return [[k, v] for k, v in sorted(table.items(),
                                      key=lambda kv: -kv[1])[:devtrace.TOP]]


def banned_modules() -> list[str]:
    """The JAX stack or the JAX package, by whole top-level module name,
    in this process."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def run(spec: dict, seed: int, seconds: float, traced: bool, device,
        t0: float) -> tuple[dict, list, dict]:
    """One run: (the result line, the banned modules found, notes for
    standard error). `t0` is the process's start on the host clock."""
    import torch
    traffic = spec["traffic"]
    program_environment(spec["config"])
    card = _on_card(device)
    cell = new_cell(spec, seed, device)
    for w in range(traffic["warmup_batches"]):
        cell.batch(w)
    synchronize(device)
    setup_s = time.perf_counter() - t0
    win = window(cell, traffic, seconds, seed, device)
    prof = (devtrace.profile(cell.batch, win["batches"],
                             traffic["trace_batches"], device)
            if traced else None)
    peak = torch.cuda.max_memory_allocated() if card else 0
    banned = banned_modules()
    kept = win.pop("kept")
    cell.release()
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    checks, notes = cell.check(kept)
    del kept
    notes.update(batches=win["batches"], window_s=win["elapsed_s"],
                 setup_s=setup_s, check_s=time.perf_counter() - c0)
    dev = {"platform": "gpu" if card else "cpu",
           "kind": torch.cuda.get_device_name(0) if card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if prof is None:
        metrics = end_to_end(spec, cell, win, setup_s)
    else:
        metrics = per_layer(spec, cell, win, prof)
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        notes.update(traced_batches=prof["batches"],
                     trace_attempts=prof["attempts"],
                     port_kernel_launches=prof["launches"],
                     port_kernel_s=prof["port_s"])
    result = {
        "correct": all(v <= limit for v, limit in checks.values())
        and not banned,
        "attempted": win["batches"] * cell.requests_per_batch,
        "failed": 0, "metrics": metrics, "device": dev}
    if prof is not None:
        result["breakdown"] = {"device_ops": _top(prof["by_name"]),
                               "idle_gaps": _top(prof["gaps"])}
    result["checks"] = {name: {"value": v, "limit": limit}
                        for name, (v, limit) in checks.items()}
    return result, banned, notes
