"""Rehearsals of every cell on the CPU at a tiny size, the result line's
shape, BENCHMARK.json against the files the harness looks for, and the
command line's refusal without a card."""

import json
import os
import re
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import tiny

BENCH = os.path.join(tiny.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench() -> dict:
    with open(BENCH) as f:
        return json.load(f)


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("workload", tiny.CELLS)
def test_rehearsal_is_correct_and_reports_the_cells_metrics(workload,
                                                            traced):
    spec = tiny.spec(workload)
    result, banned, notes = tiny.run(workload, traced=traced, s=spec)
    assert banned == []
    assert list(result) == (
        ["correct", "attempted", "failed", "metrics", "device"]
        + (["breakdown"] if traced else []) + ["checks"])
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    wanted = spec["per_layer" if traced else "end_to_end"]
    assert set(result["metrics"]) == {m["name"] for m in wanted}
    for m in wanted:
        got = result["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert notes["checked_batches"] == min(2, notes["batches"])
    for check in result["checks"].values():
        assert check == {"value": 0, "limit": 0}
    if traced:
        assert result["device"]["busy_s"] > 0
        for key in ("device_ops", "idle_gaps"):
            assert 0 < len(result["breakdown"][key]) <= 10
    json.dumps(result)


def _tensors(out) -> list:
    return out if isinstance(out, list) else [out]


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_same_seed_same_inputs(workload):
    a, b, c = (_tensors(harness.new_cell(tiny.spec(workload), seed,
                                         "cpu").batch(0))
               for seed in (7, 7, 8))
    for x, y, z in zip(a, b, c, strict=True):
        assert x.equal(y) and not x.equal(z)


def test_benchmark_names_files_that_exist():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and os.path.exists(
            os.path.join(tiny.ROOT, c["file"]))
        assert len(c["why"]) <= 200 and c["reduced"] == []
    ops = set()
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        spec = harness.load_spec(tiny.ROOT, w["name"])
        op = spec["traffic"]["op"]
        ops.add(op)
        for sub in ("ops", "counts"):
            assert os.path.exists(os.path.join(harness.HERE, sub,
                                               op + ".py"))
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    moved = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in moved
        assert os.path.exists(harness.reader_path(m["name"]))
    assert len(json.dumps(bench)) < 64 * 1024


def test_command_line_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    proc = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
         tiny.CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tiny.ROOT)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_nearest_rank_quantile():
    values = list(range(1, 101))
    assert harness.nearest_rank(values, 0.95) == 95
    assert harness.nearest_rank([3.0], 0.95) == 3.0


def test_reservoir_keeps_a_uniform_sample():
    import random
    counts = [0] * 20
    for seed in range(400):
        r = harness.Reservoir(4, random.Random(seed))
        for i in range(20):
            r.offer(i, None)
        for i, _ in r.items:
            counts[i] += 1
    assert sum(counts) == 1600
    assert min(counts) > 40 and max(counts) < 120      # 80 expected


def test_a_metric_without_a_file_of_its_own_is_read_by_its_family():
    def stem(name):
        return os.path.basename(harness.reader_path(name))
    assert stem("glue_pct.newcell") == "glue_pct.py"
    assert stem("idle_pct.newcell") == "idle_pct.py"
    assert stem("newop_roofline") == "roofline.py"
    assert stem("chisq.enqueue_ms") == "chisq.enqueue_ms.py"
    with pytest.raises(FileNotFoundError):
        harness.reader_path("no_such.metric")
