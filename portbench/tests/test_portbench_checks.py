"""The correctness check fails the control and every fault a cell can
have, on the CPU at a tiny size; on the card (marked `chip`) the control
at each cell's own size, on three seeds."""

import pytest

from portbench import harness
from portbench.tests import breaks, tiny


def _readings(result) -> dict:
    return {k: v["value"] for k, v in result["checks"].items()}


@pytest.mark.parametrize("fault", breaks.FAULTS)
@pytest.mark.parametrize("workload", tiny.CELLS)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    spec = tiny.spec(workload)
    breaks.apply_fault(fault, spec, monkeypatch)
    result, _, _ = tiny.run(workload, s=spec)
    assert result["correct"] is False, _readings(result)


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_control_is_not_correct(workload, monkeypatch):
    spec = tiny.spec(workload)
    breaks.apply_control(spec, monkeypatch)
    result, _, _ = tiny.run(workload, s=spec)
    assert result["correct"] is False, _readings(result)


@pytest.mark.chip
@pytest.mark.parametrize("seed", [5_100_000_001, 5_100_000_002,
                                  5_100_000_003])
@pytest.mark.parametrize("workload", tiny.CELLS)
def test_control_on_the_card_is_not_correct(workload, seed, card,
                                            monkeypatch, capsys):
    import time
    spec = harness.load_spec(tiny.ROOT, workload)
    breaks.apply_control(spec, monkeypatch)
    result, _, notes = harness.run(spec, seed, 2.0, False, card,
                                   time.perf_counter())
    with capsys.disabled():
        print(f"\ncontrol {workload} seed {seed}: {_readings(result)} "
              f"of {notes}")
    assert result["correct"] is False
