"""The cell bfv16384.mul_relin.b64: its frozen counts worked by hand, a
rehearsal on the CPU on the configuration's own 14-limb chain and plain
modulus with N cut to 1024, the control and the faults there, and (marked
`chip`) the control at the cell's full size on three seeds."""

import time

import pytest

from portbench import harness, peaks
from portbench.counts import _bfv, bfv_mul_relin
from portbench.tests import breaks, tiny

CELL = "bfv16384.mul_relin.b64"


def _spec() -> dict:
    """The cell at N = 1024: every prime of the chain and t = 786433 are
    1 mod 2048, so only N and the batch are cut (no security level)."""
    s = harness.load_spec(tiny.ROOT, CELL)
    s["config"].update(poly_degree=1024, security_level=0)
    s["traffic"].update(batch=4, input_sets=2, warmup_batches=1,
                        checked_batches=2, trace_batches=1)
    return s


def _readings(result) -> dict:
    return {k: v["value"] for k, v in result["checks"].items()}


def test_bfv_counts_at_n16384():
    spec = harness.load_spec(tiny.ROOT, CELL)
    config, traffic = spec["config"], spec["traffic"]
    # Q: 12 x 29 + 2 x 30 = 408 bits; t 20 bits, N 15 bits: 445 bits of
    # auxiliary base, 15 primes of 30 bits
    assert _bfv.shape(config, 786433) == (16384, 14, 15, 15)
    assert _bfv.ntt_muls(16384) == 3 * 8192 * 14 == 344064
    # convert 65536 x 590 + tensor 29 x 1507328 + inverse 87 x 393216
    # + scale 49152 x 1758
    assert _bfv.multiply_muls(config, 786433) == (
        38666240 + 43712512 + 34209792 + 86409216)
    # 14 x 15 transforms + 15 x (4 x 14 x 16384 + 2 x 393216)
    # + 2 x 16384 x 28
    assert _bfv.keyswitch_muls(config, 786433) == (
        72253440 + 25559040 + 917504)
    nbytes, muls = bfv_mul_relin.work(config, traffic)
    assert muls == 64 * (202997760 + 98729984) == 19310575616
    # 3 x 64 ciphertexts of 2 x 14 x 16384 words, a key of 2 x 14 x 15 x
    # 16384
    assert nbytes == 3 * 64 * 3670016 + 55050240 == 759693312
    # bound by the multiplies: 1.1529 ms (the bytes alone 0.2268 ms)
    assert peaks.least_seconds(nbytes, muls) == muls / 16.75e12
    assert 1.1528e-3 < muls / 16.75e12 < 1.1529e-3


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_rehearsal_is_correct_and_reports_the_cells_metrics(traced):
    spec = _spec()
    assert len(spec["config"]["coeff_modulus"]) == 14
    result, banned, notes = tiny.run(CELL, traced=traced, s=spec)
    assert banned == [] and result["correct"] is True, result["checks"]
    assert result["checks"] == {"wrong_coefficients": {"value": 0,
                                                       "limit": 0}}
    assert notes["checked_batches"] == min(2, notes["batches"])
    assert notes["checked_coefficients"] == notes["checked_batches"] * 4 * 1024
    want = ({"bfv.device_ms_per_op", "glue_pct.bfv", "bfv_op_roofline",
             "idle_pct.bfv"} if traced else {"bfv_ops_per_s", "setup_s"})
    assert set(result["metrics"]) == want
    for m in result["metrics"].values():
        assert m["value"] > 0


@pytest.mark.parametrize("fault", breaks.FAULTS)
def test_fault_is_not_correct(fault, monkeypatch):
    spec = _spec()
    breaks.apply_fault(fault, spec, monkeypatch)
    result, _, _ = tiny.run(CELL, s=spec)
    assert result["correct"] is False, _readings(result)


def test_control_is_not_correct(monkeypatch):
    spec = _spec()
    breaks.apply_control(spec, monkeypatch)
    result, _, _ = tiny.run(CELL, s=spec)
    assert result["correct"] is False, _readings(result)


@pytest.mark.chip
@pytest.mark.parametrize("seed", [5_100_000_001, 5_100_000_002,
                                  5_100_000_003])
def test_control_on_the_card_is_not_correct(seed, card, monkeypatch,
                                            capsys):
    spec = harness.load_spec(tiny.ROOT, CELL)
    breaks.apply_control(spec, monkeypatch)
    result, _, notes = harness.run(spec, seed, 2.0, False, card,
                                   time.perf_counter())
    with capsys.disabled():
        print(f"\ncontrol {CELL} seed {seed}: {_readings(result)} of {notes}")
    assert result["correct"] is False
