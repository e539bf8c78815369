"""The span window's attribution (portbench/spans.py) on a synthetic
timeline of program spans, CUDA runtime calls and device operations; the
span metrics' readers; and the span window rehearsed on tiny cells on the
CPU."""

import pytest

from portbench import harness, spans
from portbench.tests import tiny
from sunscreen_tpu_torch.observability import Span

# host clock: root A [100, 1000) over B [200, 500) and C [600, 900);
# root D [1200, 1500)
HOST = [Span("A", 100, 1000, -1, 0), Span("B", 200, 500, 0, 0),
        Span("C", 600, 900, 0, 0), Span("D", 1200, 1500, -1, 3)]
SHIFT = 10_000                      # the profiler's clock is the host's + this
# device operations (start, end, name, launch), profiler clock
OPS = [(10_300, 10_400, "k1", 10_250),      # launched in B; 100 idle before
       (10_400, 10_600, "k2", 10_650),      # in C, back to back
       (10_700, 10_800, "k3", 10_950),      # in A itself; 100 idle
       (11_000, 11_050, "k4", 11_100),      # between the roots; 200 idle
       (11_100, 11_120, "k5", None),        # no launch traced; 50 idle
       (11_400, 11_500, "k6", 11_300)]      # in D; 280 idle
# CUDA API calls, host side, profiler clock; (10_660, 10_690) nests in
# the call before it, as one CUDA API call made inside another
CALLS = [(10_250, 10_270), (10_650, 10_700), (10_660, 10_690),
         (10_950, 10_960), (11_100, 11_105), (11_300, 11_310)]
LO, HI = 10_200, 11_600


def test_innermost_span_at_each_time():
    starts = [s.start_ns for s in HOST]
    ends = [s.end_ns for s in HOST]
    times = [50, 100, 199, 200, 499, 500, 650, 950, 1000, 1100, 1200, 1499,
             1500]
    assert spans.innermost(starts, ends, times) == [
        -1, 0, 0, 1, 1, 0, 2, 0, -1, -1, 3, 3, -1]
    # the answer does not depend on the order of the times
    assert spans.innermost(starts, ends, times[::-1]) == [
        -1, 3, 3, -1, -1, 0, 2, 0, 1, 1, 0, 0, -1]


def test_the_anchor_offset_is_the_calls_midpoint_less_the_brackets():
    assert spans.offset((1_000, 1_040), (11_010, 11_030)) == SHIFT
    # two marks whose calls land anywhere in their brackets give offsets
    # within half a bracket of the true one: the first mark's call early
    # in its bracket, the second's late
    first = spans.offset((500, 540), (10_502, 10_508))
    second = spans.offset((1_600, 1_640), (11_630, 11_640))
    assert abs(first - SHIFT) <= 20 and abs(second - SHIFT) <= 20


def test_the_launch_calls_refine_the_anchor():
    """Each call lies inside the span that made it: from an offset 30 ns
    off, calls made just inside the spans' boundaries pull the shift back
    to within a few ns of the true one, where no call straddles one."""
    calls = CALLS + [(10_205, 10_215), (10_490, 10_498), (10_604, 10_640),
                     (11_203, 11_260)]
    shift, straddling, width = spans.refine(SHIFT + 30, 40, HOST, calls)
    assert (shift, straddling, width) == (SHIFT, 0, 5)
    got = spans.attribute(HOST, shift, OPS, CALLS, LO, HI)
    assert got["self"] == spans.attribute(HOST, SHIFT, OPS, CALLS, LO,
                                          HI)["self"]
    # 30 ns off, the call made 50 ns after B opened (10_250) falls in A
    wrong = spans.attribute(HOST, SHIFT + 60, OPS, CALLS, LO, HI)
    assert wrong["self"] != got["self"]
    # no calls: nothing to refine by
    assert spans.refine(SHIFT, 40, HOST, []) == (SHIFT, 0, 80)


def test_device_time_goes_to_the_innermost_span_at_its_launch():
    got = spans.attribute(HOST, SHIFT, OPS, CALLS, LO, HI)
    ns = 1e-9
    assert got["self"] == pytest.approx({
        "B": 100 * ns, "C": 200 * ns, "A": 100 * ns,
        spans.NO_SPAN: 50 * ns, spans.NO_LAUNCH: 20 * ns, "D": 100 * ns})
    assert got["inclusive"] == pytest.approx({
        "A": 400 * ns, "B": 100 * ns, "C": 200 * ns, "D": 100 * ns,
        spans.NO_SPAN: 50 * ns, spans.NO_LAUNCH: 20 * ns})
    assert got["roots_s"] == pytest.approx(500 * ns)


def test_idle_gaps_go_to_the_span_that_launched_the_op_ending_them():
    got = spans.attribute(HOST, SHIFT, OPS, CALLS, LO, HI)
    ns = 1e-9
    assert got["idle"] == pytest.approx({
        "B": 100 * ns, "A": 100 * ns, spans.NO_SPAN: 200 * ns,
        spans.NO_LAUNCH: 50 * ns, "D": 280 * ns,
        spans.WINDOW_END: 100 * ns})
    # the card idles 100 ns between A's start (10_100) and its first
    # operation (10_300), the window opening at 10_200; 200 ns after D's
    # start (11_200), the card having drained at 11_120
    assert got["head_wait"] == pytest.approx({"A": [100 * ns],
                                              "D": [200 * ns]})
    # host time of each root less the API calls made inside it, each
    # instant once
    assert got["host"] == pytest.approx({"A": [(900 - 80) * ns],
                                         "D": [(300 - 10) * ns]})


def test_host_time_leaves_out_the_calls_parts_inside_the_root():
    host = [Span("R", 100, 200, -1, 0)]
    calls = [(90, 110), (150, 160), (155, 158), (190, 230), (240, 250)]
    got = spans.attribute(host, 0, [], calls, 0, 300)
    assert got["host"] == pytest.approx({"R": [(100 - 10 - 10 - 10) * 1e-9]})


def test_a_span_nested_in_its_own_name_counts_once_inclusive():
    host = [Span("op", 0, 100, -1, 0), Span("op", 10, 50, 0, 0)]
    got = spans.attribute(host, 0, [(20, 30, "k", 20), (60, 70, "k", 60)],
                          [], 0, 100)
    assert got["inclusive"] == pytest.approx({"op": 20e-9})
    assert got["self"] == pytest.approx({"op": 20e-9})


def _rec(**tables):
    rec = {"work_per_batch": 4, "steps_per_batch": 8, "span_batches": 2,
           "span_inclusive": {}, "span_host": {}, "span_head_wait": {}}
    rec.update(tables)
    return rec


def test_the_span_metrics_readers():
    rec = _rec(span_inclusive={"bfv.keyswitch": 0.008, "bfv.permute": 0.002,
                               "tfhe.br.decompose": 0.032,
                               "tfhe.br.accumulate": 0.016,
                               "tfhe.keyswitch": 0.004},
               span_host={"runtime.run": [0.004, 0.006]},
               span_head_wait={"runtime.run": [0.0001, 0.0003]})
    want = {"bfv.keyswitch_ms_per_op": 1.0, "bfv.permute_ms_per_op": 0.25,
            "pbs.decompose_ms_per_step": 2.0,
            "pbs.accumulate_ms_per_step": 1.0, "pbs.lwe_keyswitch_ms": 2.0,
            "chisq.run_host_ms": 5.0, "chisq.head_wait_ms": 0.2}
    assert set(want) == set(spans.METRICS)
    for name, value in want.items():
        assert harness.reader(name)(rec) == pytest.approx(value)
        # a record without the span window, or without the span, reads
        # nothing
        assert harness.reader(name)({"work_per_batch": 4}) is None
        assert harness.reader(name)(_rec()) is None


@pytest.mark.parametrize("workload,metrics", [
    ("bfv8192.mul_relin.b64", {"bfv.keyswitch_ms_per_op"}),
    ("tfhe80.pbs.b2048", {"pbs.decompose_ms_per_step",
                          "pbs.accumulate_ms_per_step",
                          "pbs.lwe_keyswitch_ms"})])
def test_span_window_rehearsal(workload, metrics):
    readings, notes = spans.run(tiny.spec(workload), 4_000_000_007, "cpu")
    assert set(readings) == metrics and min(readings.values()) > 0
    assert notes["span_device_in_spans_pct"] >= 99
    assert notes["span_spans"][0] > 0 and notes["span_spans"][1] == 0
    assert len(notes["span_device_ms"]["self"]) <= 10
