#!/usr/bin/env python3
"""The span window: a traced window of a cell with the program's span
recording on (`sunscreen_tpu_torch.observability.record_spans`), whose
device operations and idle gaps are each put down to the program span
that launched them.

    python3 portbench/spans.py --workload <cell> --seed <n>

runs the cell's warm-up, its plain traced window (portbench/devtrace.py)
and then its span window, with the same batches, marker spins and
launch-count check, and prints the span metrics' readings
(portbench/metrics/, each that finds its span) and notes to standard
error and one JSON object to standard output. A client's cell (chi_sq)
waits for each batch in its span window, as its measured loop does:
queued back to back, its runs meet a full launch queue and the host
stalls between CUDA calls, which no span can tell from the program's
own time. Its cost of spans is taken against the same window run with
recording off.

The program's spans are on the host's `time.perf_counter_ns` clock, the
profiler's events on its own. On the card the trace of device activity
also holds the CUDA runtime's calls (`cudaLaunchKernel`, the copies and
fills), each sharing a correlation id with the device operation it
queued. The two clocks are tied at the two marker spins: the host clock
is read just before and just after queuing each, and the middle of the
spin's launch call on the profiler's clock is taken as that bracket's
midpoint. The anchor's uncertainty is the bracket less the call's own
time (on the card a spin's launch call takes 15-120 us under the
profiler, so the bracket alone is often wider than BRACKET_NS); a window
whose uncertainty passes BRACKET_NS at either mark, or whose two offsets
differ by more than AGREE_NS, is taken again. Their mean is then refined
by the launches themselves (`refine`): each launch call lies inside the
span that made it, so of the shifts within the marks' uncertainty the
one at which the fewest calls straddle a span's boundary is taken. On
the CPU (a rehearsal) the `portbench.window` range plays the marks'
part, its anchors reported but not held to those limits (entering the
range under the profiler takes about BRACKET_NS there), and each host
`aten::` operation is its own launch.

A device operation goes to the innermost span open at its launch, or to
"(no span)"; an idle gap goes to the span that launched the operation
ending it, and the gap before the closing mark to "(window end)": the
harness's synchronize, not the program's.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import sys
import time
from collections import defaultdict

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))

from portbench import devtrace  # noqa: E402

NO_SPAN = "(no span)"
NO_LAUNCH = "(launch not traced)"
WINDOW_END = "(window end)"
BRACKET_NS = 100_000
AGREE_NS = 50_000
METRICS = ("chisq.run_host_ms", "chisq.head_wait_ms",
           "bfv.keyswitch_ms_per_op", "bfv.permute_ms_per_op",
           "pbs.decompose_ms_per_step", "pbs.accumulate_ms_per_step",
           "pbs.lwe_keyswitch_ms")


def innermost(starts, ends, times) -> list[int]:
    """For each time, the index of the innermost span [start, end) open
    at it, or -1. Spans are given in the order they opened and nest."""
    out = [-1] * len(times)
    stack: list[int] = []
    j = 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while j < len(starts) and starts[j] <= t:
            while stack and ends[stack[-1]] <= starts[j]:
                stack.pop()
            stack.append(j)
            j += 1
        while stack and ends[stack[-1]] <= t:
            stack.pop()
        out[q] = stack[-1] if stack else -1
    return out


def offset(bracket, call) -> int:
    """Profiler clock minus host clock: the call (start, end) on the
    profiler's clock was made within `bracket` (before, after) on the
    host's; their midpoints are taken as one instant."""
    return (call[0] + call[1]) // 2 - (bracket[0] + bracket[1]) // 2


def refine(shift: int, reach: int, spans, calls) -> tuple[int, int, int]:
    """The shift within `reach` of `shift` at which the fewest of the
    host's calls (start, end, profiler clock) straddle a boundary of a
    span (host clock): the program makes each call inside one span, so
    at the true shift none does. Returns the middle of the range of
    shifts with the fewest, nearest `shift`, that count and the range's
    width."""
    calls = sorted(calls)
    starts = [c[0] for c in calls]
    lo, hi = shift - reach, shift + reach
    edges = []
    for s in spans:
        for b in (s.start_ns, s.end_ns):
            k = bisect.bisect_left(starts, b + hi) - 1
            while k >= 0 and calls[k][1] > b + lo:
                edges.append((max(calls[k][0] - b, lo), 1))
                edges.append((min(calls[k][1] - b, hi), -1))
                k -= 1
    edges.sort()
    segments, at, count = [], lo, 0
    for x, step in edges:
        if x > at:
            segments.append((count, at, x))
        count += step
        at = max(at, x)
    if hi > at:
        segments.append((count, at, hi))
    fewest = min(c for c, _, _ in segments)
    _, a, b = min((max(a - shift, shift - b, 0), a, b)
                  for c, a, b in segments if c == fewest)
    return (a + b) // 2, fewest, b - a


def attribute(spans, shift: int, ops, api, lo: int, hi: int) -> dict:
    """Puts the window [lo, hi] down to the spans (nanoseconds on the
    profiler's clock; `shift` takes a span's host time there). `ops` are
    the window's device operations (start, end, name, launch or None),
    `api` the host's CUDA API calls (start, end; nested calls count
    once). Returns seconds:
    device time by span name, "self" (the innermost span) and
    "inclusive" (every span around it, each name once), idle time by the
    innermost span, and for each root name the host time of each root
    outside CUDA runtime calls ("host") and the card's idle time between
    each root's start and its first device operation ("head_wait"), and
    the device time under any root ("roots_s")."""
    starts = [s.start_ns + shift for s in spans]
    ends = [s.end_ns + shift for s in spans]
    chains: list[tuple] = []                 # each span's names, outward
    for s in spans:
        up = chains[s.parent] if s.parent >= 0 else ()
        chains.append(up if s.name in up else (s.name,) + up)
    ops = sorted(ops)
    launched = [k for k, op in enumerate(ops) if op[3] is not None]
    owner = [-1] * len(ops)
    for k, o in zip(launched, innermost(starts, ends,
                                        [ops[k][3] for k in launched])):
        owner[k] = o
    own: dict[str, float] = defaultdict(float)
    inclusive: dict[str, float] = defaultdict(float)
    idle: dict[str, float] = defaultdict(float)
    head: dict[int, float] = {}
    under_roots = 0
    reach = lo
    for (s, e, _, launch), o in zip(ops, owner):
        label = spans[o].name if o >= 0 else (
            NO_LAUNCH if launch is None else NO_SPAN)
        own[label] += e - s
        for name in chains[o] if o >= 0 else (label,):
            inclusive[name] += e - s
        if s > reach:
            idle[label] += s - reach
        if o >= 0:
            under_roots += e - s
            root = spans[o].root
            if root not in head:
                head[root] = max(0, s - max(starts[root], reach))
        reach = max(reach, e)
    if hi > reach:
        idle[WINDOW_END] += hi - reach
    merged: list[list] = []                  # the calls' union
    for a, b in sorted(api):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    api_starts = [a for a, _ in merged]
    api_sum = [0]
    for a, b in merged:
        api_sum.append(api_sum[-1] + b - a)

    def in_calls(a, b):
        """The part of [a, b) inside the calls."""
        i = max(bisect.bisect_right(api_starts, a) - 1, 0)
        j = bisect.bisect_left(api_starts, b)
        if i >= j:
            return 0
        return (api_sum[j] - api_sum[i]
                - max(0, min(merged[i][1], a) - merged[i][0])
                - max(0, merged[j - 1][1] - max(merged[j - 1][0], b)))
    host: dict[str, list] = defaultdict(list)
    head_wait: dict[str, list] = defaultdict(list)
    for i, s in enumerate(spans):
        if s.parent < 0:
            host[s.name].append((ends[i] - starts[i]
                                 - in_calls(starts[i], ends[i])) * 1e-9)
            if i in head:
                head_wait[s.name].append(head[i] * 1e-9)

    def seconds(table):
        return {k: v * 1e-9 for k, v in table.items()}

    return {"self": seconds(own), "inclusive": seconds(inclusive),
            "idle": seconds(idle), "roots_s": under_roots * 1e-9,
            "host": dict(host), "head_wait": dict(head_wait)}


def _timeline(prof, on_device: bool):
    """(lo, hi, ops, the ops' launch calls, every CUDA API call, the
    marks' calls) of the window in the profiler's raw events,
    nanoseconds on its clock (start, end), or None. On the card the
    host's events of a trace of device activity are the CUDA API's; the
    calls of the thread that queued the marks are kept."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    if not on_device:
        win = [e for e in events if e.name() == devtrace.WINDOW]
        if len(win) != 1:
            return None
        lo, hi = win[0].start_ns(), win[0].end_ns()
        ops = [(e.start_ns(), e.end_ns(), e.name(), e.start_ns())
               for e in events if e.name().startswith("aten::")
               and lo <= e.start_ns() and e.end_ns() <= hi]
        return lo, hi, ops, [op[:2] for op in ops], [], ((lo, lo), (hi, hi))
    dev = [e for e in events if e.device_type() == DeviceType.CUDA]
    calls = {e.correlation_id(): e for e in events
             if e.device_type() == DeviceType.CPU and e.correlation_id()}
    marks = sorted((e for e in dev if devtrace.MARK in e.name()),
                   key=lambda e: e.start_ns())
    if len(marks) != 2 or any(m.correlation_id() not in calls
                              for m in marks):
        return None
    lo, hi = marks[0].end_ns(), marks[1].start_ns()

    ops, launches = [], []
    for e in dev:
        if (devtrace.MARK in e.name() or e.start_ns() < lo
                or e.end_ns() > hi):
            continue
        call = calls.get(e.correlation_id())
        ops.append((e.start_ns(), e.end_ns(), e.name(),
                    None if call is None else call.start_ns()))
        if call is not None:
            launches.append((call.start_ns(), call.end_ns()))
    thread = calls[marks[0].correlation_id()].start_thread_id()
    api = [(e.start_ns(), e.end_ns()) for e in events
           if e.device_type() == DeviceType.CPU
           and e.start_thread_id() == thread]
    return lo, hi, ops, launches, api, tuple(
        (calls[m.correlation_id()].start_ns(),
         calls[m.correlation_id()].end_ns()) for m in marks)


def _bracket(fn) -> tuple[int, int]:
    t0 = time.perf_counter_ns()
    fn()
    return t0, time.perf_counter_ns()


def profile_spans(batch, first: int, batches: int, device,
                  wait: bool = False, spans_on: bool = True) -> dict:
    """devtrace.profile's window with span recording on (off where not
    `spans_on`, for the cost's comparison): `batch(first)` traced ahead of
    the window, then `batch(first + 1)`, ... in it, each waited for
    where `wait` (a client's loop). Returns devtrace.read's numbers of
    the window with "batches",
    "attempts", "launches", the anchors ("offsets_ns", "brackets_ns",
    "mark_calls_ns": the marks' launch calls' durations, "refined_ns":
    `refine`'s change to the marks' mean offset, its count of straddling
    calls and its range's width), "spans" (the count of spans, and of
    spans the cap dropped), "counts" (spans by name) and `attribute`'s
    tables."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile
    from sunscreen_tpu_torch import _build
    from sunscreen_tpu_torch import observability as obs

    def recording():
        return (obs.record_spans() if spans_on
                else contextlib.nullcontext(obs.SpanLog()))

    on_device = torch.device(device).type == "cuda"
    activity = ProfilerActivity.CUDA if on_device else ProfilerActivity.CPU

    def synchronize():
        if on_device:
            torch.cuda.synchronize()

    def mark():
        torch.cuda._sleep(devtrace.MARK_CYCLES)

    kernels = devtrace.port_kernels()
    i = first
    for attempt in range(devtrace.RETRIES + 1):
        window = record_function(devtrace.WINDOW)
        with torch_profile(activities=[activity]) as prof:
            time.sleep(devtrace.SETTLE_S * 2 ** attempt)
            batch(i)
            i += 1
            synchronize()
            before = dict(_build.LAUNCHES)
            with recording() as log:
                opened = _bracket(mark if on_device else window.__enter__)
                for _ in range(batches):
                    batch(i)
                    i += 1
                    if wait:
                        synchronize()
                synchronize()
                closed = _bracket(
                    mark if on_device
                    else lambda: window.__exit__(None, None, None))
                synchronize()
            launched = sum(_build.LAUNCHES[k] - before[k] for k in before)
            launched += 2 * (_build.LAUNCHES["msm"] - before["msm"])
            time.sleep(0.1)
        line = _timeline(prof, on_device)
        if line is None:
            continue
        lo, hi, ops, launches, api, marks = line
        got = devtrace.read([(s / 1e3, e / 1e3, n) for s, e, n, _ in ops],
                            lo / 1e3, hi / 1e3, kernels)
        offsets = [offset(b, c) for b, c in zip((opened, closed), marks)]
        brackets = [b[1] - b[0] for b in (opened, closed)]
        loose = [b - (c[1] - c[0]) for b, c in zip(brackets, marks)]
        anchors = {"offsets_ns": offsets, "brackets_ns": brackets,
                   "mark_calls_ns": [c[1] - c[0] for c in marks],
                   "port_events": got["port_events"], "launches": launched}
        print(f"portbench.spans: attempt {attempt + 1} {anchors}",
              file=sys.stderr)
        if got["port_events"] != launched or on_device and (
                max(loose) > BRACKET_NS
                or abs(offsets[1] - offsets[0]) > AGREE_NS):
            continue
        coarse = (offsets[0] + offsets[1]) // 2
        shift, straddling, width = refine(
            coarse, max(loose) // 2 + abs(offsets[1] - offsets[0]), log,
            launches)
        got.update(attribute(log, shift, ops, api, lo, hi))
        got.update(anchors, batches=batches, attempts=attempt + 1,
                   refined_ns=[shift - coarse, straddling, width],
                   spans=[len(log), log.dropped], counts=log.counts())
        return got
    raise RuntimeError(f"no span window of {devtrace.RETRIES + 1} held its "
                       f"marks, one kernel event a launch of the port's "
                       f"kernels and anchors within {BRACKET_NS} ns that "
                       f"agree within {AGREE_NS} ns")


def record(win: dict, cell) -> dict:
    """The span window as the metric readers take it (`span_*` keys)."""
    rec = {"work_per_batch": cell.work_per_batch,
           "steps_per_batch": getattr(cell, "steps_per_batch", None)}
    rec.update({"span_" + k: win[k] for k in (
        "batches", "window_s", "busy_s", "self", "inclusive", "idle",
        "host", "head_wait")})
    return rec


def _top(table: dict, scale: float = 1e3) -> list:
    return [[k, round(v * scale, 4)]
            for k, v in sorted(table.items(), key=lambda kv: -kv[1])
            [:devtrace.TOP]]


def notes(plain: dict, win: dict) -> dict:
    """The span window's notes: its tables (ms), the shares of device and
    idle time in program spans, each root name's host ms outside CUDA
    calls (mean, least, most), the anchors, and the cost of spans (the
    span window's wall ms a batch beside `plain`'s, the window with
    recording off)."""
    device = sum(win["self"].values())
    idle = sum(v for k, v in win["idle"].items() if k != WINDOW_END)
    outside = {NO_SPAN, NO_LAUNCH}
    return {
        "span_device_ms": {"self": _top(win["self"]),
                           "inclusive": _top(win["inclusive"])},
        "span_idle_ms": _top(win["idle"]),
        "span_device_in_spans_pct": 100 * (1 - sum(
            win["self"].get(k, 0) for k in outside) / device)
        if device else None,
        "span_idle_in_spans_pct": 100 * (1 - sum(
            win["idle"].get(k, 0) for k in outside) / idle) if idle else None,
        "span_roots_over_busy": win["roots_s"] / win["busy_s"]
        if win["busy_s"] else None,
        "span_host_ms": {k: [round(1e3 * f(v), 4) for f in (
            lambda v: sum(v) / len(v), min, max)]
            for k, v in win["host"].items()},
        "span_offsets_ns": win["offsets_ns"],
        "span_brackets_ns": win["brackets_ns"],
        "span_mark_calls_ns": win["mark_calls_ns"],
        "span_refined_ns": win["refined_ns"],
        "span_spans": win["spans"], "span_counts": win["counts"],
        "span_attempts": win["attempts"],
        "wall_ms_per_batch": {
            "plain": 1e3 * plain["window_s"] / plain["batches"],
            "spans": 1e3 * win["window_s"] / win["batches"]},
        "idle_pct": {"plain": 100 * (1 - plain["busy_s"] / plain["window_s"]),
                     "spans": 100 * (1 - win["busy_s"] / win["window_s"])}}


def run(spec: dict, seed: int, device) -> tuple[dict, dict]:
    """Warm-up, the plain traced window, then the span window of one
    cell: (the span metrics' readings, notes). A client's cell (traffic
    "loop" "client") waits for each batch in its span window, as in its
    measured window, so that no run meets a full launch queue, whose
    waits stall the host outside any CUDA call; its cost is then taken
    against the same window with recording off."""
    from portbench import harness
    traffic = spec["traffic"]
    harness.program_environment(spec["config"])
    cell = harness.new_cell(spec, seed, device)
    for w in range(traffic["warmup_batches"]):
        cell.batch(w)
    harness.synchronize(device)
    first = traffic["warmup_batches"]
    plain = devtrace.profile(cell.batch, first, traffic["trace_batches"],
                             device)
    first += plain["attempts"] * (traffic["trace_batches"] + 1)
    wait = traffic["loop"] == "client"
    if wait:
        plain = profile_spans(cell.batch, first, traffic["trace_batches"],
                              device, wait=True, spans_on=False)
        first += plain["attempts"] * (traffic["trace_batches"] + 1)
    win = profile_spans(cell.batch, first, traffic["trace_batches"], device,
                        wait=wait)
    rec = record(win, cell)
    readings = {}
    for name in METRICS:
        value = harness.reader(name)(rec)
        if value is not None:
            readings[name] = value
    cell.release()
    return readings, notes(plain, win)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from portbench import harness
    spec = harness.load_spec(os.path.dirname(harness.HERE), args.workload)
    readings, info = run(spec, args.seed, args.device)
    for key, value in info.items():
        print(f"portbench.spans: {key} {json.dumps(value)}", file=sys.stderr)
    for key, value in readings.items():
        print(f"portbench.spans: metric {key} {value}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "metrics": readings, "notes": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
