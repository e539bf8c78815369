"""Logging, tracing and metrics (port of `sunscreen_tpu/observability.py`).

- module loggers under the `sunscreen_tpu_torch` namespace: enable with
  `enable_logging("DEBUG")`, the standard `logging` machinery, or the
  reference's SUNSCREEN_TPU_LOG=DEBUG at import;
- `span(name)`: a region of the program on the host's clock
  (`time.perf_counter_ns`), kept while span recording is on as
  (name, start, end, parent, root) in one process-wide list. Recording is
  off unless `record_spans()`, `start_spans()` or `start_profiler()`
  turns it on; off, a span is a flag test and a shared object whose
  `__enter__` and `__exit__` are builtins. The runtime, the lowering and
  the BFV and TFHE ops open spans (`runtime.run`, `lower.<op>`,
  `bfv.<op>`, `tfhe.<op>`, `tfhe.br.<part>`); the counts of a recorded
  window's span names count the ops;
- `trace(label)`: a span that also logs its wall time at DEBUG and opens
  a `torch.profiler.record_function` of that label, which a running
  profiler shows on its timeline;
- `start_profiler(logdir)` / `stop_profiler()`: a `torch.profiler`
  capture of host and device activity with span recording on, exported
  as a Chrome trace with the spans in a row of their own;
- `metrics`: the process-wide counters and gauges the runtime feeds
  (`runtime.programs_run`, `runtime.run.<name>`,
  `runtime.noise_budget_floor_bits`), the reference's names.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from collections import defaultdict
from typing import NamedTuple

import torch

_ROOT = "sunscreen_tpu_torch"


def get_logger(name: str | None = None) -> logging.Logger:
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)


def enable_logging(level: str = "INFO") -> None:
    """Attach a stderr handler to the package's logger namespace."""
    logger = logging.getLogger(_ROOT)
    logger.setLevel(getattr(logging, level.upper()))
    if not any(isinstance(h, logging.StreamHandler)
               for h in logger.handlers):
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)


if os.environ.get("SUNSCREEN_TPU_LOG"):
    enable_logging(os.environ["SUNSCREEN_TPU_LOG"])


class _Metrics:
    """Counters and gauges."""

    def __init__(self):
        self.counters: dict[str, int] = defaultdict(int)
        self.gauges: dict[str, float] = {}

    def incr(self, name: str, by: int = 1) -> None:
        self.counters[name] += by

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def gauge_min(self, name: str, value: float) -> None:
        cur = self.gauges.get(name)
        self.gauges[name] = value if cur is None else min(cur, value)

    def snapshot(self) -> dict:
        return {"counters": dict(self.counters),
                "gauges": dict(self.gauges)}

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()


metrics = _Metrics()


# -- spans --------------------------------------------------------------------

SPAN_CAP = 1 << 20          # spans a recording keeps; the rest are counted


class Span(NamedTuple):
    """One recorded span: host nanoseconds on `time.perf_counter_ns`'s
    clock, the index of the innermost span open at its start (-1 for a
    root) and the index of its root (its own for a root)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    root: int


class SpanLog:
    """The spans of one recording, in the order they opened, and the
    count of spans the cap dropped."""

    def __init__(self, spans: list[Span] | None = None, dropped: int = 0):
        self.spans = spans or []
        self.dropped = dropped

    def __len__(self) -> int:
        return len(self.spans)

    def __iter__(self):
        return iter(self.spans)

    def __getitem__(self, i: int) -> Span:
        return self.spans[i]

    def self_ns(self) -> list[int]:
        """Each span's duration less the part its child spans cover
        (children nest inside their parent, so the part is their sum)."""
        out = [s.end_ns - s.start_ns for s in self.spans]
        for s in self.spans:
            if s.parent >= 0:
                out[s.parent] -= s.end_ns - s.start_ns
        return out

    def counts(self) -> dict[str, int]:
        """Spans by name: the counters of the recorded window."""
        out: dict[str, int] = defaultdict(int)
        for s in self.spans:
            out[s.name] += 1
        return dict(out)


class _Recorder:
    """The spans being recorded, as parallel lists. Spans nest by the
    order they open and close, so spans are opened by one thread."""

    def __init__(self, cap: int):
        self.cap = cap
        self.dropped = 0
        self.names: list[str] = []
        self.starts: list[int] = []
        self.ends: list[int] = []
        self.parents: list[int] = []
        self.roots: list[int] = []
        self.open = -1                  # the innermost open span

    def take(self) -> SpanLog:
        now = time.perf_counter_ns()
        # a span still open when recording stops ends then
        ends = [e or now for e in self.ends]
        return SpanLog([Span(*row) for row in zip(
            self.names, self.starts, ends, self.parents, self.roots)],
            self.dropped)


class _On:
    """A span while recording is on."""

    __slots__ = ("name", "rec", "i")

    def __init__(self, name: str, rec: _Recorder):
        self.name, self.rec = name, rec

    def __enter__(self):
        rec = self.rec
        i = len(rec.starts)
        if i >= rec.cap:
            rec.dropped += 1
            self.i = -1
            return
        parent = rec.open
        rec.names.append(self.name)
        rec.parents.append(parent)
        rec.roots.append(i if parent < 0 else rec.roots[parent])
        rec.ends.append(0)
        rec.open = self.i = i
        rec.starts.append(time.perf_counter_ns())

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        i = self.i
        if i >= 0:
            rec = self.rec
            rec.ends[i] = end
            rec.open = rec.parents[i]


class _Off:
    """The span while recording is off. Its `__enter__` and `__exit__`
    are builtins, so entering it runs no Python frame: `"".format` takes
    any arguments and returns "", which is false, so an exception in the
    region goes on."""

    __slots__ = ()
    __enter__ = int
    __exit__ = "".format


_OFF = _Off()
_RECORDER: _Recorder | None = None


def span(name: str):
    """A context manager around a region of the program, kept while span
    recording is on (`record_spans`, `start_spans`, `start_profiler`)."""
    return _OFF if _RECORDER is None else _On(name, _RECORDER)


def start_spans(cap: int = SPAN_CAP) -> None:
    """Turns span recording on, keeping up to `cap` spans."""
    global _RECORDER
    if _RECORDER is not None:
        raise RuntimeError("span recording is already on")
    _RECORDER = _Recorder(cap)


def take_spans() -> SpanLog:
    """Turns span recording off and returns what it recorded."""
    global _RECORDER
    rec, _RECORDER = _RECORDER, None
    return SpanLog() if rec is None else rec.take()


@contextlib.contextmanager
def record_spans(cap: int = SPAN_CAP):
    """Records the spans of the block into the `SpanLog` it yields,
    which is filled when the block ends."""
    log = SpanLog()
    start_spans(cap)
    try:
        yield log
    finally:
        taken = take_spans()
        log.spans, log.dropped = taken.spans, taken.dropped


@contextlib.contextmanager
def trace(label: str, logger: logging.Logger | None = None):
    """A span of `label` that logs its wall time at DEBUG and is a
    `record_function` range on a profiler's timeline. The wall time is
    the host's: CUDA work queued inside it may still run after it ends."""
    log = logger or get_logger("trace")
    t0 = time.perf_counter()
    with span(label), torch.profiler.record_function(label):
        yield
    log.debug("%s: %.3f ms", label, (time.perf_counter() - t0) * 1e3)


_PROFILER: tuple[torch.profiler.profile, str] | None = None
_CLOCK = "sunscreen_tpu_torch.clock"   # the anchor of the spans' clock


def start_profiler(logdir: str) -> None:
    """Capture host and device activity, and the program's spans, until
    `stop_profiler()`, which writes them to `logdir/trace.json` (Chrome
    trace format)."""
    global _PROFILER
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    start_spans()
    prof.start()
    _PROFILER = (prof, logdir)
    get_logger().info("profiler capturing to %s", logdir)


def _chrome_spans(spans: SpanLog, anchor_us: float, anchor_ns: int,
                  pid) -> list[dict]:
    """The spans as Chrome trace events in a row of their own, placed by
    the anchor: `anchor_us` on the trace's timeline is `anchor_ns` on the
    spans' clock."""
    rows = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
             "args": {"name": "sunscreen_tpu_torch spans"}},
            {"ph": "M", "name": "thread_sort_index", "pid": pid, "tid": 0,
             "args": {"sort_index": -1}}]
    for s in spans:
        rows.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                     "tid": 0,
                     "ts": anchor_us + (s.start_ns - anchor_ns) / 1e3,
                     "dur": (s.end_ns - s.start_ns) / 1e3,
                     "args": {"parent": s.parent, "root": s.root}})
    return rows


def stop_profiler() -> SpanLog | None:
    """Stops the capture, writes its trace with the spans recorded since
    `start_profiler()` and returns those spans (None without a capture)."""
    global _PROFILER
    if _PROFILER is None:
        return None
    prof, logdir = _PROFILER
    _PROFILER = None
    t0 = time.perf_counter_ns()
    with torch.profiler.record_function(_CLOCK):
        pass
    t1 = time.perf_counter_ns()
    spans = take_spans()
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        chrome = json.load(f)
    events = chrome["traceEvents"]
    anchor = next((e for e in events if e.get("name") == _CLOCK), None)
    if anchor is not None:
        events.extend(_chrome_spans(spans, anchor["ts"], (t0 + t1) // 2,
                                    anchor["pid"]))
        with open(path, "w") as f:
            json.dump(chrome, f)
    return spans
