"""Logging, tracing and metrics (port of `sunscreen_tpu/observability.py`).

- module loggers under the `sunscreen_tpu_torch` namespace: enable with
  `enable_logging("DEBUG")`, the standard `logging` machinery, or the
  reference's SUNSCREEN_TPU_LOG=DEBUG at import;
- `trace(label)`: wall-clocks a region, logs it, records it in `metrics`
  and opens a `torch.profiler.record_function` of that label, which a
  running profiler shows on its timeline;
- `start_profiler(logdir)` / `stop_profiler()`: a `torch.profiler`
  capture of host and device activity, exported as a Chrome trace;
- `metrics`: the process-wide counters and gauges the runtime feeds
  (`runtime.programs_run`, `runtime.run.<name>`,
  `runtime.noise_budget_floor_bits`), the reference's names.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict

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


@contextlib.contextmanager
def trace(label: str, logger: logging.Logger | None = None):
    """Wall-clock a region; logs at DEBUG and records a metrics gauge.
    The region is a `record_function` range on a profiler's timeline.
    The wall time is the host's: CUDA work queued inside it may still
    run after it ends."""
    log = logger or get_logger("trace")
    t0 = time.perf_counter()
    with torch.profiler.record_function(label):
        yield
    dt = time.perf_counter() - t0
    metrics.incr(f"trace.{label}.count")
    metrics.gauge(f"trace.{label}.last_s", dt)
    log.debug("%s: %.3f ms", label, dt * 1e3)


_PROFILER: tuple[torch.profiler.profile, str] | None = None


def start_profiler(logdir: str) -> None:
    """Capture host and device activity until `stop_profiler()`, which
    writes it to `logdir/trace.json` (Chrome trace format)."""
    global _PROFILER
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _PROFILER = (prof, logdir)
    get_logger().info("profiler capturing to %s", logdir)


def stop_profiler() -> None:
    global _PROFILER
    if _PROFILER is not None:
        prof, logdir = _PROFILER
        _PROFILER = None
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
