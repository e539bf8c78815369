"""The traced window of a `--trace 1` run: `torch.profiler` over a few
batches, read into the device's busy time, its time by operation, the
count of device operations, and the idle gaps by the operation the host
was enqueuing.

On the card the profiler records device activity only, so that it adds
nothing to the host's own path (recording every host operation too more
than doubled the time of a host-paced PBS batch). The window is bounded on the
device's clock by two marker spins (`torch.cuda._sleep`) queued on an
idle stream, one before the first batch's call and one after the
synchronize that follows the last; the device operations between them
are the window's own. A fresh trace can lose the events of its first
milliseconds, so each attempt waits, and runs one traced batch, before
the window opens. The window must hold one kernel event for each launch
of the port's kernels that the program's counter (`_build.LAUNCHES`)
counted in it; a window that does not is taken again, with a longer wait,
up to RETRIES times. An idle gap is named after the device operation
that ends it: the host was enqueuing that operation.

On the CPU (a rehearsal) the host's `aten::` operations inside a
`record_function` window stand in for the device's.
"""

from __future__ import annotations

import glob
import os
import re
import time

WINDOW = "portbench.window"
MARK = "spin_kernel"          # the kernel of torch.cuda._sleep
MARK_CYCLES = 200_000         # about 0.1 ms at the H100's clock
RETRIES = 3
SETTLE_S = 0.3
SHORT_GAP_US = 5.0            # gaps below this are launches back to back
TOP = 10


def port_kernels() -> frozenset[str]:
    """The function names of the port's CUDA kernels: every `*_kernel`
    named in its csrc/ sources."""
    from sunscreen_tpu_torch import _build
    names = set()
    for path in glob.glob(os.path.join(_build.CSRC, "*.cu*")):
        with open(path) as f:
            names.update(re.findall(r"\b(\w+_kernel)\b", f.read()))
    return frozenset(names)


def short_name(name: str) -> str:
    """A device operation's name without "void ", anonymous namespaces
    or its argument list."""
    name = name.strip().replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    i = name.find("(")
    return (name[:i] if i > 0 else name)[:160]


def kernel_function(name: str) -> str:
    """"void ns::f<13, false>(long long const*, ...)" -> "f"."""
    name = short_name(name)
    i = name.find("<")
    return (name[:i] if i > 0 else name).rsplit("::", 1)[-1]


def read(spans, lo: float, hi: float, kernels: frozenset) -> dict:
    """The window [lo, hi] (microseconds) from its device operations
    `spans`, (start, end, name) each."""
    spans = sorted(spans)
    by_name: dict[str, float] = {}
    gaps: dict[str, float] = {}
    busy = port = 0.0
    port_events = 0
    reach = lo                     # the end of the busy time so far
    for s, e, name in spans:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (e - s)
        if kernel_function(name) in kernels:
            port += e - s
            port_events += 1
        if s > reach:
            label = ("launches back to back" if s - reach < SHORT_GAP_US
                     else "enqueue of " + key)
            gaps[label] = gaps.get(label, 0.0) + (s - reach)
        busy += max(0.0, e - max(s, reach))
        reach = max(reach, e)
    if hi > reach:
        gaps["synchronize"] = gaps.get("synchronize", 0.0) + (hi - reach)
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy * 1e-6,
            "port_s": port * 1e-6, "port_events": port_events,
            "device_ops": len(spans),
            "by_name": {k: v * 1e-6 for k, v in by_name.items()},
            "gaps": {k: v * 1e-6 for k, v in gaps.items()}}


def _window(events, on_device: bool):
    """(lo, hi, spans) of the window in a profiler's events, or None."""
    from torch.autograd import DeviceType

    def span(e):
        return (e.time_range.start, e.time_range.end, e.name)

    if on_device:
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        marks = sorted(span(e) for e in dev if MARK in e.name)
        if len(marks) != 2:
            return None
        lo, hi = marks[0][1], marks[1][0]
        return lo, hi, [span(e) for e in dev if MARK not in e.name
                        and lo <= e.time_range.start
                        and e.time_range.end <= hi]
    win = [e for e in events if e.name == WINDOW]
    if len(win) != 1:
        return None
    lo, hi = win[0].time_range.start, win[0].time_range.end
    return lo, hi, [span(e) for e in events if e.name.startswith("aten::")
                    and lo <= e.time_range.start and e.time_range.end <= hi]


def profile(batch, first: int, batches: int, device) -> dict:
    """Runs `batch(first)`, `batch(first + 1)`, ... under the profiler:
    one traced batch ahead of the window, then `batches` in it. Returns
    `read`'s numbers with "batches", "attempts" and "launches"."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile
    from sunscreen_tpu_torch import _build

    on_device = torch.device(device).type == "cuda"
    activity = ProfilerActivity.CUDA if on_device else ProfilerActivity.CPU

    def synchronize():
        if on_device:
            torch.cuda.synchronize()

    kernels = port_kernels()
    i = first
    for attempt in range(RETRIES + 1):
        with torch_profile(activities=[activity]) as prof:
            time.sleep(SETTLE_S * 2 ** attempt)
            batch(i)
            i += 1
            synchronize()
            before = dict(_build.LAUNCHES)
            with (contextlib.nullcontext() if on_device
                  else record_function(WINDOW)):
                if on_device:
                    torch.cuda._sleep(MARK_CYCLES)
                for _ in range(batches):
                    batch(i)
                    i += 1
                synchronize()
                if on_device:
                    torch.cuda._sleep(MARK_CYCLES)
                    synchronize()
            launched = sum(_build.LAUNCHES[k] - before[k] for k in before)
            launched += 2 * (_build.LAUNCHES["msm"] - before["msm"])
            time.sleep(0.1)
        window = _window(prof.events(), on_device)
        if window is not None:
            got = read(window[2], window[0], window[1], kernels)
            if got["port_events"] == launched:
                got.update(batches=batches, attempts=attempt + 1,
                           launches=launched)
                return got
    raise RuntimeError(f"no traced window of {RETRIES + 1} held its marks "
                       f"and one kernel event a launch of the port's "
                       f"kernels")
