"""The arithmetic of the readers of the span window (portbench/spans.py):
its record's "span_*" keys, absent from a run without one."""

from __future__ import annotations

import statistics


def device_ms_under(rec, span: str, unit: str | None):
    """Device milliseconds under the span `span` (itself and every span
    inside it) over the window's batches, times their count of `unit`
    where one is given."""
    inclusive = rec.get("span_inclusive")
    if not inclusive or span not in inclusive:
        return None
    per = rec[unit] if unit else 1
    if not per:
        return None
    return 1e3 * inclusive[span] / (rec["span_batches"] * per)


def mean_ms(rec, key: str, root: str):
    """The mean, in milliseconds, of the window's per-root seconds `key`
    ("host", "head_wait") of the roots named `root`."""
    values = (rec.get(key) or {}).get(root)
    return 1e3 * statistics.fmean(values) if values else None
