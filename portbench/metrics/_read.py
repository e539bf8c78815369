"""The arithmetic the metric readers share."""

from __future__ import annotations


def device_ms_per(rec, unit: str):
    """Device milliseconds over the traced batches' count of `unit`."""
    per = rec[unit]
    if not per or not rec["busy_s"]:
        return None
    return 1e3 * rec["busy_s"] / (rec["batches"] * per)
