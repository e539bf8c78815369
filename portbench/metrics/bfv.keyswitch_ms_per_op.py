"""Device milliseconds under `bfv.keyswitch` spans (B2, B5, B8 and their
glue) over the cell's ops, in the span window."""

from portbench.metrics._spans import device_ms_under


def read(rec):
    return device_ms_under(rec, "bfv.keyswitch", "work_per_batch")
