"""Device milliseconds under `bfv.permute` spans (the Galois gather and
`where`) over the cell's ops, in the span window."""

from portbench.metrics._spans import device_ms_under


def read(rec):
    return device_ms_under(rec, "bfv.permute", "work_per_batch")
