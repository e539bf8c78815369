"""Device milliseconds an op of the cell's rate (a multiply_relin, a
rotation) in the traced window."""

from portbench.metrics._read import device_ms_per


def read(rec):
    return device_ms_per(rec, "work_per_batch")
