"""Device milliseconds a blind-rotation step of a whole batch."""

from portbench.metrics._read import device_ms_per


def read(rec):
    return device_ms_per(rec, "steps_per_batch")
