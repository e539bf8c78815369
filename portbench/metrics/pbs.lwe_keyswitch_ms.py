"""Device milliseconds under `tfhe.keyswitch` spans (the exact float64
limb matmuls and their glue) a batch, in the span window."""

from portbench.metrics._spans import device_ms_under


def read(rec):
    return device_ms_under(rec, "tfhe.keyswitch", None)
