"""Device milliseconds under `tfhe.br.accumulate` spans (the step's
output to the torus and the wrapping add) a blind-rotation step of a
whole batch, in the span window."""

from portbench.metrics._spans import device_ms_under


def read(rec):
    return device_ms_under(rec, "tfhe.br.accumulate", "steps_per_batch")
