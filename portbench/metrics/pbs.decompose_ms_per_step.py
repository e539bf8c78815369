"""Device milliseconds under `tfhe.br.decompose` spans (the monomial
rotation, the gadget digits, their residues) a blind-rotation step of a
whole batch, in the span window."""

from portbench.metrics._spans import device_ms_under


def read(rec):
    return device_ms_under(rec, "tfhe.br.decompose", "steps_per_batch")
