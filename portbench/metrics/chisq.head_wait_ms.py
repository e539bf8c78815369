"""Milliseconds the card waits, idle, between a `runtime.run` span's
start and its batch's first device operation (none where the card is
still busy with the batch before): the runtime's and the lowering's
head, in the span window."""

from portbench.metrics._spans import mean_ms


def read(rec):
    return mean_ms(rec, "span_head_wait", "runtime.run")
