"""Host milliseconds of a `runtime.run` span in the span window, less
the time inside CUDA API calls: the runtime's, the lowering's and the
BFV ops' own Python (the window queues batches back to back, so once
the launch queue fills a launch or an event record waits for the card;
that wait is the card's pace, not the runtime's)."""

from portbench.metrics._spans import mean_ms


def read(rec):
    return mean_ms(rec, "span_host", "runtime.run")
