"""Host milliseconds inside `FheRuntime.run` for one batch, before the
client's synchronize, in the untraced window."""

import statistics


def read(rec):
    if not rec["enqueue_s"]:
        return None
    return 1e3 * statistics.fmean(rec["enqueue_s"])
