"""Share of the traced window in which the card ran nothing: the reader
of every `idle_pct.<cells>`."""


def read(rec):
    if not rec["window_s"]:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
