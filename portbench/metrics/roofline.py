"""The least time of the cell's batches (the larger of their bytes over
the card's bandwidth and their 32-bit multiplies over its rate, by
portbench/counts/<op>.py) over the device time they took: the reader of
a `<op>_roofline` with no file of its own."""


def read(rec):
    if not rec["busy_s"]:
        return None
    return 100.0 * rec["least_s"] * rec["batches"] / rec["busy_s"]
