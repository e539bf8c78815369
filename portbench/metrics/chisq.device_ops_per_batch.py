"""Device operations (kernels, copies, fills) a batch of the program."""


def read(rec):
    return rec["device_ops"] / rec["batches"] if rec["batches"] else None
