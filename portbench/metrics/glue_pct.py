"""Share of device time in operations outside the port's CUDA kernels
(the plain PyTorch glue, copies, fills): the reader of every
`glue_pct.<cells>`."""


def read(rec):
    if not rec["busy_s"]:
        return None
    return 100.0 * (rec["busy_s"] - rec["port_s"]) / rec["busy_s"]
