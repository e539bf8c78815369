"""The per-layer metrics' readers. A metric is read by the file named by
the metric, or where there is none by its family's: `glue_pct.bfv` by
`glue_pct.py` (the name up to its first dot), `bfv_op_roofline` by
`roofline.py`. `read(rec)` returns the metric's value from the traced
run's record, or None where the record holds nothing to read. The record
(harness.per_layer) holds the traced window's "busy_s", "window_s",
"port_s" (device seconds in the port's own CUDA kernels), "device_ops",
"by_name", "batches", the cell's "work_per_batch" and "steps_per_batch",
"least_s" (the least time of one batch, portbench/counts/) and
"enqueue_s" (host seconds in each call of the untraced window)."""
