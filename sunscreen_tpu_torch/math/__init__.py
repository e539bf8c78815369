"""Exact modular, RNS and NTT math on int64 torch tensors, plus the
CUDA NTT kernels (`pmntt`)."""
