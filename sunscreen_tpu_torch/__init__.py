"""sunscreen_tpu_torch — the PyTorch / CUDA port of `sunscreen_tpu`.

Same data layouts and the same bits as the JAX package, on an NVIDIA
Hopper card. Residues are `torch.int64` tensors: values below 2^32 on the
u32 engine, u64 bit patterns on the u64 engine; the kernels are
hand-written CUDA C++ under `csrc/`, and each has a plain PyTorch twin
that runs when the tensor lies on the CPU.

Every entry point takes an explicit `device`. It runs on CUDA unless the
caller passes `device="cpu"`, and raises when no card is present rather
than falling back to the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA. A CUDA device without a visible card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sunscreen_tpu_torch: CUDA requested but no GPU is visible; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
