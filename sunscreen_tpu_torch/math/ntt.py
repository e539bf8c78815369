"""NTT plan selection (port of `sunscreen_tpu/math/ntt.py::get_plan`).

Only the u32 plan (`pmntt.NttPlanU32`, the port of the reference's mode
"pallas") is ported: 17-30-bit moduli and 256 <= N <= 16384. Other
envelopes raise; the u64 and unrolled plans are not ported yet.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from sunscreen_tpu_torch import resolve_device
from sunscreen_tpu_torch.errors import Unsupported
from sunscreen_tpu_torch.math.pmntt import NttPlanU32


@lru_cache(maxsize=64)
def _plan_cached(n: int, moduli: tuple[int, ...], device: torch.device):
    return NttPlanU32(n, moduli, device)


def get_plan(n: int, moduli: tuple[int, ...],
             device=None) -> NttPlanU32:
    """Shared plan cache; `device` None means CUDA."""
    bits = [int(q).bit_length() for q in moduli]
    if not (n & (n - 1) == 0 and 256 <= n <= 16384
            and max(bits) <= 30 and min(bits) >= 17):
        raise Unsupported(
            f"only the u32 NTT plan is ported: needs 17-30-bit moduli and "
            f"256 <= N <= 16384 (got N={n}, bits {min(bits)}-{max(bits)})")
    return _plan_cached(n, tuple(int(q) for q in moduli),
                        resolve_device(device))
