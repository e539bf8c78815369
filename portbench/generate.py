"""The generator of every cell's inputs: draws from the run's --seed.

The same seed gives the same inputs; each stream of draws is named, so a
cell that adds a draw leaves the others unchanged. Device draws use a
`torch.Generator` on the card and come in a few large calls.
"""

from __future__ import annotations

import hashlib
import random


def _stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for the named stream of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def device_generator(seed: int, stream: str, device):
    """A `torch.Generator` on `device` for the named stream."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(_stream_seed(seed, stream))
    return gen


def host_rng(seed: int, stream: str) -> random.Random:
    return random.Random(_stream_seed(seed, stream))


def integers(gen, low: int, high: int, shape):
    """Uniform int64 in [low, high] (inclusive) of `shape`, on the
    generator's device."""
    import torch
    return torch.randint(int(low), int(high) + 1, tuple(shape),
                         generator=gen, device=gen.device,
                         dtype=torch.int64)
