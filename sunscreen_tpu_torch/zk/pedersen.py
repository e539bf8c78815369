"""Pedersen commitment + Bulletproof generator chains (port of
`sunscreen_tpu/zk/pedersen.py`): the "weights" of the ZKP stack, derived
from fixed labels, never loaded.

Mirrors dalek-bulletproofs' `PedersenGens` / `BulletproofGens` (consumed
by the reference through its `sunscreen_bulletproofs` fork and by
`logproof/src/generators.rs` `LogProofGenerators`): B = ristretto
basepoint, B_blinding = hash_from_bytes::<Sha3_512>(B.encode()), and
G/H vectors drawn from Shake256 "GeneratorsChain" XOFs.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

from sunscreen_tpu_torch.zk import curve25519 as c


def hash_to_point_sha3(data: bytes) -> c.Point:
    """dalek `RistrettoPoint::hash_from_bytes::<Sha3_512>`."""
    return c.from_uniform_bytes(hashlib.sha3_512(data).digest())


class PedersenGens:
    def __init__(self):
        self.B = c.BASEPOINT
        self.B_blinding = hash_to_point_sha3(c.BASEPOINT.encode())

    def commit(self, value: int, blinding: int) -> c.Point:
        return self.B * value + self.B_blinding * blinding


class BulletproofGens:
    """G/H generator vectors (party 0 only — the reference never
    aggregates across parties)."""

    def __init__(self, gens_capacity: int):
        self.gens_capacity = gens_capacity
        self.G = _chain_points(b"G" + (0).to_bytes(4, "little"),
                               gens_capacity)
        self.H = _chain_points(b"H" + (0).to_bytes(4, "little"),
                               gens_capacity)


def _chain_points(label: bytes, count: int) -> list[c.Point]:
    """First `count` points of a Shake256 "GeneratorsChain" XOF (dalek
    `GeneratorsChain`), batched through the native elligator."""
    shake = hashlib.shake_256()
    shake.update(b"GeneratorsChain")
    shake.update(label)
    return c.from_uniform_bytes_batch(shake.digest(64 * count))


@lru_cache(maxsize=8)
def cached_bp_gens(capacity: int) -> BulletproofGens:
    return BulletproofGens(capacity)


@lru_cache(maxsize=1)
def cached_pedersen() -> PedersenGens:
    return PedersenGens()
