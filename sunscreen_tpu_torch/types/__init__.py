"""FHE DSL types and the ZKP DSL (port of `sunscreen_tpu.types`)."""

from sunscreen_tpu_torch.types.bfv_types import (  # noqa: F401
    Array, Batched, BfvType, Cipher, Fractional, Rational, Signed,
    Unsigned, Unsigned64, Unsigned128)
