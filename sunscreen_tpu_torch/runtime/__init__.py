"""Typed FHE and ZKP runtimes (port of `sunscreen_tpu.runtime`)."""

from sunscreen_tpu_torch.runtime.runtime import (  # noqa: F401
    Ciphertext, FheRuntime, FheZkpRuntime, PrivateKey, PublicKeySet,
    Runtime, TooMuchNoise, ZkpRuntime)
