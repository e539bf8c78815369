"""Typed FHE runtime (port of `sunscreen_tpu.runtime`, without its ZKP
runtimes)."""

from sunscreen_tpu_torch.runtime.runtime import (  # noqa: F401
    Ciphertext, FheRuntime, PrivateKey, PublicKeySet, Runtime, TooMuchNoise)
