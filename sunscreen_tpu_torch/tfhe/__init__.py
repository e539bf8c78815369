"""TFHE over the 2^64 torus (port of `sunscreen_tpu.tfhe`): parameters,
torus arithmetic, exact CRT-NTT polynomial products, keygen, encryption,
blind rotation and the univariate programmable bootstrap."""

from sunscreen_tpu_torch.tfhe.params import (  # noqa: F401
    GLWE_1_512_128, GLWE_1_1024_80, GLWE_1_1024_128, GLWE_1_2048_128,
    GLWE_5_256_80, GLWE_5_256_128, GlweDef, LWE_512_80, LWE_512_128,
    LweDef, RadixDecomposition, TEST_GLWE_DEF_1, TEST_GLWE_DEF_2,
    TEST_LWE_DEF_1, TEST_RADIX, TEST_RADIX_FINE)
