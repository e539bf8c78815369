"""TFHE over the 2^64 torus (port of `sunscreen_tpu.tfhe`): parameters,
torus arithmetic, exact CRT-NTT polynomial products, keygen, secret and
public-key encryption, GLEV/GGSW, blind rotation, the univariate,
multifunctional, bivariate and generalized programmable bootstraps,
circuit bootstrapping, the scheme switch, and the LWE, GLWE, private and
public functional keyswitches (`ops`, `high_level`), with `keys` to
carry the reference's keys over. The reference's `tfhe/zkp.py` is not
ported yet."""

from sunscreen_tpu_torch.tfhe.params import (  # noqa: F401
    GLWE_1_512_128, GLWE_1_1024_80, GLWE_1_1024_128, GLWE_1_2048_128,
    GLWE_5_256_80, GLWE_5_256_128, GlweDef, LWE_512_80, LWE_512_128,
    LweDef, RadixDecomposition, TEST_GLWE_DEF_1, TEST_GLWE_DEF_2,
    TEST_LWE_DEF_1, TEST_RADIX, TEST_RADIX_FINE)
