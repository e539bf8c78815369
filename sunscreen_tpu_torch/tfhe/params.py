"""TFHE parameter definitions (port of `sunscreen_tpu/tfhe/params.py`):
`LweDef`, `GlweDef`, `RadixDecomposition` and the reference's presets,
each validated against the port's copy of the security estimator at
import. The torus modulus is 2^64.
"""

from __future__ import annotations

from dataclasses import dataclass

TORUS_BITS = 64


@dataclass(frozen=True)
class LweDef:
    """dim: length of the LWE mask a; std: noise standard deviation as a
    fraction of the torus."""

    dim: int
    std: float

    def assert_valid(self):
        assert self.dim > 0
        assert 0 <= self.std < 0.5

    def security_level(self) -> float:
        """Bits of security of this binary-secret LWE instance by the
        lattice-estimator fit (`math.security`); raises outside the fit."""
        from sunscreen_tpu_torch.math.security import \
            lwe_std_to_security_level
        return lwe_std_to_security_level(self.dim, self.std)

    def assert_security_level(self, level: float, tolerance: float = 0.5):
        got = self.security_level()
        if abs(got - level) > tolerance:
            raise AssertionError(
                f"security level mismatch: expected {level}, got {got}")


@dataclass(frozen=True)
class GlweDef:
    """size: number of mask polynomials k; poly_degree: N (power of 2)."""

    size: int
    poly_degree: int
    std: float

    def assert_valid(self):
        assert self.size > 0
        n = self.poly_degree
        assert n > 0 and n & (n - 1) == 0
        assert 0 <= self.std < 0.5

    @property
    def as_lwe(self) -> LweDef:
        """The LWE instance produced by sample extraction."""
        return LweDef(self.size * self.poly_degree, self.std)

    def security_level(self) -> float:
        return self.as_lwe.security_level()

    def assert_security_level(self, level: float, tolerance: float = 0.5):
        self.as_lwe.assert_security_level(level, tolerance)


@dataclass(frozen=True)
class RadixDecomposition:
    """count: number of digits l; radix_log: bits per digit (base 2^b)."""

    count: int
    radix_log: int

    def assert_valid(self):
        assert self.count > 0 and self.radix_log > 0
        assert self.count * self.radix_log <= TORUS_BITS


# Test parameters (tiny sigma for deterministic tests).
TEST_LWE_DEF_1 = LweDef(dim=512, std=1e-16)
TEST_GLWE_DEF_1 = GlweDef(size=1, poly_degree=256, std=1e-16)
TEST_GLWE_DEF_2 = GlweDef(size=2, poly_degree=256, std=1e-16)
TEST_RADIX = RadixDecomposition(count=3, radix_log=4)
TEST_RADIX_FINE = RadixDecomposition(count=8, radix_log=4)

# The reference's published presets (sunscreen_tfhe params.rs:220-285).
LWE_512_128 = LweDef(dim=512, std=0.0004899836456140595)
GLWE_1_512_128 = GlweDef(size=1, poly_degree=512,
                         std=0.0004899836456140595)
GLWE_5_256_128 = GlweDef(size=5, poly_degree=256, std=5e-10)
GLWE_1_1024_128 = GlweDef(size=1, poly_degree=1024,
                          std=0.0000000444778278004718)
GLWE_1_2048_128 = GlweDef(size=1, poly_degree=2048,
                          std=0.00000000000000034667670193445625)
LWE_512_80 = LweDef(dim=512, std=0.000001842343446823844)
GLWE_5_256_80 = GlweDef(size=5, poly_degree=256,
                        std=0.0000000000000007794169597948335)
GLWE_1_1024_80 = GlweDef(size=1, poly_degree=1024,
                         std=0.0000000000010900242107812643)

LWE_128 = LWE_512_128
GLWE_128 = GLWE_1_2048_128
RADIX_128 = RadixDecomposition(count=2, radix_log=23)

# Every preset must sit at its named level by the estimator: an edited
# preset fails at import.
for _p, _lvl in ((LWE_512_128, 128), (GLWE_1_512_128, 128),
                 (GLWE_5_256_128, 129), (GLWE_1_1024_128, 128),
                 (GLWE_1_2048_128, 128), (LWE_512_80, 80),
                 (GLWE_5_256_80, 80), (GLWE_1_1024_80, 80)):
    _p.assert_valid()
    _p.assert_security_level(_lvl)
del _p, _lvl
