"""LWE/RLWE security estimation: the port's own copy of
`sunscreen_tpu/math/security.py` (pure Python, same tables and results),
so that `tfhe/params.py` can validate its presets without the JAX
package.

The reference module replaces `sunscreen_math/src/security.rs:65-244`:
a 2-D polynomial fit of lattice-estimator simulation data (commit
25f9e88, binary secrets, std normalized to modulus 2^64) with explicit
convex-polytope validity regions that ERROR rather than extrapolate,
plus the Gaussian tail-probability helper used by TFHE parameter
validation. The fit coefficient tables are empirical constants of the
public lattice-estimator data (category: necessarily-matching data, like
RFC vectors); the surrounding code is original.

Separately, `rlwe_security_level_to_std`/`rlwe_std_to_security_level`
cover the BFV parameter regime (power-of-two ring dimension 1024..32768,
ternary secrets) via the homomorphicencryption.org HE-Standard tables —
the regime the lattice-estimator fit's polytope excludes.
"""

from __future__ import annotations

import math

# ---------------------------------------------------------------------------
# validity polytopes (reference: geometry.rs ConvexPolytope2D)
# ---------------------------------------------------------------------------


class OutsideConstraintsError(ValueError):
    """Input outside the fitted validity region (reference:
    `OutsideConstraintsError` — the estimator refuses to extrapolate)."""

    def __init__(self, dimensions, value, half_spaces):
        self.dimensions = dimensions
        self.value = value
        self.half_spaces = half_spaces
        super().__init__(
            f"value {value} for {dimensions} is outside the fitted "
            f"validity region {half_spaces}")


def _inside(half_spaces, x, y) -> bool:
    """Each half space ((a, b), c) encodes a*x + b*y <= c."""
    return all(a * x + b * y <= c + 1e-9 for (a, b), c in half_spaces)


def _eval_poly_2d(coeffs, x: float, y: float) -> float:
    out = 0.0
    for i, row in enumerate(coeffs):
        for j, c in enumerate(row):
            if c:
                out += c * x**i * y**j
    return out


# ---------------------------------------------------------------------------
# lattice-estimator fit: binary-secret LWE, modulus 2^64, dims 368..2048
# ---------------------------------------------------------------------------

_LEVEL_TO_STD_POLYTOPE = (
    ((-1.0, 0.0), -368.0),
    ((1.0, 0.0), 2048.0),
    ((0.0, -1.0), -78.0),
    ((0.0, 1.0), 130.0),
    # above ~1472 dims the minimum-noise security exceeds 78 bits
    ((0.05678074392712544, -1.0), 3.5151045883938177),
)

_LEVEL_TO_STD_COEFFS = (
    (2.89630547e+00, -1.26321873e-01, 2.13993467e-03, -1.49515549e-05,
     3.84468453e-08),
    (-5.60568533e-02, 1.33311189e-03, -1.56200244e-05, 8.93067686e-08,
     -2.00996854e-10),
    (7.39088707e-07, -9.61269520e-08, 2.15766569e-09, -1.82462028e-11,
     5.45243818e-14),
    (1.49456164e-09, -4.28264022e-11, 4.30538855e-13, -1.50621118e-15,
     0.0),
    (9.49334890e-14, -2.17539853e-15, 1.22195316e-17, 0.0, 0.0),
)

_STD_TO_LEVEL_POLYTOPE = (
    ((-1.0, 0.0), -386.0),
    ((1.0, 0.0), 2048.0),
    ((-0.012501482876757172, -1.0), -0.5040411014606384),
    ((0.0077927720025765665, 1.0), 0.7390928205510939),
    ((0.0, -1.0), 17.67),
)

_STD_TO_LEVEL_COEFFS = (
    (6.90381015e+01, 5.02853460e+01, 1.94568148e+01, 4.20275108e+00,
     5.70115313e-01, 3.84445029e-02, 1.01123781e-03),
    (5.74446364e-01, 2.16090358e-01, 4.33027422e-02, 5.96469779e-03,
     3.47705471e-05, -3.75600129e-05, -1.73396859e-06),
    (1.38947894e-04, -1.97798175e-06, 6.18022031e-06, -8.44553282e-06,
     -9.87061302e-07, -1.98799589e-08, 7.73239565e-10),
    (-1.76700147e-07, 4.46397961e-08, -8.48859329e-08, -6.50906497e-09,
     2.29684491e-10, 2.23006735e-11, 0.0),
    (2.73798876e-10, -4.27647020e-10, -1.56129840e-12, 5.18444880e-12,
     2.50320308e-13, 0.0, 0.0),
    (-9.58735744e-13, 1.71390444e-13, 3.36603110e-14, 1.30767385e-15,
     0.0, 0.0, 0.0),
    (5.98968287e-16, 7.74296283e-17, 2.66615159e-18, 0.0, 0.0, 0.0, 0.0),
)


def lwe_security_level_to_std(dimension: int,
                              security_level: float) -> float:
    """Minimum noise std (normalized to modulus 2^64) reaching
    `security_level` bits for binary-secret LWE of `dimension`.

    Valid for dimension in [368, 2048], level in [78, 130]; raises
    `OutsideConstraintsError` elsewhere (no silent extrapolation).
    Reference: `lwe_security_level_to_std`, security.rs:165.
    """
    if not _inside(_LEVEL_TO_STD_POLYTOPE, dimension, security_level):
        raise OutsideConstraintsError(
            ("dimension", "security_level"), (dimension, security_level),
            _LEVEL_TO_STD_POLYTOPE)
    log_std = _eval_poly_2d(_LEVEL_TO_STD_COEFFS, float(dimension),
                            float(security_level))
    return 10.0 ** log_std


def lwe_std_to_security_level(dimension: int, std: float) -> float:
    """Security level for binary-secret LWE with noise `std` (normalized
    to modulus 2^64). Polytope-checked; raises outside the fit region.
    Reference: `lwe_std_to_security_level`, security.rs:230."""
    if std <= 0:
        raise OutsideConstraintsError(("dimension", "log_std"),
                                      (dimension, std),
                                      _STD_TO_LEVEL_POLYTOPE)
    log_std = math.log10(std)
    if not _inside(_STD_TO_LEVEL_POLYTOPE, dimension, log_std):
        raise OutsideConstraintsError(("dimension", "log_std"),
                                      (dimension, log_std),
                                      _STD_TO_LEVEL_POLYTOPE)
    return _eval_poly_2d(_STD_TO_LEVEL_COEFFS, float(dimension), log_std)


# ---------------------------------------------------------------------------
# Gaussian tail probability (reference: security.rs:84-150)
# ---------------------------------------------------------------------------

_TAIL_HIGH_COEFFS = (-0.31904236601958913, -0.13390834324063405,
                     -0.20902566462352498, -0.0003178660849038345,
                     6.75504783552659e-06, -5.91907446763691e-08)


def probability_away_from_mean_gaussian(x: float, std: float) -> float:
    """log10 P(|X| > x) for X ~ N(0, std^2). Exact (erfc) below ratio 7,
    quintic approximation (max 0.00145% error) up to ratio 30."""
    ratio = x / std
    if ratio < 7.0:
        both_tails = math.erfc(ratio / math.sqrt(2.0))
        return math.log10(both_tails)
    out = 0.0
    for i, c in enumerate(_TAIL_HIGH_COEFFS):
        out += c * ratio**i
    return out


# ---------------------------------------------------------------------------
# RLWE / BFV regime: HE-Standard tables (ternary secrets, N=1024..32768)
# ---------------------------------------------------------------------------

# log2(q_max)/n at sigma=3.19, from the HE-Standard tables
_SLOPE = {128: 218 / 8192, 192: 152 / 8192, 256: 118 / 8192}
_SIGMA_REF = 3.19
_Q_REF_OFFSET = math.log2(_SIGMA_REF)

_RLWE_DIMS = (1024, 2048, 4096, 8192, 16384, 32768)


def rlwe_security_level_to_std(dimension: int, modulus: float,
                               security_level: float = 128.0) -> float:
    """Minimum absolute noise std for a power-of-two RLWE ring to reach
    `security_level` bits (ternary secret, HE-Standard tables). Errors
    outside the tabulated regime rather than extrapolating."""
    _check_rlwe_domain(dimension, security_level)
    slope = _interp_slope(security_level)
    max_log_ratio = slope * dimension + _Q_REF_OFFSET
    return modulus / 2.0 ** max_log_ratio


def rlwe_std_to_security_level(dimension: int, modulus: float,
                               std: float) -> float:
    """Approximate security level for the given RLWE noise level."""
    if std <= 0:
        raise OutsideConstraintsError(("dimension", "std"),
                                      (dimension, std), ())
    _check_rlwe_domain(dimension, None)
    log_ratio = math.log2(modulus / std) - _Q_REF_OFFSET
    lo, hi = 32.0, 1024.0
    for _ in range(60):
        mid = (lo + hi) / 2
        if _interp_slope(mid) * dimension >= log_ratio:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def _check_rlwe_domain(dimension: int, level):
    if dimension not in _RLWE_DIMS:
        raise OutsideConstraintsError(
            ("dimension", "security_level"), (dimension, level),
            (("dimension in", _RLWE_DIMS),))
    if level is not None and not 128 <= level <= 256:
        raise OutsideConstraintsError(
            ("dimension", "security_level"), (dimension, level),
            (("level in", (128, 256)),))


def _interp_slope(security_level: float) -> float:
    """Slope of max log2(q/sigma) per dimension at a security level —
    log-linear interpolation between HE-Standard anchors; beyond the
    anchors uses the conservative c/lambda decay (only reachable from
    `rlwe_std_to_security_level`'s bisection, never silently from the
    std query, whose domain is checked)."""
    pts = sorted(_SLOPE.items())
    if security_level <= pts[0][0]:
        return pts[0][1] * pts[0][0] / max(security_level, 1.0)
    if security_level >= pts[-1][0]:
        return pts[-1][1] * pts[-1][0] / security_level
    for (l0, s0), (l1, s1) in zip(pts, pts[1:]):
        if l0 <= security_level <= l1:
            f = (security_level - l0) / (l1 - l0)
            return s0 + f * (s1 - s0)
    raise AssertionError


def probe_security(poly_degree: int, total_modulus_bits: int,
                   security_level: int) -> bool:
    """True if an RLWE instance with the given ring degree and total
    modulus bits meets the level (used by BfvParams validation)."""
    from sunscreen_tpu_torch.bfv.params import MAX_LOG_Q
    limit = MAX_LOG_Q.get(security_level, {}).get(poly_degree)
    return limit is not None and total_modulus_bits <= limit
