"""The H100's peaks that a roofline share is taken against.

BYTES_PER_S is published: NVIDIA's H100 SXM data sheet gives 3.35 TB/s of
HBM3 bandwidth. INT32_MULS_PER_S is assumed, not published: 132 SMs, 64
32-bit integer multiplies an SM a clock on compute capability 9.0 (half
the fp32 FMA rate), at the 1.98 GHz boost clock, which the data sheet's
67 TFLOP/s of fp32 (33.5 T FMA/s) implies. Both hold at the card's full
700 W power limit.
"""

BYTES_PER_S = 3.35e12
INT32_MULS_PER_S = 16.75e12


def least_seconds(nbytes: float, muls: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the bandwidth and the 32-bit multiplies over their rate."""
    return max(nbytes / BYTES_PER_S, muls / INT32_MULS_PER_S)
