"""curve25519 / ristretto255 group: the host oracle, the scalar field
mod L, and the dispatch of the multi-scalar multiplication (port of
`sunscreen_tpu/zk/curve25519.py`).

The group stays Python ints, as in the reference: it defines the
semantics, and every accelerated path (the host C++ of `zk/native.py`, the
CUDA Pippenger of `zk/cuda_curve.py`) is held against it. Ristretto255 per
RFC 9496 (encode/decode, equality, add/sub/neg, scalar mul) over the
twisted Edwards curve edwards25519.

One departure from the reference. `msm(scalars, points, device)` runs on
the card when `device` is a CUDA device and there are at least
`DEVICE_MSM_MIN` = 2048 points (the reference's threshold), unless
`SUNSCREEN_TPU_MSM=0`, which sends it back to the host C++. The reference's
device MSM is opt-in (`SUNSCREEN_TPU_MSM=1`) on a TPU; the port's entry
points run on the card unless the caller asks for the CPU. With no device,
or a CPU device, the dispatch is the reference's host one: the native C++
Pippenger from 8 points, pure python below.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from sunscreen_tpu_torch.zk import native

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493  # group order
D = (-121665 * pow(121666, -1, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1)
INVSQRT_A_MINUS_D = None  # filled below
SQRT_AD_MINUS_ONE = None


def _sqrt_ratio_m1(u: int, v: int) -> tuple[bool, int]:
    """(was_square, sqrt(u/v) or sqrt(i*u/v)) per RFC 9496 §4.2."""
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    correct_sign = check == u % P
    flipped_sign = check == (-u) % P
    flipped_sign_i = check == (-u) % P * SQRT_M1 % P
    if flipped_sign or flipped_sign_i:
        r = r * SQRT_M1 % P
    # non-negative root convention: "negative" means odd LSB (RFC 9496)
    if r & 1:
        r = P - r
    return (correct_sign or flipped_sign), r


# constants depending on sqrt helper
_, INVSQRT_A_MINUS_D = _sqrt_ratio_m1(1, (-1 - D) % P)
_, SQRT_AD_MINUS_ONE = _sqrt_ratio_m1((-1 * D - 1) % P, 1)


@dataclass(frozen=True)
class Point:
    """Edwards point in extended coordinates (X:Y:Z:T), y = Y/Z etc."""

    x: int
    y: int
    z: int
    t: int

    # -- group ops (complete formulas for a=-1 twisted Edwards) -------------

    def __add__(self, other: "Point") -> "Point":
        x1, y1, z1, t1 = self.x, self.y, self.z, self.t
        x2, y2, z2, t2 = other.x, other.y, other.z, other.t
        a = (y1 - x1) * (y2 - x2) % P
        b = (y1 + x1) * (y2 + x2) % P
        c = 2 * t1 * D % P * t2 % P
        d = 2 * z1 * z2 % P
        e, f, g, h = (b - a) % P, (d - c) % P, (d + c) % P, (b + a) % P
        return Point(e * f % P, g * h % P, f * g % P, e * h % P)

    def double(self) -> "Point":
        x, y, z = self.x, self.y, self.z
        a = x * x % P
        b = y * y % P
        c = 2 * z * z % P
        h = (a + b) % P
        e = (h - (x + y) * (x + y)) % P
        g = (a - b) % P
        f = (c + g) % P
        return Point(e * f % P, g * h % P, f * g % P, e * h % P)

    def __neg__(self) -> "Point":
        return Point((-self.x) % P, self.y, self.z, (-self.t) % P)

    def __sub__(self, other: "Point") -> "Point":
        return self + (-other)

    def __rmul__(self, k: int) -> "Point":
        return self * k

    def __mul__(self, k: int) -> "Point":
        k = int(k) % L
        acc = IDENTITY
        base = self
        while k:
            if k & 1:
                acc = acc + base
            base = base.double()
            k >>= 1
        return acc

    # -- ristretto encoding (RFC 9496 §4.3) ---------------------------------

    def encode(self) -> bytes:
        x0, y0, z0, t0 = self.x, self.y, self.z, self.t
        u1 = (z0 + y0) * (z0 - y0) % P
        u2 = x0 * y0 % P
        _, invsqrt = _sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
        den1 = invsqrt * u1 % P
        den2 = invsqrt * u2 % P
        z_inv = den1 * den2 % P * t0 % P
        ix0 = x0 * SQRT_M1 % P
        iy0 = y0 * SQRT_M1 % P
        enchanted = den1 * INVSQRT_A_MINUS_D % P
        rotate = (t0 * z_inv % P) & 1
        if rotate:
            x, y = iy0, ix0
            den_inv = enchanted
        else:
            x, y = x0, y0
            den_inv = den2
        if (x * z_inv % P) & 1:
            y = (-y) % P
        s = den_inv * (z0 - y) % P
        if s & 1:
            s = P - s
        return s.to_bytes(32, "little")

    def __eq__(self, other) -> bool:
        # ristretto coset equality (dalek ct_eq):
        # X1*Y2 == Y1*X2  or  X1*X2 == Y1*Y2
        a = self.x * other.y % P == self.y * other.x % P
        b = self.x * other.x % P == self.y * other.y % P
        return a or b

    def __hash__(self):
        return hash(self.encode())

    def is_identity(self) -> bool:
        return self == IDENTITY


IDENTITY = Point(0, 1, 1, 0)

# edwards25519 basepoint
_BY = 4 * pow(5, -1, P) % P
_BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
BASEPOINT = Point(_BX, _BY, 1, _BX * _BY % P)


class DecodeError(Exception):
    pass


def decode(data: bytes) -> Point:
    """RFC 9496 §4.3.1 decode; raises DecodeError on non-canonical."""
    if len(data) != 32:
        raise DecodeError("need 32 bytes")
    s = int.from_bytes(data, "little")
    if s >= P or (s & 1):
        if s >= P:
            raise DecodeError("non-canonical field element")
        raise DecodeError("negative s")
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-(D * u1 % P) * u1 % P - u2_sqr) % P
    was_square, invsqrt = _sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = 2 * s * den_x % P
    if x & 1:
        x = P - x
    y = u1 * den_y % P
    t = x * y % P
    if not was_square or (t & 1) or y == 0:
        raise DecodeError("invalid ristretto encoding")
    return Point(x, y, 1, t)


def from_uniform_bytes(data: bytes) -> Point:
    """RFC 9496 §4.3.4 one-way map (64 uniform bytes -> point) — the
    dalek `RistrettoPoint::from_uniform_bytes` used for generator
    derivation in bulletproofs."""
    if len(data) != 64:
        raise ValueError("from_uniform_bytes needs 64 bytes")
    p1 = _map_to_point(int.from_bytes(data[:32], "little") & ((1 << 255) - 1))
    p2 = _map_to_point(int.from_bytes(data[32:], "little") & ((1 << 255) - 1))
    return p1 + p2


def from_uniform_bytes_batch(data: bytes) -> list[Point]:
    """Batched `from_uniform_bytes` over len(data)/64 blocks
    (native-accelerated; python fallback is the oracle)."""
    if len(data) % 64:
        raise ValueError("from_uniform_bytes_batch needs 64 bytes a point")
    count = len(data) // 64
    if count >= 8:
        result = native.from_uniform_batch(data, count)
        if result is not None:
            return result
    return [from_uniform_bytes(data[64 * i:64 * (i + 1)])
            for i in range(count)]


def _map_to_point(r0: int) -> Point:
    """RFC 9496 §4.3.4 MAP (Elligator 2 for ristretto255)."""
    r = SQRT_M1 * r0 % P * r0 % P
    u = (r + 1) % P * ((1 - D * D % P) % P) % P          # (r+1)(1-d^2)
    c = (-1) % P
    v = (c - D * r % P) % P * ((r + D) % P) % P          # (-1-dr)(r+d)
    was_square, s = _sqrt_ratio_m1(u, v)
    if not was_square:
        s = s * r0 % P
        if not (s & 1):
            s = P - s                                    # -|s*r0|
        c = r
    n = (c * ((r - 1) % P) % P * ((D - 1) * (D - 1) % P) % P - v) % P
    w0 = 2 * s * v % P
    w1 = n * SQRT_AD_MINUS_ONE % P
    w2 = (1 - s * s) % P
    w3 = (1 + s * s) % P
    return Point(w0 * w3 % P, w2 * w1 % P, w1 * w3 % P, w0 * w2 % P)


# -- scalar field mod L ------------------------------------------------------

def scalar_from_bytes_wide(data: bytes) -> int:
    """64 bytes -> scalar mod L (dalek `Scalar::from_bytes_mod_order_wide`)."""
    if len(data) != 64:
        raise ValueError("scalar_from_bytes_wide needs 64 bytes")
    return int.from_bytes(data, "little") % L


def scalar_to_bytes(s: int) -> bytes:
    return (s % L).to_bytes(32, "little")


def scalar_from_canonical_bytes(data: bytes) -> int:
    """32 bytes -> scalar, rejecting non-canonical encodings >= L
    (dalek `Scalar::from_canonical_bytes`). Proof deserializers use
    this so a proof cannot be mauled by adding multiples of L to a
    response scalar."""
    if len(data) != 32:
        raise DecodeError("scalar needs 32 bytes")
    s = int.from_bytes(data, "little")
    if s >= L:
        raise DecodeError("non-canonical scalar")
    return s


def scalar_inv(s: int) -> int:
    return pow(s, -1, L)


def batch_scalar_inv(xs) -> list[int]:
    """Montgomery batch inversion mod L (one modexp total)."""
    xs = [int(x) % L for x in xs]
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % L
    inv_all = pow(prefix[n], -1, L)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % L
        inv_all = inv_all * xs[i] % L
    return out


def msm_py(scalars, points) -> Point:
    """Pure-python MSM — the bit-exactness oracle for the native path."""
    acc = IDENTITY
    for s, pt in zip(scalars, points):
        acc = acc + pt * int(s)
    return acc


DEVICE_MSM_MIN = 2048


def on_device(n: int, device) -> bool:
    """Whether an MSM of n points on `device` runs the CUDA Pippenger: a
    CUDA device, n >= DEVICE_MSM_MIN, and SUNSCREEN_TPU_MSM not "0"."""
    return (device is not None and torch.device(device).type == "cuda"
            and n >= DEVICE_MSM_MIN
            and os.environ.get("SUNSCREEN_TPU_MSM", "") != "0")


def msm(scalars, points, device=None) -> Point:
    """sum(s_i * P_i): the CUDA Pippenger (`zk/cuda_curve.py`) for at least
    DEVICE_MSM_MIN points on a CUDA `device` unless SUNSCREEN_TPU_MSM=0,
    else the native C++ Pippenger from 8 points, else pure python
    (reference: `parallel_multiscalar_multiplication`, logproof/math.rs;
    the GPU Pippenger of sunscreen_math/opencl_impl/multiexp.rs)."""
    points = list(points)
    scalars = list(scalars)
    if on_device(len(points), device):
        from sunscreen_tpu_torch.zk import cuda_curve
        return cuda_curve.msm_points(scalars, points, device)
    if len(points) >= 8:
        result = native.msm(scalars, points)
        if result is not None:
            return result
    return msm_py(scalars, points)


def batch_mul(scalars, points) -> list[Point]:
    """[s_i * P_i] element-wise (native-accelerated)."""
    points = list(points)
    scalars = list(scalars)
    if len(points) >= 4:
        result = native.batch_scalar_mul(scalars, points)
        if result is not None:
            return result
    return [p * int(s) for s, p in zip(scalars, points)]


def fold_points(points_a, points_b, scalar) -> list[Point]:
    """[a_i + scalar * b_i] (IPP generator folding, native-accelerated)."""
    points_a = list(points_a)
    points_b = list(points_b)
    if len(points_a) >= 4:
        result = native.fold(points_a, points_b, scalar)
        if result is not None:
            return result
    return [a + b * int(scalar) for a, b in zip(points_a, points_b)]
