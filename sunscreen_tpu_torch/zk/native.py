"""ctypes loader for the host ristretto kernels (`csrc/ristretto.cpp`).

Port of `sunscreen_tpu/zk/native.py`. The library is compiled with g++ at
first use into `_kbuild/<digest>/libristretto.so` beside the CUDA builds
(listed in .gitignore); the digest covers the source, the flags and the
target that `-march=native` resolves to on this host, so a library built
for another CPU is never loaded. Where g++ or the load fails, `get_lib()`
returns None and the callers fall back to the pure-python group of
`zk/curve25519.py`, as the reference does; `require_lib()` raises
`NativeBuildError` instead, and the ZKP runtime on a CUDA device calls it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from sunscreen_tpu_torch import _build

SRC = os.path.join(_build.CSRC, "ristretto.cpp")
FLAGS = ("-O3", "-march=native", "-funroll-loops", "-pthread", "-shared",
         "-fPIC")
_P, _N = ctypes.c_void_p, ctypes.c_long
# the entries bound here, with their C arguments (buffers as pointers)
ENTRIES = {"ristretto_msm": (_P, _P, _N, _P),
           "ristretto_batch_scalarmul": (_P, _P, _N, _P),
           "ristretto_fold": (_P, _P, _P, _N, _P),
           "ristretto_from_uniform": (_P, _N, _P),
           "keccak_f1600": (_P,)}

_LIB = None
_ERROR: Exception | None = None
_TRIED = False
_LOCK = threading.Lock()


class NativeBuildError(RuntimeError):
    """The host library could not be built or loaded."""


def _digest() -> str:
    target = subprocess.run(
        ["g++", "-march=native", "-Q", "--help=target"], check=True,
        capture_output=True, text=True, timeout=60).stdout
    h = hashlib.sha256(" ".join(FLAGS).encode() + target.encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def _load():
    out_dir = os.path.join(_build.BUILD_ROOT, _digest())
    so = os.path.join(out_dir, "libristretto.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", *FLAGS, "-o", tmp, SRC], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name, args in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = None
    return lib


def get_lib():
    """The loaded library, or None when it cannot be built here."""
    global _LIB, _ERROR, _TRIED
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            try:
                _LIB = _load()
            except (OSError, subprocess.SubprocessError) as e:
                _ERROR = e
        return _LIB


def require_lib():
    """The loaded library; raises NativeBuildError when it cannot be built."""
    lib = get_lib()
    if lib is None:
        detail = getattr(_ERROR, "stderr", None) or _ERROR
        raise NativeBuildError(f"building {SRC} failed: {detail}")
    return lib


def points_to_buf(points) -> bytes:
    """128 bytes a point: X, Y, Z, T as 32-byte little-endian integers."""
    out = bytearray()
    for p in points:
        out += p.x.to_bytes(32, "little")
        out += p.y.to_bytes(32, "little")
        out += p.z.to_bytes(32, "little")
        out += p.t.to_bytes(32, "little")
    return bytes(out)


def scalars_to_buf(scalars, L) -> bytes:
    return b"".join((int(s) % L).to_bytes(32, "little") for s in scalars)


def buf_to_points(buf, count):
    from sunscreen_tpu_torch.zk.curve25519 import Point
    out = []
    for i in range(count):
        off = 128 * i
        out.append(Point(
            int.from_bytes(buf[off:off + 32], "little"),
            int.from_bytes(buf[off + 32:off + 64], "little"),
            int.from_bytes(buf[off + 64:off + 96], "little"),
            int.from_bytes(buf[off + 96:off + 128], "little")))
    return out


def msm_bufs(scalar_buf: bytes, point_buf: bytes, n: int):
    """Pippenger MSM over marshalled scalars and points (threaded from 4096
    points); returns a Point or None if the library is unavailable."""
    lib = get_lib()
    if lib is None or n == 0:
        return None
    out = ctypes.create_string_buffer(128)
    lib.ristretto_msm(scalar_buf, point_buf, ctypes.c_long(n), out)
    return buf_to_points(out.raw, 1)[0]


def msm(scalars, points):
    """Native Pippenger MSM; returns a Point or None if unavailable."""
    from sunscreen_tpu_torch.zk.curve25519 import L
    if get_lib() is None or not points:
        return None
    return msm_bufs(scalars_to_buf(scalars, L), points_to_buf(points),
                    len(points))


def from_uniform_batch(data: bytes, count: int):
    """[from_uniform_bytes(data[64i:64i+64])]: batched elligator maps
    (the generator derivation's hot loop); None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if len(data) != 64 * count:
        raise ValueError("need 64 bytes a point")
    out = ctypes.create_string_buffer(128 * count)
    lib.ristretto_from_uniform(data, ctypes.c_long(count), out)
    return buf_to_points(out.raw, count)


def batch_scalar_mul(scalars, points):
    lib = get_lib()
    if lib is None:
        return None
    from sunscreen_tpu_torch.zk.curve25519 import L
    n = len(points)
    out = ctypes.create_string_buffer(128 * n)
    lib.ristretto_batch_scalarmul(scalars_to_buf(scalars, L),
                                  points_to_buf(points), ctypes.c_long(n),
                                  out)
    return buf_to_points(out.raw, n)


def fold(points_a, points_b, scalar):
    """[a_i + scalar * b_i]."""
    lib = get_lib()
    if lib is None:
        return None
    from sunscreen_tpu_torch.zk.curve25519 import L
    n = len(points_a)
    sb = (int(scalar) % L).to_bytes(32, "little")
    out = ctypes.create_string_buffer(128 * n)
    lib.ristretto_fold(points_to_buf(points_a), points_to_buf(points_b),
                       sb, ctypes.c_long(n), out)
    return buf_to_points(out.raw, n)
