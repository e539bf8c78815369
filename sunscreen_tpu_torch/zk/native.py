"""ctypes loader for the host ristretto kernels (`csrc/ristretto.cpp`).

Port of `sunscreen_tpu/zk/native.py`. The library is compiled with g++ at
first use into `_kbuild/<digest>/libristretto.so` beside the CUDA builds
(listed in .gitignore); the digest covers the source, the flags and the
target that `-march=native` resolves to on this host, so a library built
for another CPU is never loaded. Where g++ or the load fails, `get_lib()`
returns None and the callers fall back to the pure-python group of
`zk/curve25519.py`, as the reference does; `require_lib()` raises
`NativeBuildError` instead, and the ZKP runtime on a CUDA device calls it.

One departure from the reference: `msm_buf` on a CUDA `device` sends an MSM
of at least `curve25519.DEVICE_MSM_MIN` points to the card's Pippenger
(`zk/cuda_curve.py`, kernel M1) unless `SUNSCREEN_TPU_MSM=0`, as
`curve25519.msm` does; the reference's `msm_buf` always runs the host C++.
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
           "keccak_f1600": (_P,),
           # strobe state and meta, v1, v2, g, h, a, u, rho, rand, n,
           # n_real, g_coeff, then the outputs t1, tm1, w, w', z1, z2, tau
           "ristretto_ipp_prove": (_P,) * 10 + (_N, _N) + (_P,) * 8,
           "strobe_fork_challenges": (_P, _P, _P, _N, _N, _P),
           "ristretto_ipp_s": (_P, _N, _N, _P),
           "sc_vec_fold": (_P, _P, _P, _N, _P),
           "sc_vec_mul": (_P, _P, _N, _P)}

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


def _scalars_from_buf(raw: bytes, count: int) -> list[int]:
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little")
            for i in range(count)]


def msm_buf(scalars, points_buf, n: int, device=None):
    """MSM over a marshalled 128-byte-a-point buffer (cached generator
    buffers skip the python `Point` marshalling). On a CUDA `device` an MSM
    of at least DEVICE_MSM_MIN points runs M1 (unless SUNSCREEN_TPU_MSM=0),
    whose [n, 128] uint8 tensor is the buffer itself; else the host C++.
    None if n is 0 or the host library is unavailable."""
    from sunscreen_tpu_torch.zk import curve25519 as cv
    if n == 0:
        return None
    sb = scalars_to_buf(scalars, cv.L)
    if cv.on_device(n, device):
        from sunscreen_tpu_torch.zk import cuda_curve
        return cuda_curve.msm_bufs(sb, points_buf, n, device)
    return msm_bufs(sb, bytes(points_buf), n)


def batch_scalar_mul_buf(scalars, points_buf, n: int):
    """[s_i * P_i] over a marshalled buffer, returned as the raw 128-byte-
    a-point buffer (a caller feeding another native call skips two
    marshalling round trips); None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from sunscreen_tpu_torch.zk.curve25519 import L
    out = ctypes.create_string_buffer(128 * n)
    lib.ristretto_batch_scalarmul(scalars_to_buf(scalars, L),
                                  bytes(points_buf), ctypes.c_long(n), out)
    return out.raw


def sc_vec_mul(a, b):
    """Elementwise a * b mod L; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from sunscreen_tpu_torch.zk.curve25519 import L
    n = len(a)
    out = ctypes.create_string_buffer(32 * max(n, 1))
    lib.sc_vec_mul(scalars_to_buf(a, L), scalars_to_buf(b, L),
                   ctypes.c_long(n), out)
    return _scalars_from_buf(out.raw, n)


# -- the strobe state across the native calls --------------------------------

def _strobe_io(strobe):
    """(state, meta) ctypes buffers of a python `merlin.Strobe128`; call
    `_strobe_writeback` after the native call."""
    state = ctypes.create_string_buffer(bytes(strobe.state), 200)
    meta = (ctypes.c_int32 * 3)(strobe.pos, strobe.pos_begin,
                                strobe.cur_flags)
    return state, meta


def _strobe_writeback(strobe, state, meta):
    strobe.state = bytearray(state.raw[:200])
    strobe.pos = int(meta[0])
    strobe.pos_begin = int(meta[1])
    strobe.cur_flags = int(meta[2])


def fork_challenges(strobe, label: bytes, count: int):
    """The SDLP's 128-way forked batch of challenge scalars
    (`logproof/linear_relation._challenge_scalars`), mutating the python
    Strobe128 exactly as the python path would; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    state, meta = _strobe_io(strobe)
    out = ctypes.create_string_buffer(32 * max(count, 1))
    lib.strobe_fork_challenges(state, meta, label, ctypes.c_long(len(label)),
                               ctypes.c_long(count), out)
    _strobe_writeback(strobe, state, meta)
    return _scalars_from_buf(out.raw, count)


def ipp_s_vector(cs, n: int):
    """s[i] = prod_{j: bit j of i} cs[lg - 1 - j] mod L (the IPP
    verifier's exponents); None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from sunscreen_tpu_torch.zk.curve25519 import L
    out = ctypes.create_string_buffer(32 * n)
    lib.ristretto_ipp_s(scalars_to_buf(cs, L), ctypes.c_long(len(cs)),
                        ctypes.c_long(n), out)
    return _scalars_from_buf(out.raw, n)


def ipp_prove(strobe, v1, v2, g_buf: bytes, h_buf: bytes, a_pt, u_pt,
              rho: int, rand_scalars, n: int, n_real: int | None = None,
              g_coeff=None):
    """The whole ZK inner-product prover loop (`logproof/inner_product.
    create` after the draw of a) in one native call. `g_buf`/`h_buf` hold
    128 bytes a point, padded to n, a power of two; `g_coeff` (n scalars
    or None) scales the g bases virtually (the SDLP's g' = phi^-1 o g).
    Returns (t1 points, t-1 points, w, w', z1, z2, tau) or None, and
    mutates `strobe` exactly as the python loop would."""
    lib = get_lib()
    if lib is None:
        return None
    from sunscreen_tpu_torch.zk.curve25519 import L
    lg = n.bit_length() - 1
    if 1 << lg != n or len(rand_scalars) != 2 * lg + 4:
        raise ValueError("ipp_prove needs n a power of two and 2 lg n + 4 "
                         "blinding scalars")
    if g_coeff is not None and len(g_coeff) != n:
        raise ValueError("g_coeff needs one scalar a point")
    state, meta = _strobe_io(strobe)
    gcb = None if g_coeff is None else scalars_to_buf(g_coeff, L)
    t1 = ctypes.create_string_buffer(128 * max(lg, 1))
    tm1 = ctypes.create_string_buffer(128 * max(lg, 1))
    w = ctypes.create_string_buffer(128)
    wp = ctypes.create_string_buffer(128)
    z1, z2, tau = (ctypes.create_string_buffer(32) for _ in range(3))
    lib.ristretto_ipp_prove(
        state, meta, scalars_to_buf(v1, L), scalars_to_buf(v2, L), g_buf,
        h_buf, points_to_buf([a_pt]), points_to_buf([u_pt]),
        (int(rho) % L).to_bytes(32, "little"),
        scalars_to_buf(rand_scalars, L), ctypes.c_long(n),
        ctypes.c_long(n if n_real is None else n_real), gcb, t1, tm1, w,
        wp, z1, z2, tau)
    _strobe_writeback(strobe, state, meta)
    return (buf_to_points(t1.raw, lg), buf_to_points(tm1.raw, lg),
            buf_to_points(w.raw, 1)[0], buf_to_points(wp.raw, 1)[0],
            int.from_bytes(z1.raw, "little"),
            int.from_bytes(z2.raw, "little"),
            int.from_bytes(tau.raw, "little"))
