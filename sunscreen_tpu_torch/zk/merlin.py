"""Merlin transcripts: STROBE-128 over Keccak-f[1600], byte-compatible
with the `merlin` crate the reference uses for all proof transcripts (port
of `sunscreen_tpu/zk/merlin.py`). Host-side only: transcript hashing is
sequential and tiny next to the MSMs. The permutation runs in the port's
native library (`zk/native.py`) where it builds, else in python.
"""

from __future__ import annotations

import ctypes

from sunscreen_tpu_torch.zk import curve25519 as c
from sunscreen_tpu_torch.zk import native

# -- Keccak-f[1600] ----------------------------------------------------------

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROTC = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_MASK = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK


def _native_keccak():
    """ctypes handle to the C++ keccak_f1600 (the same shared library as
    the ristretto kernels); None when the native build is unavailable."""
    lib = native.get_lib()
    return None if lib is None else lib.keccak_f1600


def keccak_f1600(state: bytearray) -> None:
    """In-place permutation of a 200-byte state (little-endian lanes)."""
    fn = _native_keccak()
    if fn is not None:
        buf = (ctypes.c_uint8 * 200).from_buffer(state)
        fn(buf)
        return
    _keccak_f1600_py(state)


def _keccak_f1600_py(state: bytearray) -> None:
    """Pure-python reference permutation (oracle for the native one)."""
    a = [[int.from_bytes(state[8 * (x + 5 * y):8 * (x + 5 * y) + 8],
                         "little") for y in range(5)] for x in range(5)]
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROTC[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) &
                                     b[(x + 2) % 5][y]) & _MASK
        # iota
        a[0][0] ^= rc
    for x in range(5):
        for y in range(5):
            state[8 * (x + 5 * y):8 * (x + 5 * y) + 8] = \
                a[x][y].to_bytes(8, "little")


# -- STROBE-128 (merlin's subset: meta-AD / AD / PRF / KEY) ------------------

_R = 166  # strobe-128 rate
_FLAG_I, _FLAG_A, _FLAG_C, _FLAG_T, _FLAG_M, _FLAG_K = 1, 2, 4, 8, 16, 32


class Strobe128:
    def __init__(self, protocol_label: bytes):
        self.state = bytearray(200)
        self.state[0:6] = bytes([1, _R + 2, 1, 0, 1, 96])
        self.state[6:18] = b"STROBEv1.0.2"
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def _run_f(self):
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes):
        # chunked to the rate boundary (XOR via int bit-ops — the
        # per-byte loop dominated transcript time at SDLP sizes)
        off = 0
        n = len(data)
        while off < n:
            take = min(_R - self.pos, n - off)
            lo, hi = self.pos, self.pos + take
            cur = int.from_bytes(self.state[lo:hi], "little")
            new = cur ^ int.from_bytes(data[off:off + take], "little")
            self.state[lo:hi] = new.to_bytes(take, "little")
            self.pos += take
            off += take
            if self.pos == _R:
                self._run_f()

    def _overwrite(self, data: bytes):
        off = 0
        n = len(data)
        while off < n:
            take = min(_R - self.pos, n - off)
            self.state[self.pos:self.pos + take] = data[off:off + take]
            self.pos += take
            off += take
            if self.pos == _R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            take = min(_R - self.pos, n - len(out))
            out += self.state[self.pos:self.pos + take]
            self.state[self.pos:self.pos + take] = bytes(take)
            self.pos += take
            if self.pos == _R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool):
        if more:
            assert self.cur_flags == flags, "STROBE op continuation mismatch"
            return
        assert not (flags & _FLAG_T), "transport not supported"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (_FLAG_C | _FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool):
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool):
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool):
        self._begin_op(_FLAG_A | _FLAG_C, more)
        self._overwrite(data)


# -- Transcript (merlin API) -------------------------------------------------

def _u32le(n: int) -> bytes:
    return n.to_bytes(4, "little")


class Transcript:
    MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"

    def __init__(self, label: bytes):
        self.strobe = Strobe128(self.MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes):
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le(len(message)), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, value: int):
        self.append_message(label, value.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le(n), True)
        return self.strobe.prf(n, False)

    # conveniences mirroring the reference transcript protocols
    def append_point(self, label: bytes, point) -> None:
        self.append_message(label, point.encode())

    def append_scalar(self, label: bytes, scalar: int) -> None:
        self.append_message(label, c.scalar_to_bytes(scalar))

    def challenge_scalar(self, label: bytes) -> int:
        return c.scalar_from_bytes_wide(self.challenge_bytes(label, 64))
