"""M1's CUDA source (`csrc/msm.cu`, the Pippenger MSM over ristretto255)
compiled for the host with the stand-in CUDA runtime of
`tests/test_torch_csrc_host.py` and run against the plain PyTorch version
(`zk/cuda_curve.py`) and the python group, at n <= 64: window widths 3 to
10 (top windows of 253 mod c = 1, 3 and 5 bits), scalars 0, 1, L - 1 and
2^252, buckets holding many points, repeated points, a single point,
every bucket of every window non-empty with the teams' shares cut inside
buckets at several block counts, the same representative on a second
run, and the widths and shapes the entry refuses. The kernel's sum is
exact for any (blocks, teams); the larger cases run at a few teams a
window (SHAPES), as the wrapper's shapes for the card would cost the
emulation, a thread a CUDA thread, minutes on a busy host. The card runs
the wrapper's shapes and c = MAX_C = 12 (`chip_smoke.py`).
This checks the three kernels' digits, cached points, sort, running sums,
trees, window tickets and join, and the field's PTX carry chains (through
their portable bodies, also on edge values alone) exactly;
`chip_smoke.py` checks them on the card. Needs a C++20 compiler (g++)."""

from __future__ import annotations

import ctypes
import random
import shutil

import pytest
import torch

from sunscreen_tpu_torch.zk import cuda_curve as cc
from sunscreen_tpu_torch.zk import curve25519 as cv
from test_torch_csrc_host import HOST_CUDA, _compile, _host_source

P = ctypes.c_void_p
# (blocks, teams) a window of the larger cases: their windows walk 2^c
# bucket ends, and the wrapper's shapes for the card add scalings and
# tree levels a team
SHAPES = {(64, 6): (1, 4), (40, 8): (1, 8), (24, 10): (1, 8)}
# the host build of msm.cu with one more entry: a + b, a - b, a b and a^2
# (eight words each) through the kernels' field functions
FIELD = r"""
#include "msm_host.cpp"
#include <cstring>
extern "C" void field_ops(const u32* a, const u32* b, u32* out) {
  fe x, y;
  std::memcpy(x.v, a, 32);
  std::memcpy(y.v, b, 32);
  const fe r[4] = {fe_add(x, y), fe_sub(x, y), fe_mul(x, y), fe_sqr(x)};
  for (int i = 0; i < 4; ++i) std::memcpy(out + 8 * i, r[i].v, 32);
}
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain MSM runs thousands of small int64 ops, which PyTorch's
    intra-op threads only slow down (15 times over on a shared host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA sources for the host")
    out = str(tmp_path_factory.mktemp("csrc_host_msm"))
    with open(f"{out}/cuda_runtime.h", "w") as f:
        f.write(HOST_CUDA)
    with open(f"{out}/msm_host.cpp", "w") as f:
        f.write(_host_source("msm"))
    so = ctypes.CDLL(_compile(out, "msm", FIELD, True))
    so.msm.argtypes = [P] * 10 + [ctypes.c_int] * 4 + [P]
    so.field_ops.argtypes = [P] * 3
    return so


def test_field_edges(lib):
    """fe_add, fe_sub, fe_mul and fe_sqr (the PTX carry chains through
    their portable bodies) on values next to 0, 2^32, p and 2^256 and on
    seeded random words, each result (eight words) equal mod p to the
    python integers'. These values make the folds of 38 carry or borrow
    past word 0 and out of the top word, which random points never do."""
    p, top = cv.P, 1 << 256
    rng = random.Random(5)
    edges = [0, 1, 37, 38, 39, (1 << 32) - 1, 1 << 32, p - 1, p, p + 37,
             top - 39, top - 38, top - 37, top - 1, top - (1 << 32),
             (1 << 255) - 1]
    values = edges + [rng.randrange(top) for _ in range(6)]
    for a in values:
        for b in values:
            ab = torch.frombuffer(bytearray(a.to_bytes(32, "little")
                                            + b.to_bytes(32, "little")),
                                  dtype=torch.uint8)
            res = torch.zeros(128, dtype=torch.uint8)
            lib.field_ops(ab.data_ptr(), ab.data_ptr() + 32,
                          res.data_ptr())
            raw = bytes(res.numpy())
            got = [int.from_bytes(raw[32 * i:32 * i + 32], "little")
                   for i in range(4)]
            want = [(a + b) % p, (a - b) % p, a * b % p, a * a % p]
            assert [g % p for g in got] == want, (hex(a), hex(b))


def _run(lib, scalars: torch.Tensor, points: torch.Tensor, c: int,
         shape: tuple[int, int] | None = None):
    """The host build's output (uint8 [128]) and return code, with the
    wrapper's bucket blocks and teams unless `shape` gives them."""
    n = scalars.shape[0]
    size = min(max(c, 1), cc.MAX_C)
    blocks, teams = cc.bucket_shape(n, size) if shape is None else shape
    scratch = cc.scratch(n, size, max(blocks, 1), "cpu")
    out = torch.zeros(128, dtype=torch.uint8)
    rc = lib.msm(scalars.data_ptr(), points.data_ptr(),
                 *(s.data_ptr() for s in scratch), out.data_ptr(), n, c,
                 blocks, teams, None)
    return out, rc


def _inputs(n: int, seed: int, distinct: int, fill):
    rng = random.Random(seed)
    base = [cv.BASEPOINT * rng.randrange(1, cv.L) for _ in range(distinct)]
    pts = [base[i % distinct] for i in range(n)]
    return fill(rng, n), pts


def _edges(rng, n):
    s = [rng.randrange(cv.L) for _ in range(n)]
    s[:4] = [0, 1, cv.L - 1, 1 << 252][:n]
    return s


def _one_digit(rng, n):
    """Every scalar 3 or 3 + 2^(c w) for some window: low buckets hold
    more than one chunk of eight points."""
    return [3 + (rng.randrange(2) << rng.randrange(240)) for _ in range(n)]


@pytest.mark.parametrize("n,c,distinct,fill", [
    (1, 5, 1, _edges),
    (33, 3, 33, _edges),
    (64, 6, 64, _one_digit),
    (40, 8, 3, _one_digit),
    (24, 10, 24, _edges),
])
def test_msm_host_build_matches_plain_and_oracle(lib, n, c, distinct, fill):
    scalars, pts = _inputs(n, 1000 * n + c, distinct, fill)
    s, p = cc.to_tensors(scalars, pts, "cpu")
    shape = SHAPES.get((n, c))
    got, rc = _run(lib, s, p, c, shape)
    assert rc == 0
    want = cv.msm_py(scalars, pts)
    assert cc.point_of(got).encode() == want.encode()
    assert cc.point_of(cc.msm(s, p, c)).encode() == want.encode()
    if c == 8:
        again, _ = _run(lib, s, p, c, shape)
        assert torch.equal(again, got)     # a fixed order of every sum


def test_msm_host_build_cuts_inside_buckets(lib):
    """24 points at c = 3: all seven buckets of every window below the top
    one (253 mod 3 = 1 bit) hold three points, and 4, 8 and 16 teams a
    window (one block of 4, two of 4, one of 16) cut the 28 events inside
    buckets at different places; every cut gives the oracle's point."""
    scalars, pts = _inputs(24, 11, 24, lambda rng, n: [
        sum((i + w) % 8 << 3 * w for w in range(84)) for i in range(n)])
    s, p = cc.to_tensors(scalars, pts, "cpu")
    dig = cc.digits(s, 3)
    assert all(set(row.tolist()) >= set(range(1, 8)) for row in dig[:-1])
    want = cv.msm_py(scalars, pts).encode()
    for shape in ((1, 4), (2, 4), (1, 16)):
        got, rc = _run(lib, s, p, 3, shape)
        assert rc == 0
        assert cc.point_of(got).encode() == want


def test_msm_host_build_refuses_widths(lib):
    scalars, pts = _inputs(4, 7, 4, _edges)
    s, p = cc.to_tensors(scalars, pts, "cpu")
    for c in (0, cc.MAX_C + 1):
        assert _run(lib, s, p, c)[1] != 0
    for shape in ((0, 4), (1, 0), (1, 3), (1, 64)):
        assert _run(lib, s, p, 4, shape)[1] != 0
    with pytest.raises(ValueError):
        cc.msm(s, p, cc.MAX_C + 1)
