"""M1's CUDA source (`csrc/msm.cu`, the Pippenger MSM over ristretto255)
compiled for the host with the stand-in CUDA runtime of
`tests/test_torch_csrc_host.py` and run against the plain PyTorch version
(`zk/cuda_curve.py`) and the python group, at n <= 64: window widths 3 to
10, scalars 0, 1, L - 1 and 2^252, buckets filled past one chunk of eight
points, repeated points, a single point, the same representative on a
second run, and the widths the entry refuses.
This checks the four kernels' sort, chunking, reductions and field
arithmetic exactly; `chip_smoke.py` checks them on the card. Needs a C++20
compiler (g++)."""

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
    so = ctypes.CDLL(_compile(out, "msm", _host_source("msm"), True))
    so.msm.argtypes = [P] * 8 + [ctypes.c_int] * 2 + [P]
    return so


def _run(lib, scalars: torch.Tensor, points: torch.Tensor, c: int):
    """The host build's output (uint8 [128]) and return code."""
    n = scalars.shape[0]
    nwin, buckets = -(-253 // max(c, 1)), 1 << c
    m = -(-n // cc.SEG) + buckets
    scratch = [torch.zeros(shape, dtype=torch.int32) for shape in
               ((nwin, n), (nwin, buckets + 1), (nwin, buckets + 1),
                (nwin, m, 32), (nwin, 32))]
    out = torch.zeros(128, dtype=torch.uint8)
    rc = lib.msm(scalars.data_ptr(), points.data_ptr(),
                 *(s.data_ptr() for s in scratch), out.data_ptr(), n, c,
                 None)
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
    got, rc = _run(lib, s, p, c)
    assert rc == 0
    want = cv.msm_py(scalars, pts)
    assert cc.point_of(got).encode() == want.encode()
    assert cc.point_of(cc.msm(s, p, c)).encode() == want.encode()
    if c == 8:
        again, _ = _run(lib, s, p, c)
        assert torch.equal(again, got)     # a fixed order of every sum


def test_msm_host_build_refuses_widths(lib):
    scalars, pts = _inputs(4, 7, 4, _edges)
    s, p = cc.to_tensors(scalars, pts, "cpu")
    for c in (0, cc.MAX_C + 1):
        assert _run(lib, s, p, c)[1] != 0
    with pytest.raises(ValueError):
        cc.msm(s, p, cc.MAX_C + 1)
