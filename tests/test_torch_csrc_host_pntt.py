"""The last two transform kernels' CUDA sources (`csrc/pntt.cu`'s B16,
`csrc/inv_tensor3.cu`'s B12) compiled for the host with the stand-in CUDA
runtime of `tests/test_torch_csrc_host.py` and run against the plain
PyTorch twins, bit for bit, at small sizes: B16 in one pass
(`pntt_fwd`/`pntt_inv`) at N = 128 (its own two-stage groups), 256, 1024,
8192 and 32768 (five-stage groups, one exchange buffer) and in two passes
(`pntt_fwd_rows` then `pntt_fwd_cols`, `pntt_inv_cols` then
`pntt_inv_rows`, each pass against its own twin) at N = 65536 and 131072,
inputs up to 2^62 and above; B12 up to N = 16384 on operands that are
views of one [rows, 4, k, N] stack; the swizzles of pntt.cu's [t', s']
exchange, of the N = 128 and N = 32768 groups and of the two passes'
tiles (`csrc/pntt_passes.cuh`), warp by warp; and the sizes each entry
point refuses. Needs a C++20 compiler (g++)."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sunscreen_tpu_torch import _build
from sunscreen_tpu_torch.math import pntt, primes
from test_torch_csrc_host import HOST_CUDA, _compile, _host_source

# pntt.cu's [t', s'] exchange at every N it holds, and the groups of the
# sizes ntt.cu does not hold (N = 128 and 32768):
# every warp access hits 32 distinct banks, the swizzle is a bijection of
# [0, N), and Rot::pos puts slot s' C + t' at position t' R' + s'.
BANKS = r"""
#include "cuda_runtime.h"
#include "pntt_passes.cuh"
#include <cstdio>
#include <set>
using namespace tf;
int bad = 0;
template <class F> void warps(int logn, int threads, int e, F addr) {
  for (int w = 0; w < threads / 32; ++w)
    for (int s = 0; s < e; ++s) {
      std::set<u32> banks;
      for (int l = 0; l < 32; ++l) banks.insert(addr(32 * w + l, s) % 32);
      if (banks.size() != 32) {
        ++bad;
        printf("logn %d warp %d register %d: %zu banks\n", logn, w, s,
               banks.size());
      }
    }
}
template <int LOGN, int A> void group() {
  using S = Shape<LOGN>;
  warps(LOGN, S::T, S::E, [](u32 tau, int s) {
    return swz<LOGN, false>(thread_pos<LOGN, A>(tau)) ^
           swz<LOGN, false>(s << A);
  });
}
template <int LOGN, int G = 0> void groups() {
  group<LOGN, Shape<LOGN>::fwd_a(G)>();
  group<LOGN, Shape<LOGN>::inv_a(G)>();
  if constexpr (G + 1 < Shape<LOGN>::G) groups<LOGN, G + 1>();
}
template <int LOGN> void size() {
  using S = Shape<LOGN>;
  using D = Rot<LOGN>;
  warps(LOGN, S::T, S::E, [](u32 tau, int s) {   // slot order
    return swz<LOGN, true, D>(D::pos(tau << S::R)) ^
           swz<LOGN, true, D>(D::pos(s));
  });
  warps(LOGN, S::T, S::E, [](u32 tau, int s) {   // position order
    return swz<LOGN, true, D>(tau) ^ swz<LOGN, true, D>(s * S::T);
  });
  const u32 c = LOGN > 8 ? 128 : S::N / 2, r = S::N / c;
  std::set<u32> words;
  for (u32 p = 0; p < (u32)S::N; ++p) {
    words.insert(swz<LOGN, true, D>(p));
    if (D::pos((p % r) * c + p / r) != p) ++bad;
  }
  if ((int)words.size() != S::N || *words.rbegin() >= (u32)S::N) {
    ++bad;
    printf("logn %d: the swizzle is not a bijection\n", LOGN);
  }
}
template <class F> void bijection(const char* what, u32 n, F word) {
  std::set<u32> words;
  for (u32 i = 0; i < n; ++i) words.insert(word(i));
  if (words.size() != n || *words.rbegin() >= n) {
    ++bad;
    printf("%s: not a bijection onto [0, %u)\n", what, n);
  }
}
// The two-pass B16's row tile at R = 2^LOGR: its coalesced row segments
// (lane e: row e / P, column e % P) and a column's consecutive rows.
template <int LOGR> void rows_tile() {
  using S = Shape<LOGR>;
  warps(LOGR, S::THREADS, S::E, [](u32 t, int i) {
    const u32 e = t + i * S::THREADS;
    return twopass::tile_word<LOGR>(e % S::P, e / S::P);
  });
  warps(LOGR, S::THREADS, S::E, [](u32 t, int s) {
    return twopass::tile_word<LOGR>(t / S::T, t % S::T + s * S::T);
  });
  bijection("row tile", S::P * S::N, [](u32 i) {
    return twopass::tile_word<LOGR>(i >> LOGR, i & (S::N - 1));
  });
}
// Its column pass: the exchange (writes of columns j + 8 s, reads of
// 16 j + s, lane 8 rho + j) and the transpose tile (writes of those, reads
// of RB consecutive rows of column t').
void cols_tiles() {
  using namespace twopass;
  warps(16, COL_THREADS, 16, [](u32 t, int s) {
    return ex_word(t >> 3, (t & 7) + 8 * s);
  });
  warps(16, COL_THREADS, 16, [](u32 t, int s) {
    return ex_word(t >> 3, 16 * (t & 7) + s);
  });
  warps(16, COL_THREADS, 16, [](u32 t, int s) {
    return tp_word(16 * (t & 7) + s, t >> 3);
  });
  warps(16, COL_THREADS, 16, [](u32 t, int i) {
    const u32 e = t + i * COL_THREADS;
    return tp_word(e / RB, e % RB);
  });
  bijection("exchange", RB * C, [](u32 i) { return ex_word(i / C, i % C); });
  bijection("transpose", RB * C, [](u32 i) { return tp_word(i / RB, i % RB); });
}
int main() {
  groups<7>(); groups<15>();
  size<7>(); size<8>(); size<9>(); size<10>(); size<11>(); size<12>();
  size<13>(); size<14>(); size<15>();
  rows_tile<9>(); rows_tile<10>(); rows_tile<11>(); rows_tile<12>();
  rows_tile<13>(); rows_tile<14>();
  cols_tiles();
  return bad != 0;
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA sources for the host")
    out = str(tmp_path_factory.mktemp("csrc_host_pntt"))
    with open(os.path.join(out, "cuda_runtime.h"), "w") as f:
        f.write(HOST_CUDA)
    libs = {}
    for name in ("pntt", "inv_tensor3"):
        lib = ctypes.CDLL(_compile(out, name, _host_source(name), True))
        for fn, sig in _build.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = [_build._CTYPES[c] for c in sig]
        libs[name] = lib
    return out, libs


def _p(a: np.ndarray) -> int:
    assert a.flags.c_contiguous
    return a.ctypes.data


@pytest.mark.parametrize("n", [128, 256, 1024, 8192, 32768, 65536, 131072])
def test_pntt_kernels_match_twins(host, n):
    """B16 on 2 rows of 3 limbs (a 30-bit limb, whose lazy butterflies
    reach 4q - 1 < 2^32, and two small ones): each polynomial holds 0,
    q - 1 and a word above 2^62, the second row is q - 1 throughout. At
    N = 128 and 256 six of a block's sixteen slots hold a polynomial; at
    N = 32768 a polynomial takes 1024 threads, 32 coefficients each, and
    one 128 KB exchange buffer. Above 32768 each direction is two
    kernels, each held against its own pass's twin: the row pass with 16
    columns of 512 rows a block (8 of 1024 at 131072), the column pass
    with 32 rows a block; on one row there, its middle limb q - 1
    throughout (the host runs the blocks' threads one barrier at a time,
    and those sizes take thousands of barriers a row)."""
    _, libs = host
    small = max(17, 17 + n.bit_length() - 9)
    plan = pntt.PallasNttPlan(
        n, tuple(primes.gen_ntt_primes(30, 1, n))
        + tuple(primes.gen_ntt_primes(small, 2, n)), "cpu")
    q = plan.q.numpy()
    rows = 2 if n <= pntt.ONE_PASS_MAX_N else 1
    x = np.random.default_rng(n).integers(0, 1 << 62, (rows, 3, n))
    x[..., 0] = q[:, 0] - 1
    x[..., 1] = 0
    x[..., 2] = (1 << 62) + 12345      # the loads' 64-bit reduction
    if rows == 2:
        x[1] = q - 1
    else:
        x[0, 1] = q[1, 0] - 1
    twp, consts = plan.twp.numpy(), plan.consts.numpy()
    logn = n.bit_length() - 1

    def run(fn, src, dtype):
        out = np.empty(src.shape, dtype=dtype)
        assert getattr(libs["pntt"], fn)(_p(src), _p(out), _p(twp),
                                         _p(consts), rows, 3, logn,
                                         None) == 0
        return out

    xt = torch.from_numpy(x)
    if n <= pntt.ONE_PASS_MAX_N:
        for fn, twin in (("pntt_fwd", plan.fwd_plain),
                         ("pntt_inv", plan.inv_plain)):
            np.testing.assert_array_equal(run(fn, x, np.int64),
                                          twin(xt).numpy())
        return
    for first, second, twin1, twin in (
            ("pntt_fwd_rows", "pntt_fwd_cols", plan.fwd_rows_plain,
             plan.fwd_plain),
            ("pntt_inv_cols", "pntt_inv_rows", plan.inv_cols_plain,
             plan.inv_plain)):
        mid = run(first, x, np.int32)
        np.testing.assert_array_equal(mid, twin1(xt).numpy())
        np.testing.assert_array_equal(run(second, mid, np.int64),
                                      twin(xt).numpy())


def test_pntt_layouts_have_no_bank_conflict(host):
    """Every warp access of pntt.cu's [t', s'] exchange (slot order and
    position order) at every N from 128 to 32768, and of the N = 128 and
    N = 32768 groups' exchanges, hits 32 distinct banks; the exchange
    writes slot s' C + t' at position t' R' + s'. (inv_tensor3.cu's
    accesses are ntt.cu's, flat order and exchanges, checked in
    test_torch_csrc_host.py.)"""
    out, _ = host
    exe = _compile(out, "banks_pntt", BANKS, False)
    proc = subprocess.run([exe], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout[-2000:]


def test_entry_points_refuse_unsupported_sizes(host):
    """B16 runs in one pass at 128 <= N <= 32768 and in two passes at
    65536 <= N <= 2^21, B12 at 256 <= N <= 16384 only: outside, the C
    entry returns cudaErrorInvalidValue."""
    _, libs = host
    x = np.zeros(1 << 16, dtype=np.int64)
    twp = consts = np.zeros(8, dtype=np.int64)
    for fns, refused in ((("pntt_fwd", "pntt_inv"), (6, 16)),
                         (("pntt_fwd_rows", "pntt_fwd_cols", "pntt_inv_cols",
                           "pntt_inv_rows"), (15, 22))):
        for logn in refused:
            for fn in fns:
                assert getattr(libs["pntt"], fn)(_p(x), _p(x), _p(twp),
                                                 _p(consts), 1, 1, logn,
                                                 None) == 1, (fn, logn)
    for logn in (7, 15):
        assert libs["inv_tensor3"].inv_tensor3(
            _p(x), _p(x), _p(x), _p(twp), _p(consts), 1, 1, logn, 4, 4,
            None) == 1
