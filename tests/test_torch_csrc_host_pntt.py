"""The last two transform kernels' CUDA sources (`csrc/pntt.cu`'s B16
`pntt_fwd`/`pntt_inv`, `csrc/inv_tensor3.cu`'s B12) compiled for the host
with the stand-in CUDA runtime of `tests/test_torch_csrc_host.py` and run
against the plain PyTorch twins, bit for bit, at small sizes: B16 at
N = 128 (its own two-stage groups), 256, 1024, 8192 and 32768 (five-stage
groups, one exchange buffer), forward inputs up to 2^62 and above; B12 up
to N = 16384 on operands that are views of one [rows, 4, k, N] stack; the
swizzles of pntt.cu's [t', s'] exchange and of the N = 128 and N = 32768
groups, warp by warp; and the sizes each entry point refuses.
Needs a C++20 compiler (g++)."""

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
#include "transform.cuh"
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
int main() {
  groups<7>(); groups<15>();
  size<7>(); size<8>(); size<9>(); size<10>(); size<11>(); size<12>();
  size<13>(); size<14>(); size<15>();
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


@pytest.mark.parametrize("n", [128, 256, 1024, 8192, 32768])
def test_pntt_kernels_match_twins(host, n):
    """pntt_fwd and pntt_inv (B16) on 2 rows of 3 limbs (a 30-bit limb,
    whose lazy butterflies reach 4q - 1 < 2^32, and two small ones): each
    polynomial holds 0, q - 1 and a word above 2^62, the second row is
    q - 1 throughout. At N = 128 and 256 six of a block's sixteen slots
    hold a polynomial; at N = 32768 a polynomial takes 1024 threads, 32
    coefficients each, and one 128 KB exchange buffer."""
    _, libs = host
    small = max(17, 17 + n.bit_length() - 9)
    plan = pntt.PallasNttPlan(
        n, tuple(primes.gen_ntt_primes(30, 1, n))
        + tuple(primes.gen_ntt_primes(small, 2, n)), "cpu")
    q = plan.q.numpy()
    x = np.random.default_rng(n).integers(0, 1 << 62, (2, 3, n))
    x[..., 0] = q[:, 0] - 1
    x[..., 1] = 0
    x[..., 2] = (1 << 62) + 12345      # the loads' 64-bit reduction
    x[1] = q - 1
    twp, consts = plan.twp.numpy(), plan.consts.numpy()
    logn = n.bit_length() - 1
    for fn, twin in (("pntt_fwd", plan.fwd_plain),
                     ("pntt_inv", plan.inv_plain)):
        out = np.empty_like(x)
        assert getattr(libs["pntt"], fn)(_p(x), _p(out), _p(twp), _p(consts),
                                         2, 3, logn, None) == 0
        np.testing.assert_array_equal(out, twin(torch.from_numpy(x)).numpy())


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
    """B16 runs at 128 <= N <= 32768 and B12 at 256 <= N <= 16384 only:
    outside, the C entry returns cudaErrorInvalidValue."""
    _, libs = host
    x = np.zeros(1 << 16, dtype=np.int64)
    twp = consts = np.zeros(8, dtype=np.int64)
    for logn in (6, 16):
        for fn in ("pntt_fwd", "pntt_inv"):
            assert getattr(libs["pntt"], fn)(_p(x), _p(x), _p(twp),
                                             _p(consts), 1, 1, logn,
                                             None) == 1
    for logn in (7, 15):
        assert libs["inv_tensor3"].inv_tensor3(
            _p(x), _p(x), _p(x), _p(twp), _p(consts), 1, 1, logn, 4, 4,
            None) == 1
