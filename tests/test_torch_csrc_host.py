"""The transform kernels' CUDA sources (`csrc/ntt.cu`, `csrc/tensor3.cu`,
`csrc/transform.cuh`) compiled for the host and run against the plain
PyTorch twins.

A small header stands in for the CUDA runtime: one std::thread per CUDA
thread, a std::barrier per block for `__syncthreads`, the block's dynamic
shared memory as a byte array, static `__shared__` variables as function
statics (the emulated blocks run one after another), and the intrinsics
the kernels use (`__umulhi`, `__umul64hi`, `__brev`, `__ldg`). The
sources are compiled as they are, after two textual rewrites
(`kernel<<<grid, block, smem, stream>>>(args)` becomes a call of the
emulated launch, `extern __shared__` a pointer to the block's bytes).
This checks the kernels' index arithmetic, layouts, barriers and lazy
reductions bit for bit at small sizes; what it cannot check (the
compiler for `sm_90a`, timing) `chip_smoke.py` checks on the card. Needs
a C++20 compiler (g++).
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sunscreen_tpu_torch.math import pmntt, primes

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "sunscreen_tpu_torch", "csrc")

HOST_CUDA = r"""
#pragma once
#include <barrier>
#include <cstddef>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __shared__ static
struct uint3 { unsigned x = 0, y = 0, z = 0; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
inline thread_local uint3 threadIdx, blockIdx, blockDim;
inline thread_local dim3 gridDim;
inline thread_local std::barrier<>* host_barrier = nullptr;
inline thread_local char* host_smem = nullptr;
inline void __syncthreads() { host_barrier->arrive_and_wait(); }
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned min(unsigned a, unsigned b) { return a < b ? a : b; }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
inline unsigned long long __umul64hi(unsigned long long a,
                                     unsigned long long b) {
  return (unsigned long long)(((unsigned __int128)a * b) >> 64);
}
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
typedef void* cudaStream_t;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
template <class F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int host_error = 0;
inline int cudaGetLastError() { int e = host_error; host_error = 0; return e; }
// the H100's limits: 1024 threads and 227 KB of shared memory a block
template <class F, class... A>
void host_launch(F f, dim3 grid, int block, int smem, cudaStream_t,
                 A... args) {
  if (block > 1024 || smem > 232448 || grid.y > 65535) {
    host_error = cudaErrorInvalidConfiguration;
    return;
  }
  std::vector<char> shared(smem);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::barrier<> barrier(block);
      std::vector<std::thread> threads;
      for (int t = 0; t < block; ++t)
        threads.emplace_back([&, t] {
          threadIdx.x = t; blockIdx.x = bx; blockIdx.y = by;
          blockDim.x = block; gridDim = grid;
          host_barrier = &barrier; host_smem = shared.data();
          f(args...);
        });
      for (auto& th : threads) th.join();
    }
}
"""

# Every warp access of every exchange and of the flat permutation, at every
# size: 32 distinct banks, and both swizzles bijections of [0, N).
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
  groups<LOGN>();
  warps(LOGN, S::T, S::E, [](u32 tau, int s) {
    return swz<LOGN, true>(flat_of<LOGN>(tau << S::R)) ^
           swz<LOGN, true>(flat_of<LOGN>(s));
  });
  warps(LOGN, S::T, S::E, [](u32 tau, int s) {
    return swz<LOGN, true>(tau) ^ swz<LOGN, true>(s * S::T);
  });
  std::set<u32> ex, perm;
  for (u32 p = 0; p < (u32)S::N; ++p) {
    ex.insert(swz<LOGN, false>(p));
    perm.insert(swz<LOGN, true>(p));
    if (flat_of<LOGN>(flat_of<LOGN>(p)) != p) ++bad;
  }
  if ((int)ex.size() != S::N || *ex.rbegin() >= (u32)S::N ||
      (int)perm.size() != S::N || *perm.rbegin() >= (u32)S::N) {
    ++bad;
    printf("logn %d: a swizzle is not a bijection\n", LOGN);
  }
}
int main() {
  size<8>(); size<9>(); size<10>(); size<11>(); size<12>(); size<13>();
  size<14>();
  return bad != 0;
}
"""

P, I = ctypes.c_void_p, ctypes.c_int


def _host_source(name: str) -> str:
    src = open(os.path.join(CSRC, f"{name}.cu")).read()
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = (\1*)host_smem;", src)
    return re.sub(r"([\w:]+(?:<[^;()]*?>)?)<<<(.*?)>>>\(",
                  r"host_launch(\1, \2, ", src, flags=re.S)


def _compile(out_dir, name: str, source: str, shared: bool) -> str:
    path = os.path.join(out_dir, f"{name}.cpp")
    with open(path, "w") as f:
        f.write(source)
    target = os.path.join(out_dir, f"lib{name}.so" if shared else name)
    cmd = ["g++", "-std=c++20", "-O1", "-pthread", f"-I{out_dir}",
           f"-I{CSRC}", "-o", target, path]
    if shared:
        cmd[1:1] = ["-shared", "-fPIC"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return target


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA sources for the host")
    out = str(tmp_path_factory.mktemp("csrc_host"))
    with open(os.path.join(out, "cuda_runtime.h"), "w") as f:
        f.write(HOST_CUDA)
    libs = {}
    for name, sigs in (("ntt", {"ntt_fwd": 4, "ntt_inv": 3}),
                       ("tensor3", {"fwd_tensor3": 4})):
        lib = ctypes.CDLL(_compile(out, name, _host_source(name), True))
        for fn, ints in sigs.items():
            getattr(lib, fn).argtypes = [P] * 4 + [I] * ints + [P]
        libs[name] = lib
    return out, libs


def _plan(n: int, k: int):
    """A 30-bit limb (values up to 4q - 1 < 2^32 in the lazy butterflies)
    and k - 1 small ones."""
    small = 17 + n.bit_length() - 8
    mods = (tuple(primes.gen_ntt_primes(30, 1, n))
            + tuple(primes.gen_ntt_primes(small, k - 1, n)))
    return pmntt.NttPlanU32(n, mods, "cpu")


def _residues(rng, plan, lead):
    q = plan.q.numpy()
    x = rng.integers(0, 1 << 62, lead + (plan.k, plan.n)) % q
    x[..., 0] = q[:, 0] - 1
    x[..., 1] = 0
    x[..., 2] = (1 << 62) + 12345      # the loads' 64-bit reduction
    x.reshape(-1, plan.k, plan.n)[0] = q - 1
    return x


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


@pytest.mark.parametrize("n", [256, 1024, 8192, 16384])
def test_ntt_kernels_match_twins(host, n):
    """ntt_fwd (B1), its broadcast form (B2, raw words up to 2^32 - 1) and
    ntt_inv (B3) on 2 rows of 3 limbs, one word above 2^62 in each
    polynomial: at N = 256 six of a block's
    sixteen slots hold a polynomial; radix-8 groups at 256, radix-16 with
    a remainder group of one (8192) or two (16384) stages above."""
    _, libs = host
    plan = _plan(n, 3)
    rng = np.random.default_rng(n)
    x = _residues(rng, plan, (2,))
    twp, consts = plan.twp.numpy(), plan.consts.numpy()
    logn = n.bit_length() - 1
    out = np.empty_like(x)
    assert libs["ntt"].ntt_fwd(_ptr(x), _ptr(out), _ptr(twp), _ptr(consts),
                               2, 3, logn, 0, None) == 0
    np.testing.assert_array_equal(out, plan.fwd(torch.from_numpy(x)).numpy())
    raw = rng.integers(0, 1 << 32, (2, n))
    raw[0] = (1 << 32) - 1
    assert libs["ntt"].ntt_fwd(_ptr(raw), _ptr(out), _ptr(twp), _ptr(consts),
                               2, 3, logn, 1, None) == 0
    np.testing.assert_array_equal(
        out, plan.fwd_broadcast(torch.from_numpy(raw)).numpy())
    assert libs["ntt"].ntt_inv(_ptr(x), _ptr(out), _ptr(twp), _ptr(consts),
                               2, 3, logn, None) == 0
    np.testing.assert_array_equal(out, plan.inv(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("n", [256, 2048, 8192, 16384])
def test_tensor3_kernels_match_twins(host, n):
    """fwd_tensor3 without (B4) and with (B13) the inverse transforms on
    [2, 4, 2, N] operands (at N = 16384 a task takes 1024 threads and
    192 KB of shared memory), every operand of the first row at q - 1."""
    _, libs = host
    plan = _plan(n, 2)
    ext = _residues(np.random.default_rng(n + 1), plan, (2, 4))
    twp, consts = plan.twp.numpy(), plan.consts.numpy()
    out = np.empty((2, 3, 2, n), dtype=np.int64)
    e = torch.from_numpy(ext)
    for full, want in ((0, plan.fwd_tensor3_plain(e)),
                       (1, plan.fwd_tensor3_full_plain(e))):
        assert libs["tensor3"].fwd_tensor3(
            _ptr(ext), _ptr(out), _ptr(twp), _ptr(consts), 2, 2,
            n.bit_length() - 1, full, None) == 0
        np.testing.assert_array_equal(out, want.numpy())


def test_transform_layouts_have_no_bank_conflict(host):
    """Every warp access of transform.cuh's exchanges and flat permutation
    hits 32 distinct banks at every N from 256 to 16384."""
    out, _ = host
    exe = _compile(out, "banks", BANKS, False)
    proc = subprocess.run([exe], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout[-2000:]


def test_entry_points_refuse_unsupported_sizes(host):
    """No kernel runs outside 256 <= N <= 16384: the C entry returns
    cudaErrorInvalidValue."""
    _, libs = host
    x = np.zeros(1 << 15, dtype=np.int64)
    twp = consts = np.zeros(8, dtype=np.int64)
    for logn in (7, 15):
        assert libs["ntt"].ntt_fwd(_ptr(x), _ptr(x), _ptr(twp), _ptr(consts),
                                   1, 1, logn, 0, None) == 1
        assert libs["ntt"].ntt_inv(_ptr(x), _ptr(x), _ptr(twp), _ptr(consts),
                                   1, 1, logn, None) == 1
    for logn in (7, 15):
        assert libs["tensor3"].fwd_tensor3(_ptr(x), _ptr(x), _ptr(twp),
                                           _ptr(consts), 1, 1, logn, 0,
                                           None) == 1
