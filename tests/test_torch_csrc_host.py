"""The transform kernels' CUDA sources (`csrc/ntt.cu`, `csrc/tensor3.cu`,
`csrc/transform.cuh`) compiled for the host and run against the plain
PyTorch twins.

A small header stands in for the CUDA runtime: one std::thread per CUDA
thread of a block (made once per launch; the blocks run one after
another), a std::barrier for `__syncthreads` and a sleeping one per
aligned group of lanes for `__syncwarp` and `__match_any_sync` (made at
first use), the block's dynamic shared memory as a byte array, static
`__shared__` variables as function statics, and the intrinsics the
kernels use (`__umulhi`, `__umul64hi`, `__brev`, `__ldg`, `__ldcg`, `__stcs`,
`__popc`, `__clz`, `__threadfence`, and `atomicAdd` and `atomicExch` on
u32 words). The
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
#include <atomic>
#include <barrier>
#include <condition_variable>
#include <cstddef>
#include <map>
#include <memory>
#include <mutex>
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
// Warp-level sync: the lanes of an aligned group of 2^k lanes (a mask such
// as 0xf << 4 or a full warp) share a barrier of their own, made at first
// use; values pass through per-block words, written before the group's
// barrier and read after it. A group's barrier sleeps at once while it
// waits: its few lanes meet often, and on a busy host std::barrier's
// spinning lanes took the cores the others needed (four times slower).
struct HostGroupBarrier {
  explicit HostGroupBarrier(int n) : size(n) {}
  void arrive_and_wait() {
    std::unique_lock<std::mutex> lock(mu);
    const unsigned g = phase;
    if (++count == size) {
      count = 0;
      ++phase;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return phase != g; });
    }
  }
  const int size;
  int count = 0;
  unsigned phase = 0;
  std::mutex mu;
  std::condition_variable cv;
};
struct HostWarps {
  int block = 0;
  std::mutex mu;
  std::map<std::pair<int, int>, std::unique_ptr<HostGroupBarrier>> groups;
  std::vector<unsigned> words;
};
inline thread_local HostWarps* host_warps = nullptr;
// a thread syncs the same group again and again: the last one is cached
inline thread_local unsigned host_group_mask = 0;
inline thread_local HostGroupBarrier* host_group_barrier = nullptr;
inline HostGroupBarrier& host_group(unsigned mask) {
  if (mask == host_group_mask && host_group_barrier)
    return *host_group_barrier;
  const int first = (int)(threadIdx.x & ~31u) + __builtin_ctz(mask);
  const int size = __builtin_popcount(mask);
  std::lock_guard<std::mutex> lock(host_warps->mu);
  auto& g = host_warps->groups[{first, size}];
  if (!g) {
    const int live = host_warps->block - first;
    g = std::make_unique<HostGroupBarrier>(live < size ? live : size);
  }
  host_group_mask = mask;
  host_group_barrier = g.get();
  return *g;
}
inline void __syncwarp(unsigned mask = 0xffffffffu) {
  host_group(mask).arrive_and_wait();
}
inline unsigned __match_any_sync(unsigned mask, unsigned v) {
  auto& g = host_group(mask);
  const int base = threadIdx.x & ~31u;
  host_warps->words[threadIdx.x] = v;
  g.arrive_and_wait();
  unsigned peers = 0;
  for (int l = 0; l < 32 && base + l < host_warps->block; ++l)
    if ((mask >> l & 1) && host_warps->words[base + l] == v) peers |= 1u << l;
  g.arrive_and_wait();
  return peers;
}
template <class T> inline T __ldcg(const T* p) { return *p; }
template <class T> inline void __stcs(T* p, T v) { *p = v; }
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}
inline unsigned atomicExch(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).exchange(v);
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return uint4{x, y, z, w};
}
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
  // one thread per CUDA thread of a block, made once per launch: the
  // threads run the blocks one after another, meeting on the block's
  // barrier after each
  std::vector<char> shared(smem);
  std::barrier<> barrier(block);
  HostWarps warps;
  warps.block = block;
  warps.words.resize(block);
  std::vector<std::thread> threads;
  for (int t = 0; t < block; ++t)
    threads.emplace_back([&, t] {
      threadIdx.x = t; blockDim.x = block; gridDim = grid;
      host_barrier = &barrier; host_smem = shared.data();
      host_warps = &warps; host_group_barrier = nullptr;
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          blockIdx.x = bx; blockIdx.y = by;
          f(args...);
          barrier.arrive_and_wait();
        }
    });
  for (auto& th : threads) th.join();
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
