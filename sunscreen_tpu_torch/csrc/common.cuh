// Shared device code of the u32-engine NTT kernels (ntt.cu, tensor3.cu,
// inv_ks.cu): modular helpers, the radix-2 transforms on shared memory, and
// the map from the plan's flat NTT domain to the butterflies' bit-reversed
// order.
//
// Tensors cross the C interface as int64 residues (values < 2^32). Per limb
// the plan uploads:
//   tw     [k][4][N] u32: psi_rev, its Shoup ratios, psi_inv_rev, its Shoup
//          ratios, where psi_rev[i] = psi^brev(i) and psi is the minimal
//          primitive 2N-th root of unity mod q;
//   consts [k][4] int64: q, floor(2^64 / q), N^-1 mod q, its Shoup ratio.
#pragma once

#include <cuda_runtime.h>

typedef unsigned int u32;
typedef unsigned long long u64;

struct Limb {
  u32 q;
  u64 m;  // floor(2^64 / q)
  u32 ninv, ninv_sh;
};

__device__ __forceinline__ Limb load_limb(const long long* consts, int limb) {
  const long long* c = consts + 4 * limb;
  Limb L;
  L.q = (u32)c[0];
  L.m = (u64)c[1];
  L.ninv = (u32)c[2];
  L.ninv_sh = (u32)c[3];
  return L;
}

// x mod q for any u64 x. qhat = floor(x m / 2^64) is at most 2 below
// floor(x / q), so r < 3q < 2^32 before the corrections.
__device__ __forceinline__ u32 reduce64(u64 x, u32 q, u64 m) {
  u64 r = x - __umul64hi(x, m) * q;
  if (r >= q) r -= q;
  if (r >= q) r -= q;
  return (u32)r;
}

// (x w) mod q for any u32 x and w < q < 2^30, w_sh = floor(w 2^32 / q)
// (Shoup/Harvey: the wrapped difference lies in [0, 2q)).
__device__ __forceinline__ u32 mul_shoup(u32 x, u32 w, u32 w_sh, u32 q) {
  u32 r = w * x - __umulhi(x, w_sh) * q;
  return r >= q ? r - q : r;
}

__device__ __forceinline__ u32 add_q(u32 a, u32 b, u32 q) {
  u32 s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ u32 sub_q(u32 a, u32 b, u32 q) {
  return a >= b ? a - b : a + q - b;
}

// Flat position p = j2 * n1 + j1 of the NTT domain (n1 = N / 128) holds the
// evaluation at psi * omega^J with J = j2 + 128 j1. The forward transform
// below leaves that value at bit-reversed index brev(J).
__device__ __forceinline__ int flat_to_br(int p, int logn) {
  const int log_n1 = logn - 7;
  const u32 J = (u32)((p >> log_n1) + ((p & ((1 << log_n1) - 1)) << 7));
  return (int)(__brev(J) >> (32 - logn));
}

// Forward negacyclic Cooley-Tukey transform (psi twiddles merged) of `nb`
// polys of N = 2^logn stored back to back in shared memory: natural order in,
// bit-reversed order out, values in [0, q). Callers sync before calling; the
// function syncs after every stage.
__device__ void fwd_smem(u32* a, int nb, int logn, const u32* __restrict__ tw,
                         const u32* __restrict__ tw_sh, u32 q) {
  const int half = 1 << (logn - 1);
  for (int logt = logn - 1; logt >= 0; --logt) {
    const int t = 1 << logt;
    const int m = half >> logt;  // groups in this stage
    for (int b = threadIdx.x; b < nb * half; b += blockDim.x) {
      const int bb = b & (half - 1);
      const int i = bb >> logt;
      u32* p = a + ((b >> (logn - 1)) << logn) + (i << (logt + 1)) +
               (bb & (t - 1));
      const u32 u = p[0];
      const u32 v = mul_shoup(p[t], __ldg(tw + m + i), __ldg(tw_sh + m + i), q);
      p[0] = add_q(u, v, q);
      p[t] = sub_q(u, v, q);
    }
    __syncthreads();
  }
}

// Inverse Gentleman-Sande transform with psi^-1 twiddles: bit-reversed order
// in, natural order out, WITHOUT the final 1/N (callers fold it into their
// store). Same sync contract as fwd_smem.
__device__ void inv_smem(u32* a, int nb, int logn, const u32* __restrict__ tw,
                         const u32* __restrict__ tw_sh, u32 q) {
  const int half = 1 << (logn - 1);
  for (int logt = 0; logt < logn; ++logt) {
    const int t = 1 << logt;
    const int h = half >> logt;  // groups in this stage
    for (int b = threadIdx.x; b < nb * half; b += blockDim.x) {
      const int bb = b & (half - 1);
      const int i = bb >> logt;
      u32* p = a + ((b >> (logn - 1)) << logn) + (i << (logt + 1)) +
               (bb & (t - 1));
      const u32 u = p[0];
      const u32 v = p[t];
      p[0] = add_q(u, v, q);
      p[t] = mul_shoup(sub_q(u, v, q), __ldg(tw + h + i), __ldg(tw_sh + h + i),
                       q);
    }
    __syncthreads();
  }
}

static inline int ntt_threads(int logn) {
  const int half = 1 << (logn - 1);
  return half < 1024 ? half : 1024;
}
