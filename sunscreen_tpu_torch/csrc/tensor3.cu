// BFV tensor: four forward NTTs and the component product in one pass.
//
// Replaces the Pallas kernel sunscreen_tpu/math/pmntt.py::_make_fwd_tensor3
// with full=False (pallas_call at pmntt.py:715), reached through
// PallasMatmulNttPlan.fwd_tensor3. Input: the extended operand pair
// (a0, a1, b0, b1) [rows, 4, k, N] in coefficient order; output: the NTT-domain
// tensor (a0 b0, a0 b1 + a1 b0, a1 b1) mod q [rows, 3, k, N] in the plan's flat
// domain.
//
// Design: one thread block per (row, limb). The four polynomials of that limb
// sit in dynamic shared memory together (4 * 32 KB = 128 KB at N = 8192, so
// N <= 8192 here) and are transformed stage by stage as one batch. The
// component products are formed from shared memory and only the three tensor
// components are stored: the operands' NTT image never reaches device memory,
// which is what the Pallas kernel was for.
//
// Bound on the H100 at the main-path shape rows = 64, k = 15, N = 8192, int64
// residues: it reads 252 MB and writes 189 MB, about 0.13 ms at 3.35 TB/s.
// The four transforms take 4 * 159,744 32-bit multiplies per (row, limb),
// 0.61 G in all, about 0.04 ms at 16.7 T integer multiplies/s. Bound by bytes.

#include "common.cuh"

__global__ void fwd_tensor3_kernel(const long long* __restrict__ x,
                                   long long* __restrict__ out,
                                   const u32* __restrict__ tw,
                                   const long long* __restrict__ consts, int k,
                                   int logn) {
  extern __shared__ u32 sm[];  // a0 | a1 | b0 | b1
  const int n = 1 << logn;
  const int row = blockIdx.x / k, limb = blockIdx.x % k;
  const Limb L = load_limb(consts, limb);
  const size_t kn = (size_t)k * n;
  const long long* src = x + (size_t)row * 4 * kn + (size_t)limb * n;
  for (int i = threadIdx.x; i < 4 * n; i += blockDim.x)
    sm[i] = reduce64((u64)src[(i >> logn) * kn + (i & (n - 1))], L.q, L.m);
  __syncthreads();
  const u32* t = tw + (size_t)limb * 4 * n;
  fwd_smem(sm, 4, logn, t, t + n, L.q);
  long long* dst = out + (size_t)row * 3 * kn + (size_t)limb * n;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int s = flat_to_br(p, logn);
    u32 c0, c1, c2;
    tensor3_mod(sm[s], sm[n + s], sm[2 * n + s], sm[3 * n + s], L.q, L.m, c0,
                c1, c2);
    dst[p] = c0;
    dst[kn + p] = c1;
    dst[2 * kn + p] = c2;
  }
}

// x [rows, 4, k, N] -> out [rows, 3, k, N]
extern "C" int fwd_tensor3(const void* x, void* out, const void* tw,
                           const void* consts, int rows, int k, int logn,
                           void* stream) {
  const int smem = (int)(4 * sizeof(u32) << logn);
  cudaFuncSetAttribute(fwd_tensor3_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  fwd_tensor3_kernel<<<rows * k, ntt_threads(logn), smem,
                       (cudaStream_t)stream>>>(
      (const long long*)x, (long long*)out, (const u32*)tw,
      (const long long*)consts, k, logn);
  return (int)cudaGetLastError();
}
