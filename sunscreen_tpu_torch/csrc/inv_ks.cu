// Keyswitch digit contraction fused into the inverse NTT of both key
// components.
//
// Replaces the Pallas kernel sunscreen_tpu/math/pmntt.py::_make_inv_ks
// (pallas_call at pmntt.py:500), reached through PallasMatmulNttPlan.inv_ks.
// For c in {0, 1}: out[:, c] = INTT(sum_i d_hat[:, i] * key_c[i] mod q), with
// d_hat [rows, kdig, k, N] and key_c [kdig, k, N] in the flat NTT domain
// (values < q) and out [rows, 2, k, N] in natural coefficient order.
//
// Design: one thread block per (row, limb). Each thread sums the kdig digit
// products of its positions for both key components in u64 registers
// (kdig * q^2 < 2^64 for kdig <= 16 and q < 2^30; the wrapper checks kdig),
// reduces once, and scatters the two sums into shared memory (2 * 32 KB at
// N = 8192) in the butterflies' bit-reversed order. Both polys are then
// inverse-transformed as one batch and stored with 1/N folded in. The
// [rows, 2, k, N] inner product never reaches device memory.
//
// Bound on the H100 at the main-path shape rows = 64, kdig = 7, k = 8,
// N = 8192, int64 residues: it reads 235 MB of digits and 7 MB of keys and
// writes 67 MB, about 0.09 ms at 3.35 TB/s. The contraction takes 2 * 7 * 2
// and the two transforms 2 * 3 * (N/2) * log2 N = 319,488 32-bit multiplies per
// (row, limb): 0.17 G in all, about 0.01 ms at 16.7 T/s. Bound by bytes.

#include "common.cuh"

__global__ void inv_ks_kernel(const long long* __restrict__ d,
                              const long long* __restrict__ k0,
                              const long long* __restrict__ k1,
                              long long* __restrict__ out,
                              const u32* __restrict__ tw,
                              const long long* __restrict__ consts, int kdig,
                              int k, int logn) {
  extern __shared__ u32 sm[];  // sum_i d_i k0_i | sum_i d_i k1_i
  const int n = 1 << logn;
  const int row = blockIdx.x / k, limb = blockIdx.x % k;
  const Limb L = load_limb(consts, limb);
  const size_t kn = (size_t)k * n;
  const long long* dsrc = d + (size_t)row * kdig * kn + (size_t)limb * n;
  const long long* k0src = k0 + (size_t)limb * n;
  const long long* k1src = k1 + (size_t)limb * n;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    u64 acc0 = 0, acc1 = 0;
    for (int i = 0; i < kdig; ++i) {
      const u64 dv = (u64)dsrc[i * kn + p];
      acc0 += dv * (u64)__ldg(k0src + i * kn + p);
      acc1 += dv * (u64)__ldg(k1src + i * kn + p);
    }
    const int s = flat_to_br(p, logn);
    sm[s] = reduce64(acc0, L.q, L.m);
    sm[n + s] = reduce64(acc1, L.q, L.m);
  }
  __syncthreads();
  const u32* t = tw + (size_t)limb * 4 * n;
  inv_smem(sm, 2, logn, t + 2 * n, t + 3 * n, L.q);
  long long* dst = out + (size_t)row * 2 * kn + (size_t)limb * n;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x)
    dst[(i >> logn) * kn + (i & (n - 1))] =
        mul_shoup(sm[i], L.ninv, L.ninv_sh, L.q);
}

// d [rows, kdig, k, N], k0/k1 [kdig, k, N] -> out [rows, 2, k, N]
extern "C" int inv_ks(const void* d, const void* k0, const void* k1, void* out,
                      const void* tw, const void* consts, int rows, int kdig,
                      int k, int logn, void* stream) {
  const int smem = (int)(2 * sizeof(u32) << logn);
  cudaFuncSetAttribute(inv_ks_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  inv_ks_kernel<<<rows * k, ntt_threads(logn), smem, (cudaStream_t)stream>>>(
      (const long long*)d, (const long long*)k0, (const long long*)k1,
      (long long*)out, (const u32*)tw, (const long long*)consts, kdig, k, logn);
  return (int)cudaGetLastError();
}
