// Keyswitch megakernel: coefficient-domain digits -> forward NTT under the
// block's limb, contraction with both key components, two inverse NTTs.
//
// Replaces the Pallas kernel sunscreen_tpu/math/pmntt.py::_make_ks_full
// (pallas_call at pmntt.py:620) in both its uses:
//   per_limb = 0 (B14): PallasMatmulNttPlan.ks_full, BFV's keyswitch under
//     SUNSCREEN_TPU_FUSE_KSFULL=1: d [rows, kdig, N] holds one raw u32 poly
//     per digit, read under every limb;
//   per_limb = 1 (B15): PallasMatmulNttPlan.ks_full_limbs, TFHE's
//     blind-rotation step under SUNSCREEN_TPU_TFHE_KSFULL=1: d [rows, kdig,
//     k, N] holds each limb's own digit residues.
// For c in {0, 1}: out[:, c] = INTT(sum_i NTT(d_i) key_c[i] mod q), with keys
// [kdig, k, N] in the plan's flat NTT domain and out [rows, 2, k, N] in
// natural coefficient order.
//
// Design: one thread block per (row, limb). Shared memory holds one digit
// poly and the two accumulators, all u32: 12 N bytes, 96 KB at N = 8192 and
// 192 KB at N = 16384, within the 227 KB a block may use, so every N of the
// plan is served. For each digit the block loads the poly, reducing every
// value with a 64-bit Barrett on load (exact for any u32, as B2 is), runs the
// radix-2 forward transform in place, and each thread then walks flat
// positions p: it reads the transformed value at slot flat_to_br(p) and both
// keys at p (coalesced), and adds both products into the accumulators at the
// same slot, reduced mod q after every digit, so any digit count is exact.
// The accumulators end in the bit-reversed order inv_smem takes; both are
// inverse-transformed as one batch and stored once with 1/N folded in. The
// NTT image of the digits (and, for B14, their k-fold broadcast) never
// reaches device memory.
//
// Bound on the H100 (int64 residues in and out):
//   B14 at rows = 64, kdig = 7, k = 8, N = 8192 reads 29 MB of digits and
//   7 MB of keys and writes 67 MB: 0.031 ms at 3.35 TB/s; 7 forward and 2
//   inverse transforms and 14 products per (row, limb) are 0.88 G 32-bit
//   multiplies, 0.052 ms at 16.7 T/s. Bound by operations.
//   B15 at rows = 64, kdig = 6, k = 4, N = 1024 moves 17 MB (5.1 us) and
//   does 0.039 G multiplies (2.3 us). Bound by bytes.
// The transforms run one digit after another inside the block; the reduction
// per digit costs two Barrett steps per slot against the transform's log2 N
// butterflies.

#include "common.cuh"

template <bool PER_LIMB>
__global__ void ks_full_kernel(const long long* __restrict__ d,
                               const long long* __restrict__ k0,
                               const long long* __restrict__ k1,
                               long long* __restrict__ out,
                               const u32* __restrict__ tw,
                               const long long* __restrict__ consts,
                               int kdig, int k, int logn) {
  extern __shared__ u32 sm[];  // digit | sum_i d_i k0_i | sum_i d_i k1_i
  const int n = 1 << logn;
  const int row = blockIdx.x / k, limb = blockIdx.x % k;
  const Limb L = load_limb(consts, limb);
  const size_t kn = (size_t)k * n;
  const u32* t = tw + (size_t)limb * 4 * n;
  u32* dig = sm;
  u32* acc = sm + n;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) acc[i] = 0;
  for (int i = 0; i < kdig; ++i) {
    const long long* src =
        PER_LIMB ? d + ((size_t)row * kdig + i) * kn + (size_t)limb * n
                 : d + ((size_t)row * kdig + i) * n;
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      dig[j] = reduce64((u64)src[j], L.q, L.m);
    __syncthreads();
    fwd_smem(dig, 1, logn, t, t + n, L.q);
    const long long* k0i = k0 + (size_t)i * kn + (size_t)limb * n;
    const long long* k1i = k1 + (size_t)i * kn + (size_t)limb * n;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const int s = flat_to_br(p, logn);
      const u64 y = dig[s];
      acc[s] = reduce64(acc[s] + y * (u64)__ldg(k0i + p), L.q, L.m);
      acc[n + s] = reduce64(acc[n + s] + y * (u64)__ldg(k1i + p), L.q, L.m);
    }
    __syncthreads();  // the next digit's load overwrites dig
  }
  inv_smem(acc, 2, logn, t + 2 * n, t + 3 * n, L.q);
  long long* dst = out + (size_t)row * 2 * kn + (size_t)limb * n;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x)
    dst[(i >> logn) * kn + (i & (n - 1))] =
        mul_shoup(acc[i], L.ninv, L.ninv_sh, L.q);
}

// d [rows, kdig, N] (per_limb = 0) or [rows, kdig, k, N] (per_limb = 1),
// k0/k1 [kdig, k, N] -> out [rows, 2, k, N]
extern "C" int ks_full(const void* d, const void* k0, const void* k1,
                       void* out, const void* tw, const void* consts,
                       int rows, int kdig, int k, int logn, int per_limb,
                       void* stream) {
  const int smem = (int)(3 * sizeof(u32) << logn);
  void (*kern)(const long long*, const long long*, const long long*,
               long long*, const u32*, const long long*, int, int, int) =
      per_limb ? ks_full_kernel<true> : ks_full_kernel<false>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  kern<<<rows * k, ntt_threads(logn), smem, (cudaStream_t)stream>>>(
      (const long long*)d, (const long long*)k0, (const long long*)k1,
      (long long*)out, (const u32*)tw, (const long long*)consts, kdig, k,
      logn);
  return (int)cudaGetLastError();
}
