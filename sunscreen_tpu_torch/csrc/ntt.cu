// Forward, broadcast-forward and inverse negacyclic NTT over u32 RNS limbs.
//
// Replaces the Pallas kernel sunscreen_tpu/math/pmntt.py::_make_transform
// (pallas_call at pmntt.py:354) in its three uses: PallasMatmulNttPlan.fwd
// (inverse=False), .fwd_broadcast (broadcast=True) and .inv (inverse=True).
// The output domain is the same: flat position j2 * n1 + j1 holds natural
// NTT index j2 + 128 j1; the inverse returns natural coefficient order with
// 1/N folded in.
//
// Design: one thread block per (row, limb) polynomial. The block loads the
// polynomial into shared memory (32 KB at N = 8192), reducing every input
// mod q, so fwd and fwd_broadcast are exact for any u32 value. It runs the
// log2 N radix-2 stages there with Shoup multiplies (__umulhi) on per-limb
// twiddle tables that the plan uploads once, and stores to device memory
// once, coalesced, through the flat-domain permutation.
//
// Bound on the H100 at the main-path shapes (int64 residues in and out):
// fwd / inv on [256, 15, 8192] move 2 * 252 MB, about 0.15 ms at 3.35 TB/s;
// their 3 * (N/2) * log2 N = 159,744 32-bit multiplies per polynomial make
// 0.61 G multiplies, about 0.04 ms at 16.7 T integer multiplies/s. So they
// are bound by bytes. fwd_broadcast on [448, 8192] -> [448, 8, 8192] reads
// 29 MB and writes 235 MB. The design reads and writes each residue once;
// the int64 storage doubles those bytes against u32 storage, which a later
// change can narrow.

#include "common.cuh"

__global__ void ntt_fwd_kernel(const long long* __restrict__ x,
                               long long* __restrict__ out,
                               const u32* __restrict__ tw,
                               const long long* __restrict__ consts, int k,
                               int logn, int broadcast) {
  extern __shared__ u32 sm[];
  const int n = 1 << logn;
  const int row = blockIdx.x / k, limb = blockIdx.x % k;
  const Limb L = load_limb(consts, limb);
  // broadcast: every limb of a row transforms the row's single raw poly
  const long long* src = x + (size_t)(broadcast ? row : blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    sm[i] = reduce64((u64)src[i], L.q, L.m);
  __syncthreads();
  const u32* t = tw + (size_t)limb * 4 * n;
  fwd_smem(sm, 1, logn, t, t + n, L.q);
  long long* dst = out + (size_t)blockIdx.x * n;
  for (int p = threadIdx.x; p < n; p += blockDim.x)
    dst[p] = sm[flat_to_br(p, logn)];
}

__global__ void ntt_inv_kernel(const long long* __restrict__ x,
                               long long* __restrict__ out,
                               const u32* __restrict__ tw,
                               const long long* __restrict__ consts, int k,
                               int logn) {
  extern __shared__ u32 sm[];
  const int n = 1 << logn;
  const int limb = blockIdx.x % k;
  const Limb L = load_limb(consts, limb);
  const long long* src = x + (size_t)blockIdx.x * n;
  for (int p = threadIdx.x; p < n; p += blockDim.x)
    sm[flat_to_br(p, logn)] = reduce64((u64)src[p], L.q, L.m);
  __syncthreads();
  const u32* t = tw + (size_t)limb * 4 * n;
  inv_smem(sm, 1, logn, t + 2 * n, t + 3 * n, L.q);
  long long* dst = out + (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    dst[i] = mul_shoup(sm[i], L.ninv, L.ninv_sh, L.q);
}

// x [rows, k, N] (or [rows, N] when broadcast) -> out [rows, k, N]
extern "C" int ntt_fwd(const void* x, void* out, const void* tw,
                       const void* consts, int rows, int k, int logn,
                       int broadcast, void* stream) {
  const int smem = (int)(sizeof(u32) << logn);
  cudaFuncSetAttribute(ntt_fwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  ntt_fwd_kernel<<<rows * k, ntt_threads(logn), smem, (cudaStream_t)stream>>>(
      (const long long*)x, (long long*)out, (const u32*)tw,
      (const long long*)consts, k, logn, broadcast);
  return (int)cudaGetLastError();
}

// x [rows, k, N] flat NTT domain -> out [rows, k, N] natural coefficients
extern "C" int ntt_inv(const void* x, void* out, const void* tw,
                       const void* consts, int rows, int k, int logn,
                       void* stream) {
  const int smem = (int)(sizeof(u32) << logn);
  cudaFuncSetAttribute(ntt_inv_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  ntt_inv_kernel<<<rows * k, ntt_threads(logn), smem, (cudaStream_t)stream>>>(
      (const long long*)x, (long long*)out, (const u32*)tw,
      (const long long*)consts, k, logn);
  return (int)cudaGetLastError();
}
