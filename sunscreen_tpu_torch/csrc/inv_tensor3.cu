// BFV tensor product fused into the inverse NTT of its three components.
//
// Replaces the Pallas kernel sunscreen_tpu/math/pmntt.py::_make_inv_tensor3
// (pallas_call at pmntt.py:427), reached through
// PallasMatmulNttPlan.inv_tensor3, which bfv/ops.py::multiply runs when
// SUNSCREEN_TPU_FUSE_FT3=0 and SUNSCREEN_TPU_FUSE_T3=1 (B12). Input: the two
// 2-component operands a, b in the plan's flat NTT domain (values < q), rows
// of [2, k, N] with row strides sa, sb; output: the coefficient-domain tensor
// INTT(a0 b0, a0 b1 + a1 b0, a1 b1) [rows, 3, k, N] in natural order with 1/N
// folded in, as ntt_inv would give on the NTT-domain tensor.
//
// Design: one thread block per (row, limb). Each thread forms the three
// component products of its positions (tensor3_mod) and scatters them into
// shared memory in the butterflies' bit-reversed order (flat_to_br, the map
// ntt_inv reads through). The three polys are inverse-transformed as one batch
// and stored once, coalesced. Three polys take 3 * 4 * N bytes of shared
// memory: 96 KB at N = 8192, 192 KB at N = 16384, within the 227 KB a block
// may hold, so the kernel covers every N of the plan (the wrapper checks
// INV_TENSOR3_MAX_N). The NTT-domain tensor never reaches device memory.
//
// Bound on the H100 at the main-path shape rows = 64, k = 15, N = 8192, int64
// residues: it reads 252 MB and writes 189 MB, about 0.13 ms at 3.35 TB/s.
// The three products take 8 and the three transforms 3 * (3 * (N/2) * log2 N
// + 3 N) 32-bit multiplies per (row, limb) column of N: 0.55 G in all, about
// 0.03 ms at 16.7 T/s. Bound by bytes.

#include "common.cuh"

__global__ void inv_tensor3_kernel(const long long* __restrict__ a,
                                   const long long* __restrict__ b,
                                   long long* __restrict__ out,
                                   const u32* __restrict__ tw,
                                   const long long* __restrict__ consts, int k,
                                   int logn, long long sa, long long sb) {
  extern __shared__ u32 sm[];  // c0 | c1 | c2, bit-reversed order
  const int n = 1 << logn;
  const int row = blockIdx.x / k, limb = blockIdx.x % k;
  const Limb L = load_limb(consts, limb);
  const size_t kn = (size_t)k * n;
  const long long* ar = a + row * sa + (size_t)limb * n;
  const long long* br = b + row * sb + (size_t)limb * n;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int s = flat_to_br(p, logn);
    tensor3_mod((u64)ar[p], (u64)ar[kn + p], (u64)br[p], (u64)br[kn + p], L.q,
                L.m, sm[s], sm[n + s], sm[2 * n + s]);
  }
  __syncthreads();
  const u32* t = tw + (size_t)limb * 4 * n;
  inv_smem(sm, 3, logn, t + 2 * n, t + 3 * n, L.q);
  long long* dst = out + (size_t)row * 3 * kn + (size_t)limb * n;
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x)
    dst[(i >> logn) * kn + (i & (n - 1))] =
        mul_shoup(sm[i], L.ninv, L.ninv_sh, L.q);
}

// a, b rows of [2, k, N] (row strides sa, sb) -> out [rows, 3, k, N]
extern "C" int inv_tensor3(const void* a, const void* b, void* out,
                           const void* tw, const void* consts, int rows, int k,
                           int logn, int sa, int sb, void* stream) {
  const int smem = (int)(3 * sizeof(u32) << logn);
  cudaFuncSetAttribute(inv_tensor3_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  inv_tensor3_kernel<<<rows * k, ntt_threads(logn), smem,
                       (cudaStream_t)stream>>>(
      (const long long*)a, (const long long*)b, (long long*)out,
      (const u32*)tw, (const long long*)consts, k, logn, sa, sb);
  return (int)cudaGetLastError();
}
