// BFV tensor: four forward NTTs and the component product in one pass,
// optionally followed by the three inverse NTTs.
//
// Replaces the Pallas kernel sunscreen_tpu/math/pmntt.py::_make_fwd_tensor3
// (pallas_call at pmntt.py:715), reached through
// PallasMatmulNttPlan.fwd_tensor3, in both of its variants. Input: the
// extended operand pair (a0, a1, b0, b1) [rows, 4, k, N] in coefficient
// order. With full = 0 (B4) the output is the NTT-domain tensor
// (a0 b0, a0 b1 + a1 b0, a1 b1) mod q [rows, 3, k, N] in the plan's flat
// domain; with full = 1 (B13, SUNSCREEN_TPU_FUSE_TFULL=1) it is that tensor
// inverse-transformed, in natural coefficient order with 1/N folded in, as
// ntt_inv would give on B4's output.
//
// Design: one thread block per (row, limb). The four polynomials of that limb
// sit in dynamic shared memory together (4 * 32 KB = 128 KB at N = 8192, so
// N <= 8192 here) and are transformed stage by stage as one batch. The
// component products are formed from shared memory. B4 stores the three
// tensor components through the flat-domain permutation. B13 writes them back
// in place over the first three polynomials: the forward transform leaves
// bit-reversed order, which is what the inverse butterflies read, so no
// permutation is needed at all. The three polys are inverse-transformed as
// one batch and stored once, coalesced. Neither the operands' NTT image nor,
// in B13, the NTT-domain tensor ever reaches device memory.
//
// Bound on the H100 at the main-path shape rows = 64, k = 15, N = 8192, int64
// residues: it reads 252 MB and writes 189 MB, about 0.13 ms at 3.35 TB/s.
// The four transforms take 4 * 159,744 32-bit multiplies per (row, limb),
// 0.61 G in all, about 0.04 ms at 16.7 T integer multiplies/s; B13 adds
// three inverse transforms and the 1/N scaling, 1.11 G in all, 0.07 ms. Both
// are bound by bytes.

#include "common.cuh"

template <bool FULL>
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
  if (!FULL) {
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const int s = flat_to_br(p, logn);
      u32 c0, c1, c2;
      tensor3_mod(sm[s], sm[n + s], sm[2 * n + s], sm[3 * n + s], L.q, L.m,
                  c0, c1, c2);
      dst[p] = c0;
      dst[kn + p] = c1;
      dst[2 * kn + p] = c2;
    }
    return;
  }
  // each thread reads all four operands of its slots before writing them
  for (int s = threadIdx.x; s < n; s += blockDim.x)
    tensor3_mod(sm[s], sm[n + s], sm[2 * n + s], sm[3 * n + s], L.q, L.m,
                sm[s], sm[n + s], sm[2 * n + s]);
  __syncthreads();
  inv_smem(sm, 3, logn, t + 2 * n, t + 3 * n, L.q);
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x)
    dst[(i >> logn) * kn + (i & (n - 1))] =
        mul_shoup(sm[i], L.ninv, L.ninv_sh, L.q);
}

// x [rows, 4, k, N] -> out [rows, 3, k, N]; full selects B13 over B4
extern "C" int fwd_tensor3(const void* x, void* out, const void* tw,
                           const void* consts, int rows, int k, int logn,
                           int full, void* stream) {
  const int smem = (int)(4 * sizeof(u32) << logn);
  auto kernel = full ? fwd_tensor3_kernel<true> : fwd_tensor3_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  kernel<<<rows * k, ntt_threads(logn), smem, (cudaStream_t)stream>>>(
      (const long long*)x, (long long*)out, (const u32*)tw,
      (const long long*)consts, k, logn);
  return (int)cudaGetLastError();
}
