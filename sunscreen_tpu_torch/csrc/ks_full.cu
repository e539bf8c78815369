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
// Bound on the H100 (int64 residues in and out):
//   B14 at rows = 64, kdig = 7, k = 8, N = 8192 reads 29 MB of digits and
//   7 MB of keys and writes 67 MB: 0.031 ms at 3.35 TB/s; 7 forward and 2
//   inverse transforms and 14 products per (row, limb) are 0.88 G 32-bit
//   multiplies, 0.052 ms at 16.7 T/s. Bound by operations.
//   B15 at rows = 64, kdig = 6, k = 4, N = 1024 moves 17 MB (5.1 us) and
//   does 0.039 G multiplies (2.3 us). Bound by bytes.
//
// Design (transform.cuh, as ntt_fwd and inv_ks): one (row, limb) task a
// block, the k limbs of a row on neighbouring blocks, so that B14's shared
// raw digit row hits in L2. Each digit is loaded as coalesced int64 rows and
// reduced below 2q (a 32-bit Barrett step for words below 2^32, as B2 does),
// forward-transformed in registers (radix-16 groups, 3 exchanges at
// N = 8192, lazy butterflies, values below 4q), and taken through the flat
// permutation that ntt_fwd makes before its store, so that each thread holds
// flat positions tau + s T and its key loads are coalesced too. Each value
// is multiplied 32 x 32 -> 64 bits by both key words and added to the
// component sums, which are reduced below 2q by 32-bit steps (red2q) after
// every digit, so any digit count is exact (4q q + 2q < 2^63). After the
// last digit each component runs through the register-resident inverse
// transform (entered through from_flat, as inv_ks does) and is stored with
// 1/N folded in. Neither the digits' NTT image nor, for B14, their k-fold
// broadcast reaches device memory.
//
// Two block shapes. SPLIT (N <= 4096; the TFHE step has only 256 tasks of
// N = 1024, too few threads to hide the loads with one transform's threads
// a task): 2 N / 16 threads (2 N / 8 at N = 256), two slots of a
// transform's threads, B5's split shape. Slot j forward-transforms digits j,
// j + 2, ... side by side with the other and sums its own digits in
// registers; the two slots' sums are added through shared memory (each
// slot's two exchange buffers hold its two component sums), and slot c
// gathers component c in the inverse's input layout and transforms it, the
// two side by side. Shared memory 4 N words. ptxas may take 128 registers
// a thread here: at 64 the sums spill and the TFHE step ran slower on the
// H100, as it did with one slot a digit (up to 512 threads a block).
// Otherwise (N >= 8192): N / 16 threads, the digits one after another; the
// first component's sums stay in registers, the second's in shared memory
// (each thread reading back only its own words), and the two components
// are inverse-transformed one after the other. Shared memory 3 N words:
// 96 KB at N = 8192, so two 512-thread blocks share an SM at 64 registers
// a thread.

#include "transform.cuh"

// a = a + v w mod q, below 2q, for a < 2q, v < 4q and w < q.
template <int E>
__device__ __forceinline__ void mul_acc(u32 (&a)[E], const u32 (&v)[E],
                                        const long long* __restrict__ w,
                                        int stride, const Red32& R) {
#pragma unroll
  for (int s = 0; s < E; ++s)
    a[s] = red2q(a[s] + (u64)v[s] * (u32)__ldg(w + s * stride), R);
}

// SPLIT: 2 T <= 512 threads, and up to 128 registers a thread
template <int LOGN, bool PER_LIMB, bool SPLIT>
__global__ void __launch_bounds__(SPLIT ? 512 : tf::Shape<LOGN>::T,
                                  SPLIT ? 1 : 1024 / tf::Shape<LOGN>::T)
    ks_full_kernel(const long long* __restrict__ d,
                   const long long* __restrict__ k0,
                   const long long* __restrict__ k1,
                   long long* __restrict__ out, const u64* __restrict__ twp,
                   const long long* __restrict__ consts, int kdig, int k) {
  using S = tf::Shape<LOGN>;
  constexpr int N = S::N, E = S::E, T = S::T;
  // SPLIT: [2 slots][2][N] exchange buffers; else exchange [2][N] | stash
  // [N]
  extern __shared__ u32 sm[];
  const int row = blockIdx.x / k, limb = blockIdx.x % k;
  const Limb L = load_limb(consts, limb);
  const Red32 R = red32(L.q, L.m);
  const size_t kn = (size_t)k * N;
  const u32 t = threadIdx.x, slot = SPLIT ? t / T : 0, tau = t % T;
  // digit i of the task at dig + i * dstride: the row's raw poly, or this
  // limb's residues
  const size_t dstride = PER_LIMB ? kn : N;
  const long long* dig =
      d + (size_t)row * kdig * dstride + (PER_LIMB ? limb * N : 0) + tau;
  const long long* key0 = k0 + (size_t)limb * N + tau;
  const long long* key1 = k1 + (size_t)limb * N + tau;
  const u64* fw = twp + (size_t)limb * 2 * N;
  const u64* iw = fw + N;
  long long* dst = out + (size_t)row * 2 * kn + (size_t)limb * N + tau;
  u32 v[E];
  if constexpr (SPLIT) {
    u32 a0[E], a1[E];
#pragma unroll
    for (int s = 0; s < E; ++s) a0[s] = a1[s] = 0;
    tf::Buffers<2> bufs{sm + slot * 2 * N, N, 0};
    // both slots run every round (with kdig odd, slot 1 redoes the last
    // digit and adds nothing): all threads reach every barrier
#pragma unroll 1
    for (int i0 = 0; i0 < kdig; i0 += 2) {
      const int i = i0 + slot;
      tf::load_mod(v, dig + (i < kdig ? i : kdig - 1) * dstride, T, L);
      tf::fwd<LOGN>(v, bufs, tau, fw, L.q);
      tf::to_flat<LOGN>(v, bufs.next(), tau);
      if (i < kdig) {
        mul_acc(a0, v, key0 + i * kn, T, R);
        mul_acc(a1, v, key1 + i * kn, T, R);
      }
    }
    __syncthreads();  // every exchange read before the sums overwrite
    const u32 w0 = tf::swz<LOGN, true>(tau);
#pragma unroll
    for (int s = 0; s < E; ++s) {
      const u32 w = w0 ^ tf::swz<LOGN, true>(s * T);
      sm[slot * 2 * N + w] = a0[s];
      sm[slot * 2 * N + N + w] = a1[s];
    }
    __syncthreads();
    // component `slot`, the two slots' sums added, in from_flat_read's
    // layout
    const u32 r0 = tf::swz<LOGN, true>(tf::flat_of<LOGN>(tau << S::R));
#pragma unroll
    for (int s = 0; s < E; ++s) {
      const u32* src = sm + slot * N + (r0 ^ tf::swz<LOGN, true>(
                                                tf::flat_of<LOGN>(s)));
      v[s] = csub(src[0] + src[2 * N], 2 * L.q);
    }
    __syncthreads();  // both gathers done before the exchanges overwrite
    tf::inv<LOGN>(v, bufs, tau, iw, L.q);
#pragma unroll
    for (int s = 0; s < E; ++s)
      dst[slot * kn + s * T] = mul_shoup(v[s], L.ninv, L.ninv_sh, L.q);
  } else {
    u32 a0[E];
    u32* stash = sm + 2 * N + tau;  // [E][T], own words
#pragma unroll
    for (int s = 0; s < E; ++s) {
      a0[s] = 0;
      stash[s * T] = 0;
    }
    tf::Buffers<2> bufs{sm, N, 0};
#pragma unroll 1
    for (int i = 0; i < kdig; ++i) {
      tf::load_mod(v, dig + i * dstride, T, L);
      tf::fwd<LOGN>(v, bufs, tau, fw, L.q);
      tf::to_flat<LOGN>(v, bufs.next(), tau);
      mul_acc(a0, v, key0 + i * kn, T, R);
      const long long* w = key1 + i * kn;
#pragma unroll
      for (int s = 0; s < E; ++s)
        stash[s * T] =
            red2q(stash[s * T] + (u64)v[s] * (u32)__ldg(w + s * T), R);
    }
#pragma unroll 1
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int s = 0; s < E; ++s) v[s] = c ? stash[s * T] : a0[s];
      tf::from_flat<LOGN>(v, bufs.next(), tau);
      tf::inv<LOGN>(v, bufs, tau, iw, L.q);
#pragma unroll
      for (int s = 0; s < E; ++s)
        dst[c * kn + s * T] = mul_shoup(v[s], L.ninv, L.ninv_sh, L.q);
    }
  }
}

template <int LOGN, bool PER_LIMB>
static int launch(const void* d, const void* k0, const void* k1, void* out,
                  const void* twp, const void* consts, int rows, int kdig,
                  int k, void* stream) {
  using S = tf::Shape<LOGN>;
  constexpr bool SPLIT = 2 * S::T <= 512;
  const int smem = (int)((SPLIT ? 4 : 3) * sizeof(u32) * S::N);
  auto kern = ks_full_kernel<LOGN, PER_LIMB, SPLIT>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  kern<<<rows * k, (SPLIT ? 2 : 1) * S::T, smem, (cudaStream_t)stream>>>(
      (const long long*)d, (const long long*)k0, (const long long*)k1,
      (long long*)out, (const u64*)twp, (const long long*)consts, kdig, k);
  return (int)cudaGetLastError();
}

// d [rows, kdig, N] (per_limb = 0) or [rows, kdig, k, N] (per_limb = 1),
// k0/k1 [kdig, k, N] -> out [rows, 2, k, N]; twp [k, 2, N] u64 twiddle pairs
// (math/pmntt.py::twiddle_pairs)
extern "C" int ks_full(const void* d, const void* k0, const void* k1,
                       void* out, const void* twp, const void* consts,
                       int rows, int kdig, int k, int logn, int per_limb,
                       void* stream) {
  TF_DISPATCH(logn, (per_limb ? launch<LOGN, true>(d, k0, k1, out, twp,
                                                   consts, rows, kdig, k,
                                                   stream)
                              : launch<LOGN, false>(d, k0, k1, out, twp,
                                                    consts, rows, kdig, k,
                                                    stream)))
}
