// Keyswitch digit contraction fused into the inverse NTT of both key
// components.
//
// Replaces the Pallas kernel sunscreen_tpu/math/pmntt.py::_make_inv_ks
// (pallas_call at pmntt.py:500), reached through PallasMatmulNttPlan.inv_ks.
// For c in {0, 1}: out[:, c] = INTT(sum_i d_hat[:, i] * key_c[i] mod q), with
// d_hat [rows, kdig, k, N] and key_c [kdig, k, N] in the flat NTT domain
// (values < q) and out [rows, 2, k, N] in natural coefficient order.
//
// Bound on the H100 at the main-path shape rows = 64, kdig = 7, k = 8,
// N = 8192, int64 residues: it reads 235 MB of digits and 7 MB of keys and
// writes 67 MB, about 0.09 ms at 3.35 TB/s. The contraction takes 2 * 7 * 2
// and the two transforms 2 * 3 * (N/2) * log2 N = 319,488 32-bit multiplies per
// (row, limb): 0.17 G in all, about 0.01 ms at 16.7 T/s. Bound by bytes.
//
// Design (transform.cuh, as ntt_inv): one (row, limb) task a block. Each
// digit word is read once, as coalesced int64 rows, and multiplied by both
// key words, 32 x 32 -> 64 bits (every operand is below q < 2^30); each
// component sums in a u64 (kdig q^2 < 2^64 for kdig <= 16; the wrapper
// checks kdig), reduced once below 2q by 32-bit steps (red2q). Each
// component then runs through the register-resident inverse transform
// (radix-16 groups, 3 exchanges at N = 8192, lazy butterflies, one 8-byte
// load of a twiddle and its Shoup ratio) and is stored with 1/N folded in
// as coalesced int64 rows.
//
// Two block shapes. SPLIT (N <= 4096): 2 N / 16 threads (2 N / 8 at
// N = 256), each contracting half of a transform thread's positions, four
// at a time, for both components and writing the sums straight into each
// component's flat-domain exchange buffer; then each half of the block
// transforms one component, the two side by side. The TFHE step has only
// 256 tasks of N = 1024: with one transform's threads a task, too few
// loads are in flight to hide their latency. Shared memory: two buffers a
// component, 4 N words. Otherwise (N >= 8192, where 2 N / 16 threads
// would exceed 512, and a 1024-thread block ran slower on the main path
// on the H100): N / 16 threads, each contracting its own 16 positions, two
// at a time, for both components; the first component's sums stay in
// registers, the second's wait in shared memory (each thread reading back
// only its own words) until the first is stored. Shared memory 3 N words:
// 96 KB at N = 8192, so two 512-thread blocks share an SM at 64 registers
// a thread.

#include "transform.cuh"

// c0[u], c1[u] = sum_i d_i key_c,i mod q, below 2q, at the G positions
// u * step (u < G) from d, k0, k1 (digits kn apart).
template <int G>
__device__ __forceinline__ void contract(const long long* __restrict__ d,
                                         const long long* __restrict__ k0,
                                         const long long* __restrict__ k1,
                                         size_t kn, int kdig, int step,
                                         const Red32& R, u32 (&c0)[G],
                                         u32 (&c1)[G]) {
  u64 a0[G], a1[G];
#pragma unroll
  for (int u = 0; u < G; ++u) a0[u] = a1[u] = 0;
#pragma unroll(4 / G > 1 ? 4 / G : 1)
  for (int i = 0; i < kdig; ++i) {
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const size_t o = i * kn + u * step;
      const u32 dv = (u32)d[o];
      a0[u] += (u64)dv * (u32)__ldg(k0 + o);
      a1[u] += (u64)dv * (u32)__ldg(k1 + o);
    }
  }
#pragma unroll
  for (int u = 0; u < G; ++u) {
    c0[u] = red2q(a0[u], R);
    c1[u] = red2q(a1[u], R);
  }
}

template <int LOGN, bool SPLIT>
__global__ void __launch_bounds__((SPLIT ? 2 : 1) * tf::Shape<LOGN>::T,
                                  1024 / ((SPLIT ? 2 : 1) *
                                          tf::Shape<LOGN>::T))
    inv_ks_kernel(const long long* __restrict__ d,
                  const long long* __restrict__ k0,
                  const long long* __restrict__ k1,
                  long long* __restrict__ out, const u64* __restrict__ twp,
                  const long long* __restrict__ consts, int kdig, int k) {
  using S = tf::Shape<LOGN>;
  constexpr int N = S::N, E = S::E, T = S::T;
  // SPLIT: exchange [2 components][2][N]; else exchange [2][N] | stash [N]
  extern __shared__ u32 sm[];
  const int row = blockIdx.x / k, limb = blockIdx.x % k;
  const Limb L = load_limb(consts, limb);
  const Red32 R = red32(L.q, L.m);
  const size_t kn = (size_t)k * N;
  const u32 t = threadIdx.x, c = SPLIT ? t / T : 0, tau = t % T;
  const size_t src = (size_t)row * kdig * kn + (size_t)limb * N + t;
  const long long* ksrc0 = k0 + (size_t)limb * N + t;
  const long long* ksrc1 = k1 + (size_t)limb * N + t;
  u32 v[E];
  if constexpr (SPLIT) {
    constexpr int G = 4;
#pragma unroll
    for (int s0 = 0; s0 < E / 2; s0 += G) {
      u32 c0[G], c1[G];
      const int o = s0 * 2 * T;
      contract<G>(d + src + o, ksrc0 + o, ksrc1 + o, kn, kdig, 2 * T, R, c0,
                  c1);
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const u32 w = tf::swz<LOGN, true>(t + (s0 + u) * 2 * T);
        sm[w] = c0[u];
        sm[2 * N + w] = c1[u];
      }
    }
    __syncthreads();
  } else {
    constexpr int G = 2;
    u32* stash = sm + 2 * N + tau;  // [E][T], own words
#pragma unroll
    for (int s0 = 0; s0 < E; s0 += G) {
      u32 c0[G], c1[G];
      const int o = s0 * T;
      contract<G>(d + src + o, ksrc0 + o, ksrc1 + o, kn, kdig, T, R, c0, c1);
#pragma unroll
      for (int u = 0; u < G; ++u) {
        v[s0 + u] = c0[u];
        stash[(s0 + u) * T] = c1[u];
      }
    }
  }
  tf::Buffers<2> bufs{sm + c * 2 * N, N, 0};
  const u64* tw = twp + ((size_t)limb * 2 + 1) * N;
  long long* dst = out + (size_t)row * 2 * kn + (size_t)limb * N + tau;
  // SPLIT: component c; else both, one after the other
#pragma unroll 1
  for (int j = c; j < (SPLIT ? (int)c + 1 : 2); ++j) {
    if constexpr (SPLIT) {
      tf::from_flat_read<LOGN>(v, bufs.next(), tau);
    } else {
      if (j) {
#pragma unroll
        for (int s = 0; s < E; ++s) v[s] = sm[2 * N + tau + s * T];
      }
      tf::from_flat<LOGN>(v, bufs.next(), tau);
    }
    tf::inv<LOGN>(v, bufs, tau, tw, L.q);
#pragma unroll
    for (int s = 0; s < E; ++s)
      dst[j * kn + s * T] = mul_shoup(v[s], L.ninv, L.ninv_sh, L.q);
  }
}

template <int LOGN>
static int launch(const void* d, const void* k0, const void* k1, void* out,
                  const void* twp, const void* consts, int rows, int kdig,
                  int k, void* stream) {
  using S = tf::Shape<LOGN>;
  constexpr bool SPLIT = 2 * S::T <= 512;
  const int smem = (int)((SPLIT ? 4 : 3) * sizeof(u32) * S::N);
  cudaFuncSetAttribute(inv_ks_kernel<LOGN, SPLIT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  inv_ks_kernel<LOGN, SPLIT><<<rows * k, (SPLIT ? 2 : 1) * S::T, smem,
                               (cudaStream_t)stream>>>(
      (const long long*)d, (const long long*)k0, (const long long*)k1,
      (long long*)out, (const u64*)twp, (const long long*)consts, kdig, k);
  return (int)cudaGetLastError();
}

// d [rows, kdig, k, N], k0/k1 [kdig, k, N] -> out [rows, 2, k, N];
// twp [k, 2, N] u64 twiddle pairs (math/pmntt.py::twiddle_pairs)
extern "C" int inv_ks(const void* d, const void* k0, const void* k1, void* out,
                      const void* twp, const void* consts, int rows, int kdig,
                      int k, int logn, void* stream) {
  TF_DISPATCH(logn, (launch<LOGN>(d, k0, k1, out, twp, consts, rows, kdig, k,
                                  stream)))
}
