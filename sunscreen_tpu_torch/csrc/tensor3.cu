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
// Bound on the H100 at the main-path shape rows = 64, k = 15, N = 8192, int64
// residues: it reads 252 MB and writes 189 MB, about 0.13 ms at 3.35 TB/s.
// The four transforms take 4 * 159,744 32-bit multiplies per (row, limb),
// 0.68 G in all with the products, about 0.04 ms at 16.75 T integer
// multiplies/s; B13 adds three inverse transforms and the 1/N scaling,
// 1.21 G in all, 0.07 ms. Both are bound by bytes.
//
// Design (transform.cuh): one (row, limb) per N / 16 threads (several per
// 512-thread block below N = 8192, 1024 threads at N = 16384). The four
// operands are transformed one
// after the other in registers, with the exchange buffer of one polynomial
// in shared memory; a0's and a1's transforms wait in shared memory (each
// thread reads back only its own words, so with no barrier), a1 b0 in
// registers, and each tensor component is formed in registers as soon as
// its operands exist: c0 after b0, c1 and c2 after b1. B4 stores each
// through the flat-domain exchange as coalesced int64 rows. B13 feeds each
// straight into the register-resident inverse transform: the forward
// transform leaves the bit-reversed layout that the inverse reads, so no
// permutation is needed at all. Neither the operands' NTT image nor, in
// B13, the NTT-domain tensor ever reaches device memory. Shared memory per
// block is 3 N words (96 KB at N = 8192, against the earlier four-operand
// 128 KB), so two blocks share an SM and one's loads overlap the other's
// butterflies; at N = 16384 (TENSOR3_MAX_N) a block takes 192 KB and 1024
// threads, one block an SM, as inv_tensor3.cu's B12 does. The bound there,
// rows = 64 and k = 29 (default_u32(16384)'s product base): 1703 MB moved,
// about 0.51 ms.

#include "transform.cuh"

// Two 512-thread blocks per SM below N = 16384, one 1024-thread block
// there: at most 64 registers a thread either way. ptxas then spills a few
// words a thread to local memory; two blocks an SM still ran faster than
// one on the H100.
template <int LOGN, bool FULL>
__global__ void __launch_bounds__(tf::Shape<LOGN>::THREADS, LOGN < 14 ? 2 : 1)
    fwd_tensor3_kernel(const long long* __restrict__ x,
                       long long* __restrict__ out,
                       const u64* __restrict__ twp,
                       const long long* __restrict__ consts, int k,
                       int tasks) {
  using S = tf::Shape<LOGN>;
  constexpr int N = S::N, E = S::E, T = S::T;
  extern __shared__ u32 sm[];  // exchange [P][N] | stash [P][2][N]
  const u32 tau = threadIdx.x % T;
  const int slot = threadIdx.x / T;
  const int task = blockIdx.x * S::P + slot;
  // spare slots redo the last task and store nothing: every thread
  // reaches every barrier
  const int t = task < tasks ? task : tasks - 1;
  const int row = t / k, limb = t % k;
  const Limb L = load_limb(consts, limb);
  const size_t kn = (size_t)k * N;
  const long long* src = x + (size_t)row * 4 * kn + (size_t)limb * N;
  long long* dst = out + (size_t)row * 3 * kn + (size_t)limb * N;
  const u64* tw = twp + (size_t)limb * 2 * N;
  tf::Buffers<1> bufs{sm + slot * N, 0, 0};
  u32* stash = sm + S::P * N + slot * 2 * N + tau;  // [2][E][T], own words
  u32 h[E];
  // j = 0..3 transform a0, a1, b0, b1; j = 2..4 emit c0, c1, c2
#pragma unroll 1
  for (int j = 0; j < 5; ++j) {
    u32 v[E];
    if (j < 4) {
      tf::load_mod(v, src + j * kn + tau, T, L);
      tf::fwd<LOGN>(v, bufs, tau, tw, L.q);
    }
    if (j < 2) {
#pragma unroll
      for (int s = 0; s < E; ++s) stash[j * N + s * T] = v[s];
      continue;
    }
#pragma unroll
    for (int s = 0; s < E; ++s) {
      if (j == 4) {
        v[s] = h[s];
        continue;
      }
      const u64 a0 = stash[s * T], a1 = stash[N + s * T];
      if (j == 2) {          // v = b0: c0 = a0 b0, keep a1 b0
        h[s] = reduce64(a1 * v[s], L.q, L.m);
        v[s] = reduce64(a0 * v[s], L.q, L.m);
      } else {               // v = b1: c1 = a1 b0 + a0 b1, keep c2 = a1 b1
        const u32 c1 = add_q(h[s], reduce64(a0 * v[s], L.q, L.m), L.q);
        h[s] = reduce64(a1 * v[s], L.q, L.m);
        v[s] = c1;
      }
    }
    long long* d = dst + (j - 2) * kn;
    if (!FULL) {
      tf::to_flat<LOGN>(v, bufs.next(), tau);
      if (task < tasks) {
#pragma unroll
        for (int s = 0; s < E; ++s) d[tau + s * T] = v[s];
      }
    } else {
      tf::inv<LOGN>(v, bufs, tau, tw + N, L.q);
      if (task < tasks) {
#pragma unroll
        for (int s = 0; s < E; ++s)
          d[tau + s * T] = mul_shoup(v[s], L.ninv, L.ninv_sh, L.q);
      }
    }
  }
}

template <int LOGN>
static int launch(const void* x, void* out, const void* twp,
                  const void* consts, int rows, int k, int full,
                  void* stream) {
  using S = tf::Shape<LOGN>;
  const int tasks = rows * k;
  const int blocks = (tasks + S::P - 1) / S::P;
  const int smem = (int)(3 * sizeof(u32) * S::P * S::N);
  auto kernel = full ? fwd_tensor3_kernel<LOGN, true>
                     : fwd_tensor3_kernel<LOGN, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  kernel<<<blocks, S::THREADS, smem, (cudaStream_t)stream>>>(
      (const long long*)x, (long long*)out, (const u64*)twp,
      (const long long*)consts, k, tasks);
  return (int)cudaGetLastError();
}

// x [rows, 4, k, N] -> out [rows, 3, k, N]; full selects B13 over B4;
// twp [k, 2, N] u64 twiddle pairs (math/pmntt.py::twiddle_pairs)
extern "C" int fwd_tensor3(const void* x, void* out, const void* twp,
                           const void* consts, int rows, int k, int logn,
                           int full, void* stream) {
  TF_DISPATCH(logn, (launch<LOGN>(x, out, twp, consts, rows, k, full,
                                  stream)))
}
