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
// Bound on the H100 at the main-path shape rows = 64, k = 15, N = 8192, int64
// residues: it reads 252 MB and writes 189 MB, about 0.13 ms at 3.35 TB/s.
// The three products take 8 and the three transforms 3 * (3 * (N/2) * log2 N
// + 3 N) 32-bit multiplies per (row, limb) column of N: 0.55 G in all, about
// 0.03 ms at 16.7 T/s. Bound by bytes.
//
// Design (transform.cuh), the second half of tensor3.cu's B13: one (row,
// limb) per N / 16 threads (several per 512-thread block below N = 8192).
// Each thread loads a0, a1, b0 and b1 at flat positions tau + s T, coalesced
// int64 reads; the four words of a position share its NTT index, so the
// three products are formed in the flat layout with no exchange, and each
// is written straight into its own swizzled flat-domain buffer (the first
// half of from_flat). After one barrier each component is read back in the
// butterflies' layout, inverse-transformed in registers and stored with
// 1/N folded in as coalesced int64 rows: c0 with its own buffer as the
// exchange buffer (two barriers an exchange), c1 and c2 alternating their
// own buffer with c0's (one barrier an exchange after one to start). The
// NTT-domain tensor never reaches device memory. A task takes 3 N words of
// shared memory: 96 KB at N = 8192, two blocks an SM as tensor3.cu runs,
// and 192 KB for the 1024 threads at N = 16384, one block an SM, so the
// kernel holds every N of the plan from 256 (TENSOR3_MAX_N). ptxas
// keeps it within 64 registers with at most a few bytes of spills.

#include "transform.cuh"

// Two blocks an SM up to N = 8192 (at most 64 registers a thread, as
// tensor3.cu); one 1024-thread block at N = 16384, also 64 registers.
template <int LOGN>
__global__ void __launch_bounds__(tf::Shape<LOGN>::THREADS,
                                  LOGN < 14 ? 2 : 1)
    inv_tensor3_kernel(const long long* __restrict__ a,
                       const long long* __restrict__ b,
                       long long* __restrict__ out,
                       const u64* __restrict__ twp,
                       const long long* __restrict__ consts, int k, int tasks,
                       long long sa, long long sb) {
  using S = tf::Shape<LOGN>;
  constexpr int N = S::N, E = S::E, T = S::T;
  extern __shared__ u32 sm[];  // [P][3][N]
  const u32 tau = threadIdx.x % T;
  const int slot = threadIdx.x / T;
  const int task = blockIdx.x * S::P + slot;
  // spare slots redo the last task and store nothing: every thread
  // reaches every barrier
  const int t = task < tasks ? task : tasks - 1;
  const int row = t / k, limb = t % k;
  const Limb L = load_limb(consts, limb);
  const size_t kn = (size_t)k * N;
  const long long* ar = a + row * sa + (size_t)limb * N + tau;
  const long long* br = b + row * sb + (size_t)limb * N + tau;
  long long* dst = out + (size_t)row * 3 * kn + (size_t)limb * N + tau;
  u32* buf = sm + slot * 3 * N;  // c0 | c1 | c2, swizzled flat positions
  const u64* tw = twp + ((size_t)limb * 2 + 1) * N;
  const u32 w0 = tf::swz<LOGN, true>(tau);
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const u32 w = w0 ^ tf::swz<LOGN, true>(s * T);
    tensor3_mod((u64)ar[s * T], (u64)ar[kn + s * T], (u64)br[s * T],
                (u64)br[kn + s * T], L.q, L.m, buf[w], buf[N + w],
                buf[2 * N + w]);
  }
  __syncthreads();
#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    u32 v[E];
    tf::from_flat_read<LOGN>(v, buf + c * N, tau);
    if (c == 0) {  // c1 and c2 still fill their buffers
      tf::Buffers<1> bufs{buf, 0, 0};
      tf::inv<LOGN>(v, bufs, tau, tw, L.q);
    } else {
      // every thread has read buffer c, and c0's buffer in the previous
      // transform, before either is written again
      __syncthreads();
      tf::Buffers<2> bufs{buf, (u32)(c * N), 0};
      tf::inv<LOGN>(v, bufs, tau, tw, L.q);
    }
    if (task < tasks) {
#pragma unroll
      for (int s = 0; s < E; ++s)
        dst[c * kn + s * T] = mul_shoup(v[s], L.ninv, L.ninv_sh, L.q);
    }
  }
}

template <int LOGN>
static int launch(const void* a, const void* b, void* out, const void* twp,
                  const void* consts, int rows, int k, int sa, int sb,
                  void* stream) {
  using S = tf::Shape<LOGN>;
  const int tasks = rows * k;
  const int blocks = (tasks + S::P - 1) / S::P;
  const int smem = (int)(3 * sizeof(u32) * S::P * S::N);
  cudaFuncSetAttribute(inv_tensor3_kernel<LOGN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  inv_tensor3_kernel<LOGN><<<blocks, S::THREADS, smem,
                             (cudaStream_t)stream>>>(
      (const long long*)a, (const long long*)b, (long long*)out,
      (const u64*)twp, (const long long*)consts, k, tasks, sa, sb);
  return (int)cudaGetLastError();
}

// a, b rows of [2, k, N] (row strides sa, sb) -> out [rows, 3, k, N],
// 256 <= N <= 16384; twp [k, 2, N] u64 twiddle pairs
// (math/pmntt.py::twiddle_pairs)
extern "C" int inv_tensor3(const void* a, const void* b, void* out,
                           const void* twp, const void* consts, int rows,
                           int k, int logn, int sa, int sb, void* stream) {
  TF_DISPATCH(logn, (launch<LOGN>(a, b, out, twp, consts, rows, k, sa, sb,
                                  stream)))
}
