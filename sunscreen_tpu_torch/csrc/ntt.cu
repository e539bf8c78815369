// Forward, broadcast-forward and inverse negacyclic NTT over u32 RNS limbs.
//
// Replaces the Pallas kernel sunscreen_tpu/math/pmntt.py::_make_transform
// (pallas_call at pmntt.py:354) in its three uses: PallasMatmulNttPlan.fwd
// (inverse=False, B1), .fwd_broadcast (broadcast=True, B2) and .inv
// (inverse=True, B3). The output domain is the same: flat position
// j2 * n1 + j1 holds natural NTT index j2 + 128 j1; the inverse returns
// natural coefficient order with 1/N folded in.
//
// Bound on the H100 at the main-path shapes (int64 residues in and out):
// fwd / inv on [256, 15, 8192] move 2 * 252 MB, about 0.15 ms at 3.35 TB/s;
// their 3 * (N/2) * log2 N = 159,744 32-bit multiplies per polynomial make
// 0.61 G multiplies, about 0.04 ms at 16.75 T integer multiplies/s. So they
// are bound by bytes. fwd_broadcast on [448, 8192] -> [448, 8, 8192] reads
// 29 MB and writes 235 MB, 0.08 ms.
//
// Design (transform.cuh): each polynomial is held in registers by N / 16
// threads, 16 coefficients each (N / 8 threads of 8 at N = 256), several
// polynomials per block below N = 8192 so that a block has 512 threads
// (1024 at N = 16384). Each thread loads its coefficients as coalesced
// int64 reads and reduces them below 2q (one 32-bit Barrett step while
// they fit 32 bits, the 64-bit reduction otherwise, so fwd and
// fwd_broadcast are exact for any value below 2^63), runs the log2 N
// stages in groups of four in registers with lazy butterflies and one
// 8-byte load of each twiddle and its Shoup ratio from the plan's pair
// table, and exchanges through conflict-free swizzled shared memory
// between groups: 3 exchanges and 3 barriers at N = 8192, where the
// radix-2 design of earlier versions made 13 passes through shared
// memory, each with two loads and two stores per butterfly and a barrier.
// The flat-domain permutation is one more exchange (the last of the
// forward transform, the first of the inverse), so the int64 stores and
// loads stay coalesced. Two exchange buffers alternate, one barrier per
// exchange. A block takes 64 KB of shared memory and ptxas gives a thread
// about 64 registers, so two blocks share an SM and one's loads and stores
// overlap the other's butterflies. The kernels' bodies are transform.cuh's
// fwd_poly and inv_poly, which pntt.cu's B16 runs in its own domain.

#include "transform.cuh"

template <int LOGN>
__global__ void __launch_bounds__(tf::Shape<LOGN>::THREADS)
    ntt_fwd_kernel(const long long* __restrict__ x,
                   long long* __restrict__ out, const u64* __restrict__ twp,
                   const long long* __restrict__ consts, int k, int polys,
                   int broadcast) {
  extern __shared__ u32 sm[];
  tf::fwd_poly<LOGN, tf::Flat<LOGN>>(sm, x, out, twp, consts, k, polys,
                                     broadcast);
}

template <int LOGN>
__global__ void __launch_bounds__(tf::Shape<LOGN>::THREADS)
    ntt_inv_kernel(const long long* __restrict__ x,
                   long long* __restrict__ out, const u64* __restrict__ twp,
                   const long long* __restrict__ consts, int k, int polys) {
  extern __shared__ u32 sm[];
  tf::inv_poly<LOGN, tf::Flat<LOGN>>(sm, x, out, twp, consts, k, polys);
}

template <int LOGN, bool INV>
static int launch(const void* x, void* out, const void* twp,
                  const void* consts, int rows, int k, int broadcast,
                  void* stream) {
  using S = tf::Shape<LOGN>;
  const int polys = rows * k;
  const int blocks = (polys + S::P - 1) / S::P;
  const int smem = (int)(2 * sizeof(u32) * S::P * S::N);
  if constexpr (INV) {
    cudaFuncSetAttribute(ntt_inv_kernel<LOGN>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    ntt_inv_kernel<LOGN><<<blocks, S::THREADS, smem, (cudaStream_t)stream>>>(
        (const long long*)x, (long long*)out, (const u64*)twp,
        (const long long*)consts, k, polys);
  } else {
    cudaFuncSetAttribute(ntt_fwd_kernel<LOGN>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    ntt_fwd_kernel<LOGN><<<blocks, S::THREADS, smem, (cudaStream_t)stream>>>(
        (const long long*)x, (long long*)out, (const u64*)twp,
        (const long long*)consts, k, polys, broadcast);
  }
  return (int)cudaGetLastError();
}

// x [rows, k, N] (or [rows, N] when broadcast) -> out [rows, k, N];
// twp [k, 2, N] u64 twiddle pairs (math/pmntt.py::twiddle_pairs)
extern "C" int ntt_fwd(const void* x, void* out, const void* twp,
                       const void* consts, int rows, int k, int logn,
                       int broadcast, void* stream) {
  TF_DISPATCH(logn, (launch<LOGN, false>(x, out, twp, consts, rows, k,
                                         broadcast, stream)))
}

// x [rows, k, N] flat NTT domain -> out [rows, k, N] natural coefficients
extern "C" int ntt_inv(const void* x, void* out, const void* twp,
                       const void* consts, int rows, int k, int logn,
                       void* stream) {
  TF_DISPATCH(logn, (launch<LOGN, true>(x, out, twp, consts, rows, k, 0,
                                        stream)))
}
