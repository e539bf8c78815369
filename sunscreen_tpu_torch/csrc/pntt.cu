// The u32 NTT plan of SUNSCREEN_TPU_NTT=pallas_vpu: forward and inverse
// negacyclic transforms in the plan's own [t', s'] NTT domain (B16) and the
// exact pointwise product a b mod q per limb (B17).
//
// Replaces the Pallas kernels of sunscreen_tpu/math/pntt.py::PallasNttPlan:
// _transform (pallas_call at pntt.py:395; .fwd and .inv) and _pmul
// (pallas_call at pntt.py:452; .pointwise_mul).
//
// B16. The TPU kernel runs a four-step transform, [R', C = 128] rows NTT,
// mid twiddle, transpose, column NTT, because that keeps every slice a
// contiguous sublane half on the TPU's vector unit. Its output position
// p = t' R' + s' holds the evaluation at psi^(2J + 1) with J = brev(s') +
// R' brev(t') (bit reversal over log2 R' and log2 C bits), which the
// one-pass negacyclic transform leaves at bit-reversed slot brev(J) =
// s' C + t': p is that slot rotated left by log2 R' bits (tf::Rot). So
// the card needs no four-step: B16 is ntt.cu's kernel (transform.cuh's
// register-resident radix-16 groups, lazy butterflies, the pair table
// twp, two swizzled exchange buffers a polynomial, several polynomials a
// 512-thread block below N = 8192) with the rotation in place of the
// flat permutation as its last exchange (the first of the inverse), so
// loads and stores stay coalesced int64 rows with no position table. Both
// directions reduce any input below 2^63; the inverse folds 1/N into its
// store. N = 128, which ntt.cu does not hold, takes groups of two stages
// (Shape<7>: 32 threads a polynomial, 16 polynomials a block). N = 32768,
// which ntt.cu does not hold either (the reference's pmntt plan stops at
// 16384; BfvParams.default_u32(32768) runs under this plan), takes 1024
// threads of 32 coefficients each, three groups of five stages
// (Shape<15>), and one exchange buffer of 128 KB (two would not fit a
// block), so each exchange waits at a barrier before it writes.
//
// B17. One pass over the broadcast shape [rows, k, N]: each block takes one row
// and a stretch of its k N residues (8 per thread, so the row's offsets are
// worked out once per 8), reduces the u64 product with floor(2^64 / q) and
// writes the output once. The operands are read through
// their own strides over up to four merged leading dims, so a broadcast
// operand (the public key against a batch of u, the secret key against
// every component) is read in place and never materialized.
//
// Bounds on the H100 (int64 residues in and out): B16 on [256, 15, 8192] moves
// 2 * 252 MB, about 0.15 ms at 3.35 TB/s, against 0.61 G 32-bit multiplies,
// 0.04 ms at 16.7 T/s: bound by bytes; at BfvParams.default_u32(32768)'s
// multiply, [256, 59, 32768], 2 * 3.96 GB, about 2.4 ms. B17 on
// [64, 15, 8192] reads 126 MB per full operand and writes 63 MB, 2
// multiplies per residue: bound by bytes.

#include "transform.cuh"

// exchange buffers a polynomial
template <int LOGN>
constexpr int NBUF = LOGN < 15 ? 2 : 1;

template <int LOGN>
__global__ void __launch_bounds__(tf::Shape<LOGN>::THREADS)
    pntt_fwd_kernel(const long long* __restrict__ x,
                    long long* __restrict__ out, const u64* __restrict__ twp,
                    const long long* __restrict__ consts, int k, int polys) {
  extern __shared__ u32 sm[];
  tf::fwd_poly<LOGN, tf::Rot<LOGN>, NBUF<LOGN>>(sm, x, out, twp, consts, k,
                                                polys, 0);
}

template <int LOGN>
__global__ void __launch_bounds__(tf::Shape<LOGN>::THREADS)
    pntt_inv_kernel(const long long* __restrict__ x,
                    long long* __restrict__ out, const u64* __restrict__ twp,
                    const long long* __restrict__ consts, int k, int polys) {
  extern __shared__ u32 sm[];
  tf::inv_poly<LOGN, tf::Rot<LOGN>, NBUF<LOGN>>(sm, x, out, twp, consts, k,
                                                polys);
}

template <int LOGN, bool INV>
static int launch(const void* x, void* out, const void* twp,
                  const void* consts, int rows, int k, void* stream) {
  using S = tf::Shape<LOGN>;
  const int polys = rows * k;
  const int blocks = (polys + S::P - 1) / S::P;
  const int smem = (int)(NBUF<LOGN> * sizeof(u32) * S::P * S::N);
  auto kernel = INV ? pntt_inv_kernel<LOGN> : pntt_fwd_kernel<LOGN>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  kernel<<<blocks, S::THREADS, smem, (cudaStream_t)stream>>>(
      (const long long*)x, (long long*)out, (const u64*)twp,
      (const long long*)consts, k, polys);
  return (int)cudaGetLastError();
}

// Leading dims of the broadcast shape, outermost first, and each operand's
// strides over them in elements (0 where it is broadcast).
struct Lead {
  int size[4];
  long long sa[4], sb[4];
};

__global__ void pntt_pmul_kernel(const long long* __restrict__ a,
                                 const long long* __restrict__ b,
                                 long long* __restrict__ out,
                                 const long long* __restrict__ consts, int k,
                                 int logn, int rows, Lead lead) {
  const int kn = k << logn;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    long long oa = 0, ob = 0;
    int r = row;
    for (int d = 3; d >= 0; --d) {
      const int i = r % lead.size[d];
      r /= lead.size[d];
      oa += i * lead.sa[d];
      ob += i * lead.sb[d];
    }
    const long long* ar = a + oa;
    const long long* br = b + ob;
    long long* dst = out + (size_t)row * kn;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < kn;
         i += gridDim.x * blockDim.x) {
      const int limb = i >> logn;
      const u32 q = (u32)__ldg(consts + 4 * limb);
      const u64 m = (u64)__ldg(consts + 4 * limb + 1);
      // residues are below 2^32: one 32 x 32 -> 64-bit multiply
      dst[i] = reduce64((u64)(u32)__ldg(ar + i) * (u32)__ldg(br + i), q, m);
    }
  }
}

// x [rows, k, N] coefficients -> out [rows, k, N] in the [t', s'] domain,
// 128 <= N <= 32768; twp [k, 2, N] u64 twiddle pairs
// (math/pmntt.py::twiddle_pairs)
extern "C" int pntt_fwd(const void* x, void* out, const void* twp,
                        const void* consts, int rows, int k, int logn,
                        void* stream) {
  if (logn == 7) return launch<7, false>(x, out, twp, consts, rows, k, stream);
  if (logn == 15)
    return launch<15, false>(x, out, twp, consts, rows, k, stream);
  TF_DISPATCH(logn, (launch<LOGN, false>(x, out, twp, consts, rows, k,
                                         stream)))
}

// x [rows, k, N] in the [t', s'] domain -> out [rows, k, N] coefficients
extern "C" int pntt_inv(const void* x, void* out, const void* twp,
                        const void* consts, int rows, int k, int logn,
                        void* stream) {
  if (logn == 7) return launch<7, true>(x, out, twp, consts, rows, k, stream);
  if (logn == 15)
    return launch<15, true>(x, out, twp, consts, rows, k, stream);
  TF_DISPATCH(logn, (launch<LOGN, true>(x, out, twp, consts, rows, k,
                                        stream)))
}

// out [rows, k, N] = a b mod q, a and b read at row offsets given by the
// leading sizes d0..d3 and their strides (elements) sa0..sa3, sb0..sb3
extern "C" int pntt_pmul(const void* a, const void* b, void* out,
                         const void* consts, int k, int logn, int rows, int d0,
                         int d1, int d2, int d3, int sa0, int sa1, int sa2,
                         int sa3, int sb0, int sb1, int sb2, int sb3,
                         void* stream) {
  const Lead lead = {{d0, d1, d2, d3},
                     {sa0, sa1, sa2, sa3},
                     {sb0, sb1, sb2, sb3}};
  // 8 residues per thread: the row offsets are worked out once per 8
  const int threads = 256, per_thread = 8;
  const int kn = k << logn;
  const dim3 grid((kn + threads * per_thread - 1) / (threads * per_thread),
                  rows < 65535 ? rows : 65535);
  pntt_pmul_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)a, (const long long*)b, (long long*)out,
      (const long long*)consts, k, logn, rows, lead);
  return (int)cudaGetLastError();
}
