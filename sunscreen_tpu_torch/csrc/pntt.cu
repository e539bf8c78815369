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
// block), so each exchange waits at a barrier before it writes. Above
// N = 32768 a polynomial no longer fits a block's shared memory, and B16 is
// two kernels a direction (see "B16 at N >= 65536" below).
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
// multiply, [256, 59, 32768], 2 * 3.96 GB, about 2.4 ms; at the multiply of
// BfvParams.insecure_u32(65536, limbs=3), [256, 8, 65536], 2 * 1.07 GB,
// 0.64 ms in one pass, 0.96 ms for the two passes' 24 bytes a coefficient.
// B17 on [64, 15, 8192] reads 126 MB per full operand and writes 63 MB, 2
// multiplies per residue: bound by bytes.

#include "pntt_passes.cuh"

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

// B16 at N >= 65536 (logn 16 to 21): two passes a transform, as two
// kernels a direction. The [t', s'] domain is the one-pass transform's
// bit-reversed array rotated (Rot above), and the radix-2 network splits at
// position bit 7, the reference's own four-step split of i = r C + c with
// C = 128 lanes and R = N / C rows:
//   - its stages on bits LOGN - 1 down to 7 take psi_rev[m + (r >> ...)]
//     with m + ... < R, which is psi_R^brev(.) with psi_R = psi^C: for
//     each column c they are the reference's R-point negacyclic row
//     transform (row_tw), here tf::fwd<LOGR> on the column, the full
//     table's first R pairs as its table;
//   - its stages on bits 6 down to 0, for each bit-reversed row r', are
//     the reference's mid twiddle, transpose and 128-point cyclic column
//     transform, here tf::fwd_stages<LOGN> on the row's 128 words,
//     whose output slot r' C + t' goes to position t' R + r'.
// The inverse runs the Gentleman-Sande stages the other way: bits 0 to 6
// a row (the columns' inverse and the inverse mid twiddle, without the
// 1/N), then bits 7 and up a column, 1/N folded into the store.
//
// The intermediate [rows, k, R, C] is the reference's own after its row
// stage (forward) or N times its own after the inverse mid twiddle
// (inverse), exact residues as u32 words in a scratch tensor of the
// caller's: half the bytes of int64, so a transform moves 8 + 4 + 4 + 8
// bytes a coefficient, 1.5 times the one-pass kernel's 16.
//
// Row pass (pntt_{fwd,inv}_rows_kernel<LOGN>): a block takes one
// polynomial's P adjacent columns (P = tf::Shape<LOGR>::P: 16 at
// N = 65536, down to 1 at 2^20), loads the [R, P] tile with coalesced
// row segments into shared memory (column-major, each column's rows
// XORed below bit 5 so that both the segments and a column's 32
// consecutive rows hit 32 banks), runs transform.cuh's transform on each
// column with the column's T threads of E = 16 words (one exchange more,
// to the layout of consecutive rows), and stores through the tile. Two
// exchange buffers a column: the tile and the block's second half.
//
// Column pass (pntt_{fwd,inv}_cols_kernel<LOGN>): a block takes RB = 32
// rows of one polynomial, 8 threads a row with 16 words each (stages on
// bits 6-3, an exchange, bits 2-0), and a [128, RB] transpose tile, so
// that the int64 side reads or writes runs of RB words at t' R + r'.
template <int LOGN>
__global__ void __launch_bounds__(twopass::ROW_THREADS<LOGN>,
                                   twopass::ROW_BLOCKS<LOGN>)
    pntt_fwd_rows_kernel(const long long* __restrict__ x,
                         u32* __restrict__ a, const u64* __restrict__ twp,
                         const long long* __restrict__ consts, int k) {
  constexpr int LOGR = LOGN - twopass::LOGC;
  using S = tf::Shape<LOGR>;
  extern __shared__ u32 sm[];
  const int poly = blockIdx.x / (twopass::C / S::P);
  const int c0 = blockIdx.x % (twopass::C / S::P) * S::P;
  const int limb = poly % k;
  const Limb L = load_limb(consts, limb);
  // tile word e = threadIdx.x + i THREADS: row e / P, column e % P
  constexpr int ROWS = S::THREADS / S::P;  // rows of the tile a step
  const u32 r0 = threadIdx.x / S::P, cl = threadIdx.x % S::P;
  u32 v[S::E];
  tf::load_mod(v, x + ((size_t)poly << LOGN) + c0 + r0 * twopass::C + cl,
               ROWS * twopass::C, L);
#pragma unroll
  for (int i = 0; i < S::E; ++i)
    sm[twopass::tile_word<LOGR>(cl, r0 + i * ROWS)] = v[i];
  __syncthreads();
  const u32 tau = threadIdx.x % S::T, c = threadIdx.x / S::T;
#pragma unroll
  for (int s = 0; s < S::E; ++s)
    v[s] = sm[twopass::tile_word<LOGR>(c, tau + s * S::T)];
  // the first exchange writes the second half, which no thread reads yet
  tf::Buffers<2> bufs{sm + (c << LOGR), S::P << LOGR, 1};
  tf::fwd<LOGR>(v, bufs, tau, twp + ((size_t)limb << (LOGN + 1)), L.q);
  tf::exchange<LOGR, S::fwd_a(S::G - 1), S::fwd_a(0)>(v, bufs.next(), tau);
  tf::canon(v, L.q);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < S::E; ++s)
    sm[twopass::tile_word<LOGR>(c, tau + s * S::T)] = v[s];
  __syncthreads();
  u32* dst = a + ((size_t)poly << LOGN) + c0 + r0 * twopass::C + cl;
#pragma unroll 4
  for (int i = 0; i < S::E; ++i)
    dst[i * ROWS * twopass::C] =
        sm[twopass::tile_word<LOGR>(cl, r0 + i * ROWS)];
}

template <int LOGN>
__global__ void __launch_bounds__(twopass::ROW_THREADS<LOGN>,
                                   twopass::ROW_BLOCKS<LOGN>)
    pntt_inv_rows_kernel(const u32* __restrict__ a,
                         long long* __restrict__ out,
                         const u64* __restrict__ twp,
                         const long long* __restrict__ consts, int k) {
  constexpr int LOGR = LOGN - twopass::LOGC;
  using S = tf::Shape<LOGR>;
  extern __shared__ u32 sm[];
  const int poly = blockIdx.x / (twopass::C / S::P);
  const int c0 = blockIdx.x % (twopass::C / S::P) * S::P;
  const int limb = poly % k;
  const Limb L = load_limb(consts, limb);
  // tile word e = threadIdx.x + i THREADS: row e / P, column e % P (so
  // written, this pass's tile loops ran faster on the H100 than in the
  // forward pass's strided form)
  const u32* src = a + ((size_t)poly << LOGN) + c0;
#pragma unroll 4
  for (int i = 0; i < S::E; ++i) {
    const u32 e = threadIdx.x + i * S::THREADS, r = e / S::P, c = e % S::P;
    sm[twopass::tile_word<LOGR>(c, r)] = src[r * twopass::C + c];
  }
  __syncthreads();
  const u32 tau = threadIdx.x % S::T, c = threadIdx.x / S::T;
  u32 v[S::E];
#pragma unroll
  for (int s = 0; s < S::E; ++s)
    v[s] = sm[twopass::tile_word<LOGR>(c, tau + s * S::T)];
  tf::Buffers<2> bufs{sm + (c << LOGR), S::P << LOGR, 1};
  // consecutive rows -> the bit-reversed layout of the inverse's first
  // group
  tf::exchange<LOGR, S::inv_a(S::G - 1), S::inv_a(0)>(v, bufs.next(), tau);
  tf::inv<LOGR>(v, bufs, tau, twp + ((size_t)(2 * limb + 1) << LOGN), L.q);
#pragma unroll
  for (int s = 0; s < S::E; ++s)
    v[s] = mul_shoup(v[s], L.ninv, L.ninv_sh, L.q);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < S::E; ++s)
    sm[twopass::tile_word<LOGR>(c, tau + s * S::T)] = v[s];
  __syncthreads();
  long long* dst = out + ((size_t)poly << LOGN) + c0;
#pragma unroll 4
  for (int i = 0; i < S::E; ++i) {
    const u32 e = threadIdx.x + i * S::THREADS, r = e / S::P, c = e % S::P;
    dst[r * twopass::C + c] = sm[twopass::tile_word<LOGR>(c, r)];
  }
}

template <int LOGN>
__global__ void __launch_bounds__(twopass::COL_THREADS)
    pntt_fwd_cols_kernel(const u32* __restrict__ a,
                         long long* __restrict__ out,
                         const u64* __restrict__ twp,
                         const long long* __restrict__ consts, int k) {
  constexpr int LOGR = LOGN - twopass::LOGC;
  __shared__ u32 ex[twopass::RB * twopass::C], tp[twopass::RB * twopass::C];
  const int poly = blockIdx.x >> (LOGR - 5);
  const u32 r0 = (blockIdx.x & ((1 << (LOGR - 5)) - 1)) * twopass::RB;
  const int limb = poly % k;
  const Limb L = load_limb(consts, limb);
  const u64* tw = twp + ((size_t)limb << (LOGN + 1));
  const u32 rho = threadIdx.x >> 3, j = threadIdx.x & 7, row = r0 + rho;
  const u32* src = a + ((size_t)poly << LOGN) + row * twopass::C;
  u32 v[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) v[s] = src[j + 8 * s];
  // stages on bits 6-3: the registers hold columns j + 8 s
  tf::fwd_stages<LOGN, 3, 6>(v, row * twopass::C + j, tw, L.q);
#pragma unroll
  for (int s = 0; s < 16; ++s) ex[twopass::ex_word(rho, j + 8 * s)] = v[s];
  __syncthreads();
#pragma unroll
  for (int s = 0; s < 16; ++s) v[s] = ex[twopass::ex_word(rho, 16 * j + s)];
  tf::fwd_stages<LOGN, 0, 2>(v, row * twopass::C + 16 * j, tw, L.q);
  tf::canon(v, L.q);
  // slot row C + t' goes to position t' R + row
#pragma unroll
  for (int s = 0; s < 16; ++s) tp[twopass::tp_word(16 * j + s, rho)] = v[s];
  __syncthreads();
  // tile word e = threadIdx.x + i COL_THREADS: column e / RB, row e % RB
  constexpr int COLS = twopass::COL_THREADS / twopass::RB;  // a step
  const u32 t0 = threadIdx.x / twopass::RB, rl = threadIdx.x % twopass::RB;
  long long* dst = out + ((size_t)poly << LOGN) + (t0 << LOGR) + r0 + rl;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    dst[(i * COLS) << LOGR] = tp[twopass::tp_word(t0 + i * COLS, rl)];
}

template <int LOGN>
__global__ void __launch_bounds__(twopass::COL_THREADS)
    pntt_inv_cols_kernel(const long long* __restrict__ x,
                         u32* __restrict__ a, const u64* __restrict__ twp,
                         const long long* __restrict__ consts, int k) {
  constexpr int LOGR = LOGN - twopass::LOGC;
  __shared__ u32 ex[twopass::RB * twopass::C], tp[twopass::RB * twopass::C];
  const int poly = blockIdx.x >> (LOGR - 5);
  const u32 r0 = (blockIdx.x & ((1 << (LOGR - 5)) - 1)) * twopass::RB;
  const int limb = poly % k;
  const Limb L = load_limb(consts, limb);
  const u64* tw = twp + ((size_t)(2 * limb + 1) << LOGN);
  // tile word e = threadIdx.x + i COL_THREADS: column e / RB, row e % RB
  constexpr int COLS = twopass::COL_THREADS / twopass::RB;  // a step
  const u32 t0 = threadIdx.x / twopass::RB, rl = threadIdx.x % twopass::RB;
  u32 v[16];
  tf::load_mod(v, x + ((size_t)poly << LOGN) + (t0 << LOGR) + r0 + rl,
               COLS << LOGR, L);
#pragma unroll
  for (int i = 0; i < 16; ++i) tp[twopass::tp_word(t0 + i * COLS, rl)] = v[i];
  __syncthreads();
  const u32 rho = threadIdx.x >> 3, j = threadIdx.x & 7, row = r0 + rho;
#pragma unroll
  for (int s = 0; s < 16; ++s) v[s] = tp[twopass::tp_word(16 * j + s, rho)];
  // stages on bits 0-3: the registers hold columns 16 j + s
  tf::inv_stages<LOGN, 0, 0, 3>(v, row * twopass::C + 16 * j, tw, L.q);
#pragma unroll
  for (int s = 0; s < 16; ++s) ex[twopass::ex_word(rho, 16 * j + s)] = v[s];
  __syncthreads();
#pragma unroll
  for (int s = 0; s < 16; ++s) v[s] = ex[twopass::ex_word(rho, j + 8 * s)];
  tf::inv_stages<LOGN, 3, 4, 6>(v, row * twopass::C + j, tw, L.q);
  u32* dst = a + ((size_t)poly << LOGN) + row * twopass::C;
#pragma unroll
  for (int s = 0; s < 16; ++s) dst[j + 8 * s] = csub(v[s], L.q);
}

// A row pass over rows * k polynomials: C / P blocks a polynomial.
template <int LOGN, bool INV>
static int launch_rows(const void* in, void* out, const void* twp,
                       const void* consts, int rows, int k, void* stream) {
  using S = tf::Shape<LOGN - twopass::LOGC>;
  const long long blocks = (long long)rows * k * (twopass::C / S::P);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  const int smem = (int)(2 * sizeof(u32) * S::P * S::N);
  if constexpr (INV) {
    cudaFuncSetAttribute(pntt_inv_rows_kernel<LOGN>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    pntt_inv_rows_kernel<LOGN><<<(unsigned)blocks, S::THREADS, smem,
                                 (cudaStream_t)stream>>>(
        (const u32*)in, (long long*)out, (const u64*)twp,
        (const long long*)consts, k);
  } else {
    cudaFuncSetAttribute(pntt_fwd_rows_kernel<LOGN>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    pntt_fwd_rows_kernel<LOGN><<<(unsigned)blocks, S::THREADS, smem,
                                 (cudaStream_t)stream>>>(
        (const long long*)in, (u32*)out, (const u64*)twp,
        (const long long*)consts, k);
  }
  return (int)cudaGetLastError();
}

// A column pass over rows * k polynomials: R / RB blocks a polynomial.
template <int LOGN, bool INV>
static int launch_cols(const void* in, void* out, const void* twp,
                       const void* consts, int rows, int k, void* stream) {
  const long long blocks = (long long)rows * k << (LOGN - twopass::LOGC - 5);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  if constexpr (INV)
    pntt_inv_cols_kernel<LOGN><<<(unsigned)blocks, twopass::COL_THREADS, 0,
                                 (cudaStream_t)stream>>>(
        (const long long*)in, (u32*)out, (const u64*)twp,
        (const long long*)consts, k);
  else
    pntt_fwd_cols_kernel<LOGN><<<(unsigned)blocks, twopass::COL_THREADS, 0,
                                 (cudaStream_t)stream>>>(
        (const u32*)in, (long long*)out, (const u64*)twp,
        (const long long*)consts, k);
  return (int)cudaGetLastError();
}

// Runs `call` with LOGN the compile-time value of the runtime logn for the
// two-pass sizes, 65536 <= N <= 2^21; cudaErrorInvalidValue otherwise.
#define BIG_DISPATCH(logn, call)                               \
  switch (logn) {                                              \
    case 16: { constexpr int LOGN = 16; return call; }         \
    case 17: { constexpr int LOGN = 17; return call; }         \
    case 18: { constexpr int LOGN = 18; return call; }         \
    case 19: { constexpr int LOGN = 19; return call; }         \
    case 20: { constexpr int LOGN = 20; return call; }         \
    case 21: { constexpr int LOGN = 21; return call; }         \
    default: return (int)cudaErrorInvalidValue;                \
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

// The two passes of B16 at 65536 <= N <= 2^21, each [rows, k, N] to
// [rows, k, N]; the intermediate a is u32 residues in [R, C] order.
// x coefficients -> a (row transforms, rows bit-reversed)
extern "C" int pntt_fwd_rows(const void* x, void* a, const void* twp,
                             const void* consts, int rows, int k, int logn,
                             void* stream) {
  BIG_DISPATCH(logn, (launch_rows<LOGN, false>(x, a, twp, consts, rows, k,
                                               stream)))
}

// a -> out in the [t', s'] domain
extern "C" int pntt_fwd_cols(const void* a, void* out, const void* twp,
                             const void* consts, int rows, int k, int logn,
                             void* stream) {
  BIG_DISPATCH(logn, (launch_cols<LOGN, false>(a, out, twp, consts, rows, k,
                                               stream)))
}

// x in the [t', s'] domain -> a (column inverses, inverse mid twiddle)
extern "C" int pntt_inv_cols(const void* x, void* a, const void* twp,
                             const void* consts, int rows, int k, int logn,
                             void* stream) {
  BIG_DISPATCH(logn, (launch_cols<LOGN, true>(x, a, twp, consts, rows, k,
                                              stream)))
}

// a -> out coefficients (row inverses, 1/N)
extern "C" int pntt_inv_rows(const void* a, void* out, const void* twp,
                             const void* consts, int rows, int k, int logn,
                             void* stream) {
  BIG_DISPATCH(logn, (launch_rows<LOGN, true>(a, out, twp, consts, rows, k,
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
