// Fused RNS conversions of the BFV multiply and keyswitch.
//
// Replaces the Pallas kernels of sunscreen_tpu/math/prns.py:
//   rns_convert   FusedRnsOp, mode "convert" (pallas_call at prns.py:264),
//                 built by fused_converter; reached through
//                 BaseConverter.extend / .convert (B6);
//   rns_scale     FusedRnsOp, mode "scale" (the same pallas_call), built by
//                 fused_scaler; reached through ScaleAndRound.apply, which
//                 bfv/ops.py::_scale_convert runs when SUNSCREEN_TPU_FUSE_SC=0
//                 (B9);
//   scale_convert FusedScaleConvert (pallas_call at prns.py:608); reached
//                 through bfv/ops.py::_scale_convert (B7);
//   mod_down      FusedModDown (pallas_call at prns.py:495); reached through
//                 ModDown.apply (B8).
// Each computes the residues of the unfused math/rns.py code, bit for bit.
//
// Design: one thread per (row, coefficient). A thread reads its column's
// source limbs once (neighbouring threads on neighbouring coefficients, so
// every load and store is coalesced) and writes each output limb once.
//
// mod_down: native 64-bit Barrett steps (reduce64) on tables read through
// the read-only cache; all threads of a warp read the same entry.
//
// With mod_down's arithmetic (64-bit Barrett steps, each a 64 x 64-bit
// product emulated in 32-bit multiply-adds, and a table load a term),
// rns_convert, rns_scale and scale_convert were held by their instruction
// count, not their bytes. They stage their tables once a block in shared memory as u32
// words and work in 32-bit multiplies: Shoup products for the
// normalizations (the ratios derived from floor(2^64 / q) at staging),
// 32 x 32 -> 64-bit multiply-adds for the limb sums, reduced once by
// 32-bit steps (red2q in common.cuh), and four multiply-adds a term for
// the exact 128-bit fixed-point sums (Frac128), as the reference's 32-bit
// column sums. rns_scale runs its sums digit-major, every limb sum at
// once, reading omega four words a load.
//
// Tables are int64, one row of 8 per modulus (load_mod in common.cuh): q,
// floor(2^64 / q), then the op's constants (below). Residues cross the
// interface as int64 values < 2^30.
//
// Exactness of rns_scale, scale_convert and rns_convert at any base size
// up to MAXK (64) limbs: a Frac128 word holds below 2^32 after a carry, and
// the four terms added before the next are each below 2^30 2^32, so no word
// passes 2^64 whatever the count; the integer part, r or alpha, is below
// k 2^30 <= 2^36. A limb sum holds a value below 2^36 (its start, or the r
// that rns_scale adds at its end) and at most 15 products below 2^60 past
// its last fold (fold below), 2^36 + 15 2^60 < 2^64.
// BfvParams.default_u32(32768) reaches 59 limbs in the product base.
//
// Bound on the H100 at the main-path shapes (N = 8192, batch 64,
// default_u32(8192)), int64 in and out: rns_convert [64,4,7,N] ->
// [64,4,15,N] moves 369 MB (0.110 ms at 3.35 TB/s); scale_convert
// [64,3,15,N] -> [64,3,7,N] moves 277 MB (0.083 ms); rns_scale [64,3,15,N]
// -> [64,3,8,N] moves 289 MB (0.086 ms); mod_down [64,2,8,N] -> [64,2,7,N]
// moves 126 MB (0.038 ms). Their 32-bit multiplies (chip_smoke.py counts
// them) take under 0.06 ms at 16.7 T/s, so all four are bound by bytes.
// At default_u32(32768)'s multiply, scale_convert [64,3,59,32768] ->
// [64,3,29,32768] moves 4.4 GB (1.32 ms) but takes 39 G multiplies
// (2.34 ms), rns_scale into the 30 limbs of B 26 G (1.57 ms): bound by
// operations.

#include "common.cuh"

#define MAXK 64          // the source base of rns_scale and scale_convert
#define CONVERT_MAXK 32  // both bases of rns_convert, B of scale_convert

// Four 32-bit words, one 16-byte load from shared memory.
struct __align__(16) Words {
  u32 w0, w1, w2, w3;
};

__device__ __forceinline__ Words words128(u64 hi, u64 lo) {
  return {(u32)lo, (u32)(lo >> 32), (u32)hi, (u32)(hi >> 32)};
}

// (q, w, floor(w 2^32 / q)) of a table row (q, m, w, ...)
__device__ __forceinline__ Words shoup_row(const long long* row) {
  const u32 q = (u32)row[0], w = (u32)row[2];
  return {q, w, shoup32(w, q, (u64)row[1]), 0};
}

// Exact running sum of y f / 2^128 over terms with y < 2^30 and f a
// 128-bit fraction (four 32-bit words): word k of the products sums in
// a[k] (each product below 2^62, so four terms fit a u64 above a carried
// word); carry() moves every word's bits above 32 into the next, the
// integer part into hi. Every carry reaches hi, as in the reference's
// column sums (math/rns.py::fixed_point_dot).
struct Frac128 {
  u64 a[4] = {0, 0, 0, 0}, hi = 0;
  __device__ __forceinline__ void add(u32 y, const Words& f) {
    a[0] += (u64)y * f.w0;
    a[1] += (u64)y * f.w1;
    a[2] += (u64)y * f.w2;
    a[3] += (u64)y * f.w3;
  }
  __device__ __forceinline__ void carry() {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a[k + 1] += a[k] >> 32;
      a[k] = (u32)a[k];
    }
    hi += a[3] >> 32;
    a[3] = (u32)a[3];
  }
  // floor(total)
  __device__ __forceinline__ u64 floor() {
    carry();
    return hi;
  }
  // floor(total + 1/2)
  __device__ __forceinline__ u64 round() {
    carry();
    return hi + ((a[3] + (1ull << 31)) >> 32);
  }
};

// Whether a limb sum of up to K terms below (2^30)^2, plus a value below
// K 2^30 (r, alpha (d_l - B mod d_l): its start, or rns_scale's r at its
// end), folds after term i: never for K <= 16
// (K 2^30 + 16 (2^30 - 1)^2 < 2^64), else every 15 terms
// (K 2^30 + 15 (2^30 - 1)^2 < 2^64 for K <= 64).
template <int K>
__device__ __forceinline__ constexpr bool fold(int i) {
  return K > 16 && i % 15 == 14 && i + 1 < K;
}

// rns_convert's tables, staged once a block from the int64 tables into
// shared memory as u32 words (3.2 KB for <16>, 5.8 KB for <32>), the
// digits' entries zero past ks: all threads of a warp read the same word, a
// broadcast.
template <int K>
struct CvTables {
  Words s[K];        // q_i, (Q/q_i)^-1 mod q_i, its Shoup ratio
  Words f[K];        // 1/q_i rounded up, four 32-bit words
  u32 th[CONVERT_MAXK][K];  // theta transposed: th[j][i] = theta_ij
  Red32 d[CONVERT_MAXK];     // d_j and its reduction constants
  u32 dneg[CONVERT_MAXK];    // d_j - (Q mod d_j)
};

// v = x[row][i][col] for i < ks, 0 past ks or past the last row.
template <int K>
__device__ __forceinline__ void load_column(long long (&v)[K],
                                            const long long* __restrict__ x,
                                            int row, int rows, int ks, int n,
                                            int col) {
#pragma unroll
  for (int i = 0; i < K; ++i)
    v[i] = row < rows && i < ks ? x[((size_t)row * ks + i) * n + col] : 0;
}

// x [rows, ks, N] -> out [rows, kd, N], or [rows, ks + kd, N] with the source
// limbs copied ahead (include_src). y_i = x_i (Q/q_i)^-1 mod q_i,
// alpha = floor(sum_i y_i / q_i (+ 1/2 if centered)); out_j = sum_i y_i
// theta_ij - alpha (Q mod d_j) mod d_j. One thread a column in
// CONVERT_ROWS rows (blockIdx.y striding over them), after the block has
// staged the tables (the Shoup ratios derived from floor(2^64 / q)); the
// next row's digits are loaded while a row is converted. Each
// normalization is one 32-bit Shoup product, alpha an exact 128-bit
// fixed-point sum of four multiply-adds a term (Frac128), each limb a chain
// of 32 x 32 -> 64-bit multiply-adds started from alpha (d_j - Q mod d_j)
// and reduced once by 32-bit steps (fold: every 15 terms for K > 16), two
// limbs at a time. The loops run over all K digits, unguarded: digits past
// ks are 0. ptxas takes 122-210 registers a thread (<8> to <16>): capped
// at 80, the spills made the kernel slower on the H100, as did one row a
// block, no prefetch or one limb at a time.
//   src [ks]: q_i, m, (Q/q_i)^-1 mod q_i, 1/q_i rounded up (hi, lo word)
//   dst [kd]: d_j, m, Q mod d_j
//   theta [ks][kd]: (Q/q_i) mod d_j
template <int K>
__global__ void __launch_bounds__(256)
    rns_convert_kernel(const long long* __restrict__ x,
                       long long* __restrict__ out,
                       const long long* __restrict__ src,
                       const long long* __restrict__ dst,
                       const long long* __restrict__ theta, int rows, int ks,
                       int kd, int n, int centered, int include_src) {
  __shared__ CvTables<K> tb;
  for (int e = threadIdx.x; e < kd * K; e += blockDim.x) {
    const int j = e / K, i = e % K;
    tb.th[j][i] = i < ks ? (u32)theta[i * kd + j] : 0u;
  }
  for (int e = threadIdx.x; e < K + kd; e += blockDim.x) {
    if (e < K) {
      const long long* r = src + 8 * e;
      tb.s[e] = e < ks ? shoup_row(r) : Words{1, 0, 0, 0};
      tb.f[e] = e < ks ? words128((u64)r[3], (u64)r[4]) : Words{0, 0, 0, 0};
    } else {
      const long long* r = dst + 8 * (e - K);
      tb.d[e - K] = red32((u32)r[0], (u64)r[1]);
      tb.dneg[e - K] = (u32)(r[0] - r[2]);
    }
  }
  __syncthreads();
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const int ko = include_src ? ks + kd : kd;
  long long xn[K];  // the column's digits in the block's next row
  load_column(xn, x, blockIdx.y, rows, ks, n, col);
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    long long* oc = out + (size_t)row * ko * n + col;
    u32 y[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (include_src && i < ks) oc[(size_t)i * n] = xn[i];
      y[i] = (u32)xn[i];
    }
    load_column(xn, x, row + gridDim.y, rows, ks, n, col);
    Frac128 fr;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const Words si = tb.s[i];
      y[i] = mul_shoup(y[i], si.w1, si.w2, si.w0);
      fr.add(y[i], tb.f[i]);
      if ((i & 3) == 3) fr.carry();
    }
    const u32 alpha = (u32)(centered ? fr.round() : fr.floor());  // <= ks
    if (include_src) oc += (size_t)ks * n;
#pragma unroll 2
    for (int j = 0; j < kd; ++j) {
      const Red32 dj = tb.d[j];
      u64 acc = (u64)alpha * tb.dneg[j];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        acc += (u64)y[i] * tb.th[j][i];
        if (fold<K>(i)) acc = red2q(acc, dj);
      }
      oc[(size_t)j * n] = red(acc, dj);
    }
  }
}

// rns_scale's tables, staged once a block from the int64 tables into
// shared memory as u32 words (1.1 KB for <16>, 3.3 KB for <32>, 10.5 KB
// for <64>), the entries zero past ks and kd: all threads of a warp read
// the same word, a broadcast.
template <int K>
struct ScaleTables {
  Words a[K];           // q_i, (A/q_i)^-1 mod q_i, its Shoup ratio
  Words af[K];          // phi_i, four 32-bit words, lowest first
  Words om[K][K / 8];   // omega_ij, four limbs a word: om[i][g] = j 4g..4g+3
  Red32 b[K / 2];       // b_j and its reduction constants
};

// v[u] = x[row][c G + u][col] as u32 for c G + u < ks, 0 past ks or past
// the last row.
template <int G>
__device__ __forceinline__ void load_digits(u32 (&v)[G],
                                            const long long* __restrict__ x,
                                            int row, int rows, int ks, int n,
                                            int col, int c) {
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const int i = c * G + u;
    v[u] = row < rows && i < ks ? (u32)x[((size_t)row * ks + i) * n + col]
                                : 0u;
  }
}

// x [rows, ks, N] in the tensor base A -> out [rows, kd, N] =
// round(t x / Q) mod each b_j of a base B dividing A / Q (ks <= K,
// kd <= K / 2). With y_i = x_i (A/q_i)^-1 mod q_i and
// r = floor(sum_i y_i phi_i + 1/2): out_j = sum_i y_i omega_ij + r mod b_j.
// One thread a column in the rows blockIdx.y strides over, after the
// block has staged the tables (the Shoup ratios derived from
// floor(2^64 / q)). Digit-major: each digit is normalized by one 32-bit
// Shoup product, added into r's exact 128-bit fixed-point sum (Frac128)
// and into all K / 2 limb sums at once, 32 x 32 -> 64-bit multiply-adds
// reading omega's row four limbs a 16-byte load; the sums fold every 15
// digits (fold) and take r before their one reduction. The digits are
// loaded G at a time, each group while the one before is scaled, the
// next row's first group while the last is.
//   a [ks]: q_i, m, (A/q_i)^-1 mod q_i, phi_i = frac(t (A/q_i) / Q) (hi, lo)
//   d [kd]: b_j, m; omega [ks][kd]
template <int K>
__device__ __forceinline__ void scale_rows(const long long* __restrict__ x,
                                           long long* __restrict__ out,
                                           const long long* __restrict__ a,
                                           const long long* __restrict__ d,
                                           const long long* __restrict__ omega,
                                           int rows, int ks, int kd, int n) {
  constexpr int KD = K / 2, G = K > 32 ? 8 : 16;
  __shared__ ScaleTables<K> tb;
  for (int e = threadIdx.x; e < K * KD / 4; e += blockDim.x) {
    const int i = e / (KD / 4), j = 4 * (e % (KD / 4));
    u32 w[4];
#pragma unroll
    for (int l = 0; l < 4; ++l)
      w[l] = i < ks && j + l < kd ? (u32)omega[i * kd + j + l] : 0u;
    tb.om[i][e % (KD / 4)] = {w[0], w[1], w[2], w[3]};
  }
  for (int e = threadIdx.x; e < K + KD; e += blockDim.x) {
    if (e < K) {
      const long long* r = a + 8 * e;
      tb.a[e] = e < ks ? shoup_row(r) : Words{1, 0, 0, 0};
      tb.af[e] = e < ks ? words128((u64)r[3], (u64)r[4]) : Words{0, 0, 0, 0};
    } else {
      const int j = e - K;
      tb.b[j] = j < kd ? red32((u32)d[8 * j], (u64)d[8 * j + 1])
                       : Red32{1, 0, 0, 0};
    }
  }
  __syncthreads();
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  u32 v[G];  // the next group of the column's digits
  load_digits<G>(v, x, blockIdx.y, rows, ks, n, col, 0);
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    // the table words are read anew each row: held across rows in
    // registers, they spilled
    asm volatile("" ::: "memory");
    u64 acc[KD] = {};
    Frac128 fr;
#pragma unroll
    for (int c = 0; c < K / G; ++c) {
      u32 y[G];
#pragma unroll
      for (int u = 0; u < G; ++u) y[u] = v[u];
      if (c + 1 < K / G)
        load_digits<G>(v, x, row, rows, ks, n, col, c + 1);
      else
        load_digits<G>(v, x, row + gridDim.y, rows, ks, n, col, 0);
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int i = c * G + u;
        if (i < ks) {
          const Words ai = tb.a[i];
          const u32 yi = mul_shoup(y[u], ai.w1, ai.w2, ai.w0);
          fr.add(yi, tb.af[i]);
#pragma unroll
          for (int g = 0; g < KD / 4; ++g) {
            const Words w = tb.om[i][g];
            acc[4 * g] += (u64)yi * w.w0;
            acc[4 * g + 1] += (u64)yi * w.w1;
            acc[4 * g + 2] += (u64)yi * w.w2;
            acc[4 * g + 3] += (u64)yi * w.w3;
          }
        }
        if ((i & 3) == 3) fr.carry();
        if (fold<K>(i) && i + 1 < ks) {
#pragma unroll
          for (int j = 0; j < KD; ++j) acc[j] = red2q(acc[j], tb.b[j]);
        }
      }
    }
    const u64 r = fr.round();
    long long* oc = out + (size_t)row * kd * n + col;
#pragma unroll
    for (int j = 0; j < KD; ++j)
      if (j < kd) oc[(size_t)j * n] = red(acc[j] + r, tb.b[j]);
  }
}

// ptxas takes 79 registers at <16>, 112 at <32>; asked for two blocks an
// SM, it took more and ran slower on the H100.
template <int K>
__global__ void __launch_bounds__(256)
    rns_scale_kernel(const long long* __restrict__ x,
                     long long* __restrict__ out,
                     const long long* __restrict__ a,
                     const long long* __restrict__ d,
                     const long long* __restrict__ omega, int rows, int ks,
                     int kd, int n) {
  scale_rows<K>(x, out, a, d, omega, rows, ks, kd, n);
}

// <64>: at most 128 registers, two blocks an SM (a few hundred bytes of
// spills); one block at 166 registers ran slower on the H100.
template <>
__global__ void __launch_bounds__(256, 2)
    rns_scale_kernel<MAXK>(const long long* __restrict__ x,
                           long long* __restrict__ out,
                           const long long* __restrict__ a,
                           const long long* __restrict__ d,
                           const long long* __restrict__ omega,
                           int rows, int ks, int kd, int n) {
  scale_rows<MAXK>(x, out, a, d, omega, rows, ks, kd, n);
}

// scale_convert's tables, staged once a block from the int64 tables into
// shared memory as u32 words (3 KB for <16, 8>, 11 KB for <32, 32>, 20 KB
// for <64, 32>, under the 48 KB of static shared memory a block may have):
// all threads of a warp read the same word, a broadcast.
template <int KS, int KM>
struct ScTables {
  Words a[KS];     // q_i, (A/q_i)^-1 mod q_i, its Shoup ratio
  Words af[KS];    // phi_i, four 32-bit words, lowest first
  u32 om[KM][KS];  // omega transposed: om[j][i] = omega_ij
  Red32 b[KM];     // b_j and its reduction constants
  Words bn[KM];    // (B/b_j)^-1 mod b_j, its Shoup ratio
  Words bf[KM];    // 1/b_j rounded up, four 32-bit words
  u32 th[KS][KM];  // theta transposed: th[l][j] = theta_jl
  Red32 d[KS];     // d_l and its reduction constants
  u32 dneg[KS];    // d_l - (B mod d_l)
};

// One column of scale_convert: x [ks] (limbs n apart) in the tensor base
// -> out [kd] in Q: s = round(t x / Q) mod each b_j, then the centered
// conversion of s from B to Q. With y_i = x_i (A/q_i)^-1 mod q_i and
// r = floor(sum_i y_i phi_i + 1/2): s_j = sum_i y_i omega_ij + r mod b_j;
// z_j = s_j (B/b_j)^-1 mod b_j, alpha = floor(sum_j z_j / b_j + 1/2);
// out_l = sum_j z_j theta_jl - alpha (B mod d_l) mod d_l. KS >= ks,
// KM >= km and KS > kd bound the unrolled loops. Each normalization is one
// 32-bit Shoup product, each limb sum a chain of 32 x 32 -> 64-bit
// multiply-adds started from r (or alpha (d_l - B mod d_l)) and reduced
// once by 32-bit steps (fold), and each fixed-point sum four multiply-adds
// a term (Frac128).
template <int KS, int KM>
__device__ __forceinline__ void scale_convert_column(
    const ScTables<KS, KM>& tb, const long long* __restrict__ xc,
    long long* __restrict__ oc, int ks, int km, int kd, int n) {
  // digits and limbs past ks and km are 0, so the products and fractions
  // over the full KS and KM run unguarded
  u32 y[KS];
#pragma unroll
  for (int i = 0; i < KS; ++i) y[i] = i < ks ? (u32)xc[(size_t)i * n] : 0;
  Frac128 fr;
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    if (i < ks) {
      const Words ai = tb.a[i];
      y[i] = mul_shoup(y[i], ai.w1, ai.w2, ai.w0);
    }
    fr.add(y[i], tb.af[i]);
    if ((i & 3) == 3) fr.carry();
  }
  const u64 r = fr.round();
  u32 z[KM];
  Frac128 fz;
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    z[j] = 0;
    if (j < km) {
      const Red32 bj = tb.b[j];
      u64 acc = r;
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        acc += (u64)y[i] * tb.om[j][i];
        if (fold<KS>(i)) acc = red2q(acc, bj);
      }
      const Words bn = tb.bn[j];
      z[j] = mul_shoup(red2q(acc, bj), bn.w1, bn.w2, bj.q);
    }
    fz.add(z[j], tb.bf[j]);
    if ((j & 3) == 3) fz.carry();
  }
  const u32 alpha = (u32)fz.round();  // at most km
#pragma unroll 1
  for (int l = 0; l < kd; ++l) {
    const Red32 dl = tb.d[l];
    u64 acc = (u64)alpha * tb.dneg[l];
#pragma unroll
    for (int j = 0; j < KM; ++j) {
      acc += (u64)z[j] * tb.th[l][j];
      if (fold<KM>(j)) acc = red2q(acc, dl);
    }
    oc[(size_t)l * n] = red(acc, dl);
  }
}

// x [rows, ks, N] in the tensor base -> out [rows, kd, N] in Q, one thread
// a column (scale_convert_column), blockIdx.y striding over the rows, after
// the block has staged the tables (the Shoup ratios derived from
// floor(2^64 / q)).
//   a [ks]: q_i, m, (A/q_i)^-1 mod q_i, phi_i = frac(t (A/q_i) / Q) (hi, lo)
//   b [km]: b_j, m, (B/b_j)^-1 mod b_j, 1/b_j rounded up (hi, lo)
//   d [kd]: d_l, m, B mod d_l
//   omega [ks][km], theta [km][kd]
template <int KS, int KM>
__global__ void __launch_bounds__(256)
    scale_convert_kernel(const long long* __restrict__ x,
                         long long* __restrict__ out,
                         const long long* __restrict__ a,
                         const long long* __restrict__ b,
                         const long long* __restrict__ d,
                         const long long* __restrict__ omega,
                         const long long* __restrict__ theta, int rows,
                         int ks, int km, int kd, int n) {
  __shared__ ScTables<KS, KM> tb;
  for (int e = threadIdx.x; e < ks * km + km * kd; e += blockDim.x) {
    if (e < ks * km)
      tb.om[e % km][e / km] = (u32)omega[e];
    else
      tb.th[(e - ks * km) % kd][(e - ks * km) / kd] =
          (u32)theta[e - ks * km];
  }
  for (int e = threadIdx.x; e < ks + km + kd; e += blockDim.x) {
    if (e < ks) {
      const long long* r = a + 8 * e;
      tb.a[e] = shoup_row(r);
      tb.af[e] = words128((u64)r[3], (u64)r[4]);
    } else if (e < ks + km) {
      const int j = e - ks;
      const long long* r = b + 8 * j;
      tb.b[j] = red32((u32)r[0], (u64)r[1]);
      tb.bn[j] = shoup_row(r);
      tb.bf[j] = words128((u64)r[3], (u64)r[4]);
    } else {
      const int l = e - ks - km;
      const long long* r = d + 8 * l;
      tb.d[l] = red32((u32)r[0], (u64)r[1]);
      tb.dneg[l] = (u32)(r[0] - r[2]);
    }
  }
  __syncthreads();
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y)
    scale_convert_column<KS, KM>(tb, x + (size_t)row * ks * n + col,
                                 out + (size_t)row * kd * n + col, ks, km, kd,
                                 n);
}

// x_q rows of k limbs (row stride sq elements, limbs N apart) and x_p rows
// (row stride sp) -> out [rows, k, N] = round(x / p) mod q_j:
// v = (x_p + p/2) mod p; out_j = ((x_j + p/2 mod q_j) - v mod q_j) p^-1.
//   tab [k]: q_j, m, floor(p/2) mod q_j, p^-1 mod q_j
__global__ void mod_down_kernel(const long long* __restrict__ xq,
                                const long long* __restrict__ xp,
                                long long* __restrict__ out,
                                const long long* __restrict__ tab, int rows,
                                int k, int n, int sq, int sp, int p,
                                int half) {
  const size_t id = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= (size_t)rows * n) return;
  const size_t row = id / n, col = id % n;
  u32 v = (u32)xp[row * sp + col] + (u32)half;
  if (v >= (u32)p) v -= (u32)p;
  const long long* xc = xq + row * sq + col;
  long long* oc = out + row * k * n + col;
  for (int j = 0; j < k; ++j) {
    const Mod qj = load_mod(tab, j);
    const u32 num = sub_q(add_q((u32)xc[(size_t)j * n], (u32)tab_at(tab, j, 2),
                                qj.q),
                          reduce64(v, qj.q, qj.m), qj.q);
    oc[(size_t)j * n] = reduce64((u64)num * tab_at(tab, j, 3), qj.q, qj.m);
  }
}

static const int THREADS = 256;
static const int CONVERT_ROWS = 4;  // rows a rns_convert thread converts
// rows a rns_scale thread scales up to 32 limbs (one at <64>: the H100 ran
// <64> fastest so, <16> and <32> at four)
static const int SCALE_ROWS = 4;

static unsigned blocks_for(int rows, int n) {
  return (unsigned)(((size_t)rows * n + THREADS - 1) / THREADS);
}

extern "C" int rns_convert(const void* x, void* out, const void* src,
                           const void* dst, const void* theta, int rows,
                           int ks, int kd, int n, int centered,
                           int include_src, void* stream) {
  if (ks > CONVERT_MAXK || kd > CONVERT_MAXK)
    return (int)cudaErrorInvalidValue;
  auto kern = ks <= 8    ? &rns_convert_kernel<8>
              : ks <= 16 ? &rns_convert_kernel<16>
                         : &rns_convert_kernel<CONVERT_MAXK>;
  if (rows == 0) return 0;
  const int gy = (rows + CONVERT_ROWS - 1) / CONVERT_ROWS;
  const dim3 grid((n + THREADS - 1) / THREADS, gy < 65535 ? gy : 65535);
  kern<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)x, (long long*)out, (const long long*)src,
      (const long long*)dst, (const long long*)theta, rows, ks, kd, n,
      centered, include_src);
  return (int)cudaGetLastError();
}

extern "C" int rns_scale(const void* x, void* out, const void* a,
                         const void* d, const void* omega, int rows, int ks,
                         int kd, int n, void* stream) {
  if (ks > MAXK || 2 * kd > MAXK) return (int)cudaErrorInvalidValue;
  const int k = ks > 2 * kd ? ks : 2 * kd;
  auto kern = k <= 16   ? &rns_scale_kernel<16>
              : k <= 32 ? &rns_scale_kernel<32>
                        : &rns_scale_kernel<MAXK>;
  if (rows == 0) return 0;
  const int per = k > 32 ? 1 : SCALE_ROWS;
  const int gy = (rows + per - 1) / per;
  const dim3 grid((n + THREADS - 1) / THREADS, gy < 65535 ? gy : 65535);
  kern<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)x, (long long*)out, (const long long*)a,
      (const long long*)d, (const long long*)omega, rows, ks, kd, n);
  return (int)cudaGetLastError();
}

extern "C" int scale_convert(const void* x, void* out, const void* a,
                             const void* b, const void* d, const void* omega,
                             const void* theta, int rows, int ks, int km,
                             int kd, int n, void* stream) {
  if (ks > MAXK || km > CONVERT_MAXK || kd >= ks)
    return (int)cudaErrorInvalidValue;
  auto kern = ks <= 16   ? (km <= 8 ? &scale_convert_kernel<16, 8>
                                    : &scale_convert_kernel<16, 16>)
              : ks <= 32 ? (km <= 16 ? &scale_convert_kernel<32, 16>
                                     : &scale_convert_kernel<32, 32>)
                         : &scale_convert_kernel<MAXK, CONVERT_MAXK>;
  if (rows == 0) return 0;
  const dim3 grid((n + THREADS - 1) / THREADS, rows < 65535 ? rows : 65535);
  kern<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)x, (long long*)out, (const long long*)a,
      (const long long*)b, (const long long*)d, (const long long*)omega,
      (const long long*)theta, rows, ks, km, kd, n);
  return (int)cudaGetLastError();
}

extern "C" int mod_down(const void* xq, const void* xp, void* out,
                        const void* tab, int rows, int k, int n, int sq,
                        int sp, int p, int half, void* stream) {
  mod_down_kernel<<<blocks_for(rows, n), THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)xq, (const long long*)xp, (long long*)out,
      (const long long*)tab, rows, k, n, sq, sp, p, half);
  return (int)cudaGetLastError();
}
