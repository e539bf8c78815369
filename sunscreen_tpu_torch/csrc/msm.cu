// M1: Pippenger multi-scalar multiplication over ristretto255,
// sum_i s_i * P_i, on the card.
//
// Replaces `sunscreen_tpu/zk/tpu_curve.py` `msm_tpu_fn` (:240, jitted at
// :281, wrapper `msm` :284): plain JAX under `jax.jit`, not a Pallas kernel,
// and the only device function of the reference's ZK stack. Its 9 x 29-bit
// limbs in u64 lanes work around the TPU's lack of a 64-bit product, and its
// sort plus segmented Hillis-Steele scan (n log n additions) worked around an
// XLA compile that ran out of memory; neither is carried over.
//
// Field. An element mod p = 2^255 - 19 is eight 32-bit limbs, below 2^256
// but not always below p (the caller reduces the result). Products are PTX
// carry chains (mad.lo.cc / madc.hi.cc), laid out by the parity of i + j:
// within a row of the schoolbook the products a_j b_i of one parity tile
// whole word pairs, so each chain step is one fused 32 x 32 + 64 multiply-
// add (IMAD.WIDE.U32.X), and two accumulators merge at the end; a square
// takes 36 products, and 2^256 = 38 (mod p) folds the high half. Every PTX
// primitive has a portable body under `#ifndef __CUDA_ARCH__`, with the
// carry flag in a thread-local word, so the same source builds for the
// host in the tests.
//
// Points. Extended twisted-Edwards coordinates (X:Y:Z:T), added with the
// unified formula of the reference's `Point.__add__` (add-2008-hwcd-3,
// k = 2d) and doubled with its `Point.double` (dbl-2008-hwcd). A point
// operation runs on a team of four lanes of one warp, lane q holding
// coordinate q (X, Y, Z, T): at each stage of both formulas the four
// multiplies are independent (Hisil-Wong-Carter-Dawson), so each lane takes
// one, and the team exchanges them through shared memory (two buffers a
// team, one __syncwarp a stage). The second operand of an addition comes in
// cached form (Y - X, Y + X, 2 Z, 2d T): a doubling is two multiply
// latencies, an addition of a cached point two, of a plain one three (its
// 2d T on one lane first).
//
// Three kernels, each launched once a call, on windows of c bits
// (c <= MAX_C = 12):
//  1. msm_digit_kernel, a thread a point: its scalar's ceil(253 / c)
//     digits, as u16 rows [window][n], and its cached form;
//  2. msm_sort_kernel, a block a window, a warp per 512 indices up to 16
//     warps (8 at c = 12): a stable counting sort of the point indices by
//     digit. Each warp counts a contiguous range of indices into its own
//     row of a [warps][2^c] table in shared memory (integer atomics), a
//     scan gives each (warp, digit) its place, and a second pass places the
//     indices in rounds of 32 in order, a lane's rank among its digit's
//     lanes from __match_any_sync;
//  3. msm_bucket_kernel, `teams` teams (up to 32) a block, `blocks` blocks
//     a window, the top windows first, and one block more for the join.
//     A window's sum of b S_b by running sums: its events, in ascending
//     order, are for each bucket b >= 1 an end marker followed by b's
//     points (digit 0 is dropped). A team takes an equal share of them and
//     walks it downwards: a point adds into `run`, an end marker adds `run`
//     into `acc`. A share [x0, x1) with k end markers before x0 contributes
//     acc + k run (k by double-and-add, at most c bits), so the shares sum
//     to sum_b b S_b exactly wherever the cuts fall: no bucket, however
//     full (the prover's witnesses fill a few), holds up a team. Each event
//     is one addition, so a window costs n + 2^c additions, the bound's
//     count, plus the c-bit scalings and the trees. The block's shares are
//     summed by a tree in shared memory; the window's last block to finish
//     (an integer ticket) sums the window's blocks by a tree and raises the
//     window's flag. The last block's first team joins the windows, c
//     doublings each, most significant first, waiting on each window's
//     flag just before adding it, so the join's doublings run while the
//     lower windows are still summed.
// The order of every sum is fixed, so the output is the same
// representative on every run; no atomics touch a point.
//
// Bound: operations. Pippenger takes ceil(253 / c) (n + 2^(c+1)) point
// additions of 9 field multiplies, 72 32 x 32 -> 64-bit products each; the
// bytes (160 a point) are far below that. The join is the chain floor:
// c (nwin - 1) doublings and nwin - 1 additions, one after another, whose
// latency no width of the card shortens (the kernel writes its own time,
// waits excluded, from the globaltimer). At the main path's n ~ 2049 the
// MSM is latency-bound by that chain, which the four-lane point operation
// and the fused multiply chains shorten; at 65536 the buckets' running
// sums fill the card.

#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;
typedef uint64_t u64;

constexpr int MAX_C = 12;         // the sort's [16][2^c] table (8 warps at 12)
constexpr int SORT_SPAN = 512;    // indices a sort warp takes, at least
constexpr int SCALAR_BITS = 253;  // scalars are reduced mod L < 2^253
constexpr int TEAMS = 32;         // teams of four lanes a bucket block
constexpr int DIGIT_THREADS = 256;
constexpr int SORT_BATCH = 8;     // rounds of digits a warp loads at once
constexpr u32 FULL = 0xffffffffu;
#define SYNC_WORDS(nwin) (2 * (nwin) + 4)

struct __align__(16) fe {
  u32 v[8];
};

// --- PTX carry-chain primitives ---------------------------------------------
// On the card the carry flag is the hardware's; on the host a thread-local
// word plays it, with the same semantics.

#ifndef __CUDA_ARCH__
inline thread_local u32 host_cf = 0;
#endif

__device__ __forceinline__ u32 add_cc(u32 a, u32 b) {
#ifdef __CUDA_ARCH__
  u32 r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  const u64 s = (u64)a + b;
  host_cf = (u32)(s >> 32);
  return (u32)s;
#endif
}

__device__ __forceinline__ u32 addc_cc(u32 a, u32 b) {
#ifdef __CUDA_ARCH__
  u32 r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  const u64 s = (u64)a + b + host_cf;
  host_cf = (u32)(s >> 32);
  return (u32)s;
#endif
}

__device__ __forceinline__ u32 addc(u32 a, u32 b) {
#ifdef __CUDA_ARCH__
  u32 r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  return a + b + host_cf;
#endif
}

__device__ __forceinline__ u32 sub_cc(u32 a, u32 b) {
#ifdef __CUDA_ARCH__
  u32 r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  host_cf = a < b;
  return a - b;
#endif
}

__device__ __forceinline__ u32 subc_cc(u32 a, u32 b) {
#ifdef __CUDA_ARCH__
  u32 r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  const u64 d = (u64)a - b - host_cf;
  host_cf = (u32)(d >> 63);
  return (u32)d;
#endif
}

__device__ __forceinline__ u32 subc(u32 a, u32 b) {
#ifdef __CUDA_ARCH__
  u32 r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  return a - b - host_cf;
#endif
}

// lo(a b) + c and hi(a b) + c, with and without the carry in and out
__device__ __forceinline__ u32 mad_lo_cc(u32 a, u32 b, u32 c) {
#ifdef __CUDA_ARCH__
  u32 r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
#else
  const u64 s = (u64)(u32)(a * b) + c;
  host_cf = (u32)(s >> 32);
  return (u32)s;
#endif
}

__device__ __forceinline__ u32 madc_lo_cc(u32 a, u32 b, u32 c) {
#ifdef __CUDA_ARCH__
  u32 r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
#else
  const u64 s = (u64)(u32)(a * b) + c + host_cf;
  host_cf = (u32)(s >> 32);
  return (u32)s;
#endif
}

__device__ __forceinline__ u32 mad_hi_cc(u32 a, u32 b, u32 c) {
#ifdef __CUDA_ARCH__
  u32 r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
#else
  const u64 s = (((u64)a * b) >> 32) + c;
  host_cf = (u32)(s >> 32);
  return (u32)s;
#endif
}

__device__ __forceinline__ u32 madc_hi_cc(u32 a, u32 b, u32 c) {
#ifdef __CUDA_ARCH__
  u32 r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
#else
  const u64 s = (((u64)a * b) >> 32) + c + host_cf;
  host_cf = (u32)(s >> 32);
  return (u32)s;
#endif
}

__device__ __forceinline__ u32 madc_hi(u32 a, u32 b, u32 c) {
#ifdef __CUDA_ARCH__
  u32 r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
#else
  return (u32)(((u64)a * b) >> 32) + c + host_cf;
#endif
}

// --- the field mod 2^255 - 19 ----------------------------------------------

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  fe r;
  r.v[0] = add_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) r.v[i] = addc_cc(a.v[i], b.v[i]);
  const u32 carry = addc(0, 0);
  // 2^256 = 38: a second carry leaves r below 38, so the last 38 cannot
  // carry again
  r.v[0] = add_cc(r.v[0], 38 * carry);
#pragma unroll
  for (int i = 1; i < 8; ++i) r.v[i] = addc_cc(r.v[i], 0);
  r.v[0] += 38 * addc(0, 0);
  return r;
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  fe r;
  r.v[0] = sub_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) r.v[i] = subc_cc(a.v[i], b.v[i]);
  const u32 wrap = subc(0, 0);            // all ones on a borrow
  // a wrap added 2^256 = 38 (mod p): take 38 off; a second wrap leaves r
  // at least 2^256 - 38, so the last 38 cannot borrow again
  r.v[0] = sub_cc(r.v[0], wrap & 38);
#pragma unroll
  for (int i = 1; i < 8; ++i) r.v[i] = subc_cc(r.v[i], 0);
  r.v[0] -= subc(0, 0) & 38;
  return r;
}

// t [16] (below 2^512) mod p, below 2^256: t_lo + 38 t_hi in two chains
// (the low and the high words of each 38 t_{8+j}), then the ninth word,
// at most 38, folded again
__device__ __forceinline__ fe fe_fold(const u32* t) {
  fe r;
  r.v[0] = mad_lo_cc(t[8], 38, t[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) r.v[j] = madc_lo_cc(t[8 + j], 38, t[j]);
  u32 top = addc(0, 0);
  r.v[1] = mad_hi_cc(t[8], 38, r.v[1]);
#pragma unroll
  for (int j = 1; j < 7; ++j) r.v[j + 1] = madc_hi_cc(t[8 + j], 38, r.v[j + 1]);
  top = madc_hi(t[15], 38, top);
  r.v[0] = mad_lo_cc(top, 38, r.v[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) r.v[j] = addc_cc(r.v[j], 0);
  // a carry out leaves r below 38 * 39
  r.v[0] += 38 * addc(0, 0);
  return r;
}

// Products by the parity of i + j: a_j b_i (64 bits) lands on words
// i + j and i + j + 1, so the products of one parity in a row tile a run of
// whole word pairs, which one carry chain adds with a fused 32 x 32 + 64
// multiply-add a product. Two accumulators (even and odd i + j) are merged
// at the end. `pairs` adds a_j bi for j = j0, j0 + 2, ..., j0 + 2 (m - 1)
// at word i + j of acc, and its carry into word i + j0 + 2 m when that word
// can hold it (j0 + 2 m <= 8: the rows up to i sum below
// (b mod 2^(32 (i + 1))) a < 2^(32 (i + 9)), so a carry past word i + 8 is
// zero).
__device__ __forceinline__ void pairs(u32* acc, const fe& a, u32 bi, int i,
                                      int j0, int m) {
  acc[i + j0] = mad_lo_cc(a.v[j0], bi, acc[i + j0]);
  acc[i + j0 + 1] = madc_hi_cc(a.v[j0], bi, acc[i + j0 + 1]);
#pragma unroll
  for (int k = 1; k < m; ++k) {
    const int j = j0 + 2 * k;
    acc[i + j] = madc_lo_cc(a.v[j], bi, acc[i + j]);
    acc[i + j + 1] = madc_hi_cc(a.v[j], bi, acc[i + j + 1]);
  }
  const int w = i + j0 + 2 * m;
  if (j0 + 2 * m <= 8 && w < 16) acc[w] = addc(acc[w], 0);
}

// even + odd, below 2^512 together
__device__ __forceinline__ void merge(u32* t, const u32* e, const u32* o) {
  t[0] = add_cc(e[0], o[0]);
#pragma unroll
  for (int k = 1; k < 15; ++k) t[k] = addc_cc(e[k], o[k]);
  t[15] = addc(e[15], o[15]);
}

__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b) {
  u32 e[16], o[16], t[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) e[k] = o[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    pairs(e, a, b.v[i], i, i & 1, 4);
    pairs(o, a, b.v[i], i, 1 - (i & 1), 4);
  }
  merge(t, e, o);
  return fe_fold(t);
}

// a^2: the 28 products a_i a_j (i < j) by rows as in fe_mul (row i: j from
// i + 1; the rows so far sum below (a mod 2^(32 (i + 1))) a), doubled by a
// one-bit shift, plus the eight squares a_i^2 in one chain
__device__ __forceinline__ fe fe_sqr(const fe& a) {
  u32 e[16], o[16], t[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) e[k] = o[k] = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    if ((7 - i) / 2 > 0) pairs(e, a, a.v[i], i, i + 2, (7 - i) / 2);
    pairs(o, a, a.v[i], i, i + 1, (8 - i) / 2);
  }
  merge(t, e, o);
#pragma unroll
  for (int k = 15; k > 0; --k) t[k] = (t[k] << 1) | (t[k - 1] >> 31);
  t[0] <<= 1;
  t[0] = mad_lo_cc(a.v[0], a.v[0], t[0]);
  t[1] = madc_hi_cc(a.v[0], a.v[0], t[1]);
#pragma unroll
  for (int i = 1; i < 7; ++i) {
    t[2 * i] = madc_lo_cc(a.v[i], a.v[i], t[2 * i]);
    t[2 * i + 1] = madc_hi_cc(a.v[i], a.v[i], t[2 * i + 1]);
  }
  t[14] = madc_lo_cc(a.v[7], a.v[7], t[14]);
  t[15] = madc_hi(a.v[7], a.v[7], t[15]);
  return fe_fold(t);
}

__device__ __forceinline__ fe fe_sel(bool c, const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// 2d mod p, d = -121665 / 121666
__device__ __forceinline__ fe k2d() {
  return fe{{0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au,
             0xeef3d130u, 0x198e80f2u, 0x56dffce7u, 0x2406d9dcu}};
}

// --- four-lane point operations ---------------------------------------------

// A team: four consecutive lanes of a warp; lane q holds coordinate q of the
// team's points (0 X, 1 Y, 2 Z, 3 T) and exchanges through `buf`, two
// buffers of four field elements in shared memory, used in turn: a lane
// writes a buffer again only after the next exchange's __syncwarp, which
// every lane of the team reaches after its reads of the last one.
struct Team {
  int q;
  u32 mask;
  fe* buf;
  int flip;
};

__device__ __forceinline__ Team team_of(fe* xch) {
  const int tid = threadIdx.x;
  return Team{tid & 3, 0xfu << (tid & 28), xch + 8 * (tid >> 2), 0};
}

// publishes a as slot q; returns the buffer
__device__ __forceinline__ const fe* share(Team& t, const fe& a) {
  fe* x = t.buf + 4 * t.flip;
  t.flip ^= 1;
  x[t.q] = a;
  __syncwarp(t.mask);
  return x;
}

__device__ __forceinline__ fe identity_coord(const Team& t) {
  fe r = {};
  r.v[0] = t.q == 1 || t.q == 2;
  return r;
}

// dbl-2008-hwcd: A = X^2, B = Y^2, 2 Z^2, D = (X + Y)^2 on lanes 0-3; then
// E = A + B - D, G = A - B, F = 2 Z^2 + G, H = A + B and
// (X, Y, Z, T) = (E F, G H, F G, E H)
__device__ __forceinline__ fe team_dbl(Team& t, const fe& v) {
  const fe* s = share(t, v);
  const fe xy = fe_add(s[0], s[1]);
  const fe sq = fe_sqr(fe_sel(t.q == 3, xy, v));
  const fe* r = share(t, sq);
  const fe a = r[0], b = r[1], z2 = r[2], d = r[3];
  const fe h = fe_add(a, b), g = fe_sub(a, b);
  const fe e = fe_sub(h, d), f = fe_add(fe_add(z2, z2), g);
  const fe l = fe_sel(t.q == 1, g, fe_sel(t.q == 2, f, e));
  const fe m = fe_sel(t.q == 0, f, fe_sel(t.q == 2, g, h));
  return fe_mul(l, m);
}

// A point's cached form, lane q's coordinate: Y - X, Y + X, 2 Z, 2d T
// (2d T on lane 3 alone: one multiply stage)
__device__ __forceinline__ fe to_cached(Team& t, const fe& v) {
  const fe* s = share(t, v);
  const fe x = s[0], y = s[1];
  fe r = fe_sel(t.q == 0, fe_sub(y, x),
                fe_sel(t.q == 1, fe_add(y, x), fe_add(v, v)));
  if (t.q == 3) r = fe_mul(v, k2d());
  return r;
}

// add-2008-hwcd-3 (unified: also doubles and adds the identity) with the
// second point cached (c): A = (Y1 - X1)(Y2 - X2), B = (Y1 + X1)(Y2 + X2),
// D = Z1 2 Z2, C = T1 2d T2 on lanes 0-3; then E = B - A, F = D - C,
// G = D + C, H = B + A and (X, Y, Z, T) = (E F, G H, F G, E H)
__device__ __forceinline__ fe team_add_cached(Team& t, const fe& v,
                                              const fe& c) {
  const fe* s = share(t, v);
  const fe x1 = s[0], y1 = s[1];
  const fe l = fe_sel(t.q == 0, fe_sub(y1, x1),
                      fe_sel(t.q == 1, fe_add(y1, x1), v));
  const fe* r = share(t, fe_mul(l, c));
  const fe a = r[0], b = r[1], d = r[2], k = r[3];
  const fe e = fe_sub(b, a), f = fe_sub(d, k), g = fe_add(d, k),
           h = fe_add(b, a);
  return fe_mul(fe_sel(t.q == 1, g, fe_sel(t.q == 2, f, e)),
                fe_sel(t.q == 0, f, fe_sel(t.q == 2, g, h)));
}

__device__ __forceinline__ fe team_add(Team& t, const fe& v, const fe& w) {
  return team_add_cached(t, v, to_cached(t, w));
}

// lane q's coordinate of point [32] u32 (X, Y, Z, T limbs)
__device__ __forceinline__ fe load_coord(const u32* p, int q) {
  const uint4* s = reinterpret_cast<const uint4*>(p + 8 * q);
  const uint4 lo = s[0], hi = s[1];
  return fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

// the same from the L2 cache, for what another block wrote in this launch
__device__ __forceinline__ fe load_coord_l2(const u32* p, int q) {
  const uint4* s = reinterpret_cast<const uint4*>(p + 8 * q);
  const uint4 lo = __ldcg(s), hi = __ldcg(s + 1);
  return fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

__device__ __forceinline__ void store_coord(u32* p, int q, const fe& a) {
  uint4* d = reinterpret_cast<uint4*>(p + 8 * q);
  d[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  d[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

__device__ __forceinline__ u64 now_ns() {
#ifdef __CUDA_ARCH__
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
#else
  return 0;
#endif
}

// --- the kernels --------------------------------------------------------------

// bits [w c, w c + c) of the scalar's eight little-endian 32-bit limbs
__device__ __forceinline__ u32 digit(const u32* s, int w, int c) {
  const int bit = w * c, limb = bit >> 5, sh = bit & 31;
  u64 v = s[limb];
  if (limb < 7) v |= (u64)s[limb + 1] << 32;
  return (u32)(v >> sh) & ((1u << c) - 1);
}

// thread i: digits[w][i] for every window w and point i's cached form
// (Y - X, Y + X, 2 Z, 2d T); block 0 also clears `sync`
__global__ void __launch_bounds__(DIGIT_THREADS)
msm_digit_kernel(const u32* __restrict__ scalars,
                 const u32* __restrict__ points, int n, int c, int nwin,
                 uint16_t* __restrict__ digits, u32* __restrict__ cached,
                 u32* __restrict__ sync) {
  if (blockIdx.x == 0)
    for (int k = threadIdx.x; k < SYNC_WORDS(nwin); k += DIGIT_THREADS)
      sync[k] = 0;
  const int i = blockIdx.x * DIGIT_THREADS + threadIdx.x;
  if (i >= n) return;
  u32 s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = scalars[8 * (size_t)i + j];
  for (int w = 0; w < nwin; ++w)
    digits[(size_t)w * n + i] = (uint16_t)digit(s, w, c);
  const u32* p = points + 32 * (size_t)i;
  const fe x = load_coord(p, 0), y = load_coord(p, 1), z = load_coord(p, 2);
  u32* q = cached + 32 * (size_t)i;
  store_coord(q, 0, fe_sub(y, x));
  store_coord(q, 1, fe_add(y, x));
  store_coord(q, 2, fe_add(z, z));
  store_coord(q, 3, fe_mul(load_coord(p, 3), k2d()));
}

// block w: idx[w] = the point indices ordered by digit, stably (warp v
// takes indices [n v / W, n (v + 1) / W) in rounds of 32, one index a lane
// in order), and bstart[w][d] = where bucket d starts in it, ending with n
// at d = 2^c. Shared: cnt [W][2^c], tot [2^c], scan [32 W].
__global__ void __launch_bounds__(512)
msm_sort_kernel(const uint16_t* __restrict__ digits, int n, int c,
                int* __restrict__ idx, int* __restrict__ bstart) {
  extern __shared__ u32 sm[];
  const int w = blockIdx.x, t = threadIdx.x, T = blockDim.x, W = T / 32;
  const int v = t / 32, lane = t & 31;
  const int B = 1 << c;
  u32* cnt = sm;
  u32* tot = sm + W * B;
  u32* scan = tot + B;
  const uint16_t* dg = digits + (size_t)w * n;
  for (int i = t; i < W * B; i += T) cnt[i] = 0;
  __syncthreads();
  const int lo = (int)((long long)n * v / W);
  const int hi = (int)((long long)n * (v + 1) / W);
  const u32 below = (1u << lane) - 1;
  u32* row = cnt + v * B;
  int* out = idx + (size_t)w * n;
  // pass 0 counts (integer atomics: any order gives the same counts);
  // pass 1 places each index in rounds of 32 in order, its rank in the
  // round among the lanes of its digit (__match_any_sync)
  for (int pass = 0; pass < 2; ++pass) {
    for (int base = lo; base < hi; base += 32 * SORT_BATCH) {
      u32 d[SORT_BATCH];
#pragma unroll
      for (int r = 0; r < SORT_BATCH; ++r) {
        const int i = base + 32 * r + lane;
        d[r] = i < hi ? dg[i] : (u32)B;      // B: no bucket
      }
      if (pass == 0) {
#pragma unroll
        for (int r = 0; r < SORT_BATCH; ++r)
          if (base + 32 * r + lane < hi) atomicAdd(row + d[r], 1u);
        continue;
      }
#pragma unroll
      for (int r = 0; r < SORT_BATCH; ++r) {
        const int i = base + 32 * r + lane;
        const u32 peers = __match_any_sync(FULL, d[r]);
        if (i < hi) out[row[d[r]] + __popc(peers & below)] = i;
        __syncwarp();
        if (i < hi && (peers & below) == 0) row[d[r]] += __popc(peers);
        __syncwarp();
      }
    }
    if (pass == 1) break;
    __syncthreads();
    // thread t owns digits [d0, d1): each (warp, digit) count becomes the
    // warp's offset within the bucket, then the bucket's start is added
    const int per = (B + T - 1) / T;
    const int d0 = t * per < B ? t * per : B;
    const int d1 = d0 + per < B ? d0 + per : B;
    u32 local = 0;
    for (int dd = d0; dd < d1; ++dd) {
      u32 col = 0;
      for (int u = 0; u < W; ++u) {
        const u32 x = cnt[u * B + dd];
        cnt[u * B + dd] = col;
        col += x;
      }
      tot[dd] = col;
      local += col;
    }
    scan[t] = local;
    __syncthreads();
    for (int off = 1; off < T; off <<= 1) {
      const u32 x = t >= off ? scan[t - off] : 0;
      __syncthreads();
      scan[t] += x;
      __syncthreads();
    }
    u32 start = scan[t] - local;
    int* bs = bstart + (size_t)w * (B + 1);
    for (int dd = d0; dd < d1; ++dd) {
      bs[dd] = (int)start;
      for (int u = 0; u < W; ++u) cnt[u * B + dd] += start;
      start += tot[dd];
    }
    if (t == T - 1) bs[B] = (int)start;    // == n
    __syncthreads();
  }
}

// sum of the values of the block's first `width` teams (a power of two;
// tree in `tree`, [teams][4] elements), left in team 0
__device__ __forceinline__ fe block_tree(Team& tm, fe acc, fe* tree,
                                         int team, int width) {
  tree[4 * team + tm.q] = acc;
  __syncthreads();
  for (int h = width / 2; h > 0; h >>= 1) {
    if (team < h) {
      acc = team_add(tm, acc, tree[4 * (team + h) + tm.q]);
      tree[4 * team + tm.q] = acc;
    }
    __syncthreads();
  }
  return acc;
}

// spin until window w's sum is out (a volatile read bypasses the L1 cache)
__device__ __forceinline__ void wait_window(const u32* sync, int nwin,
                                            int w) {
  while (((const volatile u32*)sync)[nwin + w] == 0) {
  }
  __threadfence();
}

// the team of the join block: sum_w 2^(w c) W_w, most significant window
// first, each window waited for just before it is added (the doublings run
// while the bucket blocks of lower windows still work); the chain's own
// time (globaltimer ns, without the waits after the top window) and the
// waits go to sync[2 nwin ...] as two u64 words in u32 pairs
__device__ void join(Team& tm, const u32* win, int nwin, int c, u32* sync,
                     u32* out) {
  wait_window(sync, nwin, nwin - 1);
  const u64 t0 = now_ns();
  u64 waited = 0;
  fe a = load_coord_l2(win + (size_t)(nwin - 1) * 64, tm.q);
  for (int w = nwin - 2; w >= 0; --w) {
    for (int k = 0; k < c; ++k) a = team_dbl(tm, a);
    const u64 tw = now_ns();
    wait_window(sync, nwin, w);
    waited += now_ns() - tw;
    a = team_add_cached(tm, a, load_coord_l2(win + (size_t)w * 64 + 32,
                                             tm.q));
  }
  const u64 chain = now_ns() - t0 - waited;
  store_coord(out, tm.q, a);
  if (tm.q == 0) {
    u32* tail = sync + 2 * nwin;
    tail[0] = (u32)chain;
    tail[1] = (u32)(chain >> 32);
    tail[2] = (u32)waited;
    tail[3] = (u32)(waited >> 32);
  }
}

// Blocks 0 .. nwin * blocks - 1: block x of window w = nwin - 1 - x /
// blocks (the top windows first) sums its teams' shares of the window's
// events, acc + k run each (see the header), into part[w][x % blocks];
// the window's last block to finish (an integer ticket in sync[w]) sums
// the window's partial sums into win[w] and raises sync[nwin + w]. The
// grid's last block runs the join on its first team.
__global__ void __launch_bounds__(4 * TEAMS)
msm_bucket_kernel(const u32* __restrict__ cached,
                  const int* __restrict__ idx,
                  const int* __restrict__ bstart, int n, int c, int nwin,
                  u32* part, u32* win, u32* sync, u32* __restrict__ out) {
  __shared__ fe xch[8 * TEAMS];
  __shared__ fe tree[4 * TEAMS];
  __shared__ int last;
  Team tm = team_of(xch);
  const int team = threadIdx.x >> 2, teams = blockDim.x >> 2;
  const int blocks = (gridDim.x - 1) / nwin;
  if (blockIdx.x == gridDim.x - 1) {
    if (team == 0) join(tm, win, nwin, c, sync, out);
    return;
  }
  const int w = nwin - 1 - blockIdx.x / blocks, bx = blockIdx.x % blocks;
  const int B = 1 << c;
  const int* bs = bstart + (size_t)w * (B + 1);
  const int* ix = idx + (size_t)w * n;
  const int zero = bs[1];
  const long long events = (long long)(n - zero) + (B - 1);
  const long long all = (long long)blocks * teams;
  const long long j = (long long)bx * teams + team;
  const int x0 = (int)(events * j / all);
  const int x1 = (int)(events * (j + 1) / all);
  // end marker of bucket b: event bs[b] - zero + b - 1
  fe run = identity_coord(tm), acc = run;
  int k = 0;
  if (x1 > x0) {
    int lo = 1, hi = B - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (bs[mid] - zero + mid - 1 <= x1 - 1) lo = mid;
      else hi = mid - 1;
    }
    int b = lo, off = x1 - 1 - (bs[b] - zero + b - 1);
    for (int x = x1 - 1; x >= x0; --x) {
      const bool end = off == 0;
      fe src;                         // the cached operand
      if (end) src = to_cached(tm, run);
      else src = load_coord(cached + 32 * (size_t)ix[bs[b] + off - 1], tm.q);
      const fe r = team_add_cached(tm, fe_sel(end, acc, run), src);
      if (end) {
        acc = r;
        k = b - 1;
        off = bs[b] - bs[b - 1];      // bucket b - 1's points come next
        --b;
      } else {
        run = r;
        k = b;
        --off;
      }
    }
    if (k > 0) {                      // acc += k run, most significant first
      const fe rc = to_cached(tm, run);
      fe m = run;
      for (int bit = 30 - __clz(k); bit >= 0; --bit) {
        m = team_dbl(tm, m);
        if ((k >> bit) & 1) m = team_add_cached(tm, m, rc);
      }
      acc = team_add(tm, acc, m);
    }
  }
  acc = block_tree(tm, acc, tree, team, teams);
  u32* p = part + (size_t)w * blocks * 32;
  if (team == 0) store_coord(p + 32 * bx, tm.q, acc);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(sync + w, 1u) == (u32)blocks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the window: its blocks' partial sums, each of the first teams taking
  // every teams-th one, then a tree
  acc = team < blocks ? load_coord_l2(p + 32 * team, tm.q)
                      : identity_coord(tm);
  for (int jb = team + teams; jb < blocks; jb += teams)
    acc = team_add(tm, acc, load_coord_l2(p + 32 * jb, tm.q));
  int width = 1;
  while (width < blocks && width < teams) width <<= 1;
  acc = block_tree(tm, acc, tree, team, width);
  if (team == 0) {
    store_coord(win + (size_t)w * 64, tm.q, acc);
    store_coord(win + (size_t)w * 64 + 32, tm.q, to_cached(tm, acc));
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicExch(sync + nwin + w, 1u);
}

// scalars: [n][8] u32 limbs (< L); points: [n][32] u32 (X, Y, Z, T limbs);
// scratch digits u16 [nwin][n], cached [n][32], idx [nwin][n], bstart
// [nwin][2^c + 1], part [nwin][blocks][32], win [nwin][2][32], sync
// [2 nwin + 4]; out: [32] u32, the sum's X, Y, Z, T, each below 2^256.
// `blocks` bucket blocks a window of `teams` teams each (a power of two
// up to 32). After the call sync[2 nwin ...] holds the join's chain and
// waits in ns (two u64 in u32 pairs).
extern "C" int msm(const void* scalars, const void* points, void* digits,
                   void* cached, void* idx, void* bstart, void* part,
                   void* win, void* sync, void* out, int n, int c, int blocks,
                   int teams, cudaStream_t stream) {
  if (n < 1 || c < 1 || c > MAX_C || blocks < 1 || teams < 1 ||
      teams > TEAMS || (teams & (teams - 1)))
    return cudaErrorInvalidValue;
  const int B = 1 << c, nwin = (SCALAR_BITS + c - 1) / c;
  msm_digit_kernel<<<(n + DIGIT_THREADS - 1) / DIGIT_THREADS, DIGIT_THREADS,
                     0, stream>>>((const u32*)scalars, (const u32*)points,
                                  n, c, nwin, (uint16_t*)digits,
                                  (u32*)cached, (u32*)sync);
  int err = cudaGetLastError();
  if (err) return err;
  const int most = c < 12 ? 16 : 8;
  const int warps = (n + SORT_SPAN - 1) / SORT_SPAN;
  const int sort_threads = 32 * (warps < most ? warps : most);
  const int smem = ((sort_threads / 32 + 1) * B + sort_threads) * 4;
  cudaFuncSetAttribute(msm_sort_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  msm_sort_kernel<<<nwin, sort_threads, smem, stream>>>(
      (const uint16_t*)digits, n, c, (int*)idx, (int*)bstart);
  err = cudaGetLastError();
  if (err) return err;
  msm_bucket_kernel<<<blocks * nwin + 1, 4 * teams, 0, stream>>>(
      (const u32*)cached, (const int*)idx, (const int*)bstart, n, c, nwin,
      (u32*)part, (u32*)win, (u32*)sync, (u32*)out);
  return cudaGetLastError();
}
