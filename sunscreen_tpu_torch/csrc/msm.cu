// M1: Pippenger multi-scalar multiplication over ristretto255,
// sum_i s_i * P_i, on the card.
//
// Replaces `sunscreen_tpu/zk/tpu_curve.py` `msm_tpu_fn` (:240, jitted at
// :281, wrapper `msm` :284): plain JAX under `jax.jit`, not a Pallas kernel,
// and the only device function of the reference's ZK stack. Its 9 x 29-bit
// limbs in u64 lanes work around the TPU's lack of a 64-bit product, and its
// sort plus segmented Hillis-Steele scan (n log n additions) worked around an
// XLA compile that ran out of memory; neither is carried over. Here a field
// element mod p = 2^255 - 19 is eight 32-bit limbs, multiplied with 64-bit
// products and folded with 2^256 = 38 (mod p); values stay below 2^256, not
// necessarily below p, and the caller reduces the result. Points are
// extended twisted-Edwards coordinates (X:Y:Z:T), added with the unified
// formula of the reference's `Point.__add__` (add-2008-hwcd-3, k = 2d: eight
// multiplies and one by 2d) and doubled with its `Point.double`
// (dbl-2008-hwcd).
//
// Four kernels, each launched once a call, on windows of c bits (c <= 10):
//  1. msm_sort_kernel, a block of 32 threads a window: a stable counting
//     sort of the point indices by the window's digit (each thread counts a
//     contiguous range of indices into its own column of a [2^c][32] table in
//     shared memory, then the prefix over columns and buckets gives every
//     index its place), and the start of each bucket and of its chunks of
//     SEG entries;
//  2. msm_bucket_kernel, a thread a chunk: the sum Q of up to SEG points of
//     one bucket b, then b Q by double-and-add, so that a large bucket (the
//     prover's bit-valued witnesses fill a few) spreads over many threads;
//  3. msm_window_kernel, a block a window: the window's chunks summed, each
//     thread a strided share, then a tree in shared memory;
//  4. msm_join_kernel, one thread: the windows joined by c doublings each,
//     most significant first.
// The order of every sum is fixed, so the output is the same
// representative on every run.
//
// Bound: operations. Pippenger takes ceil(253 / c) (n + 2^(c+1)) point
// additions of 9 field multiplies, each 64 32 x 32 -> 64-bit products and 8
// for the fold by 38 (2 32-bit multiplies each); the bytes (160 a point) are
// far below that. The design is simple and latency-bound at the main path's
// n ~ 2049: the join's 248 doublings are one thread's dependent chain, and
// per-thread field multiplies are carry chains, so a later redesign would
// split a field multiply over a warp and shorten the chain.

#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;
typedef uint64_t u64;

constexpr int SEG = 8;            // points a thread of msm_bucket_kernel sums
constexpr int SORT_THREADS = 32;  // threads (index ranges) of the sort
constexpr int BUCKET_THREADS = 128;
constexpr int WIN_THREADS = 128;
constexpr int MAX_C = 10;
constexpr int SCALAR_BITS = 253;  // scalars are reduced mod L < 2^253

struct fe {
  u32 v[8];
};
struct ge {
  fe x, y, z, t;
};

// r += 38 * carry; returns the carry out of the top limb
__device__ __forceinline__ u32 add38(fe& r, u32 carry) {
  u64 p = (u64)r.v[0] + (u64)carry * 38;
  r.v[0] = (u32)p;
  p >>= 32;
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    p += r.v[i];
    r.v[i] = (u32)p;
    p >>= 32;
  }
  return (u32)p;
}

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  fe r;
  u64 p = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    p += (u64)a.v[i] + b.v[i];
    r.v[i] = (u32)p;
    p >>= 32;
  }
  // a second carry leaves r below 38, so the last 38 cannot carry again
  const u32 again = add38(r, (u32)p);
  r.v[0] += 38 * again;
  return r;
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  fe r;
  u64 borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    u64 d = (u64)a.v[i] - b.v[i] - borrow;
    r.v[i] = (u32)d;
    borrow = d >> 63;
  }
  // a wrap added 2^256 = 38 (mod p): take 38 off; a second wrap leaves r
  // at least 2^256 - 38, so the last 38 cannot borrow again
  borrow *= 38;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    u64 d = (u64)r.v[i] - borrow;
    r.v[i] = (u32)d;
    borrow = d >> 63;
  }
  r.v[0] -= 38 * (u32)borrow;
  return r;
}

__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b) {
  u32 t[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    u64 carry = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      u64 p = (u64)a.v[i] * b.v[j] + t[i + j] + carry;
      t[i + j] = (u32)p;
      carry = p >> 32;
    }
    t[i + 8] = (u32)carry;
  }
  fe r;
  u64 carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    u64 p = (u64)t[i + 8] * 38 + t[i] + carry;
    r.v[i] = (u32)p;
    carry = p >> 32;
  }
  // carry <= 38: a carry out of this fold leaves r below 38 * 39
  const u32 again = add38(r, (u32)carry);
  r.v[0] += 38 * again;
  return r;
}

// 2d mod p, d = -121665 / 121666
__device__ __forceinline__ fe k2d() {
  return fe{{0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au,
             0xeef3d130u, 0x198e80f2u, 0x56dffce7u, 0x2406d9dcu}};
}

__device__ __forceinline__ ge ge_identity() {
  ge r = {};
  r.y.v[0] = 1;
  r.z.v[0] = 1;
  return r;
}

// unified addition (add-2008-hwcd-3, a = -1): also doubles and adds the
// identity
__device__ __forceinline__ ge ge_add(const ge& p, const ge& q) {
  const fe a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
  const fe b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
  const fe c = fe_mul(fe_mul(p.t, q.t), k2d());
  fe d = fe_mul(p.z, q.z);
  d = fe_add(d, d);
  const fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c),
           h = fe_add(b, a);
  return ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

// dbl-2008-hwcd, the oracle's `Point.double`
__device__ __forceinline__ ge ge_dbl(const ge& p) {
  const fe a = fe_mul(p.x, p.x), b = fe_mul(p.y, p.y);
  fe c = fe_mul(p.z, p.z);
  c = fe_add(c, c);
  const fe h = fe_add(a, b);
  const fe xy = fe_add(p.x, p.y);
  const fe e = fe_sub(h, fe_mul(xy, xy));
  const fe g = fe_sub(a, b);
  const fe f = fe_add(c, g);
  return ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

__device__ __forceinline__ ge ge_load(const u32* p) {
  ge r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.x.v[i] = p[i];
    r.y.v[i] = p[8 + i];
    r.z.v[i] = p[16 + i];
    r.t.v[i] = p[24 + i];
  }
  return r;
}

__device__ __forceinline__ void ge_store(u32* p, const ge& r) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    p[i] = r.x.v[i];
    p[8 + i] = r.y.v[i];
    p[16 + i] = r.z.v[i];
    p[24 + i] = r.t.v[i];
  }
}

// bits [w c, w c + c) of the scalar's eight little-endian 32-bit limbs
__device__ __forceinline__ u32 digit(const u32* s, int w, int c) {
  const int bit = w * c, limb = bit >> 5, sh = bit & 31;
  u64 v = s[limb];
  if (limb < 7) v |= (u64)s[limb + 1] << 32;
  return (u32)(v >> sh) & ((1u << c) - 1);
}

__device__ __forceinline__ int chunks_of(int d, u32 count) {
  return d == 0 ? 0 : (int)((count + SEG - 1) / SEG);
}

// block w: idx[w] = the point indices ordered by digit (stably), bstart[w][d]
// = where bucket d starts in it, cstart[w][d] = its first chunk; both end
// with the totals at d = 2^c. Shared: cnt [2^c][32], bc [2^c], sums [2][32].
__global__ void __launch_bounds__(SORT_THREADS)
msm_sort_kernel(const u32* __restrict__ scalars, int n, int c,
                int* __restrict__ idx, int* __restrict__ bstart,
                int* __restrict__ cstart) {
  extern __shared__ u32 sm[];
  const int w = blockIdx.x, t = threadIdx.x, T = SORT_THREADS;
  const int B = 1 << c;
  u32* cnt = sm;            // [d][t]: t's count, then t's next place
  u32* bc = sm + B * T;     // bucket sizes
  u32* sums = bc + B;       // per thread: [0, T) entries, [T, 2T) chunks
  for (int i = t; i < B * T; i += T) cnt[i] = 0;
  __syncthreads();
  const int lo = (int)((long long)n * t / T);
  const int hi = (int)((long long)n * (t + 1) / T);
  for (int i = lo; i < hi; ++i) cnt[digit(scalars + 8 * (size_t)i, w, c) * T + t] += 1;
  __syncthreads();
  // thread t owns digits [d0, d1): the prefix over the 32 index ranges
  const int per = (B + T - 1) / T;
  const int d0 = t * per < B ? t * per : B;
  const int d1 = d0 + per < B ? d0 + per : B;
  u32 entries = 0, chunks = 0;
  for (int d = d0; d < d1; ++d) {
    u32 col = 0;
    for (int u = 0; u < T; ++u) {
      const u32 v = cnt[d * T + u];
      cnt[d * T + u] = col;
      col += v;
    }
    bc[d] = col;
    entries += col;
    chunks += chunks_of(d, col);
  }
  sums[t] = entries;
  sums[T + t] = chunks;
  __syncthreads();
  u32 base = 0, cbase = 0;
  for (int u = 0; u < t; ++u) {
    base += sums[u];
    cbase += sums[T + u];
  }
  int* bs = bstart + (size_t)w * (B + 1);
  int* cs = cstart + (size_t)w * (B + 1);
  for (int d = d0; d < d1; ++d) {
    bs[d] = (int)base;
    cs[d] = (int)cbase;
    for (int u = 0; u < T; ++u) cnt[d * T + u] += base;
    base += bc[d];
    cbase += chunks_of(d, bc[d]);
  }
  if (t == T - 1) {
    bs[B] = (int)base;     // == n
    cs[B] = (int)cbase;
  }
  __syncthreads();
  int* out = idx + (size_t)w * n;
  for (int i = lo; i < hi; ++i) {
    const u32 d = digit(scalars + 8 * (size_t)i, w, c);
    out[cnt[d * T + t]++] = i;
  }
}

// thread j of window w: chunk j's points summed, times its bucket's digit
__global__ void __launch_bounds__(BUCKET_THREADS)
msm_bucket_kernel(const u32* __restrict__ points,
                  const int* __restrict__ idx,
                  const int* __restrict__ bstart,
                  const int* __restrict__ cstart, int n, int c, int m,
                  u32* __restrict__ part) {
  const int w = blockIdx.y;
  const int j = blockIdx.x * BUCKET_THREADS + threadIdx.x;
  const int B = 1 << c;
  const int* cs = cstart + (size_t)w * (B + 1);
  const int* bs = bstart + (size_t)w * (B + 1);
  if (j >= cs[B]) return;
  // the last bucket b >= 1 whose first chunk is at or before j (bucket 0
  // has no chunks, so cs[1] = 0)
  int lo = 1, hi = B - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (cs[mid] <= j) lo = mid;
    else hi = mid - 1;
  }
  const int b = lo;
  const int first = bs[b] + (j - cs[b]) * SEG;
  const int end = first + SEG < bs[b + 1] ? first + SEG : bs[b + 1];
  const int* ix = idx + (size_t)w * n;
  ge q = ge_load(points + 32 * (size_t)ix[first]);
  for (int e = first + 1; e < end; ++e)
    q = ge_add(q, ge_load(points + 32 * (size_t)ix[e]));
  int k = c - 1;
  while (!((b >> k) & 1)) --k;
  ge v = q;
  for (--k; k >= 0; --k) {
    v = ge_dbl(v);
    if ((b >> k) & 1) v = ge_add(v, q);
  }
  ge_store(part + ((size_t)w * m + j) * 32, v);
}

// block w: the sum of window w's chunks
__global__ void __launch_bounds__(WIN_THREADS)
msm_window_kernel(const u32* __restrict__ part,
                  const int* __restrict__ cstart, int c, int m,
                  u32* __restrict__ win) {
  __shared__ ge acc[WIN_THREADS];
  const int w = blockIdx.x, t = threadIdx.x;
  const int B = 1 << c;
  const int total = cstart[(size_t)w * (B + 1) + B];
  ge s = ge_identity();
  for (int j = t; j < total; j += WIN_THREADS)
    s = ge_add(s, ge_load(part + ((size_t)w * m + j) * 32));
  acc[t] = s;
  __syncthreads();
  for (int h = WIN_THREADS / 2; h > 0; h >>= 1) {
    if (t < h) acc[t] = ge_add(acc[t], acc[t + h]);
    __syncthreads();
  }
  if (t == 0) ge_store(win + (size_t)w * 32, acc[0]);
}

// sum_w 2^(w c) W_w, most significant window first
__global__ void msm_join_kernel(const u32* __restrict__ win, int nwin,
                                int c, u32* __restrict__ out) {
  ge a = ge_load(win + (size_t)(nwin - 1) * 32);
  for (int w = nwin - 2; w >= 0; --w) {
    for (int k = 0; k < c; ++k) a = ge_dbl(a);
    a = ge_add(a, ge_load(win + (size_t)w * 32));
  }
  ge_store(out, a);
}

// scalars: [n][8] u32 limbs (< L); points: [n][32] u32 (X, Y, Z, T limbs);
// scratch idx [nwin][n], bstart and cstart [nwin][2^c + 1], part
// [nwin][m][32] with m = ceil(n / SEG) + 2^c, win [nwin][32]; out: [32] u32,
// the sum's X, Y, Z, T, each below 2^256.
extern "C" int msm(const void* scalars, const void* points, void* idx,
                   void* bstart, void* cstart, void* part, void* win,
                   void* out, int n, int c, cudaStream_t stream) {
  if (n < 1 || c < 1 || c > MAX_C) return cudaErrorInvalidValue;
  const int B = 1 << c, nwin = (SCALAR_BITS + c - 1) / c;
  const int m = (n + SEG - 1) / SEG + B;
  const int smem = (B * SORT_THREADS + B + 2 * SORT_THREADS) * 4;
  cudaFuncSetAttribute(msm_sort_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  msm_sort_kernel<<<nwin, SORT_THREADS, smem, stream>>>(
      (const u32*)scalars, n, c, (int*)idx, (int*)bstart, (int*)cstart);
  int err = cudaGetLastError();
  if (err) return err;
  msm_bucket_kernel<<<dim3((m + BUCKET_THREADS - 1) / BUCKET_THREADS, nwin),
                      BUCKET_THREADS, 0, stream>>>(
      (const u32*)points, (const int*)idx, (const int*)bstart,
      (const int*)cstart, n, c, m, (u32*)part);
  err = cudaGetLastError();
  if (err) return err;
  msm_window_kernel<<<nwin, WIN_THREADS, 0, stream>>>(
      (const u32*)part, (const int*)cstart, c, m, (u32*)win);
  err = cudaGetLastError();
  if (err) return err;
  msm_join_kernel<<<1, 1, 0, stream>>>((const u32*)win, nwin, c, (u32*)out);
  return cudaGetLastError();
}
