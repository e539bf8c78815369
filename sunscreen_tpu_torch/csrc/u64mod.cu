// Exact 64-bit modular multiplies of the u64 engine, elementwise:
//
//   B18 shoup_mul_mod: out = x w mod q, x in [0, 2q), w < q, w_sh =
//       floor(w 2^64 / q) (Shoup/Harvey, one conditional subtract);
//   B18 mul_mod: out = a b mod q, the 128-bit product reduced by Barrett
//       with floor(2^128 / q), word for word as modular.barrett_reduce_128;
//   B19 pointwise_mul_mod: the same product and reduction on operands held
//       as (hi, lo) 32-bit halves, written back as halves.
//
// Replaces the Pallas kernels of sunscreen_tpu/math/pallas_mod.py
// (_shoup_call, pallas_call at :209; _mul_mod_call, pallas_call at :237) and
// sunscreen_tpu/math/pallas_kernels.py (make_pointwise_mul_mod, pallas_call
// at :152). The TPU has no 64-bit lanes, so those kernels carry every word as
// a planar pair of u32 planes and build each 64 x 64 -> 128-bit product from
// sixteen 16-bit partial products. The card has native 64-bit integers and
// __umul64hi, so here a word is one unsigned long long: shoup_mul_mod and
// mul_mod read and write contiguous int64 words, and only B19 keeps the
// halves, because its caller's API is halves.
//
// q and its Barrett or Shoup constants are kernel arguments: one build serves
// every modulus below 2^62. Each thread takes one element per step of a
// grid-stride loop over the last dim; blockIdx.y walks the rows. Every
// operand is read through its own strides over up to four leading dims and
// its own stride along the last dim, so a broadcast table (one twiddle row
// against a batch) is read in place, never expanded in device memory.
//
// Bounds on the H100: all three move 8 bytes per operand read and per word
// written, and do 2-6 64-bit multiplies (each several 32-bit multiplies) per
// element: on [512, 8192] shoup_mul_mod moves 4 x 33.6 MB (0.040 ms at
// 3.35 TB/s) against about 0.05 G 32-bit multiplies (0.003 ms at 16.7 T/s):
// bound by bytes.

#include <cuda_runtime.h>

typedef unsigned long long u64;

#define LEAD 4

// Leading sizes of the output shape (outermost first) and, for each of up
// to three operands, its strides over them and along the last dim, in
// elements (0 where broadcast).
struct Strides {
  int size[LEAD];
  long long s[3][LEAD];
  long long inner[3];
};

__device__ __forceinline__ u64 shoup(u64 x, u64 w, u64 w_sh, u64 q) {
  const u64 r = w * x - __umul64hi(x, w_sh) * q;  // in [0, 2q)
  return r >= q ? r - q : r;
}

// (hi 2^64 + lo) mod q for a value below q 2^64, ratio floor(2^128 / q) =
// r_hi 2^64 + r_lo: the steps of modular.barrett_reduce_128.
__device__ __forceinline__ u64 barrett128(u64 hi, u64 lo, u64 q, u64 r_hi,
                                          u64 r_lo) {
  const u64 carry = __umul64hi(lo, r_lo);
  const u64 l2 = lo * r_hi, h2 = __umul64hi(lo, r_hi);
  const u64 tmp1 = l2 + carry;
  const u64 tmp3 = h2 + (tmp1 < l2);
  const u64 l3 = hi * r_lo, h3 = __umul64hi(hi, r_lo);
  const u64 carry2 = h3 + ((tmp1 + l3) < l3);
  const u64 qhat = hi * r_hi + tmp3 + carry2;
  const u64 r = lo - qhat * q;
  return r >= q ? r - q : r;
}

__device__ __forceinline__ void row_offsets(const Strides& st, int row,
                                            int nops, long long* off) {
  for (int o = 0; o < nops; ++o) off[o] = 0;
  int r = row;
  for (int d = LEAD - 1; d >= 0; --d) {
    const int i = r % st.size[d];
    r /= st.size[d];
    for (int o = 0; o < nops; ++o) off[o] += i * st.s[o][d];
  }
}

__global__ void u64_shoup_kernel(const long long* __restrict__ x,
                                 const long long* __restrict__ w,
                                 const long long* __restrict__ w_sh,
                                 long long* __restrict__ out, int rows, int n,
                                 u64 q, Strides st) {
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    long long off[3];
    row_offsets(st, row, 3, off);
    long long* dst = out + (size_t)row * n;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x)
      dst[i] = (long long)shoup((u64)__ldg(x + off[0] + i * st.inner[0]),
                                (u64)__ldg(w + off[1] + i * st.inner[1]),
                                (u64)__ldg(w_sh + off[2] + i * st.inner[2]),
                                q);
  }
}

__global__ void u64_mul_mod_kernel(const long long* __restrict__ a,
                                   const long long* __restrict__ b,
                                   long long* __restrict__ out, int rows,
                                   int n, u64 q, u64 r_hi, u64 r_lo,
                                   Strides st) {
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    long long off[3];
    row_offsets(st, row, 2, off);
    long long* dst = out + (size_t)row * n;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x) {
      const u64 va = (u64)__ldg(a + off[0] + i * st.inner[0]);
      const u64 vb = (u64)__ldg(b + off[1] + i * st.inner[1]);
      dst[i] = (long long)barrett128(__umul64hi(va, vb), va * vb, q, r_hi,
                                     r_lo);
    }
  }
}

// Halves: int64 tensors holding values below 2^32, contiguous [count].
__global__ void pointwise_mul_mod_kernel(const long long* __restrict__ a_hi,
                                         const long long* __restrict__ a_lo,
                                         const long long* __restrict__ b_hi,
                                         const long long* __restrict__ b_lo,
                                         long long* __restrict__ o_hi,
                                         long long* __restrict__ o_lo,
                                         long long count, u64 q, u64 r_hi,
                                         u64 r_lo) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x) {
    const u64 va = ((u64)__ldg(a_hi + i) << 32) | (u64)__ldg(a_lo + i);
    const u64 vb = ((u64)__ldg(b_hi + i) << 32) | (u64)__ldg(b_lo + i);
    const u64 r = barrett128(__umul64hi(va, vb), va * vb, q, r_hi, r_lo);
    o_hi[i] = (long long)(r >> 32);
    o_lo[i] = (long long)(r & 0xFFFFFFFFull);
  }
}

static const int THREADS = 256;

static dim3 grid_for(int rows, int n) {
  const int bx = (n + THREADS - 1) / THREADS;
  return dim3(bx < 1024 ? bx : 1024, rows < 65535 ? rows : 65535);
}

// sizes: the LEAD leading sizes; strides: for each operand LEAD leading
// strides then its last-dim stride (LEAD + 1 int64 per operand).
static Strides make_strides(const long long* sizes, const long long* strides,
                            int nops) {
  Strides st;
  for (int d = 0; d < LEAD; ++d) st.size[d] = (int)sizes[d];
  for (int o = 0; o < 3; ++o) {
    for (int d = 0; d < LEAD; ++d)
      st.s[o][d] = o < nops ? strides[o * (LEAD + 1) + d] : 0;
    st.inner[o] = o < nops ? strides[o * (LEAD + 1) + LEAD] : 0;
  }
  return st;
}

// out [rows, n] = x w mod q over the broadcast shape
extern "C" int u64_shoup_mul_mod(const void* x, const void* w,
                                 const void* w_sh, void* out,
                                 const void* sizes, const void* strides,
                                 int rows, int n, u64 q, void* stream) {
  const Strides st = make_strides((const long long*)sizes,
                                  (const long long*)strides, 3);
  u64_shoup_kernel<<<grid_for(rows, n), THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)x, (const long long*)w, (const long long*)w_sh,
      (long long*)out, rows, n, q, st);
  return (int)cudaGetLastError();
}

// out [rows, n] = a b mod q over the broadcast shape
extern "C" int u64_mul_mod(const void* a, const void* b, void* out,
                           const void* sizes, const void* strides, int rows,
                           int n, u64 q, u64 r_hi, u64 r_lo, void* stream) {
  const Strides st = make_strides((const long long*)sizes,
                                  (const long long*)strides, 2);
  u64_mul_mod_kernel<<<grid_for(rows, n), THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)a, (const long long*)b, (long long*)out, rows, n, q,
      r_hi, r_lo, st);
  return (int)cudaGetLastError();
}

// (o_hi, o_lo) = a b mod q on halves, `count` contiguous elements each
extern "C" int pointwise_mul_mod(const void* a_hi, const void* a_lo,
                                 const void* b_hi, const void* b_lo,
                                 void* o_hi, void* o_lo, long long count,
                                 u64 q, u64 r_hi, u64 r_lo, void* stream) {
  const long long blocks = (count + THREADS - 1) / THREADS;
  pointwise_mul_mod_kernel<<<(int)(blocks < 65535 ? blocks : 65535), THREADS,
                             0, (cudaStream_t)stream>>>(
      (const long long*)a_hi, (const long long*)a_lo,
      (const long long*)b_hi, (const long long*)b_lo, (long long*)o_hi,
      (long long*)o_lo, count, q, r_hi, r_lo);
  return (int)cudaGetLastError();
}
