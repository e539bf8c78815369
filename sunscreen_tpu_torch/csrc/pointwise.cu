// Pointwise NTT-domain passes of the BFV multiply and keyswitch.
//
// Replaces the Pallas kernels of sunscreen_tpu/math/prns.py:
//   tensor3_pointwise FusedTensor3 (pallas_call at prns.py:343): the BFV
//                     tensor (a0 b0, a0 b1 + a1 b0, a1 b1) mod q of two
//                     2-component NTT-domain operands; reached through
//                     bfv/ops.py::multiply when the B4 kernel does not run
//                     (N > 8192 on CUDA, SUNSCREEN_TPU_FUSE_FT3=0 or
//                     SUNSCREEN_TPU_FUSE_INV=0) (B10);
//   ks_inner          FusedKsInner (pallas_call at prns.py:410): the
//                     keyswitch digit contraction sum_i d_i key_c[i] mod q for
//                     both key components; reached through
//                     bfv/ops.py::keyswitch when SUNSCREEN_TPU_FUSE_KS=0 or
//                     SUNSCREEN_TPU_FUSE_INV=0 (B11).
//
// Design: one thread per (row, limb, coefficient); blockIdx.y walks the rows,
// so a thread finds its limb with one 32-bit division. Neighbouring threads
// read and write neighbouring coefficients, so every access is coalesced.
// Inputs are residues < q < 2^30 (int64). tensor3 forms each product in u64
// (the middle sum is below 2^61) and reduces once per component. ks_inner
// sums the digit products in u64 registers and folds the sum mod q every 16
// terms (q + 16 (2^30 - 1)^2 < 2^64), so it is exact for any digit count; the
// reference adds raw products and relies on kdig <= 16. The keys are shared
// by all rows and come through the read-only cache (7 MB at the main path,
// far below the 50 MB L2). Operand rows may be strided (the multiply passes
// the two halves of one [rows, 4, k, N] tensor), so each kernel takes its
// input row strides.
//
// Bound on the H100 at the main-path shapes (N = 8192, batch 64,
// default_u32(8192)), int64 in and out: tensor3 on a, b [64,2,15,N] ->
// [64,3,15,N] moves 440 MB (0.131 ms at 3.35 TB/s); ks_inner on
// d [64,7,8,N] and keys [7,8,N] -> [64,2,8,N] moves 309 MB (0.092 ms). Their
// 32-bit multiplies (2 per 32x32 -> 64 product) take under 0.01 ms at
// 16.7 T/s, so both are bound by bytes.

#include "common.cuh"

static const int THREADS = 256;
static const int MAX_GRID_Y = 65535;

// a, b rows of [2, k, N] (row strides sa, sb) -> out [rows, 3, k, N].
//   tab [k]: q, m
__global__ void tensor3_kernel(const long long* __restrict__ a,
                               const long long* __restrict__ b,
                               long long* __restrict__ out,
                               const long long* __restrict__ tab, int rows,
                               int k, int n, long long sa, long long sb) {
  const int kn = k * n;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;  // limb * n + col
  if (e >= kn) return;
  const Mod L = load_mod(tab, e / n);
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const long long* ar = a + row * sa + e;
    const long long* br = b + row * sb + e;
    u32 c0, c1, c2;
    tensor3_mod((u64)ar[0], (u64)ar[kn], (u64)br[0], (u64)br[kn], L.q, L.m,
                c0, c1, c2);
    long long* o = out + (size_t)row * 3 * kn + e;
    o[0] = c0;
    o[kn] = c1;
    o[2 * kn] = c2;
  }
}

// d [rows, kdig, k, N], k0/k1 [kdig, k, N] -> out [rows, 2, k, N].
//   tab [k]: q, m
__global__ void ks_inner_kernel(const long long* __restrict__ d,
                                const long long* __restrict__ k0,
                                const long long* __restrict__ k1,
                                long long* __restrict__ out,
                                const long long* __restrict__ tab, int rows,
                                int kdig, int k, int n) {
  const int kn = k * n;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kn) return;
  const Mod L = load_mod(tab, e / n);
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const long long* dr = d + (size_t)row * kdig * kn + e;
    u64 acc0 = 0, acc1 = 0;
    for (int i = 0; i < kdig; ++i) {
      const u64 dv = (u64)dr[(size_t)i * kn];
      acc0 += dv * (u64)__ldg(k0 + (size_t)i * kn + e);
      acc1 += dv * (u64)__ldg(k1 + (size_t)i * kn + e);
      if ((i & 15) == 15) {
        acc0 = reduce64(acc0, L.q, L.m);
        acc1 = reduce64(acc1, L.q, L.m);
      }
    }
    long long* o = out + (size_t)row * 2 * kn + e;
    o[0] = reduce64(acc0, L.q, L.m);
    o[kn] = reduce64(acc1, L.q, L.m);
  }
}

static dim3 grid_for(int rows, int kn) {
  return dim3((unsigned)((kn + THREADS - 1) / THREADS),
              (unsigned)(rows < MAX_GRID_Y ? rows : MAX_GRID_Y));
}

extern "C" int tensor3_pointwise(const void* a, const void* b, void* out,
                                 const void* tab, int rows, int k, int n,
                                 int sa, int sb, void* stream) {
  tensor3_kernel<<<grid_for(rows, k * n), THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)a, (const long long*)b, (long long*)out,
      (const long long*)tab, rows, k, n, sa, sb);
  return (int)cudaGetLastError();
}

extern "C" int ks_inner(const void* d, const void* k0, const void* k1,
                        void* out, const void* tab, int rows, int kdig, int k,
                        int n, void* stream) {
  ks_inner_kernel<<<grid_for(rows, k * n), THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)d, (const long long*)k0, (const long long*)k1,
      (long long*)out, (const long long*)tab, rows, kdig, k, n);
  return (int)cudaGetLastError();
}
