// Shared device code of the u32-engine kernels (ntt.cu, tensor3.cu,
// inv_ks.cu, inv_tensor3.cu, ks_full.cu, pntt.cu, rns.cu, pointwise.cu):
// modular helpers, the 32-bit reduction of u64 words (inv_ks.cu,
// ks_full.cu, rns.cu's rns_convert, rns_scale and scale_convert) and the
// per-modulus tables. The transforms themselves are transform.cuh's.
//
// Tensors cross the C interface as int64 residues (values < 2^32). Per limb
// the plan uploads:
//   twp    [k][2][N] u64: pairs (w | w_sh << 32) of psi_rev then
//          psi_inv_rev, where psi_rev[i] = psi^brev(i), psi is the minimal
//          primitive 2N-th root of unity mod q and w_sh = floor(w 2^32 / q)
//          (transform.cuh);
//   consts [k][4] int64: q, floor(2^64 / q), N^-1 mod q, its Shoup ratio.
#pragma once

#include <cuda_runtime.h>

typedef unsigned int u32;
typedef unsigned long long u64;

struct Limb {
  u32 q;
  u64 m;  // floor(2^64 / q)
  u32 ninv, ninv_sh;
};

__device__ __forceinline__ Limb load_limb(const long long* consts, int limb) {
  const long long* c = consts + 4 * limb;
  Limb L;
  L.q = (u32)c[0];
  L.m = (u64)c[1];
  L.ninv = (u32)c[2];
  L.ninv_sh = (u32)c[3];
  return L;
}

// x mod q for any u64 x. qhat = floor(x m / 2^64) is at most 2 below
// floor(x / q), so r < 3q < 2^32 before the corrections.
__device__ __forceinline__ u32 reduce64(u64 x, u32 q, u64 m) {
  u64 r = x - __umul64hi(x, m) * q;
  if (r >= q) r -= q;
  if (r >= q) r -= q;
  return (u32)r;
}

// Per-modulus tables of the RNS and pointwise kernels (rns.cu,
// pointwise.cu): int64, one row of 8 per modulus: q, floor(2^64 / q), then
// the op's constants.
struct Mod {
  u32 q;
  u64 m;
};

__device__ __forceinline__ Mod load_mod(const long long* tab, int i) {
  return {(u32)__ldg(tab + 8 * i), (u64)__ldg(tab + 8 * i + 1)};
}

__device__ __forceinline__ u64 tab_at(const long long* tab, int i, int c) {
  return (u64)__ldg(tab + 8 * i + c);
}

// The BFV tensor (a0 b0, a0 b1 + a1 b0, a1 b1) mod q of NTT-domain residues
// a, b < q < 2^30 (tensor3.cu, inv_tensor3.cu, pointwise.cu): the middle sum
// is below 2^61, so each component is one u64 reduction.
__device__ __forceinline__ void tensor3_mod(u64 a0, u64 a1, u64 b0, u64 b1,
                                            u32 q, u64 m, u32& c0, u32& c1,
                                            u32& c2) {
  c0 = reduce64(a0 * b0, q, m);
  c1 = reduce64(a0 * b1 + a1 * b0, q, m);
  c2 = reduce64(a1 * b1, q, m);
}

// (x w) mod q for any u32 x and w < q < 2^30, w_sh = floor(w 2^32 / q)
// (Shoup/Harvey: the wrapped difference lies in [0, 2q)).
__device__ __forceinline__ u32 mul_shoup(u32 x, u32 w, u32 w_sh, u32 q) {
  u32 r = w * x - __umulhi(x, w_sh) * q;
  return r >= q ? r - q : r;
}

__device__ __forceinline__ u32 add_q(u32 a, u32 b, u32 q) {
  u32 s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ u32 sub_q(u32 a, u32 b, u32 q) {
  return a >= b ? a - b : a + q - b;
}

// x - m if x >= m, else x: below m for x < 2m.
__device__ __forceinline__ u32 csub(u32 x, u32 m) { return min(x, x - m); }

// floor(w 2^32 / q) for w < q < 2^30, from m = floor(2^64 / q): w m / 2^32
// falls short of w 2^32 / q by less than w / 2^32 < 1/4, so its floor is
// at most one low.
__device__ __forceinline__ u32 shoup32(u32 w, u32 q, u64 m) {
  u64 s = (u64)w * (u32)(m >> 32) + __umulhi(w, (u32)m);
  if ((s + 1) * q <= (u64)w << 32) ++s;
  return (u32)s;
}

// The constants of a 32-bit reduction of any u64 word mod q < 2^30 (inv_ks.cu,
// ks_full.cu, rns.cu's rns_convert, rns_scale and scale_convert):
// m32 = floor(2^32 / q), c = 2^32 mod q and its Shoup ratio. 16 bytes, so a
// row of a table in shared memory is one load.
struct __align__(16) Red32 {
  u32 q, m32, c, c_sh;
};

__device__ __forceinline__ Red32 red32(u32 q, u64 m) {
  const u32 m32 = (u32)(m >> 32), c = 0u - q * m32;
  return {q, m32, c, shoup32(c, q, m)};
}

// x mod q up to one q, in [0, 2q), for any u64 x = xh 2^32 + xl: xh c by
// Shoup's product and xl by a 32-bit Barrett step (the quotient at most 1
// short), each in [0, 2q), so the sum lies below 4q < 2^32.
__device__ __forceinline__ u32 red2q(u64 x, const Red32& r) {
  const u32 xh = (u32)(x >> 32), xl = (u32)x;
  const u32 a = r.c * xh - __umulhi(xh, r.c_sh) * r.q;
  const u32 b = xl - __umulhi(xl, r.m32) * r.q;
  return csub(a + b, 2 * r.q);
}

__device__ __forceinline__ u32 red(u64 x, const Red32& r) {
  return csub(red2q(x, r), r.q);
}
