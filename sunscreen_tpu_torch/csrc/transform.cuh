// Register-resident negacyclic transforms over one u32 limb (ntt.cu,
// tensor3.cu, inv_ks.cu, ks_full.cu, inv_tensor3.cu, pntt.cu): the forward
// Cooley-Tukey transform with merged psi twiddles and the inverse
// Gentleman-Sande transform with psi^-1 twiddles, with Harvey's lazy
// butterflies (values below 4q or 2q between stages, exact residues after the
// caller's last reduction).
//
// Layout. A polynomial of N = 2^LOGN coefficients is held by T = N / E
// threads, E = 2^R coefficients each in registers (R = 4; R = 3 at N = 256
// and R = 2 at N = 128, pntt.cu's smallest plan, so that T is a whole
// warp; R = 5 at N = 32768, pntt.cu's largest, so that T is 1024, the most
// a block holds: three groups of five stages). Position p of the
// bit-reversed array has LOGN bits. A "group" of
// stages works on R bits [A, A + R) of p that the registers own: register
// s of thread tau holds p = thread_pos<A>(tau) | s << A, and the thread
// index fills the other bits in order, so a warp's 32 lanes cover the five
// lowest bits outside [A, A + R). Each group runs up to R radix-2 stages
// in registers, one 8-byte load of (w, floor(w 2^32 / q)) per distinct
// twiddle. Between groups the threads exchange through shared memory: 13
// stages at N = 8192 take 4 groups and 3 exchanges, each one barrier.
//
// Forward: the first group owns the top R bits (thread tau loads
// coefficients tau + s T: coalesced int64 loads), the last owns bits
// [0, R). Inverse: the first group owns bits [0, R), the last the top R
// bits (coalesced natural-order stores). So a forward transform's result
// is already in the inverse's input layout: B13 inverse-transforms its
// products with no exchange and no permutation between.
//
// Each plan's NTT domain is a bit permutation of the bit-reversed index:
// the flat domain (j2 * n1 + j1) of pmntt.py's plan (Flat below, an
// involution) and the [t', s'] domain of pntt.py's (Rot, a rotation). So
// the forward transform stores through one more exchange that writes each
// value at its domain position and reads positions tau + s T for
// coalesced int64 stores; the inverse loads the same way round.
//
// Banks. Every shared access of a warp is one 32-bit word per lane. The
// buffers are swizzled by an XOR-linear map of the position (swz): bit
// b >= 5 of the position flips the bank bits ex_col(b) (exchanges, in p
// order) or the domain's col(b) (its permutation, in position order). For
// every LOGN from 8 to 14 (7 and 15 for the exchanges and Rot) these
// columns make each group's lane bits, the permutation's lane bits and the
// coalesced position order map onto 32 distinct banks, so no access has a
// bank conflict. At N = 32768 (pntt.cu only) the exchanges have columns
// of their own, and one exchange buffer of N words (128 KB) serves
// every exchange, each write after a barrier (Buffers<1>): two would take
// 256 KB, more than a block's 227 KB.
#pragma once

#include "common.cuh"

namespace tf {

template <int LOGN>
struct Shape {
  static constexpr int N = 1 << LOGN;
  static constexpr int R = LOGN == 7 ? 2 : LOGN == 8 ? 3 : LOGN == 15 ? 5 : 4;
  static constexpr int E = 1 << R;
  static constexpr int T = N >> R;               // threads per polynomial
  static constexpr int G = (LOGN + R - 1) / R;   // groups of stages
  static constexpr int P = T >= 512 ? 1 : 512 / T;  // polys per block
  static constexpr int THREADS = P * T;
  // forward group g: registers own bits [fwd_a(g), fwd_a(g) + R); its
  // stages run on bits fwd_hi(g) down to fwd_a(g)
  __host__ __device__ static constexpr int fwd_a(int g) {
    return LOGN - (g + 1) * R > 0 ? LOGN - (g + 1) * R : 0;
  }
  __host__ __device__ static constexpr int fwd_hi(int g) {
    return LOGN - 1 - g * R;
  }
  // inverse group g: registers own [inv_a(g), + R); stages on bits
  // inv_lo(g) up to inv_hi(g)
  __host__ __device__ static constexpr int inv_a(int g) {
    return g * R < LOGN - R ? g * R : LOGN - R;
  }
  __host__ __device__ static constexpr int inv_lo(int g) {
    return g * R;
  }
  __host__ __device__ static constexpr int inv_hi(int g) {
    return g * R + R - 1 < LOGN - 1 ? g * R + R - 1 : LOGN - 1;
  }
};

// Position of register 0 of thread tau in a group whose registers own bits
// [A, A + R): tau's low A bits stay, the rest move above the register bits.
template <int LOGN, int A>
__device__ __forceinline__ u32 thread_pos(u32 tau) {
  constexpr int R = Shape<LOGN>::R;
  return (tau & ((1u << A) - 1)) | ((tau >> A) << (A + R));
}

template <int LOGN>
__host__ __device__ constexpr u32 ex_col(int b) {
  if (LOGN == 7) return b == 5 ? 0xAu : 0x15u;
  if (LOGN == 8) return (1u << (b - 5)) ^ (1u << (b - 3));
  // the first inverse group's lanes own bits 5-9: one bank bit each
  if (LOGN == 15) return b < 10 ? 1u << (b - 5) : 0u;
  return b == 5 ? 0x2u : b == 6 ? 0x4u : b == 7 ? 0x8u : b == 8 ? 0x11u : 0u;
}

template <int LOGN>
__host__ __device__ constexpr u32 perm_col(int b) {
  return LOGN <= 9 ? 1u << (b % 5) : 1u << (4 - (LOGN - 1 - b) % 5);
}

// Flat NTT-domain position of bit-reversed index p: bit b < n1's bits goes
// to bit L1 - 1 - b, a higher bit to 2 L1 + 6 - b (L1 = log2 n1). The map
// is its own inverse, and XOR-linear as swz is.
template <int LOGN>
__host__ __device__ __forceinline__ constexpr u32 flat_of(u32 p) {
  constexpr int L1 = LOGN - 7;
  u32 o = 0;
  for (int b = 0; b < LOGN; ++b)
    if ((p >> b) & 1) o |= 1u << (b < L1 ? L1 - 1 - b : 2 * L1 + 6 - b);
  return o;
}

// The NTT domains a transform is stored in: pos(j) is the position of
// bit-reversed slot j, col(b) the bank bits that position bit b >= 5
// flips in the domain's exchange buffer.
template <int LOGN>
struct Flat {  // pmntt.py's flat domain
  __host__ __device__ static constexpr u32 pos(u32 j) {
    return flat_of<LOGN>(j);
  }
  __host__ __device__ static constexpr u32 col(int b) {
    return perm_col<LOGN>(b);
  }
};

// pntt.py's [t', s'] domain: with C = min(128, N / 2) and R' = N / C,
// position t' R' + s' holds slot s' C + t', so pos(j) is j rotated left by
// log2 R' bits (its own inverse only at N = 16384, where R' = C). A warp
// writing in slot order has lanes on j bits [R, R + 5), which land on
// position bits 0 and 1 (0 alone below N = 512) and the top two or three:
// col sends those onto the bank bits the low ones leave free.
template <int LOGN>
struct Rot {
  static constexpr int LOG_R = LOGN > 8 ? LOGN - 7 : 1;   // log2 R'
  __host__ __device__ static constexpr u32 pos(u32 j) {
    return ((j << LOG_R) | (j >> (LOGN - LOG_R))) & ((1u << LOGN) - 1);
  }
  __host__ __device__ static constexpr u32 col(int b) {
    return LOGN <= 8 ? 1u << (b - 4) : 1u << (4 - (LOGN - 1 - b) % 5);
  }
};

// Word offset of position p in a swizzled buffer: an exchange's (PERM
// false) or domain D's; linear over XOR, so swz(pt | off) = swz(pt) ^
// swz(off) for disjoint bits.
template <int LOGN, bool PERM, class D = Flat<LOGN>>
__host__ __device__ __forceinline__ constexpr u32 swz(u32 p) {
  u32 f = 0;
  for (int b = 5; b < LOGN; ++b)
    if ((p >> b) & 1) f ^= PERM ? D::col(b) : ex_col<LOGN>(b);
  return p ^ f;
}

// Exchange buffers of one polynomial. With NBUF = 2 consecutive exchanges
// alternate buffers, so the barrier of the exchange between two uses of a
// buffer orders the earlier reads before the later writes; with NBUF = 1
// each write waits at a barrier first.
template <int NBUF>
struct Buffers {
  u32* base;
  u32 stride;  // words from one buffer to the other
  int phase;
  __device__ __forceinline__ u32* next() {
    if (NBUF == 1) {
      __syncthreads();
      return base;
    }
    u32* b = base + phase * stride;
    phase ^= 1;
    return b;
  }
};

// x w mod q up to one q, in [0, 2q), for any u32 x: wp = (w, floor(w 2^32
// / q)) from the pair table.
__device__ __forceinline__ u32 mul_lazy(u32 x, u64 wp, u32 q) {
  return (u32)wp * x - __umulhi(x, (u32)(wp >> 32)) * q;
}

// The forward stages on bits HI down to A of registers owning [A, A + R).
// The butterfly on p (bit l clear) and p + 2^l takes psi_rev[m + i] with
// m = N / 2^(l+1), i = p >> (l + 1). Harvey's lazy butterfly: values
// stay in [0, 4q) (4q < 2^32 for q < 2^30), with one conditional
// subtraction and no other correction per butterfly; the caller reduces to
// [0, q) once at the end (canon).
template <int LOGN, int A, int HI>
__device__ __forceinline__ void fwd_stages(u32 (&v)[Shape<LOGN>::E], u32 pt,
                                           const u64* __restrict__ tw,
                                           u32 q) {
  constexpr int E = Shape<LOGN>::E, HALF = Shape<LOGN>::N / 2;
#pragma unroll
  for (int l = HI; l >= A; --l) {
    const int k = l - A;
    const u64* t = tw + (HALF >> l) + (pt >> (l + 1));
#pragma unroll
    for (int s = 0; s < E; ++s) {
      if ((s >> k) & 1) continue;
      const u64 w = __ldg(t + ((u32)(s << A) >> (l + 1)));
      const u32 x = csub(v[s], 2 * q);                  // [0, 2q)
      const u32 y = mul_lazy(v[s | 1 << k], w, q);      // [0, 2q)
      v[s] = x + y;
      v[s | 1 << k] = x - y + 2 * q;
    }
  }
}

// The inverse Gentleman-Sande stages on bits LO up to HI, the butterfly on
// p and p + 2^l taking psi_inv_rev[N / 2^(l+1) + (p >> (l + 1))], lazily:
// values in [0, 2q) in and out of every butterfly.
template <int LOGN, int A, int LO, int HI>
__device__ __forceinline__ void inv_stages(u32 (&v)[Shape<LOGN>::E], u32 pt,
                                           const u64* __restrict__ tw,
                                           u32 q) {
  constexpr int E = Shape<LOGN>::E, HALF = Shape<LOGN>::N / 2;
#pragma unroll
  for (int l = LO; l <= HI; ++l) {
    const int k = l - A;
    const u64* t = tw + (HALF >> l) + (pt >> (l + 1));
#pragma unroll
    for (int s = 0; s < E; ++s) {
      if ((s >> k) & 1) continue;
      const u64 w = __ldg(t + ((u32)(s << A) >> (l + 1)));
      const u32 x = v[s], y = v[s | 1 << k];
      v[s] = csub(x + y, 2 * q);
      v[s | 1 << k] = mul_lazy(x - y + 2 * q, w, q);
    }
  }
}

// v[s] = x[s * stride] up to a multiple of q, below 2q (the input bound of
// both transforms), for any int64 x in [0, 2^63). While every word of the
// thread (of each 16, at E = 32: 32 words in flight would not fit the
// registers) is below 2^32, a 32-bit Barrett step with m32 = floor(2^32 / q)
// (the quotient is at most 1 short, so the rest is below 2q); else the
// exact 64-bit reduction.
template <int E>
__device__ __forceinline__ void load_mod(u32 (&v)[E],
                                         const long long* __restrict__ x,
                                         int stride, const Limb& L) {
  if constexpr (E > 16) {
    load_mod(*reinterpret_cast<u32(*)[16]>(&v[0]), x, stride, L);
    load_mod(*reinterpret_cast<u32(*)[16]>(&v[16]), x + 16 * stride, stride,
             L);
    return;
  }
  u64 w[E];
  u32 hi = 0;
#pragma unroll
  for (int s = 0; s < E; ++s) {
    w[s] = (u64)x[s * stride];
    hi |= (u32)(w[s] >> 32);
  }
  if (hi == 0) {
    const u32 m32 = (u32)(L.m >> 32);
#pragma unroll
    for (int s = 0; s < E; ++s)
      v[s] = (u32)w[s] - __umulhi((u32)w[s], m32) * L.q;
  } else {
#pragma unroll
    for (int s = 0; s < E; ++s) v[s] = reduce64(w[s], L.q, L.m);
  }
}

// A forward transform's values [0, 4q) -> [0, q).
template <int E>
__device__ __forceinline__ void canon(u32 (&v)[E], u32 q) {
#pragma unroll
  for (int s = 0; s < E; ++s) v[s] = csub(csub(v[s], 2 * q), q);
}

// Registers of the group owning [A0, A0 + R) -> the group owning
// [A1, A1 + R), through `buf` in exchange order.
template <int LOGN, int A0, int A1>
__device__ __forceinline__ void exchange(u32 (&v)[Shape<LOGN>::E], u32* buf,
                                         u32 tau) {
  constexpr int E = Shape<LOGN>::E;
  const u32 w0 = swz<LOGN, false>(thread_pos<LOGN, A0>(tau));
#pragma unroll
  for (int s = 0; s < E; ++s) buf[w0 ^ swz<LOGN, false>(s << A0)] = v[s];
  __syncthreads();
  const u32 r0 = swz<LOGN, false>(thread_pos<LOGN, A1>(tau));
#pragma unroll
  for (int s = 0; s < E; ++s) v[s] = buf[r0 ^ swz<LOGN, false>(s << A1)];
}

// Forward transform: v in the first group's layout (v[s] = coefficient
// tau + s T, values in [0, 4q)) -> v in the last group's
// (bit-reversed index tau E + s), values in [0, 4q).
template <int LOGN, int GRP = 0, int NBUF>
__device__ __forceinline__ void fwd(u32 (&v)[Shape<LOGN>::E],
                                    Buffers<NBUF>& bufs, u32 tau,
                                    const u64* __restrict__ tw, u32 q) {
  using S = Shape<LOGN>;
  if constexpr (GRP > 0)
    exchange<LOGN, S::fwd_a(GRP - 1), S::fwd_a(GRP)>(v, bufs.next(), tau);
  fwd_stages<LOGN, S::fwd_a(GRP), S::fwd_hi(GRP)>(
      v, thread_pos<LOGN, S::fwd_a(GRP)>(tau), tw, q);
  if constexpr (GRP + 1 < S::G) fwd<LOGN, GRP + 1>(v, bufs, tau, tw, q);
}

// Inverse transform without the 1/N: v in bit-reversed layout (index
// tau E + s), values in [0, 2q) -> natural coefficient tau + s T, values
// in [0, 2q).
template <int LOGN, int GRP = 0, int NBUF>
__device__ __forceinline__ void inv(u32 (&v)[Shape<LOGN>::E],
                                    Buffers<NBUF>& bufs, u32 tau,
                                    const u64* __restrict__ tw, u32 q) {
  using S = Shape<LOGN>;
  if constexpr (GRP > 0)
    exchange<LOGN, S::inv_a(GRP - 1), S::inv_a(GRP)>(v, bufs.next(), tau);
  inv_stages<LOGN, S::inv_a(GRP), S::inv_lo(GRP), S::inv_hi(GRP)>(
      v, thread_pos<LOGN, S::inv_a(GRP)>(tau), tw, q);
  if constexpr (GRP + 1 < S::G) inv<LOGN, GRP + 1>(v, bufs, tau, tw, q);
}

// Bit-reversed layout (index tau E + s) -> domain D's layout (v[s] =
// position tau + s T).
template <int LOGN, class D = Flat<LOGN>>
__device__ __forceinline__ void to_flat(u32 (&v)[Shape<LOGN>::E], u32* buf,
                                        u32 tau) {
  using S = Shape<LOGN>;
  const u32 w0 = swz<LOGN, true, D>(D::pos(tau << S::R));
#pragma unroll
  for (int s = 0; s < S::E; ++s)
    buf[w0 ^ swz<LOGN, true, D>(D::pos(s))] = v[s];
  __syncthreads();
  const u32 r0 = swz<LOGN, true, D>(tau);
#pragma unroll
  for (int s = 0; s < S::E; ++s)
    v[s] = buf[r0 ^ swz<LOGN, true, D>(s * S::T)];
}

// The bit-reversed layout (index tau E + s) from a buffer that holds
// position p of domain D at word swz<LOGN, true, D>(p), written before a
// barrier: the second half of from_flat.
template <int LOGN, class D = Flat<LOGN>>
__device__ __forceinline__ void from_flat_read(u32 (&v)[Shape<LOGN>::E],
                                               const u32* buf, u32 tau) {
  using S = Shape<LOGN>;
  const u32 r0 = swz<LOGN, true, D>(D::pos(tau << S::R));
#pragma unroll
  for (int s = 0; s < S::E; ++s)
    v[s] = buf[r0 ^ swz<LOGN, true, D>(D::pos(s))];
}

// Domain D's layout -> bit-reversed layout: to_flat's inverse.
template <int LOGN, class D = Flat<LOGN>>
__device__ __forceinline__ void from_flat(u32 (&v)[Shape<LOGN>::E], u32* buf,
                                          u32 tau) {
  using S = Shape<LOGN>;
  const u32 w0 = swz<LOGN, true, D>(tau);
#pragma unroll
  for (int s = 0; s < S::E; ++s)
    buf[w0 ^ swz<LOGN, true, D>(s * S::T)] = v[s];
  __syncthreads();
  from_flat_read<LOGN, D>(v, buf, tau);
}

// The forward transform of one polynomial of x [rows, k, N] (with
// broadcast, of its row's single polynomial of x [rows, N]) into out
// [rows, k, N] in domain D: a slot of a block of Shape<LOGN>::P slots,
// with NBUF exchange buffers of N words a slot in `sm` (ntt.cu's B1 and B2,
// pntt.cu's B16). Each thread loads its coefficients as coalesced int64
// reads, any value below 2^63, reduced below 2q.
template <int LOGN, class D, int NBUF = 2>
__device__ __forceinline__ void fwd_poly(u32* sm,
                                         const long long* __restrict__ x,
                                         long long* __restrict__ out,
                                         const u64* __restrict__ twp,
                                         const long long* __restrict__ consts,
                                         int k, int polys, int broadcast) {
  using S = Shape<LOGN>;
  const u32 tau = threadIdx.x % S::T;
  const int slot = threadIdx.x / S::T;
  const int task = blockIdx.x * S::P + slot;
  // a block's spare slots redo the last polynomial and store nothing: every
  // thread reaches every barrier
  const int poly = task < polys ? task : polys - 1;
  const int row = poly / k, limb = poly % k;
  const Limb L = load_limb(consts, limb);
  const long long* src = x + (size_t)(broadcast ? row : poly) * S::N;
  u32 v[S::E];
  load_mod(v, src + tau, S::T, L);
  Buffers<NBUF> bufs{sm + slot * S::N, S::P * S::N, 0};
  fwd<LOGN>(v, bufs, tau, twp + (size_t)limb * 2 * S::N, L.q);
  canon(v, L.q);
  to_flat<LOGN, D>(v, bufs.next(), tau);
  if (task >= polys) return;
  long long* dst = out + (size_t)poly * S::N;
#pragma unroll
  for (int s = 0; s < S::E; ++s) dst[tau + s * S::T] = v[s];
}

// The inverse of fwd_poly (without broadcast): x [rows, k, N] in domain D,
// any value below 2^63, -> out [rows, k, N] in natural coefficient order,
// 1/N folded into the store.
template <int LOGN, class D, int NBUF = 2>
__device__ __forceinline__ void inv_poly(u32* sm,
                                         const long long* __restrict__ x,
                                         long long* __restrict__ out,
                                         const u64* __restrict__ twp,
                                         const long long* __restrict__ consts,
                                         int k, int polys) {
  using S = Shape<LOGN>;
  const u32 tau = threadIdx.x % S::T;
  const int slot = threadIdx.x / S::T;
  const int task = blockIdx.x * S::P + slot;
  const int poly = task < polys ? task : polys - 1;
  const int limb = poly % k;
  const Limb L = load_limb(consts, limb);
  u32 v[S::E];
  load_mod(v, x + (size_t)poly * S::N + tau, S::T, L);
  Buffers<NBUF> bufs{sm + slot * S::N, S::P * S::N, 0};
  from_flat<LOGN, D>(v, bufs.next(), tau);
  inv<LOGN>(v, bufs, tau, twp + ((size_t)limb * 2 + 1) * S::N, L.q);
  if (task >= polys) return;
  long long* dst = out + (size_t)poly * S::N;
#pragma unroll
  for (int s = 0; s < S::E; ++s)
    dst[tau + s * S::T] = mul_shoup(v[s], L.ninv, L.ninv_sh, L.q);
}

}  // namespace tf

// Runs `call` with LOGN the compile-time value of the runtime logn, for
// every supported size (256 <= N <= 16384); cudaErrorInvalidValue
// otherwise.
#define TF_DISPATCH(logn, call)                                  \
  switch (logn) {                                                \
    case 8: { constexpr int LOGN = 8; return call; }             \
    case 9: { constexpr int LOGN = 9; return call; }             \
    case 10: { constexpr int LOGN = 10; return call; }           \
    case 11: { constexpr int LOGN = 11; return call; }           \
    case 12: { constexpr int LOGN = 12; return call; }           \
    case 13: { constexpr int LOGN = 13; return call; }           \
    case 14: { constexpr int LOGN = 14; return call; }           \
    default: return (int)cudaErrorInvalidValue;                  \
  }
