// The glue of a blind-rotation step with an NTT-domain bootstrap key: the
// wrapping add that finishes step i and the rotated, decomposed digit
// residues that step i + 1's transform kernel (B1, or B15) reads, in one
// pass over the accumulator.
//
// Replaces no TPU kernel: the reference's step glue
// (sunscreen_tpu/tfhe/ops.py, _blind_rotate_ntt) is plain XLA. It stands in
// for the port's own torch ops (TorusNttPlanU32.br_glue_plain in
// tfhe/poly.py, about 66 launches a step). For a polynomial p = (row, c) of
// the accumulator acc [rows, C, N] (u64 torus words as int64):
//   1. with upd [rows, C, kp, N] (B5's output, residues below q_i):
//      acc[p] += to_torus(upd[p]), where per coefficient
//      y_i = x_i (C/c_i)^-1 mod c_i, alpha = (sum_i y_i g_i + 2^59) >> 60
//      with g_i = ceil(2^60 / c_i), and to_torus = sum_i y_i theta_i -
//      alpha C, wrapping mod 2^64 (theta_i = C / c_i mod 2^64);
//   2. with exps [rows] (exponents in [0, 2N), one per GLWE ciphertext):
//      digits [rows, C l, kp, N] = the residues mod each c_i of the
//      balanced base-2^radix_log gadget digits (count l, most significant
//      first, index c l + j) of X^e acc[p] - acc[p], rounded to the top
//      l radix_log bits, the carry at d == B/2 going up when the remaining
//      word is odd, the top carry dropped: TorusNttPlanU32.br_glue_plain's
//      bits exactly.
// Modes: upd null, decompose only (a rotation's first step); exps and
// digits null, accumulate only (after its last step).
//
// Bound on the H100 at the PBS step rows = 2048, C = 2, N = 1024, kp = 4,
// l = 3 (int64 words in and out): it reads B5's output (134.2 MB) and the
// accumulator (33.5 MB) and writes the accumulator (33.5 MB) and the digit
// residues (402.7 MB): 604 MB, 0.180 ms at 3.35 TB/s. The arithmetic (four
// 64-bit reductions and eight 64-bit products a coefficient, l shifts and
// masks) is small beside the bytes. Bound by bytes.
//
// Design: one polynomial a block, 256 threads, each taking the N / 256
// coefficients t + 256 s, so every global load and store is a coalesced
// int64 row. Phase 1 takes them four at a time: it reads their accumulator
// words and kp residue rows (all twenty loads in flight before any
// reduction), finishes the add in registers, stores the new words and stages
// them in shared memory (8 N bytes: 8 KB at N = 1024). Four at a time bounds
// the registers at every N (74 at N = 1024, 96-97 above, no spill; holding
// all N / 256 took 110 at 1024 and spilled from 4096). After one barrier,
// phase 2 gathers each coefficient's rotated partner with its sign from
// shared memory (consecutive threads read consecutive words), takes the
// difference and writes the l kp residue rows with streaming stores (the
// next kernel reads them after some 400 MB of other traffic); a digit d is
// below 2^28 in size, so its residue is d < 0 ? d + c_i : d, with no
// division. Nothing but the accumulator and the digits touches device
// memory. On the H100 at the PBS step it ran at 0.2119 ms, 85% of its bound,
// against 0.2114 for the register-held form and 0.2138-0.2198 for 2
// coefficients at a time, 128 threads or plain stores.

#include "common.cuh"

constexpr int BR_T = 256;     // threads a block
constexpr int BR_G = 4;       // coefficients a thread takes at a time
constexpr int BR_MAX_KP = 4;  // CRT primes (the torus plan's four)

// tab [kp][8] int64 per prime: q, floor(2^64 / q), (C/q)^-1 mod q,
// ceil(2^60 / q), C / q mod 2^64, C mod 2^64, 0, 0.
template <int LOGN>
__global__ void __launch_bounds__(BR_T)
    br_glue_kernel(const long long* __restrict__ acc,
                   const long long* __restrict__ upd,
                   const long long* __restrict__ exps,
                   long long* __restrict__ acc_out,
                   long long* __restrict__ digits,
                   const long long* __restrict__ tab, int comps, int kp,
                   int count, int radix_log) {
  constexpr int N = 1 << LOGN, E = N / BR_T, G = E < BR_G ? E : BR_G;
  extern __shared__ u64 words[];  // [N]: the polynomial's new words
  const size_t p = blockIdx.x;
  const u32 t = threadIdx.x;
  const long long* a = acc + p * N + t;
  // phase 1, G coefficients t + BR_T s at a time: all their loads in
  // flight before any reduction
#pragma unroll 1
  for (int s0 = 0; s0 < E; s0 += G) {
    u64 v[G];
#pragma unroll
    for (int s = 0; s < G; ++s) v[s] = (u64)a[(s0 + s) * BR_T];
    if (upd) {
      const long long* u = upd + p * kp * N + t + s0 * BR_T;
      u64 x[BR_MAX_KP][G];
#pragma unroll
      for (int i = 0; i < BR_MAX_KP; ++i)
        if (i < kp) {
#pragma unroll
          for (int s = 0; s < G; ++s) x[i][s] = (u64)u[i * N + s * BR_T];
        }
      u64 alpha[G], total[G];
#pragma unroll
      for (int s = 0; s < G; ++s) {
        alpha[s] = 1ull << 59;
        total[s] = 0;
      }
#pragma unroll
      for (int i = 0; i < BR_MAX_KP; ++i)
        if (i < kp) {
          const Mod M = load_mod(tab, i);
          const u64 inv = tab_at(tab, i, 2), g = tab_at(tab, i, 3),
                    theta = tab_at(tab, i, 4);
#pragma unroll
          for (int s = 0; s < G; ++s) {
            const u64 y = reduce64(x[i][s] * inv, M.q, M.m);
            alpha[s] += y * g;
            total[s] += y * theta;
          }
        }
      const u64 c_mod = tab_at(tab, 0, 5);
#pragma unroll
      for (int s = 0; s < G; ++s) {
        v[s] += total[s] - (alpha[s] >> 60) * c_mod;
        acc_out[p * N + t + (s0 + s) * BR_T] = (long long)v[s];
      }
    }
    if (digits) {
#pragma unroll
      for (int s = 0; s < G; ++s) words[t + (s0 + s) * BR_T] = v[s];
    }
  }
  if (!digits) return;
  __syncthreads();
  u32 q[BR_MAX_KP];
#pragma unroll
  for (int i = 0; i < BR_MAX_KP; ++i) q[i] = i < kp ? load_mod(tab, i).q : 0;
  const u32 e = (u32)exps[p / comps];
  // signed_decompose: keep the top count radix_log bits, rounded
  const int shift = 64 - count * radix_log;
  const u64 half_up = shift > 0 ? 1ull << (shift - 1) : 0;
  const u64 low = (1ull << radix_log) - 1, half_b = 1ull << (radix_log - 1);
  const size_t digit = (size_t)kp * N;  // one digit's residue rows
  long long* out = digits + p * count * digit + t;
#pragma unroll 1
  for (int s = 0; s < E; ++s) {
    const u32 j = t + s * BR_T, src = (j - e) & (2 * N - 1);
    const u64 w = words[src & (N - 1)];
    const u64 diff = ((src & N) ? 0 - w : w) - words[j];
    u64 cur = shift > 0 ? (diff + half_up) >> shift : diff;
    for (int i = count - 1; i >= 0; --i) {  // least significant first
      const u64 d = cur & low;
      cur >>= radix_log;
      const bool carry = d > half_b || (d == half_b && (cur & 1));
      cur += carry;
      const long long dv = carry ? (long long)d - (long long)(low + 1)
                                 : (long long)d;
      long long* o = out + i * digit + s * BR_T;
#pragma unroll
      for (int r = 0; r < BR_MAX_KP; ++r)
        if (r < kp) __stcs(o + r * N, dv < 0 ? dv + q[r] : dv);
    }
  }
}

template <int LOGN>
static int launch(const void* acc, const void* upd, const void* exps,
                  void* acc_out, void* digits, const void* tab, int rows,
                  int comps, int kp, int count, int radix_log,
                  void* stream) {
  const int smem = digits ? (int)(sizeof(u64) << LOGN) : 0;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(br_glue_kernel<LOGN>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  br_glue_kernel<LOGN><<<rows * comps, BR_T, smem, (cudaStream_t)stream>>>(
      (const long long*)acc, (const long long*)upd, (const long long*)exps,
      (long long*)acc_out, (long long*)digits, (const long long*)tab, comps,
      kp, count, radix_log);
  return (int)cudaGetLastError();
}

// acc [rows, comps, N]; upd [rows, comps, kp, N] or null; exps [rows] or
// null; acc_out [rows, comps, N] (with upd); digits [rows, comps count, kp,
// N] (with exps); tab [kp][8] as above. N = 2^logn, 256 <= N <= 16384, as
// B1's; kp <= 4; 1 <= radix_log <= 29 (a digit below the 30-bit primes),
// count radix_log <= 64.
extern "C" int br_glue(const void* acc, const void* upd, const void* exps,
                       void* acc_out, void* digits, const void* tab,
                       int rows, int comps, int kp, int count, int radix_log,
                       int logn, void* stream) {
  if (rows < 0 || comps < 1 || kp < 1 || kp > BR_MAX_KP ||
      (upd == nullptr) != (acc_out == nullptr) ||
      (exps == nullptr) != (digits == nullptr) ||
      (upd == nullptr && digits == nullptr) ||
      (digits && (count < 1 || radix_log < 1 || radix_log > 29 ||
                  count * radix_log > 64)))
    return (int)cudaErrorInvalidValue;
  switch (logn) {
#define BR_CASE(L) \
  case L:          \
    return rows ? launch<L>(acc, upd, exps, acc_out, digits, tab, rows, \
                            comps, kp, count, radix_log, stream)       \
                : 0;
    BR_CASE(8) BR_CASE(9) BR_CASE(10) BR_CASE(11) BR_CASE(12) BR_CASE(13)
    BR_CASE(14)
#undef BR_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
