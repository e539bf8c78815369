// Native curve25519/ristretto kernels for the host: field arithmetic, point
// ops, batched scalar multiplication, Pippenger MSM, keccak and the IPP
// prover loop (the port's copy of `sunscreen_tpu/_native/ristretto.cpp`,
// unchanged below this comment).
//
// Built with g++ at first use by `sunscreen_tpu_torch/zk/native.py` and bound
// through ctypes. The ZKP stack runs on it wherever the device MSM does not
// (`zk/curve25519.py`'s dispatch), and the CUDA MSM (`csrc/msm.cu`) is held
// against its `ristretto_msm`, which is in turn held against the pure-python
// group of `zk/curve25519.py`.
//
// Representation at the ABI: field elements as 32-byte little-endian,
// points as 128 bytes (X|Y|Z|T extended coordinates), scalars as
// 32-byte little-endian (already reduced mod L by the caller).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;

// ---------------------------------------------------------------------------
// threading (replaces the reference's rayon data-parallel curve paths:
// logproof parallel_multiscalar_multiplication, sunscreen_math cpu.rs)
// ---------------------------------------------------------------------------

static int native_threads() {
  static int n = 0;
  if (n == 0) {
    const char *env = getenv("SUNSCREEN_NATIVE_THREADS");
    if (env && atoi(env) > 0) {
      n = atoi(env);
    } else {
      unsigned hc = std::thread::hardware_concurrency();
      n = hc ? (int)hc : 1;
    }
    if (n > 64) n = 64;
  }
  return n;
}

// run fn(lo, hi) over [0, n) split across threads; grain = minimum
// work per thread below which the call stays sequential
template <typename F>
static void parallel_for(long n, long grain, F fn) {
  int T = native_threads();
  if (T <= 1 || n < 2 * grain) {
    fn(0L, n);
    return;
  }
  long chunks = (n + grain - 1) / grain;
  if (chunks > T) chunks = T;
  long per = (n + chunks - 1) / chunks;
  std::vector<std::thread> ts;
  for (long c = 1; c < chunks; c++) {
    long lo = c * per, hi = lo + per > n ? n : lo + per;
    if (lo >= hi) break;
    ts.emplace_back([lo, hi, &fn]() { fn(lo, hi); });
  }
  fn(0L, per > n ? n : per);
  for (auto &t : ts) t.join();
}

// ---------------------------------------------------------------------------
// fe25519: 5 x 51-bit limbs mod 2^255 - 19
// ---------------------------------------------------------------------------

struct fe { u64 v[5]; };

static const u64 MASK51 = (1ULL << 51) - 1;

static void fe_frombytes(fe &h, const uint8_t *s) {
  u64 w[4];
  memcpy(w, s, 32);
  h.v[0] = w[0] & MASK51;
  h.v[1] = ((w[0] >> 51) | (w[1] << 13)) & MASK51;
  h.v[2] = ((w[1] >> 38) | (w[2] << 26)) & MASK51;
  h.v[3] = ((w[2] >> 25) | (w[3] << 39)) & MASK51;
  h.v[4] = (w[3] >> 12) & MASK51;
}

static void fe_carry(fe &h) {
  for (int r = 0; r < 2; r++) {
    u64 c;
    c = h.v[0] >> 51; h.v[0] &= MASK51; h.v[1] += c;
    c = h.v[1] >> 51; h.v[1] &= MASK51; h.v[2] += c;
    c = h.v[2] >> 51; h.v[2] &= MASK51; h.v[3] += c;
    c = h.v[3] >> 51; h.v[3] &= MASK51; h.v[4] += c;
    c = h.v[4] >> 51; h.v[4] &= MASK51; h.v[0] += 19 * c;
  }
}

static void fe_tobytes(uint8_t *s, const fe &f) {
  fe t = f;
  fe_carry(t);
  // full reduction
  u64 q = (t.v[0] + 19) >> 51;
  q = (t.v[1] + q) >> 51;
  q = (t.v[2] + q) >> 51;
  q = (t.v[3] + q) >> 51;
  q = (t.v[4] + q) >> 51;
  t.v[0] += 19 * q;
  u64 c;
  c = t.v[0] >> 51; t.v[0] &= MASK51; t.v[1] += c;
  c = t.v[1] >> 51; t.v[1] &= MASK51; t.v[2] += c;
  c = t.v[2] >> 51; t.v[2] &= MASK51; t.v[3] += c;
  c = t.v[3] >> 51; t.v[3] &= MASK51; t.v[4] += c;
  t.v[4] &= MASK51;
  u64 w[4];
  w[0] = t.v[0] | (t.v[1] << 51);
  w[1] = (t.v[1] >> 13) | (t.v[2] << 38);
  w[2] = (t.v[2] >> 26) | (t.v[3] << 25);
  w[3] = (t.v[3] >> 39) | (t.v[4] << 12);
  memcpy(s, w, 32);
}

static void fe_add(fe &h, const fe &f, const fe &g) {
  for (int i = 0; i < 5; i++) h.v[i] = f.v[i] + g.v[i];
}

// h = f - g (adds 2p to stay positive). Single light carry pass:
// inputs are bounded by ~2^52.2 per limb (fe_mul/fe_sq outputs are
// < 2^51+eps; fe_add of two such < 2^52+eps; 2P limbs are ~2^53), so
// t < 2^53.3 per limb and one pass leaves limbs < 2^51 + 2^7 — safe
// for every consumer (fe_mul/fe_sq tolerate < 2^54).
static void fe_sub(fe &h, const fe &f, const fe &g) {
  static const u64 TWO_P[5] = {0xFFFFFFFFFFFDA * 2, 0xFFFFFFFFFFFFE * 2,
                               0xFFFFFFFFFFFFE * 2, 0xFFFFFFFFFFFFE * 2,
                               0xFFFFFFFFFFFFE * 2};
  u64 t0 = f.v[0] + TWO_P[0] - g.v[0];
  u64 t1 = f.v[1] + TWO_P[1] - g.v[1];
  u64 t2 = f.v[2] + TWO_P[2] - g.v[2];
  u64 t3 = f.v[3] + TWO_P[3] - g.v[3];
  u64 t4 = f.v[4] + TWO_P[4] - g.v[4];
  u64 c;
  c = t0 >> 51; t0 &= MASK51; t1 += c;
  c = t1 >> 51; t1 &= MASK51; t2 += c;
  c = t2 >> 51; t2 &= MASK51; t3 += c;
  c = t3 >> 51; t3 &= MASK51; t4 += c;
  c = t4 >> 51; t4 &= MASK51; t0 += 19 * c;
  h.v[0] = t0; h.v[1] = t1; h.v[2] = t2; h.v[3] = t3; h.v[4] = t4;
}

static void fe_mul(fe &h, const fe &f, const fe &g) {
  u128 r0 = 0, r1 = 0, r2 = 0, r3 = 0, r4 = 0;
  u64 f0 = f.v[0], f1 = f.v[1], f2 = f.v[2], f3 = f.v[3], f4 = f.v[4];
  u64 g0 = g.v[0], g1 = g.v[1], g2 = g.v[2], g3 = g.v[3], g4 = g.v[4];
  u64 g1_19 = 19 * g1, g2_19 = 19 * g2, g3_19 = 19 * g3, g4_19 = 19 * g4;
  r0 = (u128)f0 * g0 + (u128)f1 * g4_19 + (u128)f2 * g3_19 +
       (u128)f3 * g2_19 + (u128)f4 * g1_19;
  r1 = (u128)f0 * g1 + (u128)f1 * g0 + (u128)f2 * g4_19 +
       (u128)f3 * g3_19 + (u128)f4 * g2_19;
  r2 = (u128)f0 * g2 + (u128)f1 * g1 + (u128)f2 * g0 +
       (u128)f3 * g4_19 + (u128)f4 * g3_19;
  r3 = (u128)f0 * g3 + (u128)f1 * g2 + (u128)f2 * g1 + (u128)f3 * g0 +
       (u128)f4 * g4_19;
  r4 = (u128)f0 * g4 + (u128)f1 * g3 + (u128)f2 * g2 + (u128)f3 * g1 +
       (u128)f4 * g0;
  u64 c;
  u64 o0, o1, o2, o3, o4;
  c = (u64)(r0 >> 51); o0 = (u64)r0 & MASK51; r1 += c;
  c = (u64)(r1 >> 51); o1 = (u64)r1 & MASK51; r2 += c;
  c = (u64)(r2 >> 51); o2 = (u64)r2 & MASK51; r3 += c;
  c = (u64)(r3 >> 51); o3 = (u64)r3 & MASK51; r4 += c;
  c = (u64)(r4 >> 51); o4 = (u64)r4 & MASK51;
  o0 += 19 * c;
  c = o0 >> 51; o0 &= MASK51; o1 += c;
  h.v[0] = o0; h.v[1] = o1; h.v[2] = o2; h.v[3] = o3; h.v[4] = o4;
}

// h = f^2 (squaring: 15 partial products instead of 25)
static void fe_sq(fe &h, const fe &f) {
  u64 f0 = f.v[0], f1 = f.v[1], f2 = f.v[2], f3 = f.v[3], f4 = f.v[4];
  u64 f0_2 = f0 * 2, f1_2 = f1 * 2, f2_2 = f2 * 2, f3_2 = f3 * 2;
  u64 f3_19 = 19 * f3, f4_19 = 19 * f4;
  u128 r0 = (u128)f0 * f0 + (u128)f1_2 * f4_19 + (u128)f2_2 * f3_19;
  u128 r1 = (u128)f0_2 * f1 + (u128)f2_2 * f4_19 + (u128)f3 * f3_19;
  u128 r2 = (u128)f0_2 * f2 + (u128)f1 * f1 + (u128)f3_2 * f4_19;
  u128 r3 = (u128)f0_2 * f3 + (u128)f1_2 * f2 + (u128)f4 * f4_19;
  u128 r4 = (u128)f0_2 * f4 + (u128)f1_2 * f3 + (u128)f2 * f2;
  u64 c, o0, o1, o2, o3, o4;
  c = (u64)(r0 >> 51); o0 = (u64)r0 & MASK51; r1 += c;
  c = (u64)(r1 >> 51); o1 = (u64)r1 & MASK51; r2 += c;
  c = (u64)(r2 >> 51); o2 = (u64)r2 & MASK51; r3 += c;
  c = (u64)(r3 >> 51); o3 = (u64)r3 & MASK51; r4 += c;
  c = (u64)(r4 >> 51); o4 = (u64)r4 & MASK51;
  o0 += 19 * c;
  c = o0 >> 51; o0 &= MASK51; o1 += c;
  h.v[0] = o0; h.v[1] = o1; h.v[2] = o2; h.v[3] = o3; h.v[4] = o4;
}

// ---------------------------------------------------------------------------
// extended-coordinate edwards25519 points (a = -1)
// ---------------------------------------------------------------------------

struct ge { fe X, Y, Z, T; };

static fe FE_D2;  // 2*d
static bool initialized = false;

static void fe_from_u64s(fe &h, const u64 w[4]) {
  uint8_t b[32];
  memcpy(b, w, 32);
  fe_frombytes(h, b);
}

static void ge_init_constants() {
  if (initialized) return;
  // 2*d mod p, little-endian words
  static const u64 D2[4] = {0xebd69b9426b2f159ULL, 0x00e0149a8283b156ULL,
                            0x198e80f2eef3d130ULL, 0x2406d9dc56dffce7ULL};
  fe_from_u64s(FE_D2, D2);
  initialized = true;
}

static void ge_identity(ge &h) {
  memset(&h, 0, sizeof(h));
  h.Y.v[0] = 1;
  h.Z.v[0] = 1;
}

// complete addition for a=-1 twisted Edwards, extended coordinates
static void ge_add(ge &r, const ge &p, const ge &q) {
  fe a, b, c, d, e, f, g, h, t0, t1;
  fe_sub(t0, p.Y, p.X);
  fe_sub(t1, q.Y, q.X);
  fe_mul(a, t0, t1);                 // A = (Y1-X1)(Y2-X2)
  fe_add(t0, p.Y, p.X);
  fe_add(t1, q.Y, q.X);
  fe_mul(b, t0, t1);                 // B = (Y1+X1)(Y2+X2)
  fe_mul(c, p.T, FE_D2);
  fe_mul(c, c, q.T);                 // C = 2 d T1 T2
  fe_mul(d, p.Z, q.Z);
  fe_add(d, d, d);                   // D = 2 Z1 Z2
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

static void ge_double(ge &r, const ge &p) {
  fe a, b, c, h, e, g, f, t0;
  fe_sq(a, p.X);
  fe_sq(b, p.Y);
  fe_sq(c, p.Z);
  fe_add(c, c, c);
  fe_add(h, a, b);
  fe_add(t0, p.X, p.Y);
  fe_sq(t0, t0);
  fe_sub(e, h, t0);
  fe_sub(g, a, b);
  fe_add(f, c, g);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

static void ge_frombytes(ge &h, const uint8_t *s) {
  fe_frombytes(h.X, s);
  fe_frombytes(h.Y, s + 32);
  fe_frombytes(h.Z, s + 64);
  fe_frombytes(h.T, s + 96);
}

static void ge_tobytes(uint8_t *s, const ge &h) {
  fe_tobytes(s, h.X);
  fe_tobytes(s + 32, h.Y);
  fe_tobytes(s + 64, h.Z);
  fe_tobytes(s + 96, h.T);
}

// ---------------------------------------------------------------------------
// field helpers for the ristretto elligator map (RFC 9496 §4.3.4)
// ---------------------------------------------------------------------------

static void fe_one(fe &h) { memset(&h, 0, sizeof(h)); h.v[0] = 1; }

static void fe_neg(fe &h, const fe &f) {
  fe zero;
  memset(&zero, 0, sizeof(zero));
  fe_sub(h, zero, f);
}

static int fe_is_negative(const fe &f) {
  uint8_t b[32];
  fe_tobytes(b, f);
  return b[0] & 1;
}

static int fe_eq(const fe &a, const fe &b) {
  uint8_t ba[32], bb[32];
  fe_tobytes(ba, a);
  fe_tobytes(bb, b);
  return memcmp(ba, bb, 32) == 0;
}

// z^(2^252 - 3) = z^((p-5)/8): plain MSB-first square-and-multiply.
// Exponent bits: positions 2..251 set, position 1 clear, position 0 set.
static void fe_pow2523(fe &h, const fe &z) {
  fe r = z;  // bit 251
  for (int i = 250; i >= 0; i--) {
    fe_sq(r, r);
    int bit = (i >= 2) ? 1 : (i == 0 ? 1 : 0);
    if (bit) fe_mul(r, r, z);
  }
  h = r;
}

static fe FE_SQRT_M1, FE_D, FE_ONE_MINUS_D_SQ, FE_D_MINUS_ONE_SQ,
    FE_SQRT_AD_MINUS_ONE;
static bool elligator_initialized = false;

static void elligator_init_constants() {
  if (elligator_initialized) return;
  static const u64 W_SQRT_M1[4] = {0xc4ee1b274a0ea0b0ULL, 0x2f431806ad2fe478ULL, 0x2b4d00993dfbd7a7ULL, 0x2b8324804fc1df0bULL};
  static const u64 W_D[4] = {0x75eb4dca135978a3ULL, 0x00700a4d4141d8abULL, 0x8cc740797779e898ULL, 0x52036cee2b6ffe73ULL};
  static const u64 W_ONE_MINUS_D_SQ[4] = {0xe27c09c1945fc176ULL, 0x2c81a138cd5e350fULL, 0x9994abddbe70dfe4ULL, 0x029072a8b2b3e0d7ULL};
  static const u64 W_D_MINUS_ONE_SQ[4] = {0x31ad5aaa44ed4d20ULL, 0xd29e4a2cb01e1999ULL, 0x4cdcd32f529b4eebULL, 0x5968b37af66c2241ULL};
  static const u64 W_SQRT_AD_MINUS_ONE[4] = {0x8168095fb684d1d2ULL, 0x506271f3e487ab42ULL, 0xf0c30336ce0a2e02ULL, 0x4896ce40d47cb753ULL};
  fe_from_u64s(FE_SQRT_M1, W_SQRT_M1);
  fe_from_u64s(FE_D, W_D);
  fe_from_u64s(FE_ONE_MINUS_D_SQ, W_ONE_MINUS_D_SQ);
  fe_from_u64s(FE_D_MINUS_ONE_SQ, W_D_MINUS_ONE_SQ);
  fe_from_u64s(FE_SQRT_AD_MINUS_ONE, W_SQRT_AD_MINUS_ONE);
  elligator_initialized = true;
}

// (was_square, sqrt(u/v) or sqrt(i*u/v)) per RFC 9496 §4.2, matching
// zk/curve25519.py _sqrt_ratio_m1 bit-for-bit.
static int fe_sqrt_ratio_m1(fe &out, const fe &u, const fe &v) {
  fe v3, v7, r, check, t, neg_u, neg_u_i;
  fe_mul(v3, v, v);
  fe_mul(v3, v3, v);              // v^3
  fe_mul(v7, v3, v3);
  fe_mul(v7, v7, v);              // v^7
  fe_mul(t, u, v7);
  fe_pow2523(t, t);               // (u v^7)^((p-5)/8)
  fe_mul(r, u, v3);
  fe_mul(r, r, t);
  fe_mul(check, r, r);
  fe_mul(check, check, v);        // v r^2
  fe_neg(neg_u, u);
  fe_mul(neg_u_i, neg_u, FE_SQRT_M1);
  int correct = fe_eq(check, u);
  int flipped = fe_eq(check, neg_u);
  int flipped_i = fe_eq(check, neg_u_i);
  if (flipped || flipped_i) fe_mul(r, r, FE_SQRT_M1);
  if (fe_is_negative(r)) fe_neg(r, r);
  out = r;
  return correct || flipped;
}

// RFC 9496 §4.3.4 MAP (one 255-bit field element -> point), matching
// zk/curve25519.py _map_to_point.
static void ge_elligator_map(ge &h, const uint8_t *bytes32) {
  fe r0, r, u, c, v, s, n, t, w0, w1, w2, w3, one;
  uint8_t masked[32];
  memcpy(masked, bytes32, 32);
  masked[31] &= 0x7F;             // clear bit 255
  fe_frombytes(r0, masked);
  fe_one(one);
  fe_mul(r, r0, r0);
  fe_mul(r, r, FE_SQRT_M1);       // r = sqrt(-1) * r0^2
  fe_add(u, r, one);
  fe_mul(u, u, FE_ONE_MINUS_D_SQ);
  fe_neg(c, one);                 // c = -1
  fe_mul(t, FE_D, r);
  fe_sub(t, c, t);                // (-1 - d r)
  fe_add(v, r, FE_D);
  fe_mul(v, v, t);                // v = (-1 - d r)(r + d)
  int was_square = fe_sqrt_ratio_m1(s, u, v);
  if (!was_square) {
    fe_mul(s, s, r0);
    if (!fe_is_negative(s)) fe_neg(s, s);  // s = -|s r0| (force odd)
    c = r;
  }
  fe_sub(t, r, one);
  fe_mul(n, c, t);
  fe_mul(n, n, FE_D_MINUS_ONE_SQ);
  fe_sub(n, n, v);                // n = c (r-1) (d-1)^2 - v
  fe_add(w0, s, s);
  fe_mul(w0, w0, v);              // w0 = 2 s v
  fe_mul(w1, n, FE_SQRT_AD_MINUS_ONE);
  fe_mul(t, s, s);
  fe_sub(w2, one, t);             // w2 = 1 - s^2
  fe_add(w3, one, t);             // w3 = 1 + s^2
  fe_mul(h.X, w0, w3);
  fe_mul(h.Y, w2, w1);
  fe_mul(h.Z, w1, w3);
  fe_mul(h.T, w0, w2);
}

// ---------------------------------------------------------------------------
// Keccak-f[1600] (for merlin/STROBE transcript acceleration)
// ---------------------------------------------------------------------------

static const u64 KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static inline u64 rotl64(u64 x, int n) {
  return (x << n) | (x >> (64 - n));
}

static void keccakf(u64 a[25]) {
  // state layout matches the python reference: lane (x, y) at word
  // index x + 5*y.
  for (int round = 0; round < 24; round++) {
    u64 c[5], d[5], b[25];
    for (int x = 0; x < 5; x++)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; x++)
      d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) a[x + 5 * y] ^= d[x];
    static const int ROTC[5][5] = {{0, 36, 3, 41, 18},
                                   {1, 44, 10, 45, 2},
                                   {62, 6, 43, 15, 61},
                                   {28, 55, 25, 21, 56},
                                   {27, 20, 39, 8, 14}};
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y], ROTC[x][y]);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        a[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) &
                                       b[(x + 2) % 5 + 5 * y]);
    a[0] ^= KECCAK_RC[round];
  }
}

static void ge_neg(ge &r, const ge &p) {
  fe_neg(r.X, p.X);
  r.Y = p.Y;
  r.Z = p.Z;
  fe_neg(r.T, p.T);
}

// true iff p is the identity in the canonical (0, y, y, 0) form our
// buffers and fold chains produce (X and T limbs all zero); identity
// operands let folds skip a full scalar multiplication.
static inline bool ge_is_identity_fast(const ge &p) {
  u64 acc = 0;
  for (int i = 0; i < 5; i++) acc |= p.X.v[i] | p.T.v[i];
  return acc == 0;
}

// wNAF (w=5) recoding: odd digits in [-15, 15]; naf must hold 258
// entries; returns the number of digits (position of highest nonzero
// + 1, 0 for scalar 0).
static int scalar_to_naf5(int8_t *naf, const uint8_t *scalar) {
  u64 k[5] = {0, 0, 0, 0, 0};
  memcpy(k, scalar, 32);
  int len = 0;
  int i = 0;
  while (k[0] | k[1] | k[2] | k[3] | k[4]) {
    int d = 0;
    if (k[0] & 1) {
      d = (int)(k[0] & 31);
      if (d > 16) d -= 32;
      // k -= d (d odd, |d| <= 15)
      if (d > 0) {
        u64 borrow = (u64)d;
        for (int j = 0; j < 5 && borrow; j++) {
          u64 nv = k[j] - borrow;
          borrow = (nv > k[j]) ? 1 : 0;
          k[j] = nv;
        }
      } else {
        u64 carry = (u64)(-d);
        for (int j = 0; j < 5 && carry; j++) {
          u64 nv = k[j] + carry;
          carry = (nv < k[j]) ? 1 : 0;
          k[j] = nv;
        }
      }
    }
    naf[i] = (int8_t)d;
    if (d) len = i + 1;
    // k >>= 1
    for (int j = 0; j < 4; j++) k[j] = (k[j] >> 1) | (k[j + 1] << 63);
    k[4] >>= 1;
    i++;
  }
  return len;
}

// precompute {1P, 3P, 5P, ..., 15P}
static void ge_naf_table(ge table[8], const ge &p) {
  ge p2;
  ge_double(p2, p);
  table[0] = p;
  for (int i = 1; i < 8; i++) ge_add(table[i], table[i - 1], p2);
}

static void ge_scalarmul_naf(ge &r, const ge table[8], const int8_t *naf,
                             int len) {
  if (len == 0) {
    ge_identity(r);
    return;
  }
  int d = naf[len - 1];  // topmost digit is positive by construction
  r = table[d >> 1];
  for (int i = len - 2; i >= 0; i--) {
    ge_double(r, r);
    d = naf[i];
    if (d > 0) {
      ge_add(r, r, table[d >> 1]);
    } else if (d < 0) {
      ge neg;
      ge_neg(neg, table[(-d) >> 1]);
      ge_add(r, r, neg);
    }
  }
}

// r = sum_k c_k * P_k for up to 4 terms whose NAFs the caller
// precomputed: ONE shared Straus doubling chain instead of one per
// term. Bases must be non-identity and lens nonzero (caller filters).
static void ge_joint_scalarmul(ge &r, const ge *const bases[],
                               const int8_t *const nafs[],
                               const int lens[], int k) {
  ge tables[4][8];
  int maxlen = 0;
  for (int t = 0; t < k; t++) {
    ge_naf_table(tables[t], *bases[t]);
    if (lens[t] > maxlen) maxlen = lens[t];
  }
  ge_identity(r);
  for (int i = maxlen - 1; i >= 0; i--) {
    ge_double(r, r);
    for (int t = 0; t < k; t++) {
      if (i >= lens[t]) continue;
      int d = nafs[t][i];
      if (d > 0) {
        ge_add(r, r, tables[t][d >> 1]);
      } else if (d < 0) {
        ge neg;
        ge_neg(neg, tables[t][(-d) >> 1]);
        ge_add(r, r, neg);
      }
    }
  }
}

// scalar mult (variable time, wNAF w=5: ~253 doubles + ~42 adds + 8
// precomputed odd multiples)
static void ge_scalarmul(ge &r, const ge &p, const uint8_t *scalar) {
  int8_t naf[260];
  int len = scalar_to_naf5(naf, scalar);
  if (len == 0) {
    ge_identity(r);
    return;
  }
  ge table[8];
  ge_naf_table(table, p);
  ge_scalarmul_naf(r, table, naf, len);
}

// core = sum_i scalars[i] * (*pts[i]); Pippenger bucket method with
// signed-digit window recoding and a size-adaptive window: digits
// d in [-2^(C-1), 2^(C-1)] halve the bucket count (point negation is
// free: (-X, Y, Z, -T)), and C grows with n so the per-window bucket
// reduction amortizes — total adds ~ (253/C) * (n + 2^C) instead of
// the fixed C=6 cost (2.2x fewer at the SDLP l~3e5 sizes). Takes point
// POINTERS so callers with resident ge arrays avoid copies.
static void msm_core_seq(const uint8_t *scalars, const ge *const *pts,
                         long n, ge &result) {
  int C = 6;  // window bits
  {  // pick C minimizing (253/C) * (n + 2^C), C in [6, 14]
    double best = 1e30;
    for (int c = 6; c <= 14; c++) {
      double cost = (253.0 / c) * ((double)n + (double)(1 << c));
      if (cost < best) { best = cost; C = c; }
    }
  }
  const int WINDOWS = (253 + C - 1) / C + 1;  // +1: recoding carry
  const int NBUCKETS = 1 << (C - 1);          // digits 1 .. 2^(C-1)
  // signed-digit recoding of every scalar, least-significant first
  int16_t *digits = new int16_t[(size_t)n * WINDOWS];
  const int half = 1 << (C - 1);
  for (long i = 0; i < n; i++) {
    int carry = 0;
    for (int w = 0; w < WINDOWS; w++) {
      int bit0 = w * C;
      unsigned int v = 0;
      int word = bit0 / 8, shift = bit0 % 8;
      if (word < 32) {
        v = scalars[32 * i + word];
        if (word + 1 < 32)
          v |= (unsigned int)scalars[32 * i + word + 1] << 8;
        if (word + 2 < 32)
          v |= (unsigned int)scalars[32 * i + word + 2] << 16;
        v = (v >> shift) & ((1u << C) - 1);
      }
      int d = (int)v + carry;
      if (d > half) { d -= (1 << C); carry = 1; } else carry = 0;
      digits[(size_t)i * WINDOWS + w] = (int16_t)d;
    }
    // scalars are < L < 2^253 and the top window has headroom, so the
    // final carry is absorbed by the extra window
  }
  ge acc;
  ge_identity(acc);
  ge *buckets = new ge[NBUCKETS];
  bool *used = new bool[NBUCKETS];
  for (int w = WINDOWS - 1; w >= 0; w--) {
    if (w != WINDOWS - 1)
      for (int b = 0; b < C; b++) ge_double(acc, acc);
    for (int b = 0; b < NBUCKETS; b++) used[b] = false;
    bool nonzero = false;
    for (long i = 0; i < n; i++) {
      int d = digits[(size_t)i * WINDOWS + w];
      if (!d) continue;
      nonzero = true;
      int b;
      ge p = *pts[i];
      if (d > 0) {
        b = d - 1;
      } else {
        b = -d - 1;
        fe_neg(p.X, p.X);   // negated point: (-X, Y, Z, -T)
        fe_neg(p.T, p.T);
      }
      if (used[b]) {
        ge_add(buckets[b], buckets[b], p);
      } else {
        buckets[b] = p;
        used[b] = true;
      }
    }
    if (!nonzero) continue;
    ge sum, running;
    ge_identity(sum);
    ge_identity(running);
    bool any = false;
    for (int b = NBUCKETS - 1; b >= 0; b--) {
      if (used[b]) {
        if (any) ge_add(running, running, buckets[b]);
        else { running = buckets[b]; any = true; }
      }
      if (any) {
        ge_add(sum, sum, running);
      }
    }
    if (any) ge_add(acc, acc, sum);
  }
  delete[] digits;
  delete[] buckets;
  delete[] used;
  result = acc;
}

// parallel Pippenger: each thread reduces a chunk, partials are summed
// in chunk order (exact group ops: the result is the same group
// element as the sequential reduction; canonical encodings identical)
static void msm_core(const uint8_t *scalars, const ge *const *pts,
                     long n, ge &result) {
  int T = native_threads();
  if (T <= 1 || n < 4096) {
    msm_core_seq(scalars, pts, n, result);
    return;
  }
  long per = (n + T - 1) / T;
  long chunks = (n + per - 1) / per;
  std::vector<ge> partial(chunks);
  std::vector<std::thread> ts;
  for (long c = 1; c < chunks; c++) {
    long lo = c * per, hi = lo + per > n ? n : lo + per;
    ts.emplace_back([=, &partial]() {
      msm_core_seq(scalars + 32 * lo, pts + lo, hi - lo, partial[c]);
    });
  }
  msm_core_seq(scalars, pts, per > n ? n : per, partial[0]);
  for (auto &t : ts) t.join();
  ge acc = partial[0];
  for (long c = 1; c < chunks; c++) ge_add(acc, acc, partial[c]);
  result = acc;
}

// ---------------------------------------------------------------------------
// scalars mod L = 2^252 + 27742...493 (4 x u64 limbs, Montgomery form
// for multiplication; R = 2^256). Used by the native IPP prover loop.
// ---------------------------------------------------------------------------

struct sc { u64 v[4]; };

static const u64 SC_L[4] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
                            0ULL, 0x1000000000000000ULL};
static u64 SC_LPRIME = 0;  // -L^{-1} mod 2^64
static sc SC_RR;           // 2^512 mod L (maps into Montgomery form)
static sc SC_ONE_M;        // 1 in Montgomery form (= 2^256 mod L)
static bool sc_initialized = false;

static int sc_gte_l(const sc &a) {
  for (int i = 3; i >= 0; i--) {
    if (a.v[i] > SC_L[i]) return 1;
    if (a.v[i] < SC_L[i]) return 0;
  }
  return 1;
}

static void sc_sub_l(sc &a) {
  u64 borrow = 0;
  for (int i = 0; i < 4; i++) {
    u64 t = a.v[i] - SC_L[i] - borrow;
    borrow = (a.v[i] < SC_L[i] + borrow)
             || (SC_L[i] + borrow < SC_L[i]) ? 1 : 0;
    a.v[i] = t;
  }
}

static void sc_add(sc &r, const sc &a, const sc &b) {
  u64 carry = 0;
  for (int i = 0; i < 4; i++) {
    u128 t = (u128)a.v[i] + b.v[i] + carry;
    r.v[i] = (u64)t;
    carry = (u64)(t >> 64);
  }
  // a, b < L < 2^253 so no top overflow; reduce once if needed
  if (sc_gte_l(r)) sc_sub_l(r);
}

static void sc_montmul(sc &r, const sc &a, const sc &b) {
  // CIOS: t has 6 limbs
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; i++) {
    u128 carry = 0;
    for (int j = 0; j < 4; j++) {
      u128 cur = (u128)t[j] + (u128)a.v[i] * b.v[j] + carry;
      t[j] = (u64)cur;
      carry = cur >> 64;
    }
    u128 cur = (u128)t[4] + carry;
    t[4] = (u64)cur;
    t[5] = (u64)(cur >> 64);
    u64 m = t[0] * SC_LPRIME;
    u128 c0 = (u128)t[0] + (u128)m * SC_L[0];
    carry = c0 >> 64;
    for (int j = 1; j < 4; j++) {
      u128 cur2 = (u128)t[j] + (u128)m * SC_L[j] + carry;
      t[j - 1] = (u64)cur2;
      carry = cur2 >> 64;
    }
    u128 cur3 = (u128)t[4] + carry;
    t[3] = (u64)cur3;
    t[4] = t[5] + (u64)(cur3 >> 64);
    t[5] = 0;
  }
  sc out;
  for (int i = 0; i < 4; i++) out.v[i] = t[i];
  // CIOS with a, b < L < R guarantees t < 2L (t[4] == 0 here since
  // L < 2^253 << 2^256); a single conditional subtract reduces.
  if (t[4] || sc_gte_l(out)) sc_sub_l(out);
  r = out;
}

static void sc_init() {
  if (sc_initialized) return;
  // LPRIME = -L^{-1} mod 2^64 via Newton iteration
  u64 x = 1;
  for (int i = 0; i < 6; i++) x *= 2 - SC_L[0] * x;
  SC_LPRIME = (u64)(0 - x);
  // RR = 2^512 mod L by repeated doubling of (2^252 .. ) — start from
  // 1 and double 512 times with conditional subtraction
  sc r;
  r.v[0] = 1; r.v[1] = r.v[2] = r.v[3] = 0;
  for (int i = 0; i < 512; i++) {
    u64 carry = 0;
    for (int j = 0; j < 4; j++) {
      u64 nv = (r.v[j] << 1) | carry;
      carry = r.v[j] >> 63;
      r.v[j] = nv;
    }
    // value stays < 2L (< 2^254) so top bits never overflow
    if (carry || sc_gte_l(r)) sc_sub_l(r);
  }
  SC_RR = r;
  sc_initialized = true;
  // 1 in Montgomery form = montmul(1, RR)
  sc one;
  one.v[0] = 1; one.v[1] = one.v[2] = one.v[3] = 0;
  sc_montmul(SC_ONE_M, one, SC_RR);
}

static void sc_frombytes(sc &r, const uint8_t *b) { memcpy(r.v, b, 32); }
static void sc_tobytes(uint8_t *b, const sc &a) { memcpy(b, a.v, 32); }

static void sc_to_mont(sc &r, const sc &a) { sc_montmul(r, a, SC_RR); }
static void sc_from_mont(sc &r, const sc &a) {
  sc one;
  one.v[0] = 1; one.v[1] = one.v[2] = one.v[3] = 0;
  sc_montmul(r, a, one);
}

// canonical reduction of a 4-limb value (< 2^256): at most ~12
// subtractions of L
static void sc_reduce256(sc &a) {
  while (sc_gte_l(a)) sc_sub_l(a);
}

// 64 little-endian bytes -> scalar mod L (merlin challenge_scalar
// convention, matching zk/curve25519.scalar_from_bytes_wide)
static void sc_from_wide(sc &r, const uint8_t *b) {
  sc lo, hi;
  memcpy(lo.v, b, 32);
  memcpy(hi.v, b + 32, 32);
  sc_reduce256(lo);
  sc_reduce256(hi);
  sc hi_shift;
  sc_montmul(hi_shift, hi, SC_RR);  // hi * 2^256 mod L
  sc_add(r, hi_shift, lo);
}

// Montgomery-domain inverse via a^(L-2)
static void sc_inv_mont(sc &r, const sc &a_m) {
  // exponent L - 2
  u64 e[4] = {SC_L[0] - 2, SC_L[1], SC_L[2], SC_L[3]};
  sc acc = SC_ONE_M;
  sc base = a_m;
  for (int limb = 0; limb < 4; limb++) {
    for (int bit = 0; bit < 64; bit++) {
      if ((e[limb] >> bit) & 1) sc_montmul(acc, acc, base);
      sc_montmul(base, base, base);
    }
  }
  r = acc;
}

// ---------------------------------------------------------------------------
// STROBE-128 / merlin transcript (exact port of zk/merlin.py; pinned
// against the python implementation by tests/test_merlin.py)
// ---------------------------------------------------------------------------

struct strobe128 {
  uint8_t state[200];
  int pos;
  int pos_begin;
  int cur_flags;
};

static const int STROBE_R = 166;
enum { SF_I = 1, SF_A = 2, SF_C = 4, SF_T = 8, SF_M = 16, SF_K = 32 };

static void strobe_run_f(strobe128 &s) {
  s.state[s.pos] ^= (uint8_t)s.pos_begin;
  s.state[s.pos + 1] ^= 0x04;
  s.state[STROBE_R + 1] ^= 0x80;
  u64 a[25];
  memcpy(a, s.state, 200);
  keccakf(a);
  memcpy(s.state, a, 200);
  s.pos = 0;
  s.pos_begin = 0;
}

static void strobe_absorb(strobe128 &s, const uint8_t *data, long n) {
  for (long i = 0; i < n; i++) {
    s.state[s.pos] ^= data[i];
    if (++s.pos == STROBE_R) strobe_run_f(s);
  }
}

static void strobe_squeeze(strobe128 &s, uint8_t *out, long n) {
  for (long i = 0; i < n; i++) {
    out[i] = s.state[s.pos];
    s.state[s.pos] = 0;
    if (++s.pos == STROBE_R) strobe_run_f(s);
  }
}

static void strobe_begin_op(strobe128 &s, int flags, bool more) {
  if (more) return;  // python asserts flags match; trusted caller here
  int old_begin = s.pos_begin;
  s.pos_begin = s.pos + 1;
  s.cur_flags = flags;
  uint8_t hdr[2] = {(uint8_t)old_begin, (uint8_t)flags};
  strobe_absorb(s, hdr, 2);
  if ((flags & (SF_C | SF_K)) && s.pos != 0) strobe_run_f(s);
}

static void strobe_meta_ad(strobe128 &s, const uint8_t *d, long n,
                           bool more) {
  strobe_begin_op(s, SF_M | SF_A, more);
  strobe_absorb(s, d, n);
}

static void strobe_ad(strobe128 &s, const uint8_t *d, long n, bool more) {
  strobe_begin_op(s, SF_A, more);
  strobe_absorb(s, d, n);
}

static void strobe_prf(strobe128 &s, uint8_t *out, long n, bool more) {
  strobe_begin_op(s, SF_I | SF_A | SF_C, more);
  strobe_squeeze(s, out, n);
}

// merlin transcript ops
static void tr_append(strobe128 &s, const uint8_t *label, long ll,
                      const uint8_t *msg, long ml) {
  strobe_meta_ad(s, label, ll, false);
  uint8_t len4[4] = {(uint8_t)(ml & 0xFF), (uint8_t)((ml >> 8) & 0xFF),
                     (uint8_t)((ml >> 16) & 0xFF),
                     (uint8_t)((ml >> 24) & 0xFF)};
  strobe_meta_ad(s, len4, 4, true);
  strobe_ad(s, msg, ml, false);
}

static void tr_challenge_bytes(strobe128 &s, const uint8_t *label,
                               long ll, uint8_t *out, long n) {
  strobe_meta_ad(s, label, ll, false);
  uint8_t len4[4] = {(uint8_t)(n & 0xFF), (uint8_t)((n >> 8) & 0xFF),
                     (uint8_t)((n >> 16) & 0xFF),
                     (uint8_t)((n >> 24) & 0xFF)};
  strobe_meta_ad(s, len4, 4, true);
  strobe_prf(s, out, n, false);
}

static void tr_challenge_scalar(strobe128 &s, const uint8_t *label,
                                long ll, sc &out) {
  uint8_t wide[64];
  tr_challenge_bytes(s, label, ll, wide, 64);
  sc_from_wide(out, wide);
}

// python<->C strobe state bridging: 200B state + int32 [pos,
// pos_begin, cur_flags]
static void strobe_load(strobe128 &s, const uint8_t *state,
                        const int32_t *meta) {
  memcpy(s.state, state, 200);
  s.pos = meta[0];
  s.pos_begin = meta[1];
  s.cur_flags = meta[2];
}

static void strobe_store(const strobe128 &s, uint8_t *state,
                         int32_t *meta) {
  memcpy(state, s.state, 200);
  meta[0] = s.pos;
  meta[1] = s.pos_begin;
  meta[2] = s.cur_flags;
}

// ---------------------------------------------------------------------------
// ristretto255 compression (RFC 9496 §4.3.2; exact port of
// zk/curve25519.Point.encode — needed so the native IPP loop can
// append points to the transcript byte-identically)
// ---------------------------------------------------------------------------

static fe FE_INVSQRT_A_MINUS_D;
static bool compress_initialized = false;

static void compress_init_constants() {
  if (compress_initialized) return;
  elligator_init_constants();
  fe one, t, v;
  fe_one(one);
  fe_add(t, one, FE_D);
  fe_neg(v, t);                      // -(1 + d)
  fe_sqrt_ratio_m1(FE_INVSQRT_A_MINUS_D, one, v);
  compress_initialized = true;
}

static void ge_compress(uint8_t out[32], const ge &p) {
  fe u1, u2, t, invsqrt, den1, den2, z_inv, ix0, iy0, ench, x, y,
      den_inv, s_, one, zy;
  fe_one(one);
  fe_add(t, p.Z, p.Y);
  fe_sub(zy, p.Z, p.Y);
  fe_mul(u1, t, zy);                 // (Z+Y)(Z-Y)
  fe_mul(u2, p.X, p.Y);
  fe_sq(t, u2);
  fe_mul(t, t, u1);                  // u1 * u2^2
  fe_sqrt_ratio_m1(invsqrt, one, t);
  fe_mul(den1, invsqrt, u1);
  fe_mul(den2, invsqrt, u2);
  fe_mul(z_inv, den1, den2);
  fe_mul(z_inv, z_inv, p.T);
  fe_mul(ix0, p.X, FE_SQRT_M1);
  fe_mul(iy0, p.Y, FE_SQRT_M1);
  fe_mul(ench, den1, FE_INVSQRT_A_MINUS_D);
  fe_mul(t, p.T, z_inv);
  int rotate = fe_is_negative(t);
  if (rotate) {
    x = iy0;
    y = ix0;
    den_inv = ench;
  } else {
    x = p.X;
    y = p.Y;
    den_inv = den2;
  }
  fe_mul(t, x, z_inv);
  if (fe_is_negative(t)) fe_neg(y, y);
  fe_sub(t, p.Z, y);
  fe_mul(s_, den_inv, t);
  uint8_t sb[32];
  fe_tobytes(sb, s_);
  if (sb[0] & 1) {
    fe_neg(s_, s_);
    fe_tobytes(sb, s_);
  }
  memcpy(out, sb, 32);
}

extern "C" {

// out(128B) = sum_i scalars[i] * points[i] (ABI wrapper over msm_core)
void ristretto_msm(const uint8_t *scalars, const uint8_t *points,
                   long n, uint8_t *out) {
  ge_init_constants();
  ge *pts = new ge[n];
  const ge **ptrs = new const ge *[n];
  for (long i = 0; i < n; i++) {
    ge_frombytes(pts[i], points + 128 * i);
    ptrs[i] = &pts[i];
  }
  ge acc;
  msm_core(scalars, ptrs, n, acc);
  ge_tobytes(out, acc);
  delete[] pts;
  delete[] ptrs;
}

// out[i] = scalars[i] * points[i] (independent scalar mults)
void ristretto_batch_scalarmul(const uint8_t *scalars,
                               const uint8_t *points, long n,
                               uint8_t *out) {
  ge_init_constants();
  parallel_for(n, 64, [&](long lo, long hi) {
    for (long i = lo; i < hi; i++) {
      ge p, r;
      ge_frombytes(p, points + 128 * i);
      ge_scalarmul(r, p, scalars + 32 * i);
      ge_tobytes(out + 128 * i, r);
    }
  });
}

// out[i] = a[i] + scalar * b[i] (IPP generator folding; the scalar is
// shared, so its wNAF recoding is hoisted out of the loop)
void ristretto_fold(const uint8_t *a, const uint8_t *b,
                    const uint8_t *scalar, long n, uint8_t *out) {
  ge_init_constants();
  int8_t naf[260];
  int len = scalar_to_naf5(naf, scalar);
  parallel_for(n, 64, [&](long lo, long hi) {
    for (long i = lo; i < hi; i++) {
      ge pa, pb, r, table[8];
      ge_frombytes(pa, a + 128 * i);
      ge_frombytes(pb, b + 128 * i);
      ge_naf_table(table, pb);
      ge_scalarmul_naf(r, table, naf, len);
      ge_add(r, pa, r);
      ge_tobytes(out + 128 * i, r);
    }
  });
}

// out[i] = scalar * points[i] (same scalar)
void ristretto_scale_all(const uint8_t *points, const uint8_t *scalar,
                         long n, uint8_t *out) {
  ge_init_constants();
  int8_t naf[260];
  int len = scalar_to_naf5(naf, scalar);
  parallel_for(n, 64, [&](long lo, long hi) {
    for (long i = lo; i < hi; i++) {
      ge p, r, table[8];
      ge_frombytes(p, points + 128 * i);
      ge_naf_table(table, p);
      ge_scalarmul_naf(r, table, naf, len);
      ge_tobytes(out + 128 * i, r);
    }
  });
}

// out[i](128B) = from_uniform_bytes(bytes[i] (64B)): elligator map of
// both halves, added (generator derivation hot loop for SDLP/BP at
// production sizes; reference: curve25519-dalek from_uniform_bytes as
// used by logproof/src/generators.rs).
void ristretto_from_uniform(const uint8_t *bytes, long n, uint8_t *out) {
  ge_init_constants();
  elligator_init_constants();
  parallel_for(n, 64, [&](long lo, long hi) {
    for (long i = lo; i < hi; i++) {
      ge p1, p2, r;
      ge_elligator_map(p1, bytes + 64 * i);
      ge_elligator_map(p2, bytes + 64 * i + 32);
      ge_add(r, p1, p2);
      ge_tobytes(out + 128 * i, r);
    }
  });
}

// In-place Keccak-f[1600] on a 200-byte state (little-endian lanes).
void keccak_f1600(uint8_t *state) {
  u64 a[25];
  memcpy(a, state, 200);
  keccakf(a);
  memcpy(state, a, 200);
}

// In-place Keccak-f[1600] on `n` contiguous 200-byte states (forked
// transcript batches).
void keccak_f1600_batch(uint8_t *states, long n) {
  for (long i = 0; i < n; i++) keccak_f1600(states + 200 * i);
}

// --- deferred-materialization generator chains (round 5) -------------------
//
// The prover's generator folds are its dominant curve cost: folding m
// points costs m wNAF scalar multiplications (~253 doublings each) per
// round, and the g chain additionally paid an up-front l-point pass
// materializing g' = phi^-1 o g (linear_relation.create). Generators
// only need to EXIST as points where a value depending on them is
// emitted — the round cross terms t_-1/t_+1 (MSMs, which can run over
// the unfolded points with challenge-adjusted scalars at Pippenger
// cost, ~1/9 of a scalarmul per point) and the final opening's
// g[0]/h[0]. So each chain defers: fold challenges accumulate
// symbolically for two rounds (virtual depth dv.t in {0, 1}), cross
// terms expand over the materialized points, and every second round
// the chain re-materializes with ONE joint Straus walk per output
// combining both pending challenges — and, the first time, the
// per-point phi^-1 coefficients, which therefore never get their own
// scalar-multiplication pass. Emitted group elements are identical to
// the eager-fold schedule (ristretto compression canonicalizes), so
// proofs stay byte-for-byte the same.

struct defvec {
  ge *pts;   // materialized points (logical length m)
  sc *coef;  // pending per-point Montgomery coefficients, or null (=1)
  long m;    // materialized count
  int t;     // rounds deferred since materialization (0 or 1)
  sc ce;     // pending even-round fold scalar (Montgomery), when t==1
};

static inline bool sc_is_zero(const sc &a) {
  return !(a.v[0] | a.v[1] | a.v[2] | a.v[3]);
}

static inline long emit_term(uint8_t *msm_sc, const ge **msm_pt,
                             long pos, const sc &k_m, const ge &pt) {
  if (sc_is_zero(k_m) || ge_is_identity_fast(pt)) return pos;
  sc k;
  sc_from_mont(k, k_m);
  sc_tobytes(msm_sc + 32 * pos, k);
  msm_pt[pos] = &pt;
  return pos + 1;
}

// Append the expansion of sum_{i<cnt} v[voff+i] * Virt_{goff+i} over
// dv's materialized points (v entries Montgomery). Virtual generators:
// t=0: Virt_j = coef_j P_j;  t=1: Virt_j = coef_j P_j +
// ce * coef_{j+m/2} P_{j+m/2}.
static long expand_range(const defvec &dv, const sc *v, long voff,
                         long goff, long cnt, uint8_t *msm_sc,
                         const ge **msm_pt, long pos) {
  long m2 = dv.m / 2;
  for (long i = 0; i < cnt; i++) {
    const sc &vm = v[voff + i];
    if (sc_is_zero(vm)) continue;
    long j = goff + i;
    sc k = vm;
    if (dv.coef) sc_montmul(k, k, dv.coef[j]);
    pos = emit_term(msm_sc, msm_pt, pos, k, dv.pts[j]);
    if (dv.t == 1) {
      sc k2;
      sc_montmul(k2, vm, dv.ce);
      if (dv.coef) sc_montmul(k2, k2, dv.coef[j + m2]);
      pos = emit_term(msm_sc, msm_pt, pos, k2, dv.pts[j + m2]);
    }
  }
  return pos;
}

// Re-materialize dv after its deferred rounds. co_m = the fold scalar
// of the just-finished odd round (null when flushing a single pending
// even round at loop end). depth 2: newP_j = K0 P_j + K1 P_{j+q} +
// K2 P_{j+2q} + K3 P_{j+3q} with (K0..K3) = (1, co, ce, ce*co) times
// the pending coefs; depth 1: newP_j = K0 P_j + K2 P_{j+q} with
// (K0, K2) = (1, ce) times coefs. In-place safe: output j only reads
// indices >= j and only output j reads index j.
static void materialize(defvec &dv, const sc *co_m) {
  int depth = dv.t + (co_m ? 1 : 0);
  if (depth == 0) {
    if (!dv.coef) return;
    // no pending rounds but unabsorbed coefficients (n==1 proofs):
    // scale the points in place
    ge *pts = dv.pts;
    const sc *coef = dv.coef;
    parallel_for(dv.m, 16, [&](long lo, long hi) {
      for (long j = lo; j < hi; j++) {
        if (ge_is_identity_fast(pts[j])) continue;
        sc k;
        sc_from_mont(k, coef[j]);
        uint8_t kb[32];
        sc_tobytes(kb, k);
        ge r;
        ge_scalarmul(r, pts[j], kb);
        pts[j] = r;
      }
    });
    delete[] dv.coef;
    dv.coef = nullptr;
    return;
  }
  long q = dv.m >> depth;
  int nterms = 1 << depth;
  sc ks_m[4];  // shared scalar per offset slot (Montgomery)
  {
    sc one;
    memset(&one, 0, sizeof(one));
    one.v[0] = 1;
    sc one_m;
    sc_to_mont(one_m, one);
    if (depth == 2) {
      ks_m[0] = one_m;
      ks_m[1] = *co_m;
      ks_m[2] = dv.ce;
      sc_montmul(ks_m[3], dv.ce, *co_m);
    } else {
      ks_m[0] = one_m;
      ks_m[1] = dv.ce;
    }
  }
  // shared-NAF fast path (no pending coefs): recode each K once
  int8_t snaf[4][260];
  int slen[4] = {0, 0, 0, 0};
  if (!dv.coef) {
    for (int s = 1; s < nterms; s++) {
      sc k;
      sc_from_mont(k, ks_m[s]);
      uint8_t kb[32];
      sc_tobytes(kb, k);
      slen[s] = scalar_to_naf5(snaf[s], kb);
    }
  }
  ge *pts = dv.pts;
  const sc *coef = dv.coef;
  parallel_for(q, 16, [&](long lo, long hi) {
    for (long j = lo; j < hi; j++) {
      const ge *bases[4];
      const int8_t *nafs[4];
      int lens[4];
      int8_t pnaf[4][260];
      int k = 0;
      ge unit;
      bool have_unit = false;
      for (int s = 0; s < nterms; s++) {
        const ge &p = pts[j + s * q];
        if (ge_is_identity_fast(p)) continue;
        if (!coef && s == 0) {  // unit scalar: plain add at the end
          unit = p;
          have_unit = true;
          continue;
        }
        sc km = ks_m[s];
        if (coef) sc_montmul(km, km, coef[j + s * q]);
        if (!coef) {
          nafs[k] = snaf[s];
          lens[k] = slen[s];
        } else {
          sc kn;
          sc_from_mont(kn, km);
          uint8_t kb[32];
          sc_tobytes(kb, kn);
          lens[k] = scalar_to_naf5(pnaf[k], kb);
          nafs[k] = pnaf[k];
        }
        if (lens[k] == 0) continue;  // scalar 0
        bases[k] = &p;
        k++;
      }
      ge r;
      if (k > 0) {
        ge_joint_scalarmul(r, bases, nafs, lens, k);
        if (have_unit) ge_add(r, r, unit);
      } else if (have_unit) {
        r = unit;
      } else {
        ge_identity(r);
      }
      pts[j] = r;
    }
  });
  dv.m = q;
  dv.t = 0;
  if (dv.coef) {
    delete[] dv.coef;
    dv.coef = nullptr;
  }
}

// Full ZK inner-product prover loop (logproof/inner_product.py create,
// everything after the dom-sep/a_pt draw). Runs the log-rounds of
// cross-term MSMs, transcript appends/challenges, generator and
// vector folding, and the final Schnorr-style opening natively, so no
// per-round python marshalling happens. The strobe state is bridged
// in/out so the surrounding python Transcript continues seamlessly.
//
// g_coeff_b (nullable, n*32): per-point scalars folded into the g
// bases virtually (the SDLP's g' = phi^-1 o g) — absorbed by the
// deferred chains above, never materialized as a standalone pass.
//
// rand layout: per round [sigma, sigma_m1], then [y1, y2, sig, sig_p]
// — exactly the draw order of the python fallback, so with injected
// randomness both paths emit byte-identical proofs (pinned by
// tests/test_logproof.py).
void ristretto_ipp_prove(
    uint8_t *strobe_state, int32_t *strobe_meta,
    const uint8_t *v1_in, const uint8_t *v2_in,   // n*32 (mod L)
    const uint8_t *g_in, const uint8_t *h_in,     // n*128
    const uint8_t *a_pt_b, const uint8_t *u_pt_b, // 128 each
    const uint8_t *rho_b,                         // 32
    const uint8_t *rand_b,                        // (2*lg+4)*32
    long n,                                       // power of two
    long n_real,  // entries >= n_real are identity/zero padding
                  // (skipped via zero-scalar / identity checks)
    const uint8_t *g_coeff_b,                     // nullable, n*32
    uint8_t *t1_out, uint8_t *tm1_out,            // lg*128
    uint8_t *w_out, uint8_t *wp_out,              // 128 each
    uint8_t *z1_out, uint8_t *z2_out, uint8_t *tau_out) {  // 32 each
  (void)n_real;
  ge_init_constants();
  compress_init_constants();
  sc_init();
  strobe128 tr;
  strobe_load(tr, strobe_state, strobe_meta);

  ge *g = new ge[n], *h = new ge[n];
  for (long i = 0; i < n; i++) {
    ge_frombytes(g[i], g_in + 128 * i);
    ge_frombytes(h[i], h_in + 128 * i);
  }
  defvec G = {g, nullptr, n, 0, {{0, 0, 0, 0}}};
  defvec H = {h, nullptr, n, 0, {{0, 0, 0, 0}}};
  if (g_coeff_b) {
    G.coef = new sc[n];
    parallel_for(n, 8192, [&](long lo, long hi) {
      sc t;
      for (long i = lo; i < hi; i++) {
        sc_frombytes(t, g_coeff_b + 32 * i);
        sc_to_mont(G.coef[i], t);
      }
    });
  }
  ge a_pt, u_pt;
  ge_frombytes(a_pt, a_pt_b);
  ge_frombytes(u_pt, u_pt_b);
  // v1/v2 in Montgomery form for cheap folding / inner products
  sc *v1 = new sc[n], *v2 = new sc[n];
  parallel_for(n, 8192, [&](long lo, long hi) {
    sc t;
    for (long i = lo; i < hi; i++) {
      sc_frombytes(t, v1_in + 32 * i);
      sc_to_mont(v1[i], t);
      sc_frombytes(t, v2_in + 32 * i);
      sc_to_mont(v2[i], t);
    }
  });
  sc rho;
  {
    sc t;
    sc_frombytes(t, rho_b);
    sc_to_mont(rho, t);
  }

  // scratch for the round MSMs: a deferred-round expansion can touch
  // both halves of each materialized chain, so up to 2n+2 terms
  uint8_t *msm_sc = new uint8_t[(size_t)(2 * n + 2) * 32];
  const ge **msm_pt = new const ge *[2 * n + 2];
  int round = 0;
  long cur = n;
  while (cur > 1) {
    long n2 = cur / 2;
    sc sigma_m, sigma_m1_m;
    {
      sc t;
      sc_frombytes(t, rand_b + 64 * round);
      sc_to_mont(sigma_m, t);
      sc_frombytes(t, rand_b + 64 * round + 32);
      sc_to_mont(sigma_m1_m, t);
    }
    // x_m1 = <v1b, v2t>, x_p1 = <v1t, v2b> (threaded partials:
    // the serial scalar algebra was a measurable slice of create at
    // l ~ 278k — round-5 profile)
    sc x_m1_m, x_p1_m, prod;
    {
      sc pm1[8], pp1[8];
      memset(pm1, 0, sizeof(pm1));
      memset(pp1, 0, sizeof(pp1));
      std::atomic<int> slot{0};
      parallel_for(n2, 8192, [&](long lo, long hi) {
        int s = slot.fetch_add(1);
        sc a, b, p;
        memset(&a, 0, sizeof(a));
        memset(&b, 0, sizeof(b));
        for (long i = lo; i < hi; i++) {
          sc_montmul(p, v1[n2 + i], v2[i]);
          sc_add(a, a, p);
          sc_montmul(p, v1[i], v2[n2 + i]);
          sc_add(b, b, p);
        }
        pm1[s] = a;
        pp1[s] = b;
      });
      memset(&x_m1_m, 0, sizeof(x_m1_m));
      memset(&x_p1_m, 0, sizeof(x_p1_m));
      for (int s = 0; s < 8; s++) {
        sc_add(x_m1_m, x_m1_m, pm1[s]);
        sc_add(x_p1_m, x_p1_m, pp1[s]);
      }
    }
    sc tmp;
    // t_m1 = <v1b, gt> + <v2t, hb> + x_m1*a + sigma_m1*u
    // (virtual generators expanded over the materialized chains)
    long pos = expand_range(G, v1, n2, 0, n2, msm_sc, msm_pt, 0);
    pos = expand_range(H, v2, 0, n2, n2, msm_sc, msm_pt, pos);
    sc_from_mont(tmp, x_m1_m);
    sc_tobytes(msm_sc + 32 * pos, tmp);
    msm_pt[pos++] = &a_pt;
    sc_frombytes(tmp, rand_b + 64 * round + 32);  // sigma_m1 (normal)
    sc_tobytes(msm_sc + 32 * pos, tmp);
    msm_pt[pos++] = &u_pt;
    ge t_m1;
    msm_core(msm_sc, msm_pt, pos, t_m1);
    // t_p1 = <v1t, gb> + <v2b, ht> + x_p1*a + sigma*u
    pos = expand_range(G, v1, 0, n2, n2, msm_sc, msm_pt, 0);
    pos = expand_range(H, v2, n2, 0, n2, msm_sc, msm_pt, pos);
    sc_from_mont(tmp, x_p1_m);
    sc_tobytes(msm_sc + 32 * pos, tmp);
    msm_pt[pos++] = &a_pt;
    sc_frombytes(tmp, rand_b + 64 * round);       // sigma (normal)
    sc_tobytes(msm_sc + 32 * pos, tmp);
    msm_pt[pos++] = &u_pt;
    ge t_p1;
    msm_core(msm_sc, msm_pt, pos, t_p1);

    ge_tobytes(tm1_out + 128 * round, t_m1);
    ge_tobytes(t1_out + 128 * round, t_p1);

    uint8_t comp[32];
    ge_compress(comp, t_m1);
    tr_append(tr, (const uint8_t *)"t-1", 3, comp, 32);
    ge_compress(comp, t_p1);
    tr_append(tr, (const uint8_t *)"t1", 2, comp, 32);
    sc c;
    tr_challenge_scalar(tr, (const uint8_t *)"c", 1, c);
    sc c_m, c_inv_m;
    sc_to_mont(c_m, c);
    sc_inv_mont(c_inv_m, c_m);
    // generator folds g = gt + c*gb, h = ht + c_inv*hb are DEFERRED:
    // stash the even round's fold scalars; after an odd round flush
    // both pending rounds with one joint Straus walk per output
    if (G.t == 0) {
      G.ce = c_m;
      G.t = 1;
      H.ce = c_inv_m;
      H.t = 1;
    } else {
      materialize(G, &c_m);
      materialize(H, &c_inv_m);
    }
    // fold vectors: v1 = v1t + c_inv*v1b, v2 = v2t + c*v2b (threaded)
    parallel_for(n2, 8192, [&](long lo, long hi) {
      sc p;
      for (long i = lo; i < hi; i++) {
        sc_montmul(p, v1[n2 + i], c_inv_m);
        sc_add(v1[i], v1[i], p);
        sc_montmul(p, v2[n2 + i], c_m);
        sc_add(v2[i], v2[i], p);
      }
    });
    // rho = c_inv*sigma_m1 + rho + c*sigma
    sc_montmul(prod, c_inv_m, sigma_m1_m);
    sc_add(rho, rho, prod);
    sc_montmul(prod, c_m, sigma_m);
    sc_add(rho, rho, prod);
    cur = n2;
    round++;
  }
  // flush a pending even round (odd total round count) and any
  // still-unabsorbed g coefficients so g[0]/h[0] are real points
  materialize(G, nullptr);
  materialize(H, nullptr);

  // final Schnorr-style ZK opening
  const uint8_t *y1_b = rand_b + 64 * round;
  const uint8_t *y2_b = y1_b + 32;
  const uint8_t *sig_b = y1_b + 64;
  const uint8_t *sigp_b = y1_b + 96;
  sc y1, y2, sig, sigp, y1_m, y2_m;
  sc_frombytes(y1, y1_b);
  sc_frombytes(y2, y2_b);
  sc_frombytes(sig, sig_b);
  sc_frombytes(sigp, sigp_b);
  sc_to_mont(y1_m, y1);
  sc_to_mont(y2_m, y2);
  // w = y1*g0 + y2*h0 + (y1*v2_0 + y2*v1_0)*a + sig*u
  sc cross_m, t_m, cross;
  sc_montmul(cross_m, y1_m, v2[0]);
  sc_montmul(t_m, y2_m, v1[0]);
  sc_add(cross_m, cross_m, t_m);
  sc_from_mont(cross, cross_m);
  {
    uint8_t sb[4 * 32];
    memcpy(sb, y1_b, 32);
    memcpy(sb + 32, y2_b, 32);
    sc_tobytes(sb + 64, cross);
    memcpy(sb + 96, sig_b, 32);
    const ge *pp[4] = {&g[0], &h[0], &a_pt, &u_pt};
    ge w;
    msm_core(sb, pp, 4, w);
    ge_tobytes(w_out, w);
    uint8_t comp[32];
    ge_compress(comp, w);
    tr_append(tr, (const uint8_t *)"w", 1, comp, 32);
  }
  // w' = (y1*y2)*a + sig_p*u
  sc y1y2_m, y1y2;
  sc_montmul(y1y2_m, y1_m, y2_m);
  sc_from_mont(y1y2, y1y2_m);
  {
    uint8_t sb[2 * 32];
    sc_tobytes(sb, y1y2);
    memcpy(sb + 32, sigp_b, 32);
    const ge *pp[2] = {&a_pt, &u_pt};
    ge wp;
    msm_core(sb, pp, 2, wp);
    ge_tobytes(wp_out, wp);
    uint8_t comp[32];
    ge_compress(comp, wp);
    tr_append(tr, (const uint8_t *)"w'", 2, comp, 32);
  }
  sc c;
  tr_challenge_scalar(tr, (const uint8_t *)"c", 1, c);
  sc c_m, c_inv_m;
  sc_to_mont(c_m, c);
  sc_inv_mont(c_inv_m, c_m);
  sc z, prod_m;
  // z1 = y1 + c*v1_0 ; z2 = y2 + c*v2_0
  sc_montmul(prod_m, c_m, v1[0]);
  sc_from_mont(z, prod_m);
  sc_add(z, z, y1);
  sc_tobytes(z1_out, z);
  sc_montmul(prod_m, c_m, v2[0]);
  sc_from_mont(z, prod_m);
  sc_add(z, z, y2);
  sc_tobytes(z2_out, z);
  // tau = c*rho + sig + c_inv*sig_p
  sc sigp_m, tau_m, t2_m;
  sc_to_mont(sigp_m, sigp);
  sc_montmul(tau_m, c_m, rho);
  sc_montmul(t2_m, c_inv_m, sigp_m);
  sc_add(tau_m, tau_m, t2_m);
  sc tau;
  sc_from_mont(tau, tau_m);
  sc_add(tau, tau, sig);
  sc_tobytes(tau_out, tau);

  strobe_store(tr, strobe_state, strobe_meta);
  delete[] g;
  delete[] h;
  delete[] v1;
  delete[] v2;
  delete[] msm_sc;
  delete[] msm_pt;
}

// 128-way forked batch challenge scalars (exact port of
// linear_relation._challenge_scalars): clone the parent transcript
// into 128 children, draw count scalars spread across them, then
// re-join every child's 128-byte challenge into the parent.
void strobe_fork_challenges(uint8_t *strobe_state, int32_t *strobe_meta,
                            const uint8_t *label, long label_len,
                            long count, uint8_t *out) {
  sc_init();
  strobe128 parent;
  strobe_load(parent, strobe_state, strobe_meta);
  const int NB = 128;
  strobe128 *children = new strobe128[NB];
  long base = count / NB;
  long k = 0;
  for (int i = 0; i < NB; i++) {
    children[i] = parent;
    uint8_t i8[8];
    for (int b = 0; b < 8; b++) i8[b] = (uint8_t)((i >> (8 * b)) & 0xFF);
    tr_append(children[i], (const uint8_t *)"fork", 4, i8, 8);
    long size = (i == NB - 1) ? count - base * (NB - 1) : base;
    for (long j = 0; j < size; j++) {
      sc s;
      tr_challenge_scalar(children[i], label, label_len, s);
      sc_tobytes(out + 32 * k, s);
      k++;
    }
  }
  for (int i = 0; i < NB; i++) {
    uint8_t join[128];
    tr_challenge_bytes(children[i], (const uint8_t *)"join", 4, join,
                       128);
    tr_append(parent, (const uint8_t *)"join", 4, join, 128);
  }
  strobe_store(parent, strobe_state, strobe_meta);
  delete[] children;
}

// s-exponent vector for IPP verification: s[i] = prod_{j: bit j of i}
// cs[lg-1-j] mod L. O(n) multiplications via lowest-set-bit reuse.
void ristretto_ipp_s(const uint8_t *cs_bytes, long lg, long n,
                     uint8_t *out) {
  sc_init();
  sc *cs_m = new sc[lg > 0 ? lg : 1];
  for (long j = 0; j < lg; j++) {
    sc t;
    sc_frombytes(t, cs_bytes + 32 * j);
    sc_to_mont(cs_m[j], t);
  }
  sc *s_m = new sc[n];
  s_m[0] = SC_ONE_M;
  for (long i = 1; i < n; i++) {
    long j = __builtin_ctzl(i);
    sc_montmul(s_m[i], s_m[i - (1L << j)], cs_m[lg - 1 - j]);
  }
  for (long i = 0; i < n; i++) {
    sc t;
    sc_from_mont(t, s_m[i]);
    sc_tobytes(out + 32 * i, t);
  }
  delete[] cs_m;
  delete[] s_m;
}

// batched scalar algebra mod L: out = (a + c*b) mod L elementwise
// (IPP vector folding and verifier scalar composition)
void sc_vec_fold(const uint8_t *a, const uint8_t *b, const uint8_t *c,
                 long n, uint8_t *out) {
  sc_init();
  sc cm, t;
  sc_frombytes(t, c);
  sc_to_mont(cm, t);
  for (long i = 0; i < n; i++) {
    sc av, bv, bm, prod;
    sc_frombytes(av, a + 32 * i);
    sc_frombytes(bv, b + 32 * i);
    sc_to_mont(bm, bv);
    sc_montmul(prod, bm, cm);
    sc_from_mont(prod, prod);
    sc_add(prod, prod, av);
    sc_tobytes(out + 32 * i, prod);
  }
}

// out = a*b mod L elementwise
void sc_vec_mul(const uint8_t *a, const uint8_t *b, long n,
                uint8_t *out) {
  sc_init();
  for (long i = 0; i < n; i++) {
    sc av, bv, am, bm, prod;
    sc_frombytes(av, a + 32 * i);
    sc_frombytes(bv, b + 32 * i);
    sc_to_mont(am, av);
    sc_to_mont(bm, bv);
    sc_montmul(prod, am, bm);
    sc_from_mont(prod, prod);
    sc_tobytes(out + 32 * i, prod);
  }
}

}  // extern "C"
