// The layouts of pntt.cu's two-pass B16 (N >= 65536): its sizes and the
// swizzled words of its shared tiles, in a header of their own so that the
// host bank test checks these very maps (tests/test_torch_csrc_host_pntt.py).
#pragma once

#include "transform.cuh"

namespace twopass {

constexpr int LOGC = 7, C = 1 << LOGC;  // the reference's 128 lanes
constexpr int RB = 32;                  // rows a column-pass block
constexpr int COL_THREADS = 8 * RB;     // 8 threads a row, 16 words each

// A row pass's block: the threads of tf::Shape<LOGR>, and two blocks an SM
// (64 registers) where it holds several columns: at 127 registers, one
// block an SM, the row passes ran slower on the H100; where one column
// fills the block, two blocks an SM ran slower.
template <int LOGN>
constexpr int ROW_THREADS = tf::Shape<LOGN - LOGC>::THREADS;
template <int LOGN>
constexpr int ROW_BLOCKS = tf::Shape<LOGN - LOGC>::P > 1 ? 2 : 1;

// Word of column c < P, row r of a row pass's [R, P] tile.
template <int LOGR>
__host__ __device__ __forceinline__ u32 tile_word(u32 c, u32 r) {
  return (c << LOGR) + (r ^ (c * (32 / tf::Shape<LOGR>::P)));
}

// Column pass: word of (block row rho, column c) in the exchange buffer
// (bank bits 0-2 take c's bits 4-6, bits 3-4 rho's low two) and of
// (column t', block row rho) in the transpose tile (rho's bits 2-4 take
// t's bits 4-6).
__host__ __device__ __forceinline__ u32 ex_word(u32 rho, u32 c) {
  return rho * C + ((c ^ ((c >> 4) & 7)) ^ ((rho & 3) << 3));
}
__host__ __device__ __forceinline__ u32 tp_word(u32 t, u32 rho) {
  return t * RB + (rho ^ ((t >> 4) << 2));
}

}  // namespace twopass
