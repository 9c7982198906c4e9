// The u8 x u8 -> s32 tensor-core contraction shared by multiagg_mxu.cu and
// the contraction variants of probes.cu, so that a fragment-layout slip
// shows in a 16 x 128 probe as well as in the aggregate.
//
//   C[p][q] += sum_r A[p][r] * B[r][q]       (A: planes x rows, B: rows x
//                                             groups, every entry a byte)
//
// Both operands live in shared memory in one layout: a row of 32-bit words
// per plane (A) or per group (B), word w holding the bytes of rows 4w..4w+3
// (row 4w in the low byte).  Each of kThreads threads owns four consecutive
// rows of a step of kStepRows rows and packs one word per plane and per
// group (pack_bytes); the words of a warp are consecutive, so the stores do
// not conflict.  The row stride kStride (in words) is 4 more than a
// multiple of 32, so the fragment loads, which read 8 rows x 4 consecutive
// words, hit 32 distinct banks.  A step holds at most kChunkPlanes planes
// and kChunkGroups groups.
//
// One mma_u8 is one `mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32`: a
// 16-plane x 8-group tile over 32 rows (8 words).  Fragment layout (PTX ISA,
// "Matrix Fragments for mma.m16n8k32", 8-bit types), g = lane / 4,
// t = lane % 4, words relative to the k-step:
//   A regs a0..a3: (plane g, word t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
//   B regs b0, b1: (group g, word t), (g, t + 4)
//   C regs c0..c3: (plane g, group 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
// Byte j of a register is the element of row 4 * word + j, which is what
// the word layout holds.  An int32 cell gains at most 255 per row; the
// callers move it into int64 before 2^23 rows (255 * 2^23 < 2^31).

#pragma once

#include <stdint.h>

namespace m2v {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStepRows = 4 * kThreads;          // 512 rows per step
constexpr int kWords = kStepRows / 4;            // words per plane row
constexpr int kStride = kWords + 4;
constexpr int kWarpWords = kWords / kWarps;      // each warp: 4 k-steps
constexpr int kChunkPlanes = 32;
constexpr int kChunkGroups = 32;
constexpr int kMTiles = kChunkPlanes / 16;
constexpr int kNTiles = kChunkGroups / 8;
constexpr long long kFlushRows = 1ll << 23;

// Packs four bytes (row 4w + j in byte j) into one word.
__device__ __forceinline__ uint32_t pack_bytes(uint32_t b0, uint32_t b1,
                                               uint32_t b2, uint32_t b3) {
  return (b0 & 0xffu) | ((b1 & 0xffu) << 8) | ((b2 & 0xffu) << 16) |
         ((b3 & 0xffu) << 24);
}

// Limb k (bits 8k..8k+7) of a value, as a plane element.
__device__ __forceinline__ uint32_t limb8(unsigned long long v, int k) {
  return (uint32_t)(v >> (8 * k)) & 0xffu;
}

__device__ __forceinline__ void mma_u8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Warp `warp` adds its kWarpWords-word slice of the step to c, for the
// first mt 16-plane tiles and nt 8-group tiles (warp-uniform counts).
__device__ __forceinline__ void contract_step(
    const uint32_t* planes, const uint32_t* groups, int warp, int lane,
    int mt, int nt, int c[kMTiles][kNTiles][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kWarpWords; kk += 8) {
    const int kw = warp * kWarpWords + kk + t;
    uint32_t b[kNTiles][2];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      if (j < nt) {
        const uint32_t* p = groups + (8 * j + g) * kStride + kw;
        b[j][0] = p[0];
        b[j][1] = p[4];
      }
    }
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
      if (i < mt) {
        const uint32_t* lo = planes + (16 * i + g) * kStride + kw;
        const uint32_t* hi = lo + 8 * kStride;
        const uint32_t a[4] = {lo[0], hi[0], lo[4], hi[4]};
#pragma unroll
        for (int j = 0; j < kNTiles; ++j)
          if (j < nt) mma_u8(c[i][j], a, b[j]);
      }
    }
  }
}

// (plane, group) of accumulator register e of `lane`, relative to its tile.
__device__ __forceinline__ void c_coord(int lane, int e, int* plane,
                                        int* group) {
  *plane = (lane >> 2) + ((e & 2) ? 8 : 0);
  *group = 2 * (lane & 3) + (e & 1);
}

}  // namespace m2v
