// Scatter through unique, ascending positions into a zeroed buffer.
//
// Replaces mplan2vdl_tpu/engine/kernels/scatter.py:monotone_scatter — the
// Pallas kernel `_kernel`, which owns one 8192-element output block per grid
// step, finds that block's writers in two aligned source windows, left-packs
// them and right-spreads them to their destinations with log-shift tile
// rolls (the only way to move data between lanes of the TPU's register
// tiles).
//
//   out[0:L] = 0;  out[pos[i]] = src[i]  for i < n with 0 <= pos[i] < L
//
// The engine's callers (FK mask-deduction scatters, relational Scatter of
// compaction outputs) give positions that are strictly ascending over the
// valid prefix and map every invalid row to L or beyond, so the key
// clamp(pos[i], -1, L) never decreases in i.
//
// Bound on an H100: bytes.  The function reads n positions and n source
// elements and writes L output elements: n * (pos bytes + src bytes) +
// L * elem at 3.35 TB/s.  It does no arithmetic worth counting.
//
// Design: ONE launch, no fill; every output slot is stored exactly once, in
// full sectors, by 16-byte stores.  Blocks own output, not input:
//   * The output is cut into tiles of kTile = 4096 slots (16 KB of int32,
//     32 KB of int64), and each block owns a contiguous span of tiles, as
//     many as make one wave of resident blocks on the card.  Because the
//     positions ascend, a tile's writers are one contiguous run of source
//     rows, at most kTile long, and the next tile's run starts where it
//     ends.
//   * Warp 0 finds the first source row of the block's span once, by a
//     32-ary search (each lane probes one of 32 evenly spaced rows, a
//     ballot picks the interval): about 5 dependent loads at n = 2M, where
//     a binary search would take 22.
//   * For each tile the block walks the positions forward in chunks of
//     1024 rows (4 per thread, all loads in flight together), loads the
//     source element of each row whose position falls in the tile, and
//     writes it into the tile staged in shared memory at pos - tile start.
//     A chunk's in-tile rows are a prefix of it; a block-wide count moves
//     the walk past them, and the walk stops at the first chunk that holds
//     a position past the tile (or when the tile is full).  Positions at
//     the chunk's end are read again by the next tile: that overread is at
//     most one chunk per tile and hits the cache.
//   * After a barrier the block stores the tile with coalesced 16-byte
//     streaming stores (evict-first: the output is larger than L2 and this
//     kernel never reads it, while the positions it reads again should
//     stay) and zeroes, in the same loop, the shared words each thread just
//     read; one more barrier and the next tile starts.
// Work per block is bounded at any density: a block's cost is its tiles'
// slots plus the rows that land in them, so one valid row into 15M slots
// costs what 15M rows cost.  No two threads write one slot and no atomics
// are needed: the positions are unique.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;              // output slots a block stages
constexpr int kPer = 4;                  // rows a thread loads per chunk
constexpr int kChunk = kThreads * kPer;  // 1024 rows
constexpr unsigned kFull = 0xffffffffu;

// The first row i in [0, n) with pos[i] >= target, or n, found by one warp
// with a 32-ary search.  0 <= target < L, where pos[i] >= target is
// monotone in i because clamp(pos, -1, L) never decreases.
template <typename P>
__device__ long long first_row_at(const P* __restrict__ pos, long long n,
                                  long long target, int lane) {
  long long lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) / 32;
    const long long i = lo + (lane + 1) * step - 1;
    const unsigned ge =
        __ballot_sync(kFull, i >= hi || (long long)pos[i] >= target);
    if (ge == 0) return hi;
    const int f = __ffs(ge) - 1;
    // lane f probed the first row at or past target; lane f - 1 one before
    hi = min(lo + (f + 1) * step - 1, hi);
    lo += f * step;
  }
  const long long i = lo + lane;
  const unsigned ge =
      __ballot_sync(kFull, i >= hi || (long long)pos[i] >= target);
  return ge ? lo + __ffs(ge) - 1 : hi;
}

template <typename P, typename T>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const P* __restrict__ pos, const T* __restrict__ src,
               T* __restrict__ out, long long n, long long L,
               long long tiles, long long per_block) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte store
  constexpr int kVecs = kTile / kVec;
  __shared__ __align__(16) T tile[kTile];
  __shared__ int warp_rows[2][kWarps];
  __shared__ long long start_row;
  uint4* const tv = reinterpret_cast<uint4*>(tile);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = (long long)blockIdx.x * per_block;
  const long long t1 = min(t0 + per_block, tiles);

  for (int k = tid; k < kVecs; k += kThreads) tv[k] = zero;
  if (warp == 0) {
    const long long r = first_row_at(pos, n, t0 * kTile, lane);
    if (lane == 0) start_row = r;
  }
  __syncthreads();
  long long row = start_row;  // first row whose position is >= the tile
  int buf = 0;                // warp_rows is double-buffered by chunk
  for (long long t = t0; t < t1; ++t) {
    const long long lo = t * kTile;
    const int m = (int)min((long long)kTile, L - lo);
    const long long hi = lo + m;
    int staged = 0;
    for (;;) {
      long long p[kPer];
      T v[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const long long i = row + j * kThreads + tid;
        p[j] = i < n ? (long long)pos[i] : LLONG_MAX;
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        v[j] = p[j] >= lo && p[j] < hi ? src[row + j * kThreads + tid]
                                       : T(0);
      int mine = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (p[j] >= lo && p[j] < hi) {
          tile[p[j] - lo] = v[j];
          ++mine;
        }
      }
      mine = __reduce_add_sync(kFull, mine);
      if (lane == 0) warp_rows[buf][warp] = mine;
      __syncthreads();
      int c = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) c += warp_rows[buf][w];
      buf ^= 1;
      row += c;
      staged += c;
      if (c < kChunk || staged == m) break;
    }
    uint4* const ov = reinterpret_cast<uint4*>(out + lo);
    if (m == kTile) {
      for (int k = tid; k < kVecs; k += kThreads) {
        __stcs(ov + k, tv[k]);
        tv[k] = zero;
      }
    } else {  // the output's last tile: no tile is staged after it
      const int full = m / kVec;
      for (int k = tid; k < full; k += kThreads) __stcs(ov + k, tv[k]);
      for (int e = full * kVec + tid; e < m; e += kThreads)
        out[lo + e] = tile[e];
    }
    __syncthreads();
  }
}

template <typename P, typename T>
int resident_blocks() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks,
                                                scatter_kernel<P, T>,
                                                kThreads, 0);
  return blocks > 0 ? blocks : 1;
}

// One wave: as many blocks as the card holds at once, each owning an equal
// span of tiles.
template <typename P, typename T>
int launch(const P* pos, const void* src, void* out, long long n,
           long long L, cudaStream_t s) {
  static const int resident = resident_blocks<P, T>();
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (L + kTile - 1) / kTile;
  const long long slots = (long long)sms * resident;
  const long long per_block = (tiles + slots - 1) / slots;
  const long long blocks = (tiles + per_block - 1) / per_block;
  scatter_kernel<P, T><<<(unsigned)blocks, kThreads, 0, s>>>(
      pos, static_cast<const T*>(src), static_cast<T*>(out), n, L, tiles,
      per_block);
  return (int)cudaGetLastError();
}

template <typename P>
int launch_typed(const void* pos, const void* src, int esize, void* out,
                 long long n, long long L, cudaStream_t s) {
  const P* p = static_cast<const P*>(pos);
  return esize == 4 ? launch<P, int32_t>(p, src, out, n, L, s)
                    : launch<P, int64_t>(p, src, out, n, L, s);
}

}  // namespace

extern "C" {

// pos: n positions of pos_esize bytes (4 or 8).  src: n elements of esize
// bytes (4 or 8).  out: L elements of esize bytes, 16-byte aligned, every
// one written here.  L = 0 launches nothing.
int m2v_scatter(const void* pos, int pos_esize, const void* src, int esize,
                void* out, long long n, long long L, void* stream) {
  if ((pos_esize != 4 && pos_esize != 8) || (esize != 4 && esize != 8) ||
      n < 0 || L < 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (L == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pos_esize == 4
             ? launch_typed<int32_t>(pos, src, esize, out, n, L, s)
             : launch_typed<int64_t>(pos, src, esize, out, n, L, s);
}

// The output slots one block stages at a time (scatter.TILE).
int m2v_scatter_tile() { return kTile; }

}  // extern "C"
