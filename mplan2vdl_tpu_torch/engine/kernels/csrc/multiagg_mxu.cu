// Fused multi-aggregate dense group-by on the tensor cores: the sums of a
// Q1-class family as a u8 one-hot contraction.
//
// Replaces mplan2vdl_tpu/engine/kernels/multiagg_mxu.py:
// fused_group_aggregate_mxu (the Pallas `_kernel`, which builds each row's
// value as renormalised 8-bit limbs in int32 lanes, stacks the limb planes
// and a one-hot of the group id as bf16 and contracts them on the MXU with
// f32 accumulation, splitting the block partials into lo/hi int32 planes).
// The contract is unchanged: for each "sum" AggSpec,
//   value(row) = base(row) * prod_f (const_f + sign_f * col_f(row))
// (0 <= value < 2^bits, bits <= 64) is summed exactly into an int64
// [n_groups, n_specs] table over the rows whose group id g satisfies
// 0 <= g < n_groups.
//
// Bound on an H100: bytes.  The function reads the columns the specs
// reference and the group ids once, 4*(c+1)*n bytes; the contraction is
// planes x groups x n byte products, far below the int8 tensor-core rate.
//
// A row's value is exact in 64-bit arithmetic (it is below 2^bits), so the
// limb multiply, renormalisation, carry plane and lo/hi output split of the
// TPU kernel have no counterpart: each value is split into ceil(bits/8)
// byte planes directly.  The planes of all specs are stacked (Q1:
// 2+3+4+5+1+1+1 = 17) and contracted with the rows' one-hot group bytes by
// mma.sync m16n8k32 u8 x u8 -> s32 (mma_u8.cuh):
//   partial[plane][group] = sum_rows plane(row) * (gid(row) == group)
// The int32 partials are moved into int64 before any cell can pass 2^31,
// and each (plane, group) cell is shifted by 8 * limb and added to its
// spec's output with one global atomic per block: sum_k plane_sum_k << 8k
// is taken in wrapping 64-bit unsigned arithmetic, exact because the true
// total is below 2^63 although a shifted plane sum alone may not be.  The
// "max" specs of a family stay with multiagg.cu, as in the JAX engine.
//
// Two paths; the wrapper picks one by shape (multiagg_mxu.fast_path):
//
// fast_kernel<NS>, the fast path: at most 16 groups (one m16 tile) and at
// most 12 sum specs, which covers every family fuse.plan_fusions emits.
// The first design (mxu_kernel below) spent about 6 us on each 512-row
// block step: every spec loaded its columns from global memory again, the
// spec, plane and one-hot loops ran over run-time bounds, and two block
// barriers per step left nothing in flight.  Here
//   * every warp works alone on 128-row steps (one quad of 4 rows per
//     lane), so no block barrier is taken until the end.  Each lane copies
//     its quad of every column the specs use, and of the group ids, into
//     its own slots of a kStages-deep shared buffer with 16-byte cp.async
//     (zero-filled past n), kStages - 1 steps ahead; the specs then read
//     their operands from the staged quads, one shared load per operand;
//   * the kernel is a template on the spec count and each spec's head
//     (base slot, factor count, first factor word, first plane, plane
//     count) sits at a fixed place in the parameters, so the spec loop and
//     the 4-plane store loops unroll; factor loops stay dynamic (guarded
//     unrolled blocks were predicated and cost more in multiagg.cu).  A
//     spec of at most 4 planes is evaluated in 32-bit arithmetic (its
//     value is below 2^32, and the products are exact modulo 2^32); the
//     byte planes of 4 rows come from a 4 x 4 byte transpose (8 PRMT);
//   * the plane words and one word of group-id bytes per quad go to the
//     warp's own tile, double-buffered so a step needs one __syncwarp.  In
//     the mma the one-hot is the A operand (16 groups x 32 rows), built in
//     registers from the group-id words by a bytewise compare (__vcmpeq4),
//     and the planes are B (8 planes per n8 tile), so Q1 takes 3 mma per
//     32 rows and no one-hot is stored;
//   * a warp's int32 fragment cell gains at most 255 per row, so the warp
//     moves its fragments into the block's shared int64 table every
//     flush_steps steps, computed by the wrapper so that 255 * 128 *
//     flush_steps < 2^31 (2^16 steps, 2^23 rows), and at the end.  A block
//     holds as many warps as its tiles and buffers fit in 227 KB, at most
//     16; the grid is one wave of resident blocks.
//
// mxu_kernel, the general path (more groups or specs): per step a block of
// 128 threads packs 512 rows into shared memory (one word per plane and per
// group per thread) and each of its 4 warps contracts its 128-row slice
// into int32 fragments (mma_u8.cuh's contract_step).  Every kFlushSteps
// steps (2^23 rows of the block, whatever the grid) and at the end the
// fragments are added into a shared int64 table.  A block covers 32 planes
// and 32 groups (grid.y walks the chunks of more planes or groups, so any
// n_groups works), and reads only the columns its specs reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_u8.cuh"

namespace {

constexpr int kMaxCols = 16;
constexpr int kMaxWords = 512;
constexpr int kMaxSpecs = 64;
constexpr int kMaxPlanes = 8 * kMaxSpecs;
constexpr int kFlushSteps = (int)(m2v::kFlushRows / m2v::kStepRows);
constexpr int kBlocksPerSm = 4;

using m2v::kChunkGroups;
using m2v::kChunkPlanes;
using m2v::kMTiles;
using m2v::kNTiles;
using m2v::kStepRows;
using m2v::kStride;
using m2v::kThreads;

struct MxuArgs {
  const int32_t* cols[kMaxCols];
  int32_t words[kMaxWords];
  int32_t spec_word[kMaxSpecs];       // offset of each spec in `words`
  int32_t spec_plane[kMaxSpecs + 1];  // first plane of each spec; the last
                                      // entry is the plane count
  int n_specs;
  int n_groups;
  int n_pchunks;
};

// Four consecutive int32 values from row r0 (a multiple of 4); 0 past n.
__device__ __forceinline__ void load4(const int32_t* __restrict__ p,
                                      long long r0, long long n, int y[4]) {
  if (r0 + 4 <= n) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p + r0));
    y[0] = q.x;
    y[1] = q.y;
    y[2] = q.z;
    y[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = r0 + j < n ? p[r0 + j] : 0;
  }
}

// The values of spec s at rows r0..r0+3, as unsigned 64-bit (wrapping
// products: the bits bound keeps the true value below 2^64).
__device__ __forceinline__ void values4(const MxuArgs& a, int s, long long r0,
                                        long long n,
                                        unsigned long long v[4]) {
  int w = a.spec_word[s];
  const int base = a.words[w + 1], nf = a.words[w + 2];
  w += 3;
  int y[4];
  if (base < 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = 1ull;
  } else {
    load4(a.cols[base], r0, n, y);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (unsigned long long)(long long)y[j];
  }
  for (int f = 0; f < nf; ++f, w += 3) {
    const long long c = a.words[w], sign = a.words[w + 1];
    load4(a.cols[a.words[w + 2]], r0, n, y);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] *= (unsigned long long)(c + sign * (long long)y[j]);
  }
}

__global__ void __launch_bounds__(kThreads)
mxu_kernel(const __grid_constant__ MxuArgs a, const int32_t* __restrict__ gid,
           long long n, unsigned long long* __restrict__ out) {
  __shared__ __align__(16) uint32_t planes[kChunkPlanes * kStride];
  __shared__ __align__(16) uint32_t onehot[kChunkGroups * kStride];
  __shared__ unsigned long long acc[kChunkPlanes * kChunkGroups];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = (blockIdx.y % a.n_pchunks) * kChunkPlanes;
  const int g0 = (blockIdx.y / a.n_pchunks) * kChunkGroups;
  const int np = min(kChunkPlanes, a.spec_plane[a.n_specs] - p0);
  const int ng = min(kChunkGroups, a.n_groups - g0);
  const int mt = (np + 15) / 16, nt = (ng + 7) / 8;
  for (int i = tid; i < kChunkPlanes * kStride; i += kThreads) {
    planes[i] = 0;
    onehot[i] = 0;
  }
  for (int i = tid; i < kChunkPlanes * kChunkGroups; i += kThreads) acc[i] = 0;
  // the specs whose planes meet [p0, p0 + np)
  int s_lo = 0;
  while (a.spec_plane[s_lo + 1] <= p0) ++s_lo;
  int s_hi = s_lo;
  while (s_hi < a.n_specs && a.spec_plane[s_hi] < p0 + np) ++s_hi;
  __syncthreads();

  int c[kMTiles][kNTiles][4];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][j][e] = 0;

  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < kMTiles; ++i)
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (i < mt && j < nt && c[i][j][e] != 0) {
            int p, q;
            m2v::c_coord(lane, e, &p, &q);
            atomicAdd(&acc[(16 * i + p) * kChunkGroups + 8 * j + q],
                      (unsigned long long)(unsigned)c[i][j][e]);
          }
          c[i][j][e] = 0;
        }
  };

  const long long steps = (n + kStepRows - 1) / kStepRows;
  int since_flush = 0;
  for (long long step = blockIdx.x; step < steps; step += gridDim.x) {
    const long long r0 = step * kStepRows + 4ll * tid;
    __syncthreads();  // the previous step's fragments have been read
    int g[4];
    load4(gid, r0, n, g);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // chunk-local group, or -1: past n, masked out, or another chunk
      const int local = g[j] - g0;
      g[j] = (r0 + j < n && g[j] >= 0 && local >= 0 && local < ng) ? local : -1;
    }
    for (int q = 0; q < ng; ++q)
      onehot[q * kStride + tid] =
          m2v::pack_bytes(g[0] == q, g[1] == q, g[2] == q, g[3] == q);
    for (int s = s_lo; s < s_hi; ++s) {
      unsigned long long v[4];
      values4(a, s, r0, n, v);
      const int first = a.spec_plane[s];
      const int lo = max(first, p0), hi = min(a.spec_plane[s + 1], p0 + np);
      for (int p = lo; p < hi; ++p) {
        const int k = p - first;
        planes[(p - p0) * kStride + tid] =
            m2v::pack_bytes(m2v::limb8(v[0], k), m2v::limb8(v[1], k),
                            m2v::limb8(v[2], k), m2v::limb8(v[3], k));
      }
    }
    __syncthreads();
    m2v::contract_step(planes, onehot, warp, lane, mt, nt, c);
    if (++since_flush == kFlushSteps) {
      flush();
      since_flush = 0;
    }
  }
  flush();
  __syncthreads();
  for (int i = tid; i < kChunkPlanes * kChunkGroups; i += kThreads) {
    const int p = i / kChunkGroups, q = i % kChunkGroups;
    const unsigned long long v = acc[i];
    if (p >= np || q >= ng || v == 0) continue;
    const int plane = p0 + p;
    int s = s_lo;
    while (a.spec_plane[s + 1] <= plane) ++s;
    atomicAdd(out + (long long)(g0 + q) * a.n_specs + s,
              v << (8 * (plane - a.spec_plane[s])));
  }
}

// ------------------------------------------------------------- fast path
constexpr int kFastMaxSpecs = 12;   // multiagg_mxu.FAST_MAX_SPECS
constexpr int kFastMaxGroups = 16;  // multiagg_mxu.FAST_MAX_GROUPS: one m16
constexpr int kFastMaxWarps = 16;
constexpr int kStages = 3;          // staged steps per warp: 2 in flight
constexpr int kWarpRows = 128;      // multiagg_mxu.FAST_STEP_ROWS: 32 quads
// words per tile row: 32 quads + 4, so the fragment loads (8 rows x 4
// consecutive words) hit 32 distinct banks
constexpr int kTileStride = kWarpRows / 4 + 4;
// 227 KB, the most one block may use, less 1 KB the runtime reserves
constexpr int kSmemMax = 232448 - 1024;

// A spec's head at a fixed place in the parameters.  base: column slot or
// -1 (count); its nf factors are the (const, sign, slot) triples at
// words[w..]; it owns planes [plane, plane + nplanes).
struct FastSpec {
  int base, nf, w, plane, nplanes;
};

struct FastArgs {
  const int32_t* cols[kMaxCols];  // the columns the specs use, by slot
  int32_t words[kMaxWords];
  FastSpec specs[kFastMaxSpecs];
  int ncols;
  int n_groups;
  int n_planes;
  int n_tiles;  // n8 plane tiles: ceil(n_planes / 8)
  int flush_steps;
};

// Shared bytes of the fast path: the block's int64 table, and per warp its
// two plane tiles (8 * n_tiles plane rows + the group-id row) and its
// kStages stages of one int4 per lane for each column and the group ids.
__host__ __device__ inline long long fast_table_bytes(int n_tiles) {
  return 8LL * n_tiles * kFastMaxGroups * 8;
}
__host__ __device__ inline long long fast_warp_bytes(int n_tiles, int ncols) {
  return 2LL * (8 * n_tiles + 1) * kTileStride * 4 +
         (long long)kStages * (ncols + 1) * 32 * 16;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  // bytes < 16 reads that many and zero-fills the rest
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The values of one spec at a lane's 4 staged rows, in U arithmetic
// (uint32_t when the value is below 2^32, else 64-bit; both exact modulo
// 2^width).  cur[j * 32] is the lane's staged int4 of column slot j.
template <typename U>
__device__ __forceinline__ void spec_values4(const FastArgs& a, int base,
                                             int nf, int w, const int4* cur,
                                             U v[4]) {
  if (base >= 0) {
    const int4 c = cur[base * 32];
    v[0] = (U)(long long)c.x;
    v[1] = (U)(long long)c.y;
    v[2] = (U)(long long)c.z;
    v[3] = (U)(long long)c.w;
  } else {
    v[0] = v[1] = v[2] = v[3] = 1;
  }
  for (int f = 0; f < nf; ++f, w += 3) {
    const U k0 = (U)(long long)a.words[w], sg = (U)(long long)a.words[w + 1];
    const int4 c = cur[a.words[w + 2] * 32];
    v[0] *= k0 + sg * (U)(long long)c.x;
    v[1] *= k0 + sg * (U)(long long)c.y;
    v[2] *= k0 + sg * (U)(long long)c.z;
    v[3] *= k0 + sg * (U)(long long)c.w;
  }
}

// Byte planes 0..3 of four 32-bit values: word k holds byte k of v[j] in
// byte j (a 4 x 4 byte transpose).
__device__ __forceinline__ void planes4(uint32_t v0, uint32_t v1, uint32_t v2,
                                        uint32_t v3, uint32_t w[4]) {
  const uint32_t a = __byte_perm(v0, v1, 0x5140);
  const uint32_t b = __byte_perm(v0, v1, 0x7362);
  const uint32_t c = __byte_perm(v2, v3, 0x5140);
  const uint32_t d = __byte_perm(v2, v3, 0x7362);
  w[0] = __byte_perm(a, c, 0x5410);
  w[1] = __byte_perm(a, c, 0x7632);
  w[2] = __byte_perm(b, d, 0x5410);
  w[3] = __byte_perm(b, d, 0x7632);
}

// A row's group-id byte: its group, or 0xff (no group) past n or outside
// [0, G)
__device__ __forceinline__ uint32_t gid_byte(int g, bool in, int G) {
  return in && (unsigned)g < (unsigned)G ? (uint32_t)g : 0xffu;
}

// The one-hot bytes of group q in a word of 4 group-id bytes (rep: q in
// every byte)
__device__ __forceinline__ uint32_t onehot_bytes(uint32_t word, uint32_t rep) {
  return __vcmpeq4(word, rep) & 0x01010101u;
}

template <int NS>
__global__ void __launch_bounds__(kFastMaxWarps * 32, 1)
fast_kernel(const __grid_constant__ FastArgs a,
            const int32_t* __restrict__ gid, long long n,
            unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = a.ncols, G = a.n_groups, NP = a.n_planes, NT = a.n_tiles;
  const int rows = 8 * NT + 1;  // plane rows, then the group-id row
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(smem);
  uint32_t* tiles = reinterpret_cast<uint32_t*>(smem + fast_table_bytes(NT));
  int4* stage =
      reinterpret_cast<int4*>(tiles + (size_t)W * 2 * rows * kTileStride);

  for (int i = tid; i < 8 * NT * kFastMaxGroups; i += blockDim.x) acc[i] = 0;
  // plane rows past NP stay zero: they are never written
  for (int i = tid; i < W * 2 * rows * kTileStride; i += blockDim.x)
    tiles[i] = 0;
  __syncthreads();

  uint32_t* T = tiles + (size_t)warp * 2 * rows * kTileStride;
  int4* S = stage + (size_t)warp * kStages * (nc + 1) * 32 + lane;
  const long long nq = (n + 3) >> 2;
  const long long steps = (nq + 31) >> 5;
  const long long stride = (long long)gridDim.x * W;
  // stage st of this lane's quad of `step`: slot j < nc column j, slot nc
  // the group ids
  auto issue = [&](long long step, int st) {
    const long long q = step * 32 + lane;
    const long long rem = n - 4 * q;
    const int bytes = rem >= 4 ? 16 : rem > 0 ? 4 * (int)rem : 0;
    const long long off = bytes ? 4 * q : 0;
    int4* dst = S + st * (nc + 1) * 32;
    for (int j = 0; j < nc; ++j)
      cp_async16(dst + j * 32, a.cols[j] + off, bytes);
    cp_async16(dst + nc * 32, gid + off, bytes);
  };

  const int g = lane >> 2, t = lane & 3;
  const uint32_t rep_lo = (uint32_t)g * 0x01010101u;
  const uint32_t rep_hi = (uint32_t)(g + 8) * 0x01010101u;
  int c[NS][4];
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0;
  // C fragment e of n8 tile j: group g + 8 * (e >> 1), plane 8j + 2t + (e & 1)
  auto flush = [&]() {
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = g + 8 * (e >> 1), p = 8 * j + 2 * t + (e & 1);
        if (j < NT && c[j][e] != 0 && q < G && p < NP)
          atomicAdd(&acc[p * kFastMaxGroups + q],
                    (unsigned long long)(unsigned)c[j][e]);
        c[j][e] = 0;
      }
  };

  long long step = (long long)blockIdx.x * W + warp;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (step + i * stride < steps) issue(step + i * stride, i);
    cp_async_commit();
  }
  int st = 0, buf = 0, since = 0;
  for (; step < steps; step += stride) {
    const long long ahead = step + (kStages - 1) * stride;
    if (ahead < steps) issue(ahead, (st + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this step's copies have landed
    const int4* cur = S + st * (nc + 1) * 32;
    uint32_t* Tb = T + buf * rows * kTileStride;

    // this lane's quad: group-id bytes, then every spec's plane words
    const long long rem = n - 4 * (step * 32 + lane);
    const int4 gq = cur[nc * 32];
    Tb[8 * NT * kTileStride + lane] =
        gid_byte(gq.x, rem > 0, G) | gid_byte(gq.y, rem > 1, G) << 8 |
        gid_byte(gq.z, rem > 2, G) << 16 | gid_byte(gq.w, rem > 3, G) << 24;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      // the head by value: a reference into the parameters would read them
      // through generic loads
      const int base = a.specs[s].base, nf = a.specs[s].nf, w = a.specs[s].w;
      const int npl = a.specs[s].nplanes;
      uint32_t* dst = Tb + a.specs[s].plane * kTileStride + lane;
      uint32_t pw[4];
      if (npl <= 4) {
        uint32_t v[4];
        spec_values4<uint32_t>(a, base, nf, w, cur, v);
        planes4(v[0], v[1], v[2], v[3], pw);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < npl) dst[k * kTileStride] = pw[k];
      } else {
        unsigned long long v[4];
        spec_values4<unsigned long long>(a, base, nf, w, cur, v);
        planes4((uint32_t)v[0], (uint32_t)v[1], (uint32_t)v[2],
                (uint32_t)v[3], pw);
#pragma unroll
        for (int k = 0; k < 4; ++k) dst[k * kTileStride] = pw[k];
        planes4((uint32_t)(v[0] >> 32), (uint32_t)(v[1] >> 32),
                (uint32_t)(v[2] >> 32), (uint32_t)(v[3] >> 32), pw);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k + 4 < npl) dst[(k + 4) * kTileStride] = pw[k];
      }
    }
    // the other buffer was last read a step ago, before the previous
    // __syncwarp, so one barrier orders both hazards
    __syncwarp();

    // contract the step: k-steps of 32 rows (8 words)
    const uint32_t* grow = Tb + 8 * NT * kTileStride;
#pragma unroll
    for (int kk = 0; kk < kWarpRows / 4; kk += 8) {
      const uint32_t w0 = grow[kk + t], w1 = grow[kk + t + 4];
      // A (one-hot, 16 groups x 32 rows): (g, word t), (g + 8, t),
      // (g, t + 4), (g + 8, t + 4)
      const uint32_t A[4] = {
          onehot_bytes(w0, rep_lo), onehot_bytes(w0, rep_hi),
          onehot_bytes(w1, rep_lo), onehot_bytes(w1, rep_hi)};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (j < NT) {
          // B (32 rows x 8 planes): (plane 8j + g, word t), (8j + g, t + 4)
          const uint32_t* p = Tb + (8 * j + g) * kTileStride + kk + t;
          const uint32_t B[2] = {p[0], p[4]};
          m2v::mma_u8(c[j], A, B);
        }
      }
    }
    st = st + 1 == kStages ? 0 : st + 1;
    buf ^= 1;
    if (++since == a.flush_steps) {
      flush();
      since = 0;
    }
  }
  cp_async_wait<0>();
  flush();
  __syncthreads();
  for (int i = tid; i < NP * kFastMaxGroups; i += blockDim.x) {
    const int p = i / kFastMaxGroups, q = i % kFastMaxGroups;
    const unsigned long long v = acc[i];
    if (q >= G || v == 0) continue;
    int s = 0, first = 0;
#pragma unroll
    for (int k = 1; k < NS; ++k) {
      const int pk = a.specs[k].plane;
      if (p >= pk) {
        s = k;
        first = pk;
      }
    }
    atomicAdd(out + (long long)q * NS + s, v << (8 * (p - first)));
  }
}

// fast_kernel for a spec count in [1, kFastMaxSpecs]
const void* fast_fn(int n_specs) {
  switch (n_specs) {
    case 1: return (const void*)fast_kernel<1>;
    case 2: return (const void*)fast_kernel<2>;
    case 3: return (const void*)fast_kernel<3>;
    case 4: return (const void*)fast_kernel<4>;
    case 5: return (const void*)fast_kernel<5>;
    case 6: return (const void*)fast_kernel<6>;
    case 7: return (const void*)fast_kernel<7>;
    case 8: return (const void*)fast_kernel<8>;
    case 9: return (const void*)fast_kernel<9>;
    case 10: return (const void*)fast_kernel<10>;
    case 11: return (const void*)fast_kernel<11>;
    case 12: return (const void*)fast_kernel<12>;
  }
  return nullptr;
}
static_assert(kFastMaxSpecs == 12, "fast_fn covers 1 .. kFastMaxSpecs");

}  // namespace

extern "C" {

// cols: host array of ncols device pointers to int32[n], 16-byte aligned;
// gid: int32[n], 16-byte aligned; words: the spec stream of
// multiagg.spec_words (sum specs only); spec_planes: n_specs + 1 ascending
// plane offsets (spec s owns planes [spec_planes[s], spec_planes[s + 1]),
// one per 8 bits of its bound, at most 8); out: zeroed int64
// [n_groups, n_specs] on the device.  max_blocks > 0 caps the grid (a test
// hook: one block over many rows exercises the int32 flush).
int m2v_multiagg_mxu(const void* const* cols, int ncols, const void* gid,
                     long long n, const int* words, int n_words, int n_specs,
                     const int* spec_planes, int n_groups, int max_blocks,
                     void* out, void* stream) {
  if (ncols < 0 || ncols > kMaxCols || n_words < 0 || n_words > kMaxWords ||
      n_specs < 1 || n_specs > kMaxSpecs || n_groups < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  MxuArgs a;
  for (int j = 0; j < kMaxCols; ++j)
    a.cols[j] = j < ncols ? static_cast<const int32_t*>(cols[j]) : nullptr;
  // validate the word stream on the host: sums only, columns in range
  int w = 0;
  for (int s = 0; s < n_specs; ++s) {
    if (w + 3 > n_words) return (int)cudaErrorInvalidValue;
    const int op = words[w], base = words[w + 1], nf = words[w + 2];
    if (op != 0 || base >= ncols || nf < 0 || w + 3 + 3 * nf > n_words)
      return (int)cudaErrorInvalidValue;
    for (int f = 0; f < nf; ++f) {
      const int col = words[w + 3 + 3 * f + 2];
      if (col < 0 || col >= ncols) return (int)cudaErrorInvalidValue;
    }
    const int nl = spec_planes[s + 1] - spec_planes[s];
    if (nl < 1 || nl > 8) return (int)cudaErrorInvalidValue;
    a.spec_word[s] = w;
    w += 3 + 3 * nf;
  }
  if (spec_planes[0] != 0 || spec_planes[n_specs] > kMaxPlanes)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < kMaxWords; ++i) a.words[i] = i < n_words ? words[i] : 0;
  for (int s = 0; s <= kMaxSpecs; ++s)
    a.spec_plane[s] = s <= n_specs ? spec_planes[s] : spec_planes[n_specs];
  a.n_specs = n_specs;
  a.n_groups = n_groups;
  a.n_pchunks = (spec_planes[n_specs] + kChunkPlanes - 1) / kChunkPlanes;
  const long long y =
      (long long)a.n_pchunks * ((n_groups + kChunkGroups - 1) / kChunkGroups);
  if (y > 65535) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long steps = (n + kStepRows - 1) / kStepRows;
  long long blocks = (long long)sms * kBlocksPerSm;
  if (max_blocks > 0 && max_blocks < blocks) blocks = max_blocks;
  if (steps < blocks) blocks = steps;
  if (blocks < 1) blocks = 1;
  mxu_kernel<<<dim3((unsigned)blocks, (unsigned)y), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int32_t*>(gid), n,
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}

// The fast path (multiagg_mxu.fast_args builds its inputs).  cols: host
// array of ncols device pointers to int32[n], the columns the specs use in
// slot order, 16-byte aligned; gid: int32[n], 16-byte aligned; words:
// n_words factor words, (const, sign, slot) triples; heads: n_specs x 5
// ints (base slot or -1, factor count, first factor word, first plane,
// plane count), planes consecutive from 0, 1 to 8 per spec; flush_steps:
// warp steps between int32 flushes, 255 * 128 * flush_steps < 2^31;
// max_blocks > 0 caps the grid and max_warps > 0 the warps per block (test
// hooks: one warp over many rows exercises the flush); out: zeroed int64
// [n_groups, n_specs] on the device.
int m2v_multiagg_mxu_fast(const void* const* cols, int ncols, const void* gid,
                          long long n, const int* words, int n_words,
                          const int* heads, int n_specs, int n_groups,
                          int flush_steps, int max_blocks, int max_warps,
                          void* out, void* stream) {
  if (ncols < 0 || ncols > kMaxCols || n_words < 0 || n_words > kMaxWords ||
      n_specs < 1 || n_specs > kFastMaxSpecs || n_groups < 1 ||
      n_groups > kFastMaxGroups || n < 0 || flush_steps < 1 ||
      255LL * kWarpRows * flush_steps >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  FastArgs a = {};
  for (int j = 0; j < ncols; ++j)
    a.cols[j] = static_cast<const int32_t*>(cols[j]);
  for (int i = 0; i < n_words; ++i) a.words[i] = words[i];
  int planes = 0;
  for (int s = 0; s < n_specs; ++s) {
    FastSpec& sp = a.specs[s];
    sp.base = heads[5 * s];
    sp.nf = heads[5 * s + 1];
    sp.w = heads[5 * s + 2];
    sp.plane = heads[5 * s + 3];
    sp.nplanes = heads[5 * s + 4];
    if (sp.base < -1 || sp.base >= ncols || sp.nf < 0 || sp.w < 0 ||
        sp.w + 3 * sp.nf > n_words || sp.plane != planes || sp.nplanes < 1 ||
        sp.nplanes > 8)
      return (int)cudaErrorInvalidValue;
    for (int f = 0; f < sp.nf; ++f) {
      const int col = words[sp.w + 3 * f + 2];
      if (col < 0 || col >= ncols) return (int)cudaErrorInvalidValue;
    }
    planes += sp.nplanes;
  }
  a.ncols = ncols;
  a.n_groups = n_groups;
  a.n_planes = planes;
  a.n_tiles = (planes + 7) / 8;
  a.flush_steps = flush_steps;
  if (n == 0) return (int)cudaGetLastError();

  const long long per_warp = fast_warp_bytes(a.n_tiles, ncols);
  long long warps = (kSmemMax - fast_table_bytes(a.n_tiles)) / per_warp;
  if (warps > kFastMaxWarps) warps = kFastMaxWarps;
  if (max_warps > 0 && max_warps < warps) warps = max_warps;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const int threads = (int)warps * 32;
  const size_t shmem = (size_t)(fast_table_bytes(a.n_tiles) + warps * per_warp);
  const void* fn = fast_fn(n_specs);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, threads, shmem)) != cudaSuccess)
    return (int)e;
  const long long steps = ((n + 3) / 4 + 31) / 32;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (max_blocks > 0 && max_blocks < blocks) blocks = max_blocks;
  const long long want = (steps + warps - 1) / warps;
  if (want < blocks) blocks = want;
  const int32_t* g = static_cast<const int32_t*>(gid);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  void* args[] = {&a, &g, &n, &o};
  e = cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3(threads), args, shmem,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
