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
// Design.  A row's value is exact in int64 (it is below 2^bits), so the
// limb multiply, renormalisation, carry plane and lo/hi output split of the
// TPU kernel have no counterpart: each thread computes the values of four
// consecutive rows directly and splits each into ceil(bits/8) byte planes.
// The planes of all specs are stacked (Q1: 2+3+4+5+1+1+1 = 17, padded to 32)
// and contracted with the rows' one-hot group bytes by mma_u8 (mma_u8.cuh):
//   partial[plane][group] = sum_rows plane(row) * (gid(row) == group)
// Per step a block of 128 threads packs 512 rows into shared memory (one
// word per plane and per group per thread) and each of its 4 warps
// contracts its 128-row slice into int32 fragments.  Every kFlushSteps steps
// (2^23 rows of the block, whatever the grid) and at the end the fragments
// are added into a shared int64 table, so no int32 cell ever holds more
// than 255 * 2^23 < 2^31.  Last, each (plane, group) cell of the table is
// shifted by 8 * limb and added to its spec's output with one global atomic:
// sum_k plane_sum_k << 8k is taken in wrapping 64-bit unsigned arithmetic,
// exact because the true total is below 2^63 although a shifted plane sum
// alone may not be.  A block covers 32 planes and 32 groups (grid.y walks
// the chunks of more planes or groups, so any n_groups works), and reads
// only the columns its specs reference.  The "max" specs of a family stay
// with multiagg.cu, as in the JAX engine.

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

}  // extern "C"
