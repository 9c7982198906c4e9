// Kernel-pattern probes: the twelve small patterns of
// mplan2vdl_tpu/tools/probe_mosaic.py, each written as the GPU writes it.
//
// Replaces mplan2vdl_tpu/tools/probe_mosaic.py:run_probe (twelve tiny
// Pallas kernels that asked which vector patterns Mosaic lowers, and which
// it miscompiles: tile transposes, lane/sublane reshapes, multi-dimension
// dot_generals, masked and one-hot contractions, strided slices, wide
// takes).  On this card each probe is one launch of one of five kernels:
//   transpose_kernel   a 32 x 33 shared-memory tile transpose (probe 1);
//   rows_copy_kernel   an index-remapping copy, out[r][c] = x[(row0 + r *
//                      step) * src_cols + c]: the two reshapes (identity on
//                      the flat index) and the strided row slice;
//   fma_kernel<MODE>   float FMA contractions (probes 4, 5, 7, 8, 9, 10):
//                      one block per (batch, lhs row) splits the
//                      contraction over its 8 warps and computes all n <= 32
//                      outputs from one read of the row; the rhs mode is a
//                      template parameter.  Probe 9 (mode kRowsT) stages
//                      the [n, k] rhs through shared memory as its
//                      transpose [k][n] and reads it from there;
//   mma_kernel<MODE>   the same contraction on the tensor cores through
//                      mma_u8.cuh, the device code of multiagg_mxu.cu, with
//                      the values split into u8 limbs as that kernel splits
//                      them (second variants of probes 5, 7 and 8): up to
//                      four 128-thread groups a block take the 512-row
//                      steps in turn, each in its own shared buffer; the
//                      warps' int32 fragments are summed in shared memory
//                      and the limbs shifted and added in int64 before one
//                      store of each output (no zero fill, no atomics);
//   take_kernel        a table in shared memory, one lookup per thread
//                      (probes 11 and 12).
//
// Bound on an H100: launch latency.  Every probe moves at most a few
// hundred KB and does at most 2^20 multiply-adds, microseconds of work at
// the card's rates, so each probe is one launch, and the host path in
// front of it (probes.py, _lib.py) is what is left to cut.  chip_smoke.py
// phase 5 checks one device kernel per probe call and times each probe
// beside an empty launch and the PyTorch expression of the same function.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_u8.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kTakeMax = 8192;  // int32 entries of the take table

// rhs modes (probes.py RHS_*): rhs[b][j][kk]; the same, staged through
// shared memory as its transpose; the one-hot keys[b][kk] == j; one mask
// keys[b][kk] == key in every column j
constexpr int kRows = 0, kRowsT = 1, kOneHot = 2, kKey = 3;

constexpr int kFmaThreads = 256;
constexpr int kFmaWarps = kFmaThreads / 32;
constexpr int kMaxCols = 32;  // n of a contraction
// floats of fma_kernel<kRowsT>'s staged transpose: 256 rows at n = 32
constexpr int kStageWords = kFmaThreads * (kMaxCols + 1);

constexpr int kMmaGroups = 4;  // 128-thread groups of an mma_kernel block

__global__ void transpose_kernel(const int32_t* __restrict__ x, int rows,
                                 int cols, int32_t* __restrict__ out) {
  __shared__ int32_t tile[kTile][kTile + 1];
  const int c0 = blockIdx.x * kTile, r0 = blockIdx.y * kTile;
  for (int i = threadIdx.y; i < kTile; i += blockDim.y) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    if (r < rows && c < cols) tile[i][threadIdx.x] = x[(long long)r * cols + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < kTile; i += blockDim.y) {
    const int c = c0 + i, r = r0 + threadIdx.x;
    if (r < rows && c < cols)
      out[(long long)c * rows + r] = tile[threadIdx.x][i];
  }
}

__global__ void rows_copy_kernel(const int32_t* __restrict__ x, int src_cols,
                                 int row0, int row_step, int out_rows,
                                 int out_cols, int32_t* __restrict__ out) {
  const long long total = (long long)out_rows * out_cols;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / out_cols, c = i % out_cols;
    out[i] = x[(row0 + r * row_step) * src_cols + c];
  }
}

// out[b][i][j] = sum_kk float(a[b][i][kk]) * float(rhs element of column j)
// for NB >= n columns (NB = 1 in mode kKey: every column gets one sum).
// Block (b, i) = blockIdx.x reads its lhs row once; thread t takes kk = t,
// t + 256, ... into NB independent accumulators; each warp reduces them by
// shuffles, and the 8 warps' sums meet in shared memory.  Exact while every
// partial sum is an integer below 2^24, whatever the order.
template <int MODE, int NB>
__global__ void __launch_bounds__(kFmaThreads)
fma_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ rhs,
           int m, int n, int k, int key, float* __restrict__ out) {
  const int row = blockIdx.x, b = row / m, tid = threadIdx.x;
  const int32_t* arow = a + (long long)row * k;
  const int32_t* r = rhs + (MODE == kRows || MODE == kRowsT
                                ? (long long)b * n * k
                                : (long long)b * k);
  float acc[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) acc[j] = 0.f;
  if constexpr (MODE == kRowsT) {
    // the rhs, kc contraction rows at a time, as its transpose: t[c *
    // stride + j] = rhs[j][k0 + c], staged with consecutive threads on
    // consecutive (j, c) of the rhs; an odd stride keeps both the staging
    // stores and the contraction's loads on distinct banks
    __shared__ float t[kStageWords];
    const int stride = n | 1;
    const int kc = kStageWords / stride / kFmaThreads * kFmaThreads;
    for (int k0 = 0; k0 < k; k0 += kc) {
      const int rows = min(kc, k - k0);
      __syncthreads();
#pragma unroll 4
      for (int e = tid; e < n * rows; e += kFmaThreads) {
        const int j = e / rows, c = e - j * rows;
        t[c * stride + j] = (float)r[(long long)j * k + k0 + c];
      }
      __syncthreads();
      for (int c = tid; c < rows; c += kFmaThreads) {
        const float x = (float)arow[k0 + c];
#pragma unroll
        for (int j = 0; j < NB; ++j)
          if (j < n) acc[j] = fmaf(x, t[c * stride + j], acc[j]);
      }
    }
  } else {
#pragma unroll 4
    for (int kk = tid; kk < k; kk += kFmaThreads) {
      const float x = (float)arow[kk];
      if constexpr (MODE == kRows) {
#pragma unroll
        for (int j = 0; j < NB; ++j)
          if (j < n) acc[j] = fmaf(x, (float)r[(long long)j * k + kk], acc[j]);
      } else if constexpr (MODE == kOneHot) {
        const int g = r[kk];
#pragma unroll
        for (int j = 0; j < NB; ++j) acc[j] += g == j ? x : 0.f;
      } else {
        acc[0] += r[kk] == key ? x : 0.f;
      }
    }
  }
  __shared__ float part[kFmaWarps][NB];
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    float s = acc[j];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
    if (lane == 0) part[warp][j] = s;
  }
  __syncthreads();
  if (tid < n) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kFmaWarps; ++w) s += part[w][MODE == kKey ? 0 : tid];
    out[(long long)row * n + tid] = s;
  }
}

// The barrier of one 128-thread group (named barrier 1 + group; 0 is
// __syncthreads).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(m2v::kThreads)
               : "memory");
}

// The fma_kernel contraction on the tensor cores, one block per batch item,
// in multiagg_mxu.cu's layout: plane l * m + i holds limb l of a's row i,
// group j the byte rhs element of column j (modes kRows, kOneHot, kKey).
// Group g of the block's G = blockDim.x / 128 groups packs and contracts
// the 512-row steps g, g + G, ... in its own buffer of 16 * mt plane rows
// and 8 * nt group rows (rows past np and ng are never written: they only
// reach fragment cells that are not stored).  Then every warp's fragment
// cells go to shared memory, and out[b][i][j] = sum_l (sum over warps) <<
// 8 * l in int64.  A warp's int32 cell gains at most 255 * 255 a row in
// mode kRows and 255 in the others; the wrapper bounds k so that no cell
// passes 2^31.
template <int MODE>
__global__ void __launch_bounds__(m2v::kThreads * kMmaGroups)
mma_kernel(const int32_t* __restrict__ a, int nlimb,
           const int32_t* __restrict__ rhs, int m, int n, int k, int key,
           long long* __restrict__ out) {
  using namespace m2v;
  extern __shared__ __align__(16) uint32_t smem[];
  const int G = blockDim.x / kThreads, group = threadIdx.x / kThreads;
  const int tid = threadIdx.x % kThreads, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, np = m * nlimb, ng = n;
  const int mt = (np + 15) / 16, nt = (ng + 7) / 8;
  uint32_t* planes = smem + group * (16 * mt + 8 * nt) * kStride;
  uint32_t* groups = planes + 16 * mt * kStride;
  const int32_t* r = rhs + (MODE == kRows ? (long long)b * n * k
                                          : (long long)b * k);
  int c[kMTiles][kNTiles][4] = {};
  const int steps = (k + kStepRows - 1) / kStepRows;
  for (int s = group; s < steps; s += G) {
    const int r0 = s * kStepRows + 4 * tid;
    for (int i = 0; i < m; ++i) {
      const int32_t* row = a + ((long long)b * m + i) * k;
      uint32_t v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        v[jj] = r0 + jj < k ? (uint32_t)row[r0 + jj] : 0u;
      for (int l = 0; l < nlimb; ++l)
        planes[(l * m + i) * kStride + tid] =
            pack_bytes(limb8(v[0], l), limb8(v[1], l), limb8(v[2], l),
                       limb8(v[3], l));
    }
    if constexpr (MODE == kRows) {
      for (int q = 0; q < ng; ++q) {
        uint32_t by[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          by[jj] = r0 + jj < k ? (uint32_t)r[(long long)q * k + r0 + jj] : 0u;
        groups[q * kStride + tid] = pack_bytes(by[0], by[1], by[2], by[3]);
      }
    } else {
      int g[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) g[jj] = r0 + jj < k ? r[r0 + jj] : -1;
      for (int q = 0; q < ng; ++q) {
        const int want = MODE == kOneHot ? q : key;
        groups[q * kStride + tid] =
            pack_bytes(r0 < k && g[0] == want, r0 + 1 < k && g[1] == want,
                       r0 + 2 < k && g[2] == want, r0 + 3 < k && g[3] == want);
      }
    }
    group_sync(group);
    contract_step(planes, groups, warp, lane, mt, nt, c);
    group_sync(group);
  }
  __syncthreads();
  // every warp's cells: red[(w * np + p) * ng + q], w = 4 * group + warp
  // (fits in the staging buffers: 4 * np * ng <= (16 mt + 8 nt) * kStride)
  int* red = reinterpret_cast<int*>(smem);
  const int w = group * kWarps + warp;
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int p, q;
        c_coord(lane, e, &p, &q);
        p += 16 * i;
        q += 8 * j;
        if (i < mt && j < nt && p < np && q < ng)
          red[(w * np + p) * ng + q] = c[i][j][e];
      }
  __syncthreads();
  const int nw = G * kWarps;
  for (int o = threadIdx.x; o < m * n; o += blockDim.x) {
    const int i = o / n, j = o - i * n;
    long long s = 0;
    for (int l = 0; l < nlimb; ++l) {
      long long t = 0;
      for (int ww = 0; ww < nw; ++ww) t += red[(ww * np + l * m + i) * ng + j];
      s += t << (8 * l);
    }
    out[(long long)b * m * n + o] = s;
  }
}

// out[i] = table[idx[i]] for the rows of this block's share of idx; the
// table is copied into shared memory first.
__global__ void take_kernel(const int32_t* __restrict__ table, int table_n,
                            const int32_t* __restrict__ idx, long long m,
                            int32_t* __restrict__ out) {
  __shared__ int32_t t[kTakeMax];
  for (int i = threadIdx.x; i < table_n; i += blockDim.x) t[i] = table[i];
  __syncthreads();
  const long long per = (m + gridDim.x - 1) / gridDim.x;
  const long long lo = blockIdx.x * per;
  const long long hi = lo + per < m ? lo + per : m;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int p = idx[i];
    out[i] = t[p < 0 ? 0 : (p >= table_n ? table_n - 1 : p)];
  }
}

// Does nothing: timing its launch gives the fixed cost of one probe launch.
__global__ void noop_kernel() {}

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

template <int MODE, int NB>
void launch_fma(const void* a, const void* rhs, int batch, int m, int n,
                int k, int key, void* out, cudaStream_t s) {
  fma_kernel<MODE, NB><<<batch * m, kFmaThreads, 0, s>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(rhs), m, n,
      k, key, static_cast<float*>(out));
}

template <int MODE>
void launch_fma_cols(const void* a, const void* rhs, int batch, int m, int n,
                     int k, int key, void* out, cudaStream_t s) {
  if (n <= 4)
    launch_fma<MODE, 4>(a, rhs, batch, m, n, k, key, out, s);
  else if (n <= 8)
    launch_fma<MODE, 8>(a, rhs, batch, m, n, k, key, out, s);
  else if (n <= 16)
    launch_fma<MODE, 16>(a, rhs, batch, m, n, k, key, out, s);
  else
    launch_fma<MODE, 32>(a, rhs, batch, m, n, k, key, out, s);
}

// Raises mma_kernel<MODE>'s dynamic shared memory limit to the most any
// launch asks (kMmaGroups groups of 32 plane and 32 group rows), once per
// device, so that a launch pays no attribute call.
template <int MODE>
cudaError_t allow_smem() {
  static unsigned long long raised = 0;  // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (raised & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(
      mma_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kMmaGroups * (m2v::kChunkPlanes + m2v::kChunkGroups) *
            m2v::kStride * sizeof(uint32_t)));
  if (e == cudaSuccess) raised |= bit;
  return e;
}

template <int MODE>
int launch_mma(const void* a, int nlimb, const void* rhs, int batch, int m,
               int n, int k, int key, void* out, cudaStream_t s) {
  const int mt = (m * nlimb + 15) / 16, nt = (n + 7) / 8;
  const int steps = (k + m2v::kStepRows - 1) / m2v::kStepRows;
  const int groups = steps < kMmaGroups ? steps : kMmaGroups;
  const size_t smem = (size_t)groups * (16 * mt + 8 * nt) * m2v::kStride *
                      sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem<MODE>();
    if (e != cudaSuccess) return (int)e;
  }
  mma_kernel<MODE><<<batch, groups * m2v::kThreads, smem, s>>>(
      static_cast<const int32_t*>(a), nlimb, static_cast<const int32_t*>(rhs),
      m, n, k, key, static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: int32[rows, cols]; out: int32[cols, rows].
int m2v_probe_transpose(const void* x, int rows, int cols, void* out,
                        void* stream) {
  if (rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + kTile - 1) / kTile, (rows + kTile - 1) / kTile);
  transpose_kernel<<<grid, dim3(kTile, 8), 0, as_stream(stream)>>>(
      static_cast<const int32_t*>(x), rows, cols, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

// out: int32[out_rows, out_cols] from x (the caller checks the bounds).
int m2v_probe_rows_copy(const void* x, int src_cols, int row0, int row_step,
                        int out_rows, int out_cols, void* out, void* stream) {
  if (out_rows < 1 || out_cols < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)out_rows * out_cols;
  const int blocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256
                                                      : 1024);
  rows_copy_kernel<<<blocks, 256, 0, as_stream(stream)>>>(
      static_cast<const int32_t*>(x), src_cols, row0, row_step, out_rows,
      out_cols, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

// a: int32[batch, m, k]; rhs: int32[batch, n, k] (modes 0 and 1) or the
// keys int32[batch, k] (modes 2 and 3); out: float[batch, m, n], n <= 32.
int m2v_probe_fma(const void* a, const void* rhs, int batch, int m, int n,
                  int k, int mode, int key, void* out, void* stream) {
  if (batch < 1 || m < 1 || n < 1 || n > kMaxCols || k < 1 ||
      (long long)batch * m > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = as_stream(stream);
  switch (mode) {
    case kRows: launch_fma_cols<kRows>(a, rhs, batch, m, n, k, key, out, s);
      break;
    case kRowsT: launch_fma_cols<kRowsT>(a, rhs, batch, m, n, k, key, out, s);
      break;
    case kOneHot:
      launch_fma_cols<kOneHot>(a, rhs, batch, m, n, k, key, out, s);
      break;
    case kKey: launch_fma<kKey, 1>(a, rhs, batch, m, n, k, key, out, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// As m2v_probe_fma (modes 0, 2, 3, rhs bytes 0..255, non-negative a below
// 2^(8 * nlimb)) on the tensor cores; out: int64[batch, m, n], every entry
// written.
int m2v_probe_mma(const void* a, int nlimb, const void* rhs, int batch, int m,
                  int n, int k, int mode, int key, void* out, void* stream) {
  if (batch < 1 || m < 1 || n < 1 || k < 1 || nlimb < 1 || nlimb > 4 ||
      m * nlimb > m2v::kChunkPlanes || n > m2v::kChunkGroups ||
      k > (mode == kRows ? (1 << 15) : (1 << 23) - 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = as_stream(stream);
  switch (mode) {
    case kRows:
      return launch_mma<kRows>(a, nlimb, rhs, batch, m, n, k, key, out, s);
    case kOneHot:
      return launch_mma<kOneHot>(a, nlimb, rhs, batch, m, n, k, key, out, s);
    case kKey:
      return launch_mma<kKey>(a, nlimb, rhs, batch, m, n, k, key, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out[i] = table[clip(idx[i])]; `blocks` blocks each copy the table into
// shared memory and serve one contiguous share of idx.
int m2v_probe_take(const void* table, int table_n, const void* idx,
                   long long m, int blocks, void* out, void* stream) {
  if (table_n < 1 || table_n > kTakeMax || m < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  take_kernel<<<blocks, 128, 0, as_stream(stream)>>>(
      static_cast<const int32_t*>(table), table_n,
      static_cast<const int32_t*>(idx), m, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

// One launch of the empty kernel, through the same path as the probes.
int m2v_probe_noop(void* stream) {
  noop_kernel<<<1, 1, 0, as_stream(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
