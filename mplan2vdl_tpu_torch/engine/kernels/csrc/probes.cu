// Kernel-pattern probes: the twelve small patterns of
// mplan2vdl_tpu/tools/probe_mosaic.py, each written as the GPU writes it.
//
// Replaces mplan2vdl_tpu/tools/probe_mosaic.py:run_probe (twelve tiny
// Pallas kernels that asked which vector patterns Mosaic lowers, and which
// it miscompiles: tile transposes, lane/sublane reshapes, multi-dimension
// dot_generals, masked and one-hot contractions, strided slices, wide
// takes).  On this card each pattern is one of five kernels here:
//   transpose_kernel   a 32 x 33 shared-memory tile transpose (probe 1, and
//                      the explicit rhs transpose of probe 9);
//   rows_copy_kernel   an index-remapping copy, out[r][c] = x[(row0 + r *
//                      step) * src_cols + c]: the two reshapes (identity on
//                      the flat index) and the strided row slice;
//   fma_kernel         one warp per output element, float FMA over the
//                      contraction and a shuffle reduction (probes 4, 5, 7,
//                      8, 9, 10);
//   mma_kernel         the same contraction through mma_u8.cuh, the device
//                      code of multiagg_mxu.cu, with the values split into
//                      u8 limbs as that kernel splits them (second variants
//                      of probes 5, 7 and 8);
//   take_kernel        a table in shared memory, one lookup per thread
//                      (probes 11 and 12).
//
// Bound on an H100: launch latency.  Every probe moves at most a few
// hundred KB and does at most 2^20 multiply-adds, microseconds of work at
// the card's rates; chip_smoke.py records the byte bound beside each time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_u8.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kTakeMax = 8192;  // int32 entries of the take table

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

// The rhs element (batch b, output column j, contraction index kk):
//   mode 0: rhs[b][j][kk]   mode 1: rhs[b][kk][j]
//   mode 2: keys[b][kk] == j   mode 3: keys[b][kk] == key
__device__ __forceinline__ int rhs_at(const int32_t* __restrict__ rhs,
                                      int mode, int b, int j, int kk, int n,
                                      int k, int key) {
  switch (mode) {
    case 0: return rhs[((long long)b * n + j) * k + kk];
    case 1: return rhs[((long long)b * k + kk) * n + j];
    case 2: return rhs[(long long)b * k + kk] == j;
    default: return rhs[(long long)b * k + kk] == key;
  }
}

// out[b][i][j] = sum_kk float(a[b][i][kk]) * float(rhs element)
__global__ void fma_kernel(const int32_t* __restrict__ a,
                           const int32_t* __restrict__ rhs, int batch, int m,
                           int n, int k, int mode, int key,
                           float* __restrict__ out) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (w >= (long long)batch * m * n) return;  // whole warps return
  const int b = (int)(w / ((long long)m * n)), i = (int)(w / n % m),
            j = (int)(w % n);
  const int32_t* row = a + ((long long)b * m + i) * k;
  float s = 0.f;
  for (int kk = lane; kk < k; kk += 32)
    s = fmaf((float)row[kk], (float)rhs_at(rhs, mode, b, j, kk, n, k, key), s);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
  if (lane == 0) out[w] = s;
}

// The fma_kernel contraction on the tensor cores, one block per batch item,
// in multiagg_mxu.cu's layout: plane l * m + i holds limb l of a's row i,
// group j the byte rhs element of column j (modes 0, 2 and 3); out (int64,
// zeroed) gets each limb's sum shifted by 8 * l.  k < 2^23, so the int32
// fragments need no flush.
__global__ void __launch_bounds__(m2v::kThreads)
mma_kernel(const int32_t* __restrict__ a, int nlimb,
           const int32_t* __restrict__ rhs, int m, int n, int k, int mode,
           int key, unsigned long long* __restrict__ out) {
  using namespace m2v;
  __shared__ __align__(16) uint32_t planes[kChunkPlanes * kStride];
  __shared__ __align__(16) uint32_t groups[kChunkGroups * kStride];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, np = m * nlimb, ng = n;
  const int mt = (np + 15) / 16, nt = (ng + 7) / 8;
  for (int i = tid; i < kChunkPlanes * kStride; i += kThreads) {
    planes[i] = 0;
    groups[i] = 0;
  }
  int c[kMTiles][kNTiles][4] = {};
  for (int step0 = 0; step0 < k; step0 += kStepRows) {
    const int r0 = step0 + 4 * tid;
    __syncthreads();
    for (int p = 0; p < np; ++p) {
      const int l = p / m;
      const int32_t* row = a + ((long long)b * m + p % m) * k;
      uint32_t by[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        by[jj] = r0 + jj < k
                     ? limb8((unsigned long long)(long long)row[r0 + jj], l)
                     : 0u;
      planes[p * kStride + tid] = pack_bytes(by[0], by[1], by[2], by[3]);
    }
    for (int q = 0; q < ng; ++q) {
      uint32_t by[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        by[jj] = r0 + jj < k
                     ? (uint32_t)rhs_at(rhs, mode, b, q, r0 + jj, n, k, key)
                     : 0u;
      groups[q * kStride + tid] = pack_bytes(by[0], by[1], by[2], by[3]);
    }
    __syncthreads();
    contract_step(planes, groups, warp, lane, mt, nt, c);
  }
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
          atomicAdd(out + ((long long)b * m + p % m) * n + q,
                    (unsigned long long)(unsigned)c[i][j][e] << (8 * (p / m)));
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

// a: int32[batch, m, k]; rhs per `mode` (see rhs_at); out: float[batch, m, n].
int m2v_probe_fma(const void* a, const void* rhs, int batch, int m, int n,
                  int k, int mode, int key, void* out, void* stream) {
  if (batch < 1 || m < 1 || n < 1 || k < 1 || mode < 0 || mode > 3)
    return (int)cudaErrorInvalidValue;
  const long long warps = (long long)batch * m * n;
  fma_kernel<<<(unsigned)((warps + 7) / 8), 256, 0, as_stream(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(rhs), batch,
      m, n, k, mode, key, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// As m2v_probe_fma (modes 0, 2, 3, rhs bytes 0..255, non-negative a) on the
// tensor cores; out: zeroed int64[batch, m, n].
int m2v_probe_mma(const void* a, int nlimb, const void* rhs, int batch, int m,
                  int n, int k, int mode, int key, void* out, void* stream) {
  if (batch < 1 || m < 1 || n < 1 || k < 1 || nlimb < 1 || nlimb > 4 ||
      m * nlimb > m2v::kChunkPlanes || n > m2v::kChunkGroups || mode == 1 ||
      mode < 0 || mode > 3 || k >= (1 << 23))
    return (int)cudaErrorInvalidValue;
  mma_kernel<<<batch, m2v::kThreads, 0, as_stream(stream)>>>(
      static_cast<const int32_t*>(a), nlimb, static_cast<const int32_t*>(rhs),
      m, n, k, mode, key, static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
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
