// Gather of k small tables through one shared vector of positions in any
// order.
//
// Replaces mplan2vdl_tpu/engine/kernels/sorted_gather.py:small_table_gather
// and sorted_gather.py:gather_many (small=True) — the Pallas kernels
// `_small_kernel` and `_small_kernel_multi`, which keep the whole table
// (at most SMALL_TABLE = 65536 rows) resident in VMEM and resolve each
// (8, 128) tile of positions by sweeping every 8-row sub-tile of the table
// with in-register lane permutations.  One kernel serves both: the single
// table is the k = 1 call.
//
//   out_j[i] = src_j[clip(pos[i], 0, n - 1)]
// for k sources sharing the length n.  Unlike gather.cu, rows past the
// caller's valid count are not redirected to the last valid position: the
// TPU kernel only clips, and so does this one.
//
// Bound on an H100: bytes.  The function reads m positions and the tables
// once and writes m elements per source: m * pos bytes + sum_j m * elem_j
// + table bytes at 3.35 TB/s.  The table reads are random, but the tables
// are small; what matters is that they are not fetched from device memory
// once per position.
//
// Design: a grid of a few blocks per SM, each looping over positions
// (grid-stride), so reads of positions and writes of outputs coalesce.
// When the k tables together fit a fixed shared-memory budget (96 KB, so
// two 256-thread blocks share an SM), each block copies them into shared
// memory once and serves every lookup from there: the nation (25 rows) and
// region (5 rows) tables of TPC-H take this branch.  Larger tables (65,536
// int32 rows are 256 KB, more than the 227 KB one block may use) are read
// through the read-only cache with __ldg; at most 512 KB per source, they
// stay in the 50 MB L2 after the first touch.  Sources may mix int32 and
// int64; their pointers, element sizes and shared-memory offsets travel in
// a by-value __grid_constant__ struct of fixed capacity, and the wrapper
// splits larger batches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSrc = 8;
constexpr int kThreads = 256;
constexpr int kSmemBudget = 96 * 1024;
constexpr int kLdgBlocksPerSm = 8;

struct SmallArgs {
  const void* src[kMaxSrc];
  void* out[kMaxSrc];
  int esize[kMaxSrc];
  int off[kMaxSrc];  // byte offset of table j in shared memory
  int k;
};

template <typename P, bool kShared>
__global__ void __launch_bounds__(kThreads)
small_gather_kernel(const __grid_constant__ SmallArgs a,
                    const P* __restrict__ pos, long long m, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (kShared) {
    for (int j = 0; j < a.k; ++j) {
      const int words = n * a.esize[j] / 4;
      const uint32_t* s = static_cast<const uint32_t*>(a.src[j]);
      uint32_t* d = reinterpret_cast<uint32_t*>(smem + a.off[j]);
      for (int w = threadIdx.x; w < words; w += kThreads) d[w] = __ldg(s + w);
    }
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < m;
       i += stride) {
    long long p = (long long)pos[i];
    p = p < 0 ? 0 : (p >= n ? n - 1 : p);
    for (int j = 0; j < a.k; ++j) {
      if (a.esize[j] == 4) {
        const int32_t v =
            kShared ? reinterpret_cast<const int32_t*>(smem + a.off[j])[p]
                    : __ldg(static_cast<const int32_t*>(a.src[j]) + p);
        static_cast<int32_t*>(a.out[j])[i] = v;
      } else {
        const long long v =
            kShared ? reinterpret_cast<const long long*>(smem + a.off[j])[p]
                    : __ldg(static_cast<const long long*>(a.src[j]) + p);
        static_cast<long long*>(a.out[j])[i] = v;
      }
    }
  }
}

template <typename P>
int launch(const SmallArgs& a, const P* pos, long long m, int n, int smem,
           cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long want = (m + kThreads - 1) / kThreads;
  long long cap = (long long)sms * kLdgBlocksPerSm;
  if (smem > 0) {
    auto kern = small_gather_kernel<P, true>;
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return (int)e;
    }
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
    if (e != cudaSuccess) return (int)e;
    cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const int blocks = (int)(want < cap ? want : cap);
    small_gather_kernel<P, true><<<blocks, kThreads, smem, s>>>(a, pos, m, n);
  } else {
    const int blocks = (int)(want < cap ? want : cap);
    small_gather_kernel<P, false><<<blocks, kThreads, 0, s>>>(a, pos, m, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int m2v_small_gather_max_sources() { return kMaxSrc; }

int m2v_small_gather_smem_budget() { return kSmemBudget; }

// srcs/outs/esizes: host arrays of k device pointers and element sizes
// (4 or 8).  pos: m positions of pos_esize bytes (4 or 8), any order.
// n: source length, 1 <= n <= 65536.
int m2v_small_gather(const void* const* srcs, void* const* outs,
                     const int* esizes, int k, const void* pos, int pos_esize,
                     long long m, long long n, void* stream) {
  if (k < 1 || k > kMaxSrc || n < 1 || n > 65536 ||
      (pos_esize != 4 && pos_esize != 8))
    return (int)cudaErrorInvalidValue;
  SmallArgs a;
  long long bytes = 0;
  for (int j = 0; j < k; ++j) {
    if (esizes[j] != 4 && esizes[j] != 8) return (int)cudaErrorInvalidValue;
    a.src[j] = srcs[j];
    a.out[j] = outs[j];
    a.esize[j] = esizes[j];
    a.off[j] = (int)bytes;
    bytes += (n * esizes[j] + 15) / 16 * 16;
  }
  for (int j = k; j < kMaxSrc; ++j) {
    a.src[j] = nullptr;
    a.out[j] = nullptr;
    a.esize[j] = 0;
    a.off[j] = 0;
  }
  a.k = k;
  if (m == 0) return (int)cudaGetLastError();
  const int smem = bytes <= kSmemBudget ? (int)bytes : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pos_esize == 4)
    return launch(a, static_cast<const int32_t*>(pos), m, (int)n, smem, s);
  return launch(a, static_cast<const int64_t*>(pos), m, (int)n, smem, s);
}

}  // extern "C"
