// Gather of k sources through one shared vector of monotone positions.
//
// Replaces mplan2vdl_tpu/engine/kernels/sorted_gather.py:sorted_gather and
// sorted_gather.py:gather_many (small=False) — the Pallas kernels `_kernel`
// and `_kernel_multi`, which stream two aligned source windows into VMEM per
// 1024-row output block and resolve the gather with in-register tile
// permutations.  One kernel serves both: sorted_gather is the k = 1 call.
//
//   out_j[i] = src_j[p(i)],  p(i) = clip(pos[i < valid ? i : valid - 1],
//                                        0, n - 1)
// which is `_prep_pos` (repeat the last valid position over the tail, clip
// into the source) applied once per row and shared by the k sources.
//
// Bound on an H100: bytes.  The function reads the m positions, the source
// elements they select and writes m output elements per source.  At the
// filter-project's 16% density nearly every 32-byte sector of each source
// is touched, so the sources are in effect read whole.
//
// Design: one thread per output row (grid-stride), positions loaded once
// and reused for all k sources.  Because positions ascend, neighbouring
// threads read neighbouring or equal source addresses and the loads
// coalesce by themselves; the TPU kernel's span-fit windows and its
// density floor have no counterpart.  Sources may mix int32 and int64
// (element size per source); their pointers travel in a by-value
// __grid_constant__ struct of fixed capacity, and the wrapper splits larger
// batches.  `valid` comes either as a host integer or, when the count is
// still on the device, through a pointer, so no host round trip is needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSrc = 8;
constexpr int kThreads = 256;

struct GatherArgs {
  const void* src[kMaxSrc];
  void* out[kMaxSrc];
  int esize[kMaxSrc];
  int k;
};

template <typename P>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const __grid_constant__ GatherArgs a, const P* __restrict__ pos,
              long long m, long long n, long long valid_host,
              const long long* __restrict__ valid_dev) {
  const long long valid = valid_dev ? *valid_dev : valid_host;
  const long long vlast = min(max(valid - 1, 0LL), m - 1);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < m;
       i += stride) {
    long long p = (long long)pos[i < valid ? i : vlast];
    p = min(max(p, 0LL), n - 1);
    for (int j = 0; j < a.k; ++j) {
      if (a.esize[j] == 4) {
        static_cast<int32_t*>(a.out[j])[i] =
            static_cast<const int32_t*>(a.src[j])[p];
      } else {
        static_cast<int64_t*>(a.out[j])[i] =
            static_cast<const int64_t*>(a.src[j])[p];
      }
    }
  }
}

}  // namespace

extern "C" {

int m2v_gather_max_sources() { return kMaxSrc; }

// srcs/outs/esizes: host arrays of k device pointers and element sizes
// (4 or 8).  pos: m positions of pos_esize bytes (4 or 8).  n: source
// length (> 0).  valid_dev: optional device int64 holding `valid`.
int m2v_gather(const void* const* srcs, void* const* outs, const int* esizes,
               int k, const void* pos, int pos_esize, long long m,
               long long n, long long valid_host, const void* valid_dev,
               void* stream) {
  if (k < 1 || k > kMaxSrc || n < 1 || (pos_esize != 4 && pos_esize != 8))
    return (int)cudaErrorInvalidValue;
  GatherArgs a;
  for (int j = 0; j < k; ++j) {
    if (esizes[j] != 4 && esizes[j] != 8) return (int)cudaErrorInvalidValue;
    a.src[j] = srcs[j];
    a.out[j] = outs[j];
    a.esize[j] = esizes[j];
  }
  for (int j = k; j < kMaxSrc; ++j) {
    a.src[j] = nullptr;
    a.out[j] = nullptr;
    a.esize[j] = 0;
  }
  a.k = k;
  if (m == 0) return (int)cudaGetLastError();
  const long long want = (m + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 65536 ? want : 65536);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* vd = static_cast<const long long*>(valid_dev);
  if (pos_esize == 4) {
    gather_kernel<int32_t><<<blocks, kThreads, 0, s>>>(
        a, static_cast<const int32_t*>(pos), m, n, valid_host, vd);
  } else {
    gather_kernel<int64_t><<<blocks, kThreads, 0, s>>>(
        a, static_cast<const int64_t*>(pos), m, n, valid_host, vd);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
