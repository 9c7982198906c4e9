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
// valid prefix and map every invalid row to L or beyond.
//
// Bound on an H100: bytes.  The function reads n positions and n source
// elements and writes L output elements: n * (pos bytes + src bytes) +
// L * elem at 3.35 TB/s.  It does no arithmetic worth counting.
//
// Design: the zero fill is a cudaMemsetAsync on the caller's stream, then
// one thread per source row stores its element (grid-stride).  Positions
// are unique, so no two threads write one slot and no atomics are needed;
// they ascend, so a warp's 32 stores fall into few neighbouring sectors and
// coalesce.  The fill writes the covered slots once more than needed: at
// the engine's densities (15% to 100%) that costs at most L * elem bytes,
// against the TPU kernel's in-register spread, which the GPU does not need.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename P, typename T>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const P* __restrict__ pos, const T* __restrict__ src,
               T* __restrict__ out, long long n, long long L) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const long long p = (long long)pos[i];
    if (p >= 0 && p < L) out[p] = src[i];
  }
}

template <typename P>
void launch(const P* pos, const void* src, int esize, void* out, long long n,
            long long L, cudaStream_t s) {
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 65536 ? want : 65536);
  if (esize == 4) {
    scatter_kernel<P, int32_t><<<blocks, kThreads, 0, s>>>(
        pos, static_cast<const int32_t*>(src), static_cast<int32_t*>(out), n,
        L);
  } else {
    scatter_kernel<P, int64_t><<<blocks, kThreads, 0, s>>>(
        pos, static_cast<const int64_t*>(src), static_cast<int64_t*>(out), n,
        L);
  }
}

}  // namespace

extern "C" {

// pos: n positions of pos_esize bytes (4 or 8).  src: n elements of esize
// bytes (4 or 8).  out: L elements of esize bytes, filled here.
int m2v_scatter(const void* pos, int pos_esize, const void* src, int esize,
                void* out, long long n, long long L, void* stream) {
  if ((pos_esize != 4 && pos_esize != 8) || (esize != 4 && esize != 8) ||
      n < 0 || L < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L > 0) {
    const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)L * esize, s);
    if (e != cudaSuccess) return (int)e;
  }
  if (n > 0 && L > 0) {
    if (pos_esize == 4) {
      launch(static_cast<const int32_t*>(pos), src, esize, out, n, L, s);
    } else {
      launch(static_cast<const int64_t*>(pos), src, esize, out, n, L, s);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
