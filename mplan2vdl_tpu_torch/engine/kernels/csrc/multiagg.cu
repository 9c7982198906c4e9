// Fused multi-aggregate dense group-by (the Q1-class kernel).
//
// Replaces mplan2vdl_tpu/engine/kernels/multiagg.py:fused_group_aggregate
// (the Pallas `_kernel`, which holds each per-row value as 16-bit limbs in
// int32 lanes, renormalises carries every RENORM_EVERY blocks and leaves the
// int64 recombination to the host).  The contract is unchanged: an exact
// int64 [n_groups, n_specs] table where, for each AggSpec,
//   value(row) = base(row) * prod_f (const_f + sign_f * col_f(row))
// is summed (op "sum") or max-reduced with identity 0 (op "max", FChoose)
// over the rows whose group id g satisfies 0 <= g < n_groups.
//
// Bound on an H100: bytes.  The function reads the c distinct input
// columns and the group ids once, 4*(c+1)*n bytes; its int64 multiplies
// and adds are a few per row.
//
// Design: every thread computes a row's value directly in int64 (the spec's
// `bits` bound keeps products and sums below 2^62, so the limb layout,
// RENORM_EVERY and the row layout have no counterpart).  Each block keeps a
// shared-memory int64 [n_groups x n_specs] table, accumulates into it with
// shared atomicAdd (as unsigned long long) or atomicMax, and flushes it with
// one global atomic per cell.  Integer sums do not depend on order, so the
// result is exact and the same on every run.  Known weakness: Q1 occupies
// few groups, so the threads of a warp contend on the same shared cells.
// Specs arrive as a flat int32 word array (op, base or -1 for count, factor
// count, then (const, sign, col) triples) in a by-value __grid_constant__
// struct together with the column pointers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 16;
constexpr int kMaxWords = 512;
constexpr int kMaxSpecs = 64;
constexpr int kMaxCells = 6144;  // 48 KB of int64 shared memory
constexpr int kThreads = 256;

struct AggArgs {
  const int32_t* cols[kMaxCols];
  int32_t words[kMaxWords];
  int n_specs;
  int n_groups;
};

__global__ void __launch_bounds__(kThreads)
multiagg_kernel(const __grid_constant__ AggArgs a,
                const int32_t* __restrict__ gid, long long n,
                long long* __restrict__ out) {
  extern __shared__ long long tab[];
  __shared__ int spec_op[kMaxSpecs];
  const int cells = a.n_groups * a.n_specs;
  for (int i = threadIdx.x; i < cells; i += kThreads) tab[i] = 0;
  if (threadIdx.x == 0) {
    int w = 0;
    for (int s = 0; s < a.n_specs; ++s) {
      spec_op[s] = a.words[w];
      w += 3 + 3 * a.words[w + 2];
    }
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < n;
       r += stride) {
    const int g = gid[r];
    if (g < 0 || g >= a.n_groups) continue;
    long long* row = tab + (long long)g * a.n_specs;
    int w = 0;
    for (int s = 0; s < a.n_specs; ++s) {
      const int op = a.words[w], base = a.words[w + 1], nf = a.words[w + 2];
      w += 3;
      long long v = base < 0 ? 1LL : (long long)a.cols[base][r];
      for (int f = 0; f < nf; ++f, w += 3) {
        v *= (long long)a.words[w] +
             (long long)a.words[w + 1] * (long long)a.cols[a.words[w + 2]][r];
      }
      if (op == 0) {
        atomicAdd(reinterpret_cast<unsigned long long*>(row + s),
                  (unsigned long long)v);
      } else {
        atomicMax(row + s, v);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    const long long v = tab[i];
    if (v == 0) continue;  // 0 is the identity of both ops
    if (spec_op[i % a.n_specs] == 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(out + i),
                (unsigned long long)v);
    } else {
      atomicMax(out + i, v);
    }
  }
}

}  // namespace

extern "C" {

// cols: host array of ncols device pointers to int32[n]; gid: int32[n];
// words: host array of n_words spec words; out: zeroed int64
// [n_groups, n_specs] on the device.
int m2v_multiagg(const void* const* cols, int ncols, const void* gid,
                 long long n, const int* words, int n_words, int n_specs,
                 int n_groups, void* out, void* stream) {
  if (ncols < 0 || ncols > kMaxCols || n_words < 0 || n_words > kMaxWords ||
      n_specs < 1 || n_specs > kMaxSpecs || n_groups < 1 ||
      n_groups * n_specs > kMaxCells)
    return (int)cudaErrorInvalidValue;
  AggArgs a;
  for (int j = 0; j < kMaxCols; ++j)
    a.cols[j] = j < ncols ? static_cast<const int32_t*>(cols[j]) : nullptr;
  // validate the word stream on the host: every column index in range
  int w = 0;
  for (int s = 0; s < n_specs; ++s) {
    if (w + 3 > n_words) return (int)cudaErrorInvalidValue;
    const int base = words[w + 1], nf = words[w + 2];
    if (base >= ncols || nf < 0 || w + 3 + 3 * nf > n_words)
      return (int)cudaErrorInvalidValue;
    for (int f = 0; f < nf; ++f) {
      const int col = words[w + 3 + 3 * f + 2];
      if (col < 0 || col >= ncols) return (int)cudaErrorInvalidValue;
    }
    w += 3 + 3 * nf;
  }
  for (int i = 0; i < kMaxWords; ++i) a.words[i] = i < n_words ? words[i] : 0;
  a.n_specs = n_specs;
  a.n_groups = n_groups;
  if (n == 0) return (int)cudaGetLastError();
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 2048 ? want : 2048);
  const size_t shmem = (size_t)n_groups * n_specs * sizeof(long long);
  multiagg_kernel<<<blocks, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int32_t*>(gid), n, static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
