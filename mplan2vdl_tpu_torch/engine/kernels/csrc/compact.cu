// Stream compaction: ascending int32 positions of a boolean mask's true rows.
//
// Replaces mplan2vdl_tpu/engine/kernels/compact.py:compact_positions (the
// Pallas kernel `_kernel`, which left-packs each 8192-row block by log-shift
// rolls and DMAs the packed window to its output offset).  The contract is
// unchanged: out[0:count] are the true rows' indices in ascending order,
// out[count:n_out] are 0, and the output is trimmed to n_out.
//
// Bound on an H100: bytes.  The function must read n mask bytes and write
// 4*count position bytes; it does no arithmetic worth counting.
//
// Design (three launches on the caller's stream, no host round trip):
//   1. count:  each block owns TILE = 4096 rows; each of its 256 threads
//      loads 16 mask bytes as one 16-byte vector (coalesced across the warp)
//      and counts them with __popc (a torch.bool byte is 0 or 1, so the bit
//      count of a word is its count of true bytes).  A warp reduction and a
//      shared-memory sum over the 8 warps give the block's count.
//   2. scan:   one block turns the per-block counts into exclusive offsets
//      (each thread scans a contiguous chunk, then a block-wide scan of the
//      chunk totals); offsets[nblocks] is the total count.
//   3. write:  each block re-reads its tile, ranks its true rows (per-thread
//      counts, warp shuffle scan, scan of the warp totals), packs the
//      positions into shared memory in order, and copies them out with
//      coalesced stores.  Threads whose row index lies in [total, n_out)
//      write the zero tail, so the wrapper needs no separate fill.
// The TPU kernel's (8,128) tiles, roll-based packing, carry row and window
// DMAs answer the TPU's lack of scatter and its sequential grid; on the GPU
// blocks run in parallel, so the offsets come from the explicit scan.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 16;
constexpr int kTile = kThreads * kRowsPerThread;  // 4096 rows per block
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;

// Count of true bytes among the 16 rows starting at `base` (a multiple of
// 16); `bits` gets one bit per row, in row order.
__device__ __forceinline__ int load_rows(const uint8_t* __restrict__ mask,
                                         long long n, long long base,
                                         unsigned* bits) {
  unsigned b = 0;
  if (base + kRowsPerThread <= n) {
    const uint4 w = *reinterpret_cast<const uint4*>(mask + base);
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((words[q] >> (8 * k)) & 0xffu) b |= 1u << (4 * q + k);
      }
    }
  } else {
    for (int k = 0; k < kRowsPerThread; ++k) {
      if (base + k < n && mask[base + k] != 0) b |= 1u << k;
    }
  }
  *bits = b;
  return __popc(b);
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ mask, long long n,
             int* __restrict__ counts) {
  __shared__ int warp_tot[kWarps];
  const long long base =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kRowsPerThread;
  unsigned bits;
  int c = load_rows(mask, n, base, &bits);
  c = __reduce_add_sync(0xffffffffu, (unsigned)c);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_tot[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += warp_tot[w];
    counts[blockIdx.x] = t;
  }
}

// Exclusive scan of counts[0:nb] into offsets[0:nb], offsets[nb] = total.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ counts, int nb, int* __restrict__ offsets) {
  __shared__ int warp_tot[kScanThreads / 32];
  const int chunk = (nb + kScanThreads - 1) / kScanThreads;
  const int lo = threadIdx.x * chunk;
  const int hi = min(lo + chunk, nb);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += counts[i];
  // block-wide exclusive scan of the per-thread sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = warp_tot[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t += y;
    }
    warp_tot[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  int run = (warp > 0 ? warp_tot[warp - 1] : 0) + incl - s;
  for (int i = lo; i < hi; ++i) {
    offsets[i] = run;
    run += counts[i];
  }
  if (threadIdx.x == kScanThreads - 1) offsets[nb] = warp_tot[31];
}

__global__ void __launch_bounds__(kThreads)
write_kernel(const uint8_t* __restrict__ mask, long long n,
             const int* __restrict__ offsets, int nb, int* __restrict__ out,
             long long n_out) {
  __shared__ int warp_tot[kWarps];
  __shared__ int packed[kTile];
  const long long tile0 = (long long)blockIdx.x * kTile;
  const long long base = tile0 + (long long)threadIdx.x * kRowsPerThread;
  unsigned bits;
  const int c = load_rows(mask, n, base, &bits);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += (w < warp) ? warp_tot[w] : 0;
  int block_cnt = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) block_cnt += warp_tot[w];
  // pack this thread's true rows at their in-block ranks
  int r = before + incl - c;
  while (bits) {
    const int k = __ffs(bits) - 1;
    bits &= bits - 1;
    packed[r++] = (int)(base + k);
  }
  __syncthreads();
  const long long off = offsets[blockIdx.x];
  for (int i = threadIdx.x; i < block_cnt; i += kThreads) {
    const long long dst = off + i;
    if (dst < n_out) out[dst] = packed[i];
  }
  // zero tail: slots [total, n_out) that fall inside this block's row range
  const long long total = offsets[nb];
  for (int k = 0; k < kRowsPerThread; ++k) {
    const long long g = tile0 + (long long)k * kThreads + threadIdx.x;
    if (g >= total && g < n_out) out[g] = 0;
  }
}

}  // namespace

extern "C" {

int m2v_compact_tile() { return kTile; }

// mask: n bytes (0/1), 16-byte aligned.  counts: nb ints, offsets: nb + 1
// ints of scratch, nb = ceil(n / tile).  out: n_out ints, n_out <= n.
int m2v_compact(const void* mask, long long n, void* counts, void* offsets,
                void* out, long long n_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (int)((n + kTile - 1) / kTile);
  if (nb == 0) return (int)cudaGetLastError();
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  count_kernel<<<nb, kThreads, 0, s>>>(m, n, static_cast<int*>(counts));
  scan_kernel<<<1, kScanThreads, 0, s>>>(static_cast<const int*>(counts), nb,
                                         static_cast<int*>(offsets));
  write_kernel<<<nb, kThreads, 0, s>>>(m, n, static_cast<const int*>(offsets),
                                       nb, static_cast<int*>(out), n_out);
  return (int)cudaGetLastError();
}

const char* m2v_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
