// Digit rank of an LSD radix pass: for each element, its inclusive 1-based
// rank among the elements of its 8192-element block that share its digit.
//
// Replaces the Pallas kernel of mplan2vdl_tpu/tools/probe_radix.py:
// rank_kernel (each (64, 128) block one-hot encodes its 2^nbits digits and
// scans them with lower-triangular f32 matmuls on the MXU, one static
// unroll per digit, because Mosaic has no cumsum lowering).  The contract
// is unchanged:
//   out[i] = #{ j in block(i) : j <= i, x[j] & (R - 1) == x[i] & (R - 1) }
// with R = 2^nbits, blocks of 8192 elements in flat order.
//
// Bound on an H100: bytes.  The function reads 4 bytes and writes 4 bytes
// per element; the rank needs a few integer operations per element.
//
// Design: one block of 256 threads per 8192-element block, walking it in
// flat order in 32 rounds of 256 elements.  In a round each warp finds the
// lanes that share a lane's digit with __match_any_sync; the popcount of
// those peers at or below the lane is its rank inside the warp.  The lowest
// peer writes the warp's count of that digit into a shared [8 warps x R]
// table; a lane adds the counts of its digit in the warps before its own
// and the digit's running total from earlier rounds.  Then each warp's
// lowest peer adds its count to the running total and clears its table
// entry.  R running totals carry from round to round: a table of counts for
// every chunk of a whole block would be [chunks x R] (256 x 256 x 4 bytes
// at R = 256), more than a block's shared memory.  All-equal digits are
// the worst case of __match_any_sync (one group of 32 peers) and are
// checked on the card with the rest.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 8192;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = kBlock / kThreads;
constexpr int kMaxDigits = 256;

__global__ void __launch_bounds__(kThreads)
rank_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
            int digits) {
  __shared__ int running[kMaxDigits];
  __shared__ int wcnt[kWarps][kMaxDigits];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kMaxDigits; i += kThreads) running[i] = 0;
  for (int i = tid; i < kWarps * kMaxDigits; i += kThreads)
    (&wcnt[0][0])[i] = 0;
  __syncthreads();
  const unsigned at_or_below = 0xffffffffu >> (31 - lane);
  const long long base = (long long)blockIdx.x * kBlock + tid;
  for (int r = 0; r < kRounds; ++r) {
    const long long e = base + r * kThreads;
    const int d = x[e] & (digits - 1);
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int count = __popc(peers);
    const bool leader = lane == __ffs(peers) - 1;
    if (leader) wcnt[warp][d] = count;
    __syncthreads();
    int rank = running[d] + __popc(peers & at_or_below);
    for (int w = 0; w < warp; ++w) rank += wcnt[w][d];
    out[e] = rank;
    __syncthreads();  // every lane has read this round's counts
    if (leader) {
      atomicAdd(&running[d], count);
      wcnt[warp][d] = 0;
    }
    __syncwarp();  // the clear lands before the next round's write
  }
}

}  // namespace

extern "C" {

// x, out: int32[n] on the device, n a multiple of 8192; 1 <= nbits <= 8.
int m2v_radix_rank(const void* x, void* out, long long n, int nbits,
                   void* stream) {
  if (n < 0 || n % kBlock != 0 || nbits < 1 || nbits > 8 ||
      n / kBlock > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  rank_kernel<<<(unsigned)(n / kBlock), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), 1 << nbits);
  return (int)cudaGetLastError();
}

}  // extern "C"
