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
// Design: one block of 8 warps per 8192-element block, and two block-wide
// barriers in all.
//   * Each warp owns 1024 consecutive keys of the block.  Lane l loads keys
//     r * 32 + l of its warp's run for r < 32 before any compute: 32
//     coalesced loads in flight per thread, so the card has enough bytes in
//     flight to stream at its memory rate.
//   * Warp-local ranking, with no block barrier: in round r the lanes that
//     share a lane's digit are the AND of nbits ballots (each bit's ballot,
//     or its complement, as CUB's block radix rank does; the complement is
//     an XOR with bit - 1, so a bit costs a ballot and one logic op, where
//     a select compiles to more).  The lowest such peer reads the warp's
//     running count of the digit from a warp-private row of shared memory
//     and raises it by the peers' number, and a shuffle hands the old count
//     to the other peers.  Each lane keeps its key's rank inside the warp,
//     packed with its digit, in the register that held the key.
//   * One __syncthreads; then one thread per digit turns the 8 warps' counts
//     of its digit into exclusive offsets, in place; one more
//     __syncthreads, and each lane adds its warp's offset of each key's digit
//     and stores the 32 ranks, coalesced.
// Shared memory holds 8 x R counts (8 KB at R = 256).  nbits is a template
// parameter, so the ballot loop unrolls.  All-equal digits (one group of 32
// peers every round) and digits that change at each warp's run are checked
// on the card with the rest.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 8192;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpKeys = kBlock / kWarps;  // 1024
constexpr int kRounds = kWarpKeys / 32;     // 32
constexpr unsigned kFull = 0xffffffffu;

template <int NBITS>
__global__ void __launch_bounds__(kThreads)
rank_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out) {
  constexpr int R = 1 << NBITS;
  // per warp: the running count of each digit, then its exclusive offset
  __shared__ int count[kWarps][R];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base =
      (long long)blockIdx.x * kBlock + warp * kWarpKeys + lane;
  int v[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) v[r] = __ldcs(x + base + r * 32);
  int* const mine = count[warp];
  for (int d = lane; d < R; d += 32) mine[d] = 0;
  __syncwarp();
  const unsigned at_or_below = kFull >> (31 - lane);
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int d = v[r] & (R - 1);
    unsigned peers = kFull;
#pragma unroll
    for (int b = 0; b < NBITS; ++b) {
      const unsigned bit = (d >> b) & 1;  // bit - 1 is 0 or all ones
      peers &= __ballot_sync(kFull, bit) ^ (bit - 1u);
    }
    const int leader = __ffs(peers) - 1;
    int before = 0;
    if (lane == leader) {
      before = mine[d];
      mine[d] = before + __popc(peers);
    }
    before = __shfl_sync(kFull, before, leader);
    // the rank inside the warp is at most 1024: 11 bits above the digit
    v[r] = (before + __popc(peers & at_or_below)) << NBITS | d;
    __syncwarp();  // this round's count lands before the next round reads
  }
  __syncthreads();
  if (tid < R) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = count[w][tid];
      count[w][tid] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    __stcs(out + base + r * 32, (v[r] >> NBITS) + mine[v[r] & (R - 1)]);
}

template <int NBITS>
void launch(const int32_t* x, int32_t* out, long long blocks,
            cudaStream_t s) {
  rank_kernel<NBITS><<<(unsigned)blocks, kThreads, 0, s>>>(x, out);
}

}  // namespace

extern "C" {

// x, out: int32[n] on the device, n a multiple of 8192; 1 <= nbits <= 8.
int m2v_radix_rank(const void* x, void* out, long long n, int nbits,
                   void* stream) {
  if (n < 0 || n % kBlock != 0 || nbits < 1 || nbits > 8 ||
      n / kBlock > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int32_t* xi = static_cast<const int32_t*>(x);
  int32_t* o = static_cast<int32_t*>(out);
  const long long blocks = n / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 1: launch<1>(xi, o, blocks, s); break;
    case 2: launch<2>(xi, o, blocks, s); break;
    case 3: launch<3>(xi, o, blocks, s); break;
    case 4: launch<4>(xi, o, blocks, s); break;
    case 5: launch<5>(xi, o, blocks, s); break;
    case 6: launch<6>(xi, o, blocks, s); break;
    case 7: launch<7>(xi, o, blocks, s); break;
    default: launch<8>(xi, o, blocks, s); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
