// Stream compaction: ascending int32 positions of a boolean mask's true rows.
//
// Replaces mplan2vdl_tpu/engine/kernels/compact.py:compact_positions (the
// Pallas kernel `_kernel`, which left-packs each 8192-row block by log-shift
// rolls and DMAs the packed window to its output offset).  The contract is
// unchanged: out[0:count] are the true rows' indices in ascending order,
// out[count:n_out] are 0, and the output is trimmed to n_out.
//
// Bound on an H100: bytes.  The function must read n mask bytes and write
// 4*n_out position bytes (at 15.9% of 60,003,426 rows: 60.0 MB read, 38.9 MB
// written, 0.0295 ms at 3.35 TB/s); it does no arithmetic worth counting.
//
// Design: ONE launch, a single-pass scan by decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA 2016): the mask is read once, and a call costs one kernel (on the
// engine's many tiny occupancy masks, launches are the whole cost).
//   * Each block takes its tile index from an atomic ticket, not from
//     blockIdx: blocks start in no order, and a tile may wait only on tiles
//     whose blocks are known to be running, those with smaller tickets.
//   * A tile is 32768 rows in 4 chunks; each of 512 threads loads one
//     16-byte vector per chunk (rows 16t.. of the chunk, coalesced across
//     the warp), all four in flight together, and turns each 4 bytes into 4
//     bits with one multiply.  One block-wide scan of the four chunk counts,
//     packed in 16-bit fields of one 64-bit word, ranks every true row; the
//     block packs the rows' 16-bit offsets into 64 KB of shared memory in
//     order.  Large tiles matter: a tile's look-back and publication take
//     about as long as its loads, so fewer, larger tiles keep more of the
//     card loading.
//   * Warp 0 publishes the tile's count (flag AGGREGATE), looks back over
//     its predecessors' status words 32 at a time until it meets an
//     INCLUSIVE prefix, sums what it read, and publishes its own inclusive
//     prefix, backing off 32 ns between polls.  A status word holds epoch,
//     flag and value in one 64-bit word, stored with st.release.gpu and read
//     with ld.acquire.gpu.
//   * The block copies its packed positions to out[exclusive prefix ...)
//     with coalesced stores, dropping those at or past n_out.
// Scratch state, with no fill per call: the ticket is a 64-bit counter that
// is never reset (the wrapper passes how many tickets earlier calls on this
// stream drew, and a block subtracts it), and every status word carries the
// call's epoch (a word of another epoch reads as not yet published).  The
// wrapper zeroes the scratch only when it allocates it, grows it, or the
// 30-bit epoch wraps.
// The zero tail [count, n_out): no tile knows the count while it runs, and a
// tile must not wait for later tiles (their blocks may not be resident).  So
// the wrapper launches `tail` blocks beyond the tiles.  A block whose ticket
// is past the last tile knows that every tile block drew its ticket first
// and is running or done, so it may wait for the last tile's inclusive
// prefix (the count) and then zero its share of [count, n_out).  No tile
// writes there, so the two never race.  A wait of over 2^21 polls (about a
// second) traps: a fault, not a hang.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads * 16;  // one 16-byte load per thread
constexpr int kChunks = 4;
constexpr int kTile = kChunks * kChunk;  // 32768 rows per tile
constexpr size_t kPackedBytes = kTile * sizeof(uint16_t);
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;
constexpr int kEpochShift = 34;
constexpr unsigned kSpinLimit = 1u << 21;

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

// 0 (not published in this call), 1 (aggregate) or 2 (inclusive prefix)
__device__ __forceinline__ unsigned flag_of(unsigned long long w,
                                            unsigned long long tag) {
  return (w >> kEpochShift) == (tag >> kEpochShift) ? (unsigned)(w >> 32) & 3u
                                                    : 0u;
}

__device__ __forceinline__ void spin(unsigned* n) {
  if (++*n > kSpinLimit) __trap();
  __nanosleep(32);
}

// one bit per byte of a 32-bit word, byte k -> bit k
__device__ __forceinline__ unsigned nibble(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}

// bits of the 16 rows starting at `base` (a multiple of 16), in row order
__device__ __forceinline__ unsigned load16(const uint8_t* __restrict__ mask,
                                           long long n, long long base) {
  if (base + 16 <= n) {
    const uint4 w = *reinterpret_cast<const uint4*>(mask + base);
    return nibble(w.x) | nibble(w.y) << 4 | nibble(w.z) << 8 |
           nibble(w.w) << 12;
  }
  unsigned b = 0;
  for (int k = 0; k < 16; ++k) {
    if (base + k < n && mask[base + k] != 0) b |= 1u << k;
  }
  return b;
}

__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint8_t* __restrict__ mask, long long n, int nb,
               unsigned long long* __restrict__ scratch,
               unsigned long long base, unsigned long long tag,
               int* __restrict__ out, long long n_out) {
  extern __shared__ uint16_t packed[];  // kTile row offsets within the tile
  __shared__ unsigned long long warp_tot[kWarps];
  __shared__ long long s_ticket, s_start;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long* status = scratch + 1;
  if (tid == 0) s_ticket = (long long)(atomicAdd(scratch, 1ull) - base);
  __syncthreads();
  const long long t = s_ticket;

  if (t >= nb) {  // a tail block: zero its share of [count, n_out)
    if (tid == 0) {
      unsigned spins = 0;
      unsigned long long w = ld_acquire(&status[nb - 1]);
      while (flag_of(w, tag) != 2u) {
        spin(&spins);
        w = ld_acquire(&status[nb - 1]);
      }
      s_start = (long long)(unsigned)w;
    }
    __syncthreads();
    const long long step = (long long)(gridDim.x - nb) * kThreads;
    for (long long j = s_start + (t - nb) * kThreads + tid; j < n_out;
         j += step)
      out[j] = 0;
    return;
  }

  // rows 16 * tid .. of each of the tile's kChunks chunks
  const long long tile0 = t * kTile;
  unsigned b[kChunks];
#pragma unroll
  for (int q = 0; q < kChunks; ++q)
    b[q] = load16(mask, n, tile0 + q * kChunk + tid * 16);
  // the chunks' counts packed in 16-bit fields (each at most kChunk)
  unsigned long long c = 0;
#pragma unroll
  for (int q = 0; q < kChunks; ++q)
    c |= (unsigned long long)__popc(b[q]) << (16 * q);
  unsigned long long incl = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  unsigned long long before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned long long x = warp_tot[w];
    before += w < warp ? x : 0ull;
    all += x;
  }
  const unsigned long long excl = before + incl - c;
  unsigned agg = 0, rank[kChunks];
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    rank[q] = agg + ((unsigned)(excl >> (16 * q)) & 0xffffu);
    agg += (unsigned)(all >> (16 * q)) & 0xffffu;
  }
  // publish the count at once: successors need it before our look-back ends
  if (tid == 0)
    st_release(&status[t], tag | (t == 0 ? kInclusive : kAggregate) | agg);
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    int r = (int)rank[q];
    unsigned bits = b[q];
    const int off = q * kChunk + tid * 16;
    while (bits) {
      const int k = __ffs(bits) - 1;
      bits &= bits - 1;
      packed[r++] = (uint16_t)(off + k);
    }
  }

  if (warp == 0) {
    unsigned prefix = 0;
    if (t > 0) {
      long long k = t - 1;  // the nearest predecessor not yet summed
      unsigned spins = 0;
      while (true) {
        const long long i = k - lane;
        const unsigned long long w =
            i >= 0 ? ld_acquire(&status[i]) : (tag | kInclusive);
        const unsigned f = flag_of(w, tag);
        const unsigned waiting = __ballot_sync(kFull, f == 0u);
        const unsigned inclusive = __ballot_sync(kFull, f == 2u);
        // lanes up to the nearest inclusive prefix (all 32 if none)
        const int first = inclusive ? __ffs(inclusive) - 1 : 31;
        const unsigned need = first == 31 ? kFull : (2u << first) - 1u;
        if (waiting & need) {
          spin(&spins);
          continue;
        }
        prefix += __reduce_add_sync(kFull, lane <= first ? (unsigned)w : 0u);
        if (inclusive) break;
        k -= 32;
      }
      if (lane == 0) st_release(&status[t], tag | kInclusive | (prefix + agg));
    }
    if (lane == 0) s_start = prefix;
  }
  __syncthreads();
  const long long start = s_start;
  for (int i = tid; i < (int)agg; i += kThreads) {
    const long long dst = start + i;
    if (dst < n_out) out[dst] = (int)(tile0 + packed[i]);
  }
}

}  // namespace

extern "C" {

int m2v_compact_tile() { return kTile; }

// mask: n bytes (0/1), 16-byte aligned.  scratch: 1 + ceil(n / tile)
// 64-bit words, zeroed when allocated: [0] the ticket counter, which has
// handed out `base` tickets on this stream before this call, then one
// status word per tile.  epoch: in [1, 2^30), new for every call on the
// scratch since it was zeroed.  out: n_out ints, n_out <= n.  tail: blocks
// that write the zero tail (0 when n_out is 0).
int m2v_compact(const void* mask, long long n, void* scratch,
                unsigned long long base, long long epoch, void* out,
                long long n_out, int tail, void* stream) {
  const long long nb = (n + kTile - 1) / kTile;
  if (n < 0 || n > 0x7fffffffLL || n_out < 0 || n_out > n || tail < 0 ||
      epoch < 1 || epoch >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaGetLastError();
  const cudaError_t e = cudaFuncSetAttribute(
      compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kPackedBytes);
  if (e != cudaSuccess) return (int)e;
  compact_kernel<<<(unsigned)(nb + tail), kThreads, kPackedBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), n, (int)nb,
      static_cast<unsigned long long*>(scratch), base,
      (unsigned long long)epoch << kEpochShift, static_cast<int*>(out), n_out);
  return (int)cudaGetLastError();
}

const char* m2v_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
