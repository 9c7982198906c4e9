// Gather of k sources through one shared vector of positions.
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
// into the source) applied once per row and shared by the k sources.  Any
// order of positions is right; the engine gives ascending ones (compactions,
// the join expansion), sort permutations and unordered probes.
//
// Bound on an H100: bytes.  The function reads the m positions, the source
// elements they select and writes m output elements per source: m * (pos
// bytes + 2 * sum of element sizes) at 3.35 TB/s.  Memory moves whole
// 32-byte sectors, so a scattered selection reads more than that: at the
// filter-project's 15.9% density about 76% of an int32 source's sectors
// (50% of an int64 source's) hold a selected element, and a permutation
// reads about one sector per row.  Dense runs (the join expansion's
// identity positions) can reach the byte bound; a permutation of a source
// larger than L2 is bound by the rate of random 32-byte reads.
//
// Design: V rows per thread (kRows: 2 for up to three sources, 1 above),
// warp-interleaved: a warp owns a tile of 32 * V consecutive rows and lane
// l takes rows l, l + 32, ..., so each load and store instruction of a warp
// covers 32 consecutive rows.  At 15.9% density such a load spans about 7
// of the source's 128-byte lines; 16-byte vector accesses would put a
// lane's rows side by side and make every load span ~23 lines, and the L1
// serves one line per cycle (a first version did so, and on an H100 SXM it
// ran 6% slower than one row per thread at k = 4 int32 and 65% slower at
// k = 8 int64).
//   * The launcher splits the sources into an int32 and an int64 group, and
//     the kernel is instantiated on the two counts (K4 + K8 <= 8) and the
//     position type: typed pointers, register arrays, no element-size
//     branch.  The tail repeat and the clip happen in registers.
//   * Every source load of the V rows is issued before the first store, so
//     a thread has V * k loads in flight rather than one, and the position
//     and source latencies are paid once per V rows, not once per row and
//     source.  At one to three sources two rows beat one by up to 6% (k =
//     1), and four or eight rows gained nothing; from four sources one row
//     is as fast or faster.  At most 32 registers and no spills, so 8
//     blocks of 256 threads stay resident on an SM; two rows at k = 8
//     int64 took 48 registers (5 blocks) and ran no faster than one.
//   * Any alignment of the position and source views is taken as it is
//     (every access is a coalesced scalar), and the last tile's rows past
//     m load a valid row and store nothing.
//   * One warp per tile and no cap on the grid: capping it at two waves of
//     resident blocks that stride over the tiles ran up to 17% slower
//     through a sort permutation.
// TMA and wgmma do not apply: this is an element gather whose addresses
// depend on the data, and the TMA copies tiles, not scattered elements.
// `valid` comes either as a host integer or, when the count is still on the
// device, through a pointer, so no host round trip is needed.

#include <cuda_runtime.h>

#include <array>
#include <utility>

namespace {

constexpr int kMaxSrc = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// rows per thread of an instantiation with K4 int32 and K8 int64 sources:
// two up to three sources, one above (on an H100, two rows at k = 4 int32
// ran 1% slower than one, and no slower or faster at k = 8 int64)
template <int K4, int K8>
constexpr int kRows = K4 + K8 <= 3 ? 2 : 1;

struct GatherArgs {
  const int* s4[kMaxSrc];
  int* o4[kMaxSrc];
  const long long* s8[kMaxSrc];
  long long* o8[kMaxSrc];
};

// Warp w owns rows [w * 32 V, (w + 1) * 32 V); lane l of it takes rows
// l, l + 32, ..., l + 32 (V - 1) of the tile, so every load and store
// instruction of a warp covers 32 consecutive rows.
template <int K4, int K8, typename P>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const __grid_constant__ GatherArgs a, const P* __restrict__ pos,
              long long m, long long n, long long valid_host,
              const long long* __restrict__ valid_dev) {
  constexpr int V = kRows<K4, K8>;
  const int lane = threadIdx.x & 31;
  const long long t0 =
      ((long long)blockIdx.x * kWarps + threadIdx.x / 32) * (32 * V);
  if (t0 >= m) return;  // the last block's warps past the last tile
  const long long valid = valid_dev ? *valid_dev : valid_host;
  const long long vlast = min(max(valid - 1, 0LL), m - 1);
  // positions above the largest P cannot occur, so the clip stays in P
  const P hi = (P)(sizeof(P) == 4 ? min(n - 1, 2147483647LL) : n - 1);
  const long long i0 = t0 + lane;
  P q[V];
#pragma unroll
  for (int r = 0; r < V; ++r) {
    const long long i = i0 + 32 * r;
    // rows past m (the last tile's ragged end) read row m - 1, store
    // nothing; rows past valid repeat the last valid position
    q[r] = __ldg(pos + (i < valid ? min(i, m - 1) : vlast));
    q[r] = min(max(q[r], (P)0), hi);
  }
  // every load of the V rows, then every store
  int v4[K4 > 0 ? K4 : 1][V];
  long long v8[K8 > 0 ? K8 : 1][V];
#pragma unroll
  for (int j = 0; j < K4; ++j)
#pragma unroll
    for (int r = 0; r < V; ++r) v4[j][r] = __ldg(a.s4[j] + q[r]);
#pragma unroll
  for (int j = 0; j < K8; ++j)
#pragma unroll
    for (int r = 0; r < V; ++r) v8[j][r] = __ldg(a.s8[j] + q[r]);
#pragma unroll
  for (int r = 0; r < V; ++r) {
    const long long i = i0 + 32 * r;
    if (i < m) {
#pragma unroll
      for (int j = 0; j < K4; ++j) a.o4[j][i] = v4[j][r];
#pragma unroll
      for (int j = 0; j < K8; ++j) a.o8[j][i] = v8[j][r];
    }
  }
}

// one instantiation: its launch (one warp per tile of rows) and its
// resident blocks per SM; only K4 + K8 in [1, kMaxSrc] is compiled
template <int K4, int K8, typename P>
struct Inst {
  static constexpr bool kValid = K4 + K8 >= 1 && K4 + K8 <= kMaxSrc;

  static int launch(const GatherArgs& a, const void* pos, long long m,
                    long long n, long long valid_host,
                    const long long* valid_dev, cudaStream_t s) {
    if constexpr (!kValid) {
      return (int)cudaErrorInvalidValue;
    } else {
      constexpr long long tile = 32 * kRows<K4, K8>;
      const long long tiles = (m + tile - 1) / tile;
      const int blocks = (int)((tiles + kWarps - 1) / kWarps);
      gather_kernel<K4, K8, P><<<blocks, kThreads, 0, s>>>(
          a, static_cast<const P*>(pos), m, n, valid_host, valid_dev);
      return (int)cudaGetLastError();
    }
  }

  static int blocks_per_sm() {
    if constexpr (!kValid) {
      return -(int)cudaErrorInvalidValue;
    } else {
      int b = 0;
      const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &b, gather_kernel<K4, K8, P>, kThreads, 0);
      return e == cudaSuccess ? b : -(int)e;
    }
  }
};

struct Entry {
  int (*launch)(const GatherArgs&, const void*, long long, long long,
                long long, const long long*, cudaStream_t);
  int (*blocks_per_sm)();
};

// one entry per (K4, K8) pair, K4 * (kMaxSrc + 1) + K8
template <typename P, int... I>
constexpr std::array<Entry, sizeof...(I)> table(
    std::integer_sequence<int, I...>) {
  return {{Entry{&Inst<I / (kMaxSrc + 1), I % (kMaxSrc + 1), P>::launch,
                 &Inst<I / (kMaxSrc + 1), I % (kMaxSrc + 1),
                       P>::blocks_per_sm}...}};
}

constexpr auto kTable4 =
    table<int>(std::make_integer_sequence<int, (kMaxSrc + 1) * (kMaxSrc + 1)>{});
constexpr auto kTable8 = table<long long>(
    std::make_integer_sequence<int, (kMaxSrc + 1) * (kMaxSrc + 1)>{});

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
  if (k < 1 || k > kMaxSrc || n < 1 || m < 0 ||
      (pos_esize != 4 && pos_esize != 8))
    return (int)cudaErrorInvalidValue;
  GatherArgs a = {};
  int k4 = 0, k8 = 0;
  for (int j = 0; j < k; ++j) {
    if (esizes[j] == 4) {
      a.s4[k4] = static_cast<const int*>(srcs[j]);
      a.o4[k4++] = static_cast<int*>(outs[j]);
    } else if (esizes[j] == 8) {
      a.s8[k8] = static_cast<const long long*>(srcs[j]);
      a.o8[k8++] = static_cast<long long*>(outs[j]);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (m == 0) return (int)cudaGetLastError();
  const auto& tab = pos_esize == 4 ? kTable4 : kTable8;
  return tab[k4 * (kMaxSrc + 1) + k8].launch(
      a, pos, m, n, valid_host, static_cast<const long long*>(valid_dev),
      static_cast<cudaStream_t>(stream));
}

// resident blocks per SM of the kernel that m2v_gather launches for k4
// int32 and k8 int64 sources and positions of pos_esize bytes (negative: a
// CUDA error)
int m2v_gather_blocks_per_sm(int k4, int k8, int pos_esize) {
  if (k4 < 0 || k8 < 0 || k4 + k8 < 1 || k4 + k8 > kMaxSrc ||
      (pos_esize != 4 && pos_esize != 8))
    return -(int)cudaErrorInvalidValue;
  const auto& tab = pos_esize == 4 ? kTable4 : kTable8;
  return tab[k4 * (kMaxSrc + 1) + k8].blocks_per_sm();
}

}  // extern "C"
