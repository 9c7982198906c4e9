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
// Bound on an H100: bytes.  The function reads the c input columns and the
// group ids once, 4*(c+1)*n bytes (Q1: 7 int32 columns of 60,003,426 rows,
// 0.5015 ms at 3.35 TB/s); its int64 multiplies and adds are a few per row.
//
// Every thread computes a row's value directly in int64 (the spec's `bits`
// bound keeps products and sums below 2^63, so the limb layout,
// RENORM_EVERY and the row layout have no counterpart).  Sums wrap as
// unsigned 64-bit and integer sums do not depend on order, so the result is
// exact and the same on every run.  Specs arrive as a flat int32 word array
// (op, base or -1 for count, factor count, then (const, sign, col) triples)
// in a by-value __grid_constant__ struct together with the column pointers.
//
// Two paths; the wrapper picks one from (n_groups, n_specs):
//
// lane_kernel, the fast path (every family the engine fuses: at most 16
// groups, at most 12 specs).  A shared atomic per row and spec is what held
// the first design back: Q1 occupies 4 of its 8 groups, so a warp's 32
// lanes hit about 4 cells and the hardware serialised them (6.2 ms).  Here
// each lane owns a private copy of the table in shared memory, laid out
// [warp][cell][lane], so a warp's 32 lanes touch 32 distinct words in 32
// distinct bank pairs: a row's update is a plain load, add (or max), store,
// with no atomic and no bank conflict.
//   * Each thread takes 4 consecutive rows (a quad) at a time over a
//     grid-stride run of quads, and copies the quad's values of the columns
//     its specs use, and its group ids, into its own slots of a two-stage
//     shared buffer with 16-byte cp.async, the next quad's copies in flight
//     while it evaluates the current one (the specs index columns at run
//     time, which registers cannot do).
//   * Rows of a quad in one group are merged in registers first; the other
//     rows' cells are then distinct, so the quad's 4 loads issue before its
//     4 stores.  Merged and masked rows update a dump group.
//   * The kernel is a template on the spec count, and each spec's head sits
//     at a fixed place in the parameters, so op, base and factor count are
//     constant operands and the spec loop unrolls.  Read from the word
//     stream at run-time offsets, they cost an instruction each and kept
//     the loop rolled, and evaluation, not the loads, set the time.
//   * A block holds as many warps as its table and buffer fit in 227 KB, at
//     most 16; the grid is one wave of resident blocks.  At the end the
//     block sums (or maxes) each cell over its lanes and warps (warp
//     shuffles) and makes one global atomic per (block, cell).  The last
//     n % 4 rows go through the scalar row loop of block 0.
//
// shared_kernel, the general path (more groups or specs): one shared table
// per block, updated with shared atomicAdd (as unsigned 64-bit) or
// atomicMax per row and spec, flushed with one global atomic per cell.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 16;
constexpr int kMaxWords = 512;
constexpr int kMaxSpecs = 64;
constexpr int kMaxCells = 6144;  // general path: 48 KB of int64 shared memory
constexpr int kThreads = 256;    // general path
constexpr int kMaxWarps = 16;    // fast path
constexpr int kLaneMaxSpecs = 12;  // multiagg.LANE_MAX_SPECS
// 227 KB, the most one block may use, less room for its static arrays
constexpr int kSmemMax = 232448 - 1024;
constexpr unsigned kFull = 0xffffffffu;

// A spec's head at a fixed place in the kernel's parameters: with the spec
// count a template argument, op, base and factor count are constant
// operands.  Its factors stay in the word stream, from word `w`.
struct LaneSpec {
  int op, base, nf, w;
};

struct AggArgs {
  const int32_t* cols[kMaxCols];
  int32_t words[kMaxWords];
  int n_specs;
  int n_groups;
  int ncols;
  LaneSpec specs[kLaneMaxSpecs];
};

// Fast path: shared bytes one warp needs (its table copy, with one dump
// group, and two stages of one int4 per column plus the group ids per lane).
inline long long lane_warp_bytes(int n_groups, int n_specs, int ncols) {
  return (long long)(n_groups + 1) * n_specs * 32 * 8 +
         2LL * (ncols + 1) * 32 * 16;
}

// Fast path's block shape: warps per block, or 0 when one warp's table and
// buffer exceed a block's shared memory.
inline int lane_warps(int n_groups, int n_specs, int ncols) {
  const long long w = kSmemMax / lane_warp_bytes(n_groups, n_specs, ncols);
  return (int)(w < kMaxWarps ? w : kMaxWarps);
}

__device__ __forceinline__ long long lmax(long long x, long long y) {
  return x > y ? x : y;
}

// int64 sums wrap as unsigned 64-bit
__device__ __forceinline__ long long wadd(long long x, long long y) {
  return (long long)((unsigned long long)x + (unsigned long long)y);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// One row, scalar loads: accumulate its value of every spec into `tab`
// (cell (g, s) at tab[(g * n_specs + s) * stride]).
__device__ __forceinline__ void row_update(const AggArgs& a, long long r,
                                           int g, long long* tab, int stride,
                                           bool atomic) {
  int w = 0;
  for (int s = 0; s < a.n_specs; ++s) {
    const int op = a.words[w], base = a.words[w + 1], nf = a.words[w + 2];
    w += 3;
    long long v = base < 0 ? 1LL : (long long)a.cols[base][r];
    for (int f = 0; f < nf; ++f, w += 3) {
      v *= (long long)a.words[w] +
           (long long)a.words[w + 1] * (long long)a.cols[a.words[w + 2]][r];
    }
    long long* p = tab + (long long)(g * a.n_specs + s) * stride;
    if (atomic) {
      if (op == 0) {
        atomicAdd(reinterpret_cast<unsigned long long*>(p),
                  (unsigned long long)v);
      } else {
        atomicMax(p, v);
      }
    } else {
      *p = op == 0 ? wadd(*p, v) : lmax(*p, v);
    }
  }
}

__device__ __forceinline__ void flush_cell(long long* out, int cell, int op,
                                           long long v) {
  if (v == 0) return;  // 0 is the identity of both ops
  if (op == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(out + cell),
              (unsigned long long)v);
  } else {
    atomicMax(out + cell, v);
  }
}

template <int NS>
__global__ void __launch_bounds__(kMaxWarps * 32)
lane_kernel(const __grid_constant__ AggArgs a,
            const int32_t* __restrict__ gid, long long n,
            long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, W = T >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = a.ncols, G = a.n_groups;
  const int cells = (G + 1) * NS;  // group G is the dump group
  long long* acc = reinterpret_cast<long long*>(smem);
  int4* buf = reinterpret_cast<int4*>(smem + (size_t)W * cells * 32 * 8);
  // this thread's slot of stage st, column j (j == nc: the group ids)
  auto slot = [&](int st, int j) { return buf + ((st * (nc + 1) + j) * T + tid); };

  for (int i = tid; i < W * cells * 32; i += T) acc[i] = 0;
  __syncthreads();

  long long* mine = acc + (size_t)warp * cells * 32 + lane;
  const int dump = G * NS * 32;
  const long long nq = n >> 2;
  const long long stride = (long long)gridDim.x * T;
  auto issue = [&](long long q, int st) {
    for (int j = 0; j < nc; ++j) cp_async16(slot(st, j), a.cols[j] + 4 * q);
    cp_async16(slot(st, nc), gid + 4 * q);
  };
  long long q = (long long)blockIdx.x * T + tid;
  int st = 0;
  if (q < nq) issue(q, 0);
  cp_async_commit();
  for (; q < nq; q += stride) {
    if (q + stride < nq) issue(q + stride, st ^ 1);
    cp_async_commit();
    cp_async_wait_prev();  // this quad's copies have landed
    const int4 gq = *slot(st, nc);
    const int gs[4] = {gq.x, gq.y, gq.z, gq.w};
    int o[4];
    bool any = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool ok = gs[k] >= 0 && gs[k] < G;
      o[k] = ok ? gs[k] * NS * 32 : dump;
      any |= ok;
    }
    if (any) {
      // a row whose group an earlier row of the quad has is merged into
      // that row's value (mk: the row it merges into) and its own update
      // goes to the dump group, so the 4 cells p[] are distinct
      const int m1 = o[1] == o[0] ? 0 : 1;
      const int m2 = o[2] == o[0] ? 0 : (o[2] == o[1] ? 1 : 2);
      const int m3 = o[3] == o[0] ? 0 : (o[3] == o[1] ? 1 : (o[3] == o[2] ? 2 : 3));
      const int p[4] = {o[0], m1 == 1 ? o[1] : dump, m2 == 2 ? o[2] : dump,
                        m3 == 3 ? o[3] : dump};
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        // a.specs[s] by value, not by reference: a reference into the
        // parameters would read them through generic loads
        const int op = a.specs[s].op, base = a.specs[s].base;
        const int nf = a.specs[s].nf;
        long long v[4] = {1, 1, 1, 1};
        if (base >= 0) {
          const int4 c = *slot(st, base);
          v[0] = c.x; v[1] = c.y; v[2] = c.z; v[3] = c.w;
        }
        // a loop, not guarded unrolled blocks: predicated blocks would issue
        // every factor slot's multiplies for every spec
        for (int f = 0, w = a.specs[s].w; f < nf; ++f, w += 3) {
          const long long k0 = a.words[w], sg = a.words[w + 1];
          const int4 c = *slot(st, a.words[w + 2]);
          v[0] *= k0 + sg * c.x;
          v[1] *= k0 + sg * c.y;
          v[2] *= k0 + sg * c.z;
          v[3] *= k0 + sg * c.w;
        }
        long long* cell = mine + s * 32;
        long long x[4];
        if (op == 0) {
          v[0] = wadd(v[0], wadd(m1 == 0 ? v[1] : 0,
                                 wadd(m2 == 0 ? v[2] : 0, m3 == 0 ? v[3] : 0)));
          v[1] = wadd(v[1], wadd(m2 == 1 ? v[2] : 0, m3 == 1 ? v[3] : 0));
          v[2] = wadd(v[2], m3 == 2 ? v[3] : 0);
#pragma unroll
          for (int k = 0; k < 4; ++k) x[k] = cell[p[k]];
#pragma unroll
          for (int k = 0; k < 4; ++k) cell[p[k]] = wadd(x[k], v[k]);
        } else {
          v[0] = lmax(v[0], lmax(m1 == 0 ? v[1] : 0,
                                 lmax(m2 == 0 ? v[2] : 0, m3 == 0 ? v[3] : 0)));
          v[1] = lmax(v[1], lmax(m2 == 1 ? v[2] : 0, m3 == 1 ? v[3] : 0));
          v[2] = lmax(v[2], m3 == 2 ? v[3] : 0);
#pragma unroll
          for (int k = 0; k < 4; ++k) x[k] = cell[p[k]];
#pragma unroll
          for (int k = 0; k < 4; ++k) cell[p[k]] = lmax(x[k], v[k]);
        }
      }
    }
    st ^= 1;
  }
  cp_async_wait_all();
  // the last n % 4 rows, scalar, into this thread's own lane copy
  if (blockIdx.x == 0 && tid < n - 4 * nq) {
    const long long r = 4 * nq + tid;
    const int g = gid[r];
    if (g >= 0 && g < G) row_update(a, r, g, mine, 32, false);
  }
  __syncthreads();

  // each warp folds its share of the cells over every lane and warp copy
  for (int c = warp; c < G * NS; c += W) {
    const int op = a.specs[c % NS].op;
    long long v = 0;
    for (int w2 = 0; w2 < W; ++w2) {
      const long long x = acc[((size_t)w2 * cells + c) * 32 + lane];
      v = op == 0 ? wadd(v, x) : lmax(v, x);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const long long y = __shfl_xor_sync(kFull, v, d);
      v = op == 0 ? wadd(v, y) : lmax(v, y);
    }
    if (lane == 0) flush_cell(out, c, op, v);
  }
}

__global__ void __launch_bounds__(kThreads)
shared_kernel(const __grid_constant__ AggArgs a,
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
    row_update(a, r, g, tab, 1, true);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += kThreads)
    flush_cell(out, i, spec_op[i % a.n_specs], tab[i]);
}

// lane_kernel for a spec count in [1, kLaneMaxSpecs]
const void* lane_fn(int n_specs) {
  switch (n_specs) {
    case 1: return (const void*)lane_kernel<1>;
    case 2: return (const void*)lane_kernel<2>;
    case 3: return (const void*)lane_kernel<3>;
    case 4: return (const void*)lane_kernel<4>;
    case 5: return (const void*)lane_kernel<5>;
    case 6: return (const void*)lane_kernel<6>;
    case 7: return (const void*)lane_kernel<7>;
    case 8: return (const void*)lane_kernel<8>;
    case 9: return (const void*)lane_kernel<9>;
    case 10: return (const void*)lane_kernel<10>;
    case 11: return (const void*)lane_kernel<11>;
    case 12: return (const void*)lane_kernel<12>;
  }
  return nullptr;
}
static_assert(kLaneMaxSpecs == 12, "lane_fn covers 1 .. kLaneMaxSpecs");

// The fast path reads only the columns its specs use: renumber them, in
// the word stream and in the spec descriptors, in order of first use.
void lane_args(AggArgs* a, const void* const* cols) {
  int slot_of[kMaxCols];
  for (int j = 0; j < kMaxCols; ++j) slot_of[j] = -1;
  int used = 0;
  auto remap = [&](int32_t* c) {
    if (slot_of[*c] < 0) {
      slot_of[*c] = used;
      a->cols[used++] = static_cast<const int32_t*>(cols[*c]);
    }
    *c = slot_of[*c];
  };
  int w = 0;
  for (int s = 0; s < a->n_specs; ++s) {
    LaneSpec& sp = a->specs[s];
    sp.op = a->words[w];
    if (a->words[w + 1] >= 0) remap(&a->words[w + 1]);
    sp.base = a->words[w + 1];
    sp.nf = a->words[w + 2];
    sp.w = w + 3;
    for (int f = 0; f < sp.nf; ++f) remap(&a->words[w + 5 + 3 * f]);
    w += 3 + 3 * sp.nf;
  }
  for (int j = used; j < kMaxCols; ++j) a->cols[j] = nullptr;
  a->ncols = used;
}

}  // namespace

extern "C" {

// cols: host array of ncols device pointers to int32[n]; gid: int32[n];
// words: host array of n_words spec words; out: zeroed int64
// [n_groups, n_specs] on the device.  lane != 0 takes the fast path (at
// most kLaneMaxSpecs specs), whose pointers must be 16-byte aligned.
int m2v_multiagg(const void* const* cols, int ncols, const void* gid,
                 long long n, const int* words, int n_words, int n_specs,
                 int n_groups, int lane, void* out, void* stream) {
  if (ncols < 0 || ncols > kMaxCols || n_words < 0 || n_words > kMaxWords ||
      n_specs < 1 || n_specs > kMaxSpecs || n_groups < 1 ||
      n_groups * n_specs > kMaxCells || (lane && n_specs > kLaneMaxSpecs))
    return (int)cudaErrorInvalidValue;
  AggArgs a = {};
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
  a.ncols = ncols;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* g = static_cast<const int32_t*>(gid);
  long long* o = static_cast<long long*>(out);
  if (!lane) {
    const long long want = (n + kThreads - 1) / kThreads;
    const int blocks = (int)(want < 2048 ? want : 2048);
    const size_t shmem = (size_t)n_groups * n_specs * sizeof(long long);
    shared_kernel<<<blocks, kThreads, shmem, st>>>(a, g, n, o);
    return (int)cudaGetLastError();
  }
  lane_args(&a, cols);
  const int warps = lane_warps(n_groups, n_specs, a.ncols);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const void* fn = lane_fn(n_specs);
  const int threads = warps * 32;
  const size_t shmem =
      (size_t)warps * lane_warp_bytes(n_groups, n_specs, a.ncols);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, threads, shmem)) != cudaSuccess)
    return (int)e;
  const long long quads = n >> 2;
  const long long want = quads > 0 ? (quads + threads - 1) / threads : 1;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(want < wave ? want : wave);
  void* args[] = {&a, &g, &n, &o};
  e = cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, shmem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
