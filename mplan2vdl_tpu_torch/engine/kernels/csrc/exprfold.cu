// Expression fold: a one-group fold's mask and payload trees, evaluated in
// registers in one pass over their leaf columns, and reduced on the card.
// Group ids: a fused family's mask and group-key trees, evaluated the same
// way, and written out as each row's int32 group id.
//
// Replaces no TPU kernel.  On the TPU, XLA fused a fold over a constant key
// (Q6: five compares against constants, four LogAnds, a Mul, a masked sum)
// into one loop over the columns, and likewise a fused aggregate's group
// ids (Q1: ``(l_returnflag << 1) | l_linestatus`` clamped to its eight
// pivots by ``Partition``, -1 where ``l_shipdate <= k`` fails).  Evaluated
// node by node with torch ops, the same trees are about fifteen (Q6) and
// nine (Q1) full-length passes and the casts between them.  The engine's
// plan (engine/exprfold.py) turns the two trees into one postfix program;
// these kernels run it.
//
// Bound on an H100: bytes.  The fold reads each leaf column once (Q6: four
// int32 columns of 60,003,426 rows, 0.96 GB, 0.287 ms at 3.35 TB/s) and
// writes three int64 words.  The group ids read each leaf column once and
// write one int32 a row (Q1: three int32 columns and the ids, 0.96 GB,
// 0.287 ms).
//
// Design:
//   * The program is a stack machine run by every thread over its own rows,
//     4 at a time (one 16-byte load per int32 leaf; 32 bytes for int64, 8
//     for int16, 4 for int8 and bool), each leaf loaded once before the
//     program runs, over a grid-stride run of quads: at most 4 blocks of
//     256 threads per SM.  The step's word and immediate come from the
//     parameters, the same for every lane: one warp-uniform switch a step,
//     no divergence.
//   * The stack lives in registers with its top in slot 0, so that every
//     op reads its operands at fixed places: the switch on the step's kind
//     computes the new top from the top, the slot below it, the leaves and
//     the immediate, and a uniform branch shifts the other slots for a push
//     or a pop.  A register file indexed at run time would live in local
//     memory.
//   * The dispatch costs about as much as an op, so the plan fuses the
//     common pairs into one step: a leaf against a constant (push
//     op(leaf, k)), a LogAnd with such a compare (top && cmp(leaf, k)), an
//     op with a leaf operand (op(top, leaf)).  Q6 is 7 steps, Q1's ids 3.
//   * Values are 32-bit where every leaf, immediate and step result of the
//     program fits (Q6, Q1), else 64-bit.  An arithmetic step's result is
//     narrowed to its node's dtype (int32 or int64), as the engine's
//     ``.to(dt)`` does; compares and logical ops give 0 or 1.  The payload
//     is narrowed to the fold's dtype and reduced in int64.
//   * The kernels are templates on the value width, the leaf count and the
//     stack size, so that a small program holds few registers: the fold
//     kernel at 2, 4 or 8 leaves and 3, 5 or 8 slots (18 kernels), the
//     group-id kernel at 4 leaves and 3 slots (Q1's ids and any key as
//     small) or 8 and 8 in 32 bits, and 8 and 8 in 64: 3 kernels, since
//     each instance compiles the whole step switch anew.
//   * Each fold thread reduces its rows in int64 (sums wrap as unsigned
//     64-bit: exact whatever the order); then warp shuffles, the block, and
//     one atomic per block into out[0] (sum or extreme) and out[1] (count),
//     which the entry point zeroes.  An extreme travels as an unsigned key
//     that orders as the value does (min: reversed), so a zero word is the
//     identity and atomicMax on unsigned 64-bit merges the blocks; the last
//     block to finish (a ticket in out[2]) turns the key back into the
//     value.
//   * Each group-id thread turns its 4 (mask, key) pairs into ids in 64-bit
//     arithmetic (the key less the lowest pivot, clamped to the pivots, as
//     the engine's int64 ``Partition`` computes it) and writes them with
//     one 16-byte store; nothing is reduced.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxLeaves = 8;  // exprfold.MAX_LEAVES
constexpr int kMaxSteps = 32;  // exprfold.MAX_STEPS
constexpr int kMaxDepth = 8;   // exprfold.MAX_DEPTH
constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows a thread evaluates at a time
constexpr int kBlocksPerSm = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kSign = 0x8000000000000000ull;

// step kinds (exprfold.LEAF, IMM, RR, RI, LRI, ANDLRI, RL): push leaf k;
// push the step's immediate; pop the top two and push op(second, top);
// top -> op(top, immediate); push op(leaf k, immediate) (kLRI + k * kRIOps
// + op); top -> top != 0 && cmp(leaf k, immediate) (kAndLRI + k * 6 + cmp,
// cmp an op from oGt); top -> op(top, leaf k) (kRL + k * kRROps + op)
constexpr int kLeaf = 0, kImm = 8, kRR = 16, kRI = 32, kLRI = 64,
              kAndLRI = 200, kRL = 248, kKinds = 368;
// ops (exprfold.OPS); rsub and shift take an immediate only
enum : int {
  oAdd, oSub, oMul, oMin, oMax, oGt, oLt, oGeq, oLeq, oEq, oNeq, oLAnd,
  oLOr, oBAnd, oBOr, oRSub, oShift
};
constexpr int kRROps = oBOr + 1, kRIOps = oShift + 1, kCmps = 6;
static_assert(kLRI + kMaxLeaves * kRIOps <= kAndLRI &&
                  kAndLRI + kMaxLeaves * kCmps <= kRL &&
                  kRL + kMaxLeaves * kRROps == kKinds,
              "kind ranges overlap");
// leaf dtypes (exprfold.DTYPES)
enum : int { dBool, dI8, dI16, dI32, dI64 };
// fold ops (exprfold.FOLD_OPS)
enum : int { fSum, fMin, fMax };

struct FoldArgs {
  const void* leaf[kMaxLeaves];
  int dtype[kMaxLeaves];
  int nleaf;
  int nsteps;
  int step[kMaxSteps];  // kind | move << 10 | narrow << 12 (see run_step)
  long long imm[kMaxSteps];
  int fold_op;
  int fold32;
};

using u64 = unsigned long long;

// op over values of T (int: every node and leaf of the program fits 32
// bits; long long otherwise), wrapping; a compare gives 0 or 1
template <int O, typename T>
__device__ __forceinline__ T apply(T a, T b) {
  using U = typename std::conditional<sizeof(T) == 4, unsigned, u64>::type;
  if constexpr (O == oAdd) return (T)((U)a + (U)b);
  else if constexpr (O == oSub) return (T)((U)a - (U)b);
  else if constexpr (O == oMul) return (T)((U)a * (U)b);
  else if constexpr (O == oMin) return a < b ? a : b;
  else if constexpr (O == oMax) return a > b ? a : b;
  else if constexpr (O == oGt) return a > b;
  else if constexpr (O == oLt) return a < b;
  else if constexpr (O == oGeq) return a >= b;
  else if constexpr (O == oLeq) return a <= b;
  else if constexpr (O == oEq) return a == b;
  else if constexpr (O == oNeq) return a != b;
  else if constexpr (O == oLAnd) return (a != 0) & (b != 0);
  else if constexpr (O == oLOr) return (a != 0) | (b != 0);
  else if constexpr (O == oBAnd) return a & b;
  else if constexpr (O == oBOr) return a | b;
  else if constexpr (O == oRSub) return (T)((U)b - (U)a);
  else if constexpr (sizeof(T) == 4)  // oShift by b in [-63, 63]
    return b < 0 ? (b <= -32 ? 0 : (T)((U)a << -b)) : a >> (b > 31 ? 31 : b);
  else
    return b < 0 ? (T)((U)a << (int)-b) : a >> (int)b;
}

// a compare's or logical op's 0 or 1 needs no narrowing
template <int O>
constexpr bool kBoolOp = O >= oGt && O <= oLOr;

template <int O, typename T>
__device__ __forceinline__ T narrowed(T v, bool n32) {
  if constexpr (sizeof(T) == 4 || kBoolOp<O>) return v;
  else return n32 ? (T)(int)v : v;
}

// How a step moves the stack: a push (a leaf, an immediate, op(leaf, k))
// shifts every slot down, a two-operand op pops one, the other forms keep
// the depth.
enum : int { mPush, mKeep, mPop };

// One step over a thread's kRows rows.  The stack is DM slots of
// registers with the top in slot 0, so that an op reads its operands at
// fixed places: a switch on the step's kind computes the new top (v) from
// the top (x), the slot below it (y), the leaves and the immediate; then
// the slots move as the step's move says (a uniform branch).  The entry
// point validated the program: it never needs a slot past DM.
template <int DM, int NL, typename T>
__device__ __forceinline__ void run_step(int word, T k, T (&st)[DM][kRows],
                                         const T (&lv)[NL][kRows]) {
  const int kind = word & 0x3ff, move = (word >> 10) & 3;
  const bool n32 = (word >> 12) & 1;
  const T(&x)[kRows] = st[0];
  const T(&y)[kRows] = st[DM > 1 ? 1 : 0];
  T v[kRows];
  auto fill = [&](auto f) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) v[i] = f(i);
  };
  switch (kind) {
#define M2V_LEAF(K)                                                 \
  case kLeaf + K:                                                   \
    fill([&](int i) { return lv[K < NL ? K : 0][i]; });             \
    break;
    M2V_LEAF(0) M2V_LEAF(1) M2V_LEAF(2) M2V_LEAF(3)
    M2V_LEAF(4) M2V_LEAF(5) M2V_LEAF(6) M2V_LEAF(7)
#undef M2V_LEAF
    case kImm:
      fill([&](int) { return k; });
      break;
#define M2V_RR(O)                                                         \
  case kRR + O:                                                           \
    fill([&](int i) { return narrowed<O>(apply<O>(y[i], x[i]), n32); });  \
    break;
    M2V_RR(oAdd) M2V_RR(oSub) M2V_RR(oMul) M2V_RR(oMin) M2V_RR(oMax)
    M2V_RR(oGt) M2V_RR(oLt) M2V_RR(oGeq) M2V_RR(oLeq) M2V_RR(oEq)
    M2V_RR(oNeq) M2V_RR(oLAnd) M2V_RR(oLOr) M2V_RR(oBAnd) M2V_RR(oBOr)
#undef M2V_RR
#define M2V_RI(O)                                                         \
  case kRI + O:                                                           \
    fill([&](int i) { return narrowed<O>(apply<O>(x[i], k), n32); });     \
    break;
    M2V_RI(oAdd) M2V_RI(oSub) M2V_RI(oMul) M2V_RI(oMin) M2V_RI(oMax)
    M2V_RI(oGt) M2V_RI(oLt) M2V_RI(oGeq) M2V_RI(oLeq) M2V_RI(oEq)
    M2V_RI(oNeq) M2V_RI(oLAnd) M2V_RI(oLOr) M2V_RI(oBAnd) M2V_RI(oBOr)
    M2V_RI(oRSub) M2V_RI(oShift)
#undef M2V_RI
#define M2V_LRI(K, O)                                                 \
  case kLRI + K * kRIOps + O:                                         \
    if constexpr (K < NL)                                             \
      fill([&](int i) {                                               \
        return narrowed<O>(apply<O>(lv[K < NL ? K : 0][i], k), n32);  \
      });                                                             \
    break;
#define M2V_LRI_ALL(K)                                                \
  M2V_LRI(K, oAdd) M2V_LRI(K, oSub) M2V_LRI(K, oMul) M2V_LRI(K, oMin) \
  M2V_LRI(K, oMax) M2V_LRI(K, oGt) M2V_LRI(K, oLt) M2V_LRI(K, oGeq)   \
  M2V_LRI(K, oLeq) M2V_LRI(K, oEq) M2V_LRI(K, oNeq) M2V_LRI(K, oLAnd) \
  M2V_LRI(K, oLOr) M2V_LRI(K, oBAnd) M2V_LRI(K, oBOr)                 \
  M2V_LRI(K, oRSub) M2V_LRI(K, oShift)
    M2V_LRI_ALL(0) M2V_LRI_ALL(1) M2V_LRI_ALL(2) M2V_LRI_ALL(3)
    M2V_LRI_ALL(4) M2V_LRI_ALL(5) M2V_LRI_ALL(6) M2V_LRI_ALL(7)
#undef M2V_LRI_ALL
#undef M2V_LRI
#define M2V_AND(K, C)                                                 \
  case kAndLRI + K * kCmps + C:                                       \
    if constexpr (K < NL)                                             \
      fill([&](int i) {                                               \
        return (T)((x[i] != 0) &                                      \
                   (apply<oGt + C>(lv[K < NL ? K : 0][i], k) != 0));  \
      });                                                             \
    break;
#define M2V_AND_ALL(K)                                                \
  M2V_AND(K, 0) M2V_AND(K, 1) M2V_AND(K, 2) M2V_AND(K, 3)             \
  M2V_AND(K, 4) M2V_AND(K, 5)
    M2V_AND_ALL(0) M2V_AND_ALL(1) M2V_AND_ALL(2) M2V_AND_ALL(3)
    M2V_AND_ALL(4) M2V_AND_ALL(5) M2V_AND_ALL(6) M2V_AND_ALL(7)
#undef M2V_AND_ALL
#undef M2V_AND
#define M2V_RL(K, O)                                                  \
  case kRL + K * kRROps + O:                                          \
    if constexpr (K < NL)                                             \
      fill([&](int i) {                                               \
        return narrowed<O>(apply<O>(x[i], lv[K < NL ? K : 0][i]), n32);  \
      });                                                             \
    break;
#define M2V_RL_ALL(K)                                                 \
  M2V_RL(K, oAdd) M2V_RL(K, oSub) M2V_RL(K, oMul) M2V_RL(K, oMin)     \
  M2V_RL(K, oMax) M2V_RL(K, oGt) M2V_RL(K, oLt) M2V_RL(K, oGeq)       \
  M2V_RL(K, oLeq) M2V_RL(K, oEq) M2V_RL(K, oNeq) M2V_RL(K, oLAnd)     \
  M2V_RL(K, oLOr) M2V_RL(K, oBAnd) M2V_RL(K, oBOr)
    M2V_RL_ALL(0) M2V_RL_ALL(1) M2V_RL_ALL(2) M2V_RL_ALL(3)
    M2V_RL_ALL(4) M2V_RL_ALL(5) M2V_RL_ALL(6) M2V_RL_ALL(7)
#undef M2V_RL_ALL
#undef M2V_RL
    default:
      fill([&](int i) { return x[i]; });
      break;
  }
  if (move == mPush) {
#pragma unroll
    for (int d = DM - 1; d >= 1; --d) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) st[d][i] = st[d - 1][i];
    }
  } else if (move == mPop) {
#pragma unroll
    for (int d = 1; d + 1 < DM; ++d) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) st[d][i] = st[d + 1][i];
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) st[0][i] = v[i];
}

__device__ __forceinline__ long long scalar_load(const void* p, int dt,
                                                 long long row) {
  switch (dt) {
    case dI64: return static_cast<const long long*>(p)[row];
    case dI32: return static_cast<const int32_t*>(p)[row];
    case dI16: return static_cast<const int16_t*>(p)[row];
    case dI8: return static_cast<const int8_t*>(p)[row];
    default: return static_cast<const uint8_t*>(p)[row];
  }
}

// Rows 4q .. 4q + 3 of leaf p into x[0..3]; rows at or past n read 0.
template <typename T>
__device__ __forceinline__ void load_quad(const void* p, int dt, long long q,
                                          long long n, T* x) {
  if ((q + 1) * 4 > n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = q * 4 + i;
      x[i] = row < n ? (T)scalar_load(p, dt, row) : 0;
    }
    return;
  }
  switch (dt) {
    case dI32: {
      const int4 v = __ldg(static_cast<const int4*>(p) + q);
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } break;
    case dI64: {
      const longlong2* p2 = static_cast<const longlong2*>(p) + 2 * q;
      const longlong2 u = __ldg(p2), w = __ldg(p2 + 1);
      x[0] = (T)u.x; x[1] = (T)u.y; x[2] = (T)w.x; x[3] = (T)w.y;
    } break;
    case dI16: {
      const short4 v = __ldg(static_cast<const short4*>(p) + q);
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } break;
    case dI8: {
      const char4 v = __ldg(static_cast<const char4*>(p) + q);
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } break;
    default: {
      const uchar4 v = __ldg(static_cast<const uchar4*>(p) + q);
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } break;
  }
}

__device__ __forceinline__ long long combine(int op, long long x,
                                             long long y) {
  if (op == fSum) return (long long)((u64)x + (u64)y);
  if (op == fMin) return y < x ? y : x;
  return y > x ? y : x;
}

// an extreme as an unsigned key in its order (min reversed): 0 is the
// identity of both
__device__ __forceinline__ u64 to_key(int op, long long v) {
  const u64 u = (u64)v ^ kSign;
  return op == fMax ? u : ~u;
}
__device__ __forceinline__ long long from_key(int op, u64 u) {
  return (long long)((op == fMax ? u : ~u) ^ kSign);
}

template <typename T, int NL, int DM>
__global__ void __launch_bounds__(kThreads)
expr_fold_kernel(const __grid_constant__ FoldArgs a, long long n,
                 u64* __restrict__ out) {
  const int op = a.fold_op;
  long long acc = op == fSum ? 0 : (op == fMin ? INT64_MAX : INT64_MIN);
  long long cnt = 0;
  const long long nq = (n + kRows - 1) / kRows;
  for (long long q = (long long)blockIdx.x * kThreads + threadIdx.x; q < nq;
       q += (long long)gridDim.x * kThreads) {
    T lv[NL][kRows];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      if (j >= a.nleaf) break;
      load_quad<T>(a.leaf[j], a.dtype[j], q, n, lv[j]);
    }
    T st[DM][kRows];
    for (int s = 0; s < a.nsteps; ++s)
      run_step<DM, NL, T>(a.step[s], (T)a.imm[s], st, lv);
    // the stack holds the payload (top) over the mask
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const bool ok = q * kRows + i < n && st[1][i] != 0;
      const long long v = a.fold32 ? (long long)(int)st[0][i]
                                   : (long long)st[0][i];
      cnt += ok;
      acc = ok ? combine(op, acc, v) : acc;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    acc = combine(op, acc, __shfl_xor_sync(kFull, acc, d));
    cnt += __shfl_xor_sync(kFull, cnt, d);
  }
  __shared__ long long s_acc[kThreads / 32], s_cnt[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_acc[warp] = acc;
    s_cnt[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kThreads / 32; ++w) {
    acc = combine(op, acc, s_acc[w]);
    cnt += s_cnt[w];
  }
  if (cnt > 0) {
    atomicAdd(out + 1, (u64)cnt);
    if (op == fSum) atomicAdd(out, (u64)acc);
    else atomicMax(out, to_key(op, acc));
  }
  if (op == fSum) return;
  // the last block to finish turns the merged key back into the value
  __threadfence();
  if (atomicAdd(out + 2, 1ull) == gridDim.x - 1)
    out[0] = (u64)from_key(op, atomicAdd(out, 0ull));
}

// The program leaves the mask (slot 1) under the key (top): a row's id is
// clamp(key - rmin, 0, hi), computed in 64 bits and wrapping as the
// engine's int64 subtraction does, or -1 where the mask is zero.  Each
// thread writes its 4 ids with one 16-byte store (out is 16-byte aligned).
template <typename T, int NL, int DM>
__global__ void __launch_bounds__(kThreads)
group_ids_kernel(const __grid_constant__ FoldArgs a, long long n,
                 long long rmin, long long hi, int* __restrict__ out) {
  const long long nq = (n + kRows - 1) / kRows;
  for (long long q = (long long)blockIdx.x * kThreads + threadIdx.x; q < nq;
       q += (long long)gridDim.x * kThreads) {
    T lv[NL][kRows];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      if (j >= a.nleaf) break;
      load_quad<T>(a.leaf[j], a.dtype[j], q, n, lv[j]);
    }
    T st[DM][kRows];
    for (int s = 0; s < a.nsteps; ++s)
      run_step<DM, NL, T>(a.step[s], (T)a.imm[s], st, lv);
    int id[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long k = (long long)((u64)(long long)st[0][i] - (u64)rmin);
      id[i] = st[1][i] != 0 ? (int)(k < 0 ? 0 : (k > hi ? hi : k)) : -1;
    }
    if ((q + 1) * kRows <= n) {
      reinterpret_cast<int4*>(out)[q] = make_int4(id[0], id[1], id[2], id[3]);
    } else {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        if (q * kRows + i < n) out[q * kRows + i] = id[i];
    }
  }
}

// The kernels: values of 32 bits (W = 0) or 64, NL leaves and a stack of
// DM slots, at index 9 * W + 3 * leaf_bucket(NL) + depth_bucket(DM).
using KernelFn = void (*)(FoldArgs, long long, u64*);
template <typename T>
KernelFn kernel_of(int i) {
  static const KernelFn fn[9] = {
      expr_fold_kernel<T, 2, 3>, expr_fold_kernel<T, 2, 5>,
      expr_fold_kernel<T, 2, 8>, expr_fold_kernel<T, 4, 3>,
      expr_fold_kernel<T, 4, 5>, expr_fold_kernel<T, 4, 8>,
      expr_fold_kernel<T, 8, 3>, expr_fold_kernel<T, 8, 5>,
      expr_fold_kernel<T, 8, 8>};
  return fn[i];
}

KernelFn kernel_at(int which) {
  return which < 9 ? kernel_of<int>(which) : kernel_of<long long>(which - 9);
}

// The group-id kernels: 32-bit values with at most 4 leaves and 3 slots,
// 32-bit values, and 64-bit values.
using GroupFn = void (*)(FoldArgs, long long, long long, long long, int*);
const GroupFn kGroupFns[3] = {group_ids_kernel<int, 4, 3>,
                              group_ids_kernel<int, 8, 8>,
                              group_ids_kernel<long long, 8, 8>};

inline int leaf_bucket(int x) { return x <= 2 ? 0 : (x <= 4 ? 1 : 2); }
inline int depth_bucket(int x) { return x <= 3 ? 0 : (x <= 5 ? 1 : 2); }

// resident blocks per SM of each kernel and device (0: not asked yet):
// the fold kernels at 0..17, the group-id kernels at 18..20
constexpr int kMaxDevices = 64;
constexpr int kGroupKernels = 18;
int g_per_sm[kMaxDevices][kGroupKernels + 3];
int g_sms[kMaxDevices];

// Checks an entry point's leaves and program and fills ``a``'s leaves and
// steps: every leaf 16-byte aligned and of a dtype of exprfold.DTYPES,
// every step at the depth the stack has, the program leaving two values.
// ``w32``: 32-bit values do (every leaf, immediate and step result fits);
// ``most``: the deepest stack.  0 or the error to return.
int parse_program(const void* const* leaves, const int* dtypes, int nleaf,
                  const int* code, const long long* imm, int nsteps,
                  FoldArgs& a, bool& w32, int& most) {
  if (nleaf < 1 || nleaf > kMaxLeaves || nsteps < 1 || nsteps > kMaxSteps)
    return (int)cudaErrorInvalidValue;
  w32 = true;
  for (int j = 0; j < nleaf; ++j) {
    if (dtypes[j] < dBool || dtypes[j] > dI64 ||
        reinterpret_cast<uintptr_t>(leaves[j]) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    a.leaf[j] = leaves[j];
    a.dtype[j] = dtypes[j];
    w32 &= dtypes[j] != dI64;
  }
  // every step at the depth the stack has; the program leaves two values
  int depth = 0;
  most = 0;
  for (int s = 0; s < nsteps; ++s) {
    const int kind = code[s] & 0x3ff, d = (code[s] >> 10) & 0x3f;
    const int narrow = code[s] >> 16;
    if (d != depth || narrow < 0 || narrow > 1)
      return (int)cudaErrorInvalidValue;
    int move;
    if (kind >= kLeaf && kind < kLeaf + nleaf) {
      move = mPush;
    } else if (kind == kImm) {
      move = mPush;
      w32 &= imm[s] >= INT32_MIN && imm[s] <= INT32_MAX;
    } else if (kind >= kRR && kind < kRR + kRROps) {
      if (depth < 2) return (int)cudaErrorInvalidValue;
      move = mPop;
      w32 &= narrow || (kind - kRR >= oGt && kind - kRR <= oLOr);
    } else if ((kind >= kRI && kind < kRI + kRIOps) ||
               (kind >= kLRI && kind < kLRI + nleaf * kRIOps)) {
      const bool fresh = kind >= kLRI;  // pushes op(leaf, immediate)
      const int op = fresh ? (kind - kLRI) % kRIOps : kind - kRI;
      if ((!fresh && depth < 1) ||
          (op == oShift && (imm[s] < -63 || imm[s] > 63)))
        return (int)cudaErrorInvalidValue;
      move = fresh ? mPush : mKeep;
      w32 &= imm[s] >= INT32_MIN && imm[s] <= INT32_MAX &&
             (narrow || (op >= oGt && op <= oLOr));
    } else if (kind >= kAndLRI && kind < kAndLRI + nleaf * kCmps) {
      if (depth < 1) return (int)cudaErrorInvalidValue;
      move = mKeep;
      w32 &= imm[s] >= INT32_MIN && imm[s] <= INT32_MAX;
    } else if (kind >= kRL && kind < kRL + nleaf * kRROps) {
      if (depth < 1) return (int)cudaErrorInvalidValue;
      const int op = (kind - kRL) % kRROps;
      move = mKeep;
      w32 &= narrow || (op >= oGt && op <= oLOr);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    depth += move == mPush ? 1 : (move == mPop ? -1 : 0);
    if (depth > kMaxDepth) return (int)cudaErrorInvalidValue;
    most = depth > most ? depth : most;
    a.step[s] = kind | move << 10 | narrow << 12;
    a.imm[s] = imm[s];
  }
  if (depth != 2) return (int)cudaErrorInvalidValue;
  a.nleaf = nleaf;
  a.nsteps = nsteps;
  return 0;
}

// The grid of kernel ``fn`` (slot ``slot`` of g_per_sm) over n rows: one
// quad a thread, at most one wave of kBlocksPerSm blocks an SM (fewer
// where fewer fit), at least one block.
cudaError_t grid_of(const void* fn, int slot, long long n, int& blocks) {
  int dev = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_per_sm[dev][slot] == 0) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fn, kThreads, 0)) != cudaSuccess)
      return e;
    g_sms[dev] = sms;
    g_per_sm[dev][slot] =
        per_sm < 1 ? 1 : (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
  }
  const long long want = (n + kThreads * kRows - 1) / (kThreads * kRows);
  const long long wave = (long long)g_sms[dev] * g_per_sm[dev][slot];
  blocks = (int)(want < 1 ? 1 : (want < wave ? want : wave));
  return cudaSuccess;
}

}  // namespace

extern "C" {

// leaves: host array of nleaf device pointers, each 16-byte aligned, to n
// rows of dtypes[j] (exprfold.DTYPES).  code/imm: the program's nsteps
// steps (kind | depth << 10 | narrow << 16) and immediates.  fold_op:
// exprfold.FOLD_OPS; fold32: the payload is narrowed to int32.  out: int64
// [3] on the device, which this call zeroes; out[0] the sum or extreme
// (the identity where no row is kept), out[1] the count of kept rows.
int m2v_expr_fold(const void* const* leaves, const int* dtypes, int nleaf,
                  long long n, const int* code, const long long* imm,
                  int nsteps, int fold_op, int fold32, void* out,
                  void* stream) {
  if (n < 0 || fold_op < fSum || fold_op > fMax || out == nullptr)
    return (int)cudaErrorInvalidValue;
  FoldArgs a = {};
  bool w32 = true;
  int most = 0;
  int rc = parse_program(leaves, dtypes, nleaf, code, imm, nsteps, a, w32,
                         most);
  if (rc != 0) return rc;
  a.fold_op = fold_op;
  a.fold32 = fold32 != 0;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, 3 * sizeof(long long), st);
  if (e != cudaSuccess) return (int)e;
  const int which =
      (w32 ? 0 : 9) + leaf_bucket(nleaf) * 3 + depth_bucket(most);
  const KernelFn fn = kernel_at(which);
  int blocks = 0;
  if ((e = grid_of((const void*)fn, which, n, blocks)) != cudaSuccess)
    return (int)e;
  fn<<<blocks, kThreads, 0, st>>>(a, n, static_cast<u64*>(out));
  return (int)cudaGetLastError();
}

// leaves, dtypes, code, imm as m2v_expr_fold takes them; the program leaves
// the mask, then the group key.  out: int32 [n] on the device, 16-byte
// aligned: out[i] = clamp(key - rmin, 0, rcount - 1) where row i's mask is
// nonzero, else -1.
int m2v_group_ids(const void* const* leaves, const int* dtypes, int nleaf,
                  long long n, const int* code, const long long* imm,
                  int nsteps, long long rmin, long long rcount, void* out,
                  void* stream) {
  if (n < 0 || rcount < 1 || rcount > (1ll << 31) ||
      (out == nullptr && n > 0) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  FoldArgs a = {};
  bool w32 = true;
  int most = 0;
  int rc = parse_program(leaves, dtypes, nleaf, code, imm, nsteps, a, w32,
                         most);
  if (rc != 0) return rc;
  const int which = !w32 ? 2 : (nleaf <= 4 && most <= 3 ? 0 : 1);
  const GroupFn fn = kGroupFns[which];
  int blocks = 0;
  cudaError_t e = grid_of((const void*)fn, kGroupKernels + which, n, blocks);
  if (e != cudaSuccess) return (int)e;
  fn<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, n, rmin, rcount - 1, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
