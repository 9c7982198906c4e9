"""Fused multi-aggregate dense group-by on the tensor cores (Q1 class, sums).

The sums of a fused fold family as one contraction of byte planes with a
one-hot of the group id:

    partial[plane, group] = sum_rows plane(row) * (gid(row) == group)

where each spec's per-row value ``base * prod(const + sign * col)`` (non-
negative and below ``2^bits``) is split into ``ceil(bits / 8)`` unsigned
byte planes.  Recombining ``sum_k partial[k] << 8k`` in wrapping 64-bit
arithmetic gives the exact int64 sum, because the true total is below 2^63.

On CUDA tensors ``fused_group_aggregate_mxu`` launches the hand-written
kernel in ``csrc/multiagg_mxu.cu`` (``mma.sync`` u8 x u8 -> s32, int32
fragments flushed into int64 before 2^23 rows; see the note there): the
warp-local fast path for the families the engine fuses (``fast_path``),
the block-step general path for the rest.  On CPU tensors it runs
``fused_group_aggregate_mxu_plain``, the plain version, which computes the
same planes.  Replaces
``mplan2vdl_tpu/engine/kernels/multiagg_mxu.py:fused_group_aggregate_mxu``
with the same contract: int64 ``out[n_groups, n_specs]``, "sum" specs only
(a family's "max" specs stay with ``multiagg.fused_group_aggregate``).  The
TPU kernel's limb multiply with renormalisation, its carry plane, its lo/hi
int32 output split and its ``MPLAN2VDL_MXU_DOT`` choice between two Mosaic
operand layouts have no counterpart: a row's value is exact in int64 and
the contraction has one layout.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import torch

from ... import tracing
from . import _lib
from .multiagg import AggSpec, spec_words

LIMB_BITS = 8

# kernel launches made by fused_group_aggregate_mxu (callers reset it)
launches = 0

# The fast path's reach (csrc/multiagg_mxu.cu, fast_kernel): one m16 tile
# of groups, which every family ``fuse.plan_fusions`` emits fits
# (``fuse.MAX_DOMAIN`` = 16), and one kernel per sum-spec count up to 12
# (Q1: 7 with the appended count).
FAST_MAX_GROUPS = 16
FAST_MAX_SPECS = 12
# rows of one warp step (32 lanes x a quad of 4 rows), and the rows after
# which an int32 fragment cell must be moved into int64: it gains at most
# 255 per row, and 255 * 2^23 < 2^31
FAST_STEP_ROWS = 128
FLUSH_ROWS = 1 << 23
FLUSH_STEPS = FLUSH_ROWS // FAST_STEP_ROWS


def mxu_agg_on() -> bool:
    """MPLAN2VDL_MXU_AGG: 1 force on, 0/unset off (the JAX engine's
    switch; the default stays off)."""
    return os.environ.get("MPLAN2VDL_MXU_AGG", "0") not in ("", "0")


def plane_offsets(specs: Sequence[AggSpec]) -> List[int]:
    """Spec s owns byte planes ``[off[s], off[s + 1])``: one per 8 bits of
    its bound, at least one."""
    off = [0]
    for s in specs:
        off.append(off[-1] + max(1, -(-s.bits // LIMB_BITS)))
    return off


def fast_path(n_groups: int, specs: Sequence[AggSpec]) -> bool:
    """Whether a call takes the kernel's fast path (warp-local steps, the
    one-hot built in registers) rather than its general path (block steps
    over chunks of 32 planes x 32 groups)."""
    return n_groups <= FAST_MAX_GROUPS and len(specs) <= FAST_MAX_SPECS


def fast_args(specs: Sequence[AggSpec]
              ) -> Tuple[List[int], List[int], List[Tuple[int, ...]]]:
    """The fast path's inputs: the columns the specs use, in order of first
    use (the kernel reads only these, by slot); the factor words, one
    (const, sign, slot) triple per factor; and one head per spec, (base
    slot or -1, factor count, first factor word, first plane, plane
    count), its planes those of ``plane_offsets``."""
    slot: dict = {}

    def use(col: int) -> int:
        return slot.setdefault(col, len(slot))

    off = plane_offsets(specs)
    words: List[int] = []
    heads = []
    for i, s in enumerate(specs):
        base = -1 if s.base is None else use(s.base)
        w = len(words)
        for c, sign, col in s.factors:
            words += [c, sign, use(col)]
        heads.append((base, len(s.factors), w, off[i], off[i + 1] - off[i]))
    return list(slot), words, heads


def _check(cols, gid, specs):
    n = gid.shape[0]
    if gid.dim() != 1 or gid.dtype != torch.int32:
        raise TypeError(f"gid must be 1-D int32, got {gid.dtype}")
    for c in cols:
        if c.dim() != 1 or c.shape[0] != n or c.dtype != torch.int32:
            raise TypeError("cols must be 1-D int32 of gid's length")
        if c.device != gid.device:
            raise ValueError("cols and gid on different devices")
    if not specs:
        raise ValueError("no specs")
    for s in specs:
        if s.op != "sum":
            raise ValueError(f"the tensor-core aggregate sums only, got a "
                             f"{s.op!r} spec")
        if not 1 <= s.bits <= 64:
            raise ValueError(f"spec bits {s.bits} outside [1, 64]")


def fused_group_aggregate_mxu_plain(cols: Sequence[torch.Tensor],
                                    gid: torch.Tensor,
                                    specs: Sequence[AggSpec],
                                    n_groups: int) -> torch.Tensor:
    """Plain PyTorch version: per spec, the int64 row values split into byte
    planes, ``index_add_`` of each plane into one slot per group plus a
    dump slot for skipped rows, then ``sum_k plane_k << 8k`` (int64 wraps,
    and the true total is below 2^63)."""
    dev = gid.device
    cols = [c.to(torch.int64) for c in cols]
    g = gid.to(torch.int64)
    slot = torch.where((g >= 0) & (g < n_groups), g,
                       torch.full_like(g, n_groups))
    off = plane_offsets(specs)
    out = torch.zeros((n_groups, len(specs)), dtype=torch.int64, device=dev)
    for a, spec in enumerate(specs):
        v = (torch.ones_like(g) if spec.base is None
             else cols[spec.base].clone())
        for c, s, idx in spec.factors:
            v = v * (c + s * cols[idx])
        tot = torch.zeros(n_groups + 1, dtype=torch.int64, device=dev)
        for k in range(off[a + 1] - off[a]):
            plane = (v >> (LIMB_BITS * k)) & 0xFF
            part = torch.zeros(n_groups + 1, dtype=torch.int64, device=dev)
            part.index_add_(0, slot, plane)
            tot += part << (LIMB_BITS * k)
        out[:, a] = tot[:n_groups]
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads four rows as one 16-byte load."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@tracing.kernel
def fused_group_aggregate_mxu(cols: Sequence[torch.Tensor], gid: torch.Tensor,
                              specs: Sequence[AggSpec], n_groups: int,
                              *, max_blocks: int = 0,
                              max_warps: int = 0) -> torch.Tensor:
    """[n_groups, n_specs] exact int64 sums.

    ``cols``: int32 row vectors (only those the specs reference are read);
    ``gid``: int32 group ids, every masked-out row negative.  Every spec
    must be a "sum" whose values lie in ``[0, 2^bits)``.  ``max_blocks`` > 0
    caps the kernel's grid, and ``max_warps`` > 0 the fast path's warps per
    block (one block, or one warp, over many rows exercises the int32
    flush); neither changes the result."""
    global launches
    cols, specs = list(cols), list(specs)
    _check(cols, gid, specs)
    if gid.device.type == "cpu":
        return fused_group_aggregate_mxu_plain(cols, gid, specs, n_groups)
    if gid.device.type != "cuda":
        raise ValueError(f"unsupported device {gid.device}")
    cols = [_aligned(c) for c in cols]
    gid = _aligned(gid)
    out = torch.zeros((n_groups, len(specs)), dtype=torch.int64,
                      device=gid.device)
    if fast_path(n_groups, specs):
        used, fwords, heads = fast_args(specs)
        rc = _lib.call(
            "m2v_multiagg_mxu_fast",
            _lib.ptrs([cols[i] for i in used]), len(used), gid.data_ptr(),
            gid.shape[0], _lib.ints(fwords), len(fwords),
            _lib.ints([x for h in heads for x in h]), len(specs), n_groups,
            FLUSH_STEPS, max_blocks, max_warps, out.data_ptr(),
            _lib.stream(gid))
    else:
        words = spec_words(specs)
        rc = _lib.call(
            "m2v_multiagg_mxu",
            _lib.ptrs(cols), len(cols), gid.data_ptr(), gid.shape[0],
            _lib.ints(words), len(words), len(specs),
            _lib.ints(plane_offsets(specs)), n_groups, max_blocks,
            out.data_ptr(), _lib.stream(gid))
    _lib.check(rc, "multiagg_mxu")
    launches += 1
    return out
