"""Fused multi-aggregate dense group-by — the Q1-class kernel.

One pass over the rows computes every aggregate of a family of folds that
share one (group ids, mask) pair.  Each ``AggSpec`` describes a per-row
value ``base * prod(const_i + sign_i * col_i)`` (base a column, or 1 for a
count) that is summed, or max-reduced for ``op="max"`` (FChoose), per
group; rows with a group id outside ``[0, n_groups)`` are skipped.

On CUDA tensors ``fused_group_aggregate`` launches the hand-written kernel
in ``csrc/multiagg.cu`` (int64 arithmetic per row; see the note there):
the lane-private fast path for the families the engine fuses
(``lane_path``), the shared-atomic general path for the rest.  On CPU
tensors it runs ``reference_group_aggregate``, the plain version.  Replaces
``mplan2vdl_tpu/engine/kernels/multiagg.py:fused_group_aggregate`` with the
same contract; the 16-bit limb layout that kept the TPU kernel exact in
int32 has no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ... import tracing
from . import _lib

LIMB_BITS = 16

# kernel launches made by fused_group_aggregate (callers reset it)
launches = 0

# The fast path's reach: every family ``fuse.plan_fusions`` emits has at
# most ``fuse.MAX_DOMAIN`` = 16 groups (Q1: 8 groups, 9 specs).  The spec
# limit is csrc/multiagg.cu's kLaneMaxSpecs (one lane kernel per count).
LANE_MAX_GROUPS = 16
LANE_MAX_SPECS = 12


@dataclass(frozen=True)
class AggSpec:
    """value = base * prod(const_i + sign_i * col_i).

    ``base``: input column index, or None for the constant 1 (count).
    ``factors``: (const, sign, column index) triples.
    ``bits``: upper bound on the per-row value's bit width (from catalog
    bounds); it keeps every product and sum below 2^62.
    ``op``: "sum", or "max" (FChoose group-representative picks, identity
    0 as in the JAX kernel).
    """

    base: Optional[int]
    factors: Tuple[Tuple[int, int, int], ...] = ()
    bits: int = 32
    op: str = "sum"

    @property
    def nlimb(self) -> int:
        """16-bit limbs of the JAX kernel's layout (kept for parity)."""
        if self.op == "max":
            return 1
        return max(1, -(-self.bits // LIMB_BITS))


def spec_words(specs: Sequence[AggSpec]) -> List[int]:
    """The flat int32 spec stream the kernel reads: per spec op (0 sum,
    1 max), base (-1 for count), factor count, then (const, sign, col)
    triples."""
    words: List[int] = []
    for s in specs:
        if s.op not in ("sum", "max"):
            raise ValueError(f"unknown aggregate op {s.op!r}")
        words += [0 if s.op == "sum" else 1,
                  -1 if s.base is None else s.base, len(s.factors)]
        for c, sign, col in s.factors:
            words += [c, sign, col]
    return words


def lane_path(n_groups: int, n_specs: int) -> bool:
    """Whether a call takes the kernel's fast path (a lane-private table per
    warp, no atomic per row) rather than its general path (one shared
    table per block, updated with atomics)."""
    return n_groups <= LANE_MAX_GROUPS and n_specs <= LANE_MAX_SPECS


def reference_group_aggregate(cols: Sequence[torch.Tensor],
                              gid: torch.Tensor, specs: Sequence[AggSpec],
                              n_groups: int) -> torch.Tensor:
    """Plain PyTorch version: per spec, int64 row values, then
    ``index_add_`` (sum) or ``scatter_reduce_`` (max, identity 0) into one
    slot per group plus a dump slot for skipped rows."""
    dev = gid.device
    cols = [c.to(torch.int64) for c in cols]
    g = gid.to(torch.int64)
    slot = torch.where((g >= 0) & (g < n_groups), g,
                       torch.full_like(g, n_groups))
    out = torch.zeros((n_groups, len(specs)), dtype=torch.int64, device=dev)
    for a, spec in enumerate(specs):
        v = (torch.ones_like(g) if spec.base is None
             else cols[spec.base].clone())
        for c, s, idx in spec.factors:
            v = v * (c + s * cols[idx])
        acc = torch.zeros(n_groups + 1, dtype=torch.int64, device=dev)
        if spec.op == "max":
            acc.scatter_reduce_(0, slot, v, reduce="amax", include_self=True)
        else:
            acc.index_add_(0, slot, v)
        out[:, a] = acc[:n_groups]
    return out


@tracing.kernel
def fused_group_aggregate(cols: Sequence[torch.Tensor], gid: torch.Tensor,
                          specs: Sequence[AggSpec],
                          n_groups: int) -> torch.Tensor:
    """[n_groups, n_specs] exact int64 aggregates.

    ``cols``: int32 row vectors; ``gid``: int32 group ids, every masked-out
    row negative.  No padding is needed."""
    global launches
    cols = list(cols)
    n = gid.shape[0]
    if gid.dim() != 1 or gid.dtype != torch.int32:
        raise TypeError(f"gid must be 1-D int32, got {gid.dtype}")
    for c in cols:
        if c.dim() != 1 or c.shape[0] != n or c.dtype != torch.int32:
            raise TypeError("cols must be 1-D int32 of gid's length")
        if c.device != gid.device:
            raise ValueError("cols and gid on different devices")
    words = spec_words(specs)
    if gid.device.type == "cpu":
        return reference_group_aggregate(cols, gid, specs, n_groups)
    if gid.device.type != "cuda":
        raise ValueError(f"unsupported device {gid.device}")
    lane = lane_path(n_groups, len(specs))

    def ready(t):  # the fast path copies 16-byte quads of rows
        t = t.contiguous()
        return t.clone() if lane and t.data_ptr() % 16 else t

    cols = [ready(c) for c in cols]
    gid = ready(gid)
    out = torch.zeros((n_groups, len(specs)), dtype=torch.int64,
                      device=gid.device)
    rc = _lib.call("m2v_multiagg", _lib.ptrs(cols), len(cols),
                   gid.data_ptr(), n, _lib.ints(words), len(words),
                   len(specs), n_groups, int(lane), out.data_ptr(),
                   _lib.stream(gid))
    _lib.check(rc, "multiagg")
    launches += 1
    return out
