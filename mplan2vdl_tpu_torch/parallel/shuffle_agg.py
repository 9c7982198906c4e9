"""Distributed sparse-domain group-by: local pre-aggregation + all-to-all
key shuffle + owner-side combine.

The port of ``mplan2vdl_tpu/parallel/shuffle_agg.py`` over a
``torch.distributed`` group (``dist.Mesh``).  Sparse group-bys (an
orderkey-keyed aggregation, domain ~2^38) follow the classic distributed
hash-aggregation recipe:

  rank-local:   sort local (key, value) rows -> run-segmented partials
                (each rank's distinct keys <= its row count)
  exchange:     range-partition keys over the ranks; ONE all-to-all per
                array moves every partial to its key's owner rank
  owner-side:   sort received partials -> run-segmented combine

The exchange uses fixed per-destination bucket capacities derived from the
local distinct-key bound, and a capacity overflow is detected and reported.
Combination must be associative (sum/min/max — avg is sum/count upstream).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..engine import scan
from . import dist

_SENT = 2**62  # sorts after every real key


def _segment(v: torch.Tensor, run_ok: torch.Tensor, n_out: int,
             op: str) -> torch.Tensor:
    """(n_out,) reduction of ``v`` per run id; ``run_ok`` ascends and ids
    at ``n_out`` are left out.  Empty runs hold ``segment_sum``'s 0 and
    ``segment_max``/``segment_min``'s dtype extremes."""
    if op == "sum":
        # the runs are contiguous: difference an int64 prefix sum at the
        # run bounds (the cast back keeps v's wraparound)
        bounds = torch.searchsorted(
            run_ok, torch.arange(n_out + 1, device=v.device))
        cs = torch.cat([torch.zeros(1, dtype=torch.int64, device=v.device),
                        torch.cumsum(v.to(torch.int64), 0)])
        return (cs[bounds[1:]] - cs[bounds[:-1]]).to(v.dtype)
    info = torch.iinfo(v.dtype)
    ident, how = ((info.min, "amax") if op == "max"
                  else (info.max, "amin"))
    out = torch.full((n_out + 1,), ident, dtype=v.dtype, device=v.device)
    out.scatter_reduce_(0, run_ok, v, how)
    return out[:n_out]


def _run_reduce(keys, vals_list, ops, n_out):
    """Sort rows by key and reduce runs; invalid rows carry _SENT keys.
    Returns (run_keys, reduced values list, with _SENT padding)."""
    ks, order = torch.sort(keys.to(torch.int64), stable=True)
    head = torch.ones(ks.shape[0], dtype=torch.bool, device=ks.device)
    head[1:] = ks[1:] != ks[:-1]
    run_id = scan.cumsum_flags(head) - 1
    run_ok = torch.where(ks < _SENT, run_id, n_out)
    outs = [_segment(v[order], run_ok, n_out, op)
            for v, op in zip(vals_list, ops)]
    # every row of a run holds the run's key, so any writer is the right
    # one; runs that do not occur keep _SENT (JAX: a segment_max, -1 ->
    # _SENT)
    kout = torch.full((n_out + 1,), _SENT, dtype=torch.int64,
                      device=ks.device).scatter_(0, run_ok, ks)[:n_out]
    return kout, outs


def shard_shuffle_combine(keys, vals, ops, shard_rows, n_dev, per_owner,
                          cap, mesh: dist.Mesh):
    """The rank-side body: local pre-agg, all-to-all exchange, owner
    combine.  Every rank of ``mesh`` calls it on its own rows.  Returns
    (owner keys, combined values, this rank's overflow count, not
    reduced); padding keys = _SENT."""
    # 1. local pre-aggregation
    lk, lvals = _run_reduce(keys, vals, ops, shard_rows)
    # 2. route each local group to its key's owner (padding: nowhere)
    dest = torch.clamp(torch.div(lk, per_owner, rounding_mode="floor"),
                       0, n_dev - 1)
    dest = torch.where(lk < _SENT, dest, n_dev)
    order, ds, within = dist.sort_by_dest(dest, n_dev + 1)
    live = ds < n_dev
    overflow = ((within >= cap) & live).sum()
    slot = torch.where(live, ds * cap + torch.clamp(within, max=cap - 1),
                       n_dev * cap)
    bk = torch.full((n_dev * cap + 1,), _SENT, dtype=torch.int64,
                    device=lk.device)
    bk[slot] = lk[order]
    bvs = []
    for v in lvals:
        bv = torch.zeros((n_dev * cap + 1,), dtype=v.dtype, device=v.device)
        bv[slot] = v[order]
        bvs.append(bv[:n_dev * cap])
    rk = dist.all_to_all(mesh, bk[:n_dev * cap].reshape(n_dev, cap))
    rvs = [dist.all_to_all(mesh, b.reshape(n_dev, cap)) for b in bvs]
    # 3. owner-side combine over everything received
    gk, gvals = _run_reduce(rk.reshape(-1), [r.reshape(-1) for r in rvs],
                            ops, n_dev * cap)
    return gk, gvals, overflow


@dataclass
class ShuffleGroupBy:
    """Sparse distributed group-by over pre-sharded inputs.

    ``key_hi``: exclusive upper bound of key values (from catalog bounds).
    ``ops``: per-value associative combiner ("sum" | "min" | "max").
    """

    mesh: dist.Mesh
    shard_rows: int
    key_hi: int
    ops: Sequence[str]

    def __post_init__(self):
        n_dev = self.mesh.size
        self.per_owner = -(-self.key_hi // n_dev)
        # capacity per destination bucket: assume no rank sends more than
        # cap partials to one owner (uniform-ish keys; overflow detected)
        self.cap = 2 * (self.shard_rows // n_dev) + 64
        self.n_dev = n_dev

    def __call__(self, keys: torch.Tensor, vals: Sequence[torch.Tensor]):
        """This rank's rows in (invalid rows keyed _SENT); every rank gets
        the global (keys, [values]) as numpy, owners in rank order."""
        mesh = self.mesh
        gk, gvals, overflow = shard_shuffle_combine(
            keys, list(vals), tuple(self.ops), self.shard_rows, self.n_dev,
            self.per_owner, self.cap, mesh)
        overflow = int(dist.psum(mesh, overflow))
        if overflow:
            raise RuntimeError(
                f"shuffle bucket overflow ({overflow} partials dropped) — "
                "raise capacity or enable skew repartitioning")
        # JAX gathers every owner's padded rows and keeps the live ones;
        # each rank here sends only its live rows
        gk, *gvals = dist.all_gather_rows(mesh, [gk] + gvals, gk < _SENT)
        return gk, gvals
