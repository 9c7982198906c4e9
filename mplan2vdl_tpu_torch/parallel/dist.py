"""Distributed execution primitives: row-sharded scan/filter/aggregate.

The port of ``mplan2vdl_tpu/parallel/dist.py``, SPMD over a
``torch.distributed`` process group instead of a ``shard_map`` over a JAX
mesh.  Every rank runs the same calls on its own rows:

  * fact-table rows are sharded over the ranks; each rank holds a
    contiguous padded row range on its device (``ShardedTable``)
  * predicates / per-row arithmetic are rank-local (zero communication)
  * group-by: each rank computes a *dense* partial aggregate vector over
    the bounded key domain; ONE ``all_reduce`` per vector (JAX's ``psum``)
    combines the ranks; the small combined vector is then compacted to
    occupied groups
  * ``shuffle_by_key`` is the all-to-all exchange that the distributed
    hash join / large-domain group-by build on

``Mesh`` stands for JAX's one-axis ``Mesh``: the process group, this
process's rank in it, its size (JAX's ``mesh.devices.size``) and the device
that holds the rank's rows.  The collectives below carry JAX's names.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from .. import device as _device
from ..engine.kernels import segred


@dataclass(frozen=True)
class Mesh:
    """The ranks of one process group, seen from one of them."""

    group: object
    rank: int
    size: int
    device: torch.device


def backend_for(dev: torch.device) -> str:
    """The collective backend of a device type: NCCL for CUDA, gloo for
    the CPU."""
    return "nccl" if dev.type == "cuda" else "gloo"


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh over ``group`` (default: every rank of the default process
    group, which ``multihost.initialize`` starts).  ``device`` defaults to
    ``cuda`` (this rank's current card); the group's backend must be the
    device's (NCCL for ``cuda``, gloo for ``cpu``)."""
    if not tdist.is_initialized():
        raise RuntimeError("no process group: call "
                           "mplan2vdl_tpu_torch.parallel.multihost"
                           ".initialize() first")
    dev = _device.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    group = tdist.group.WORLD if group is None else group
    backend = str(tdist.get_backend(group)).lower()
    if backend != backend_for(dev):
        raise ValueError(f"process group backend {backend} cannot carry "
                         f"{dev.type} tensors (use {backend_for(dev)})")
    return Mesh(group=group, rank=tdist.get_rank(group),
                size=tdist.get_world_size(group), device=dev)


# ------------------------------------------------------------ collectives
def psum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Elementwise sum over the ranks (``lax.psum``); every rank gets it."""
    out = x.reshape(-1).clone()
    tdist.all_reduce(out, op=tdist.ReduceOp.SUM, group=mesh.group)
    return out.reshape(x.shape)


def pmax(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Elementwise maximum over the ranks (``lax.pmax``)."""
    out = x.reshape(-1).clone()
    tdist.all_reduce(out, op=tdist.ReduceOp.MAX, group=mesh.group)
    return out.reshape(x.shape)


def pmin(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Elementwise minimum over the ranks (``lax.pmin``)."""
    out = x.reshape(-1).clone()
    tdist.all_reduce(out, op=tdist.ReduceOp.MIN, group=mesh.group)
    return out.reshape(x.shape)


def all_to_all(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` is (size, ...): block ``d`` goes to rank ``d``.  Returns the
    same shape, block ``s`` being what rank ``s`` sent here
    (``lax.all_to_all(x, "d", 0, 0)``)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    tdist.all_to_all_single(out, x, group=mesh.group)
    return out


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x`` in rank order
    (``lax.all_gather``)."""
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    tdist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.stack(parts)


def all_gather_rows(mesh: Mesh, arrays: Sequence[torch.Tensor],
                    keep: torch.Tensor, host: bool = True) -> list:
    """The rows of ``arrays`` where ``keep``, from every rank in rank
    order, as numpy (``host=False``: as tensors on the rank's device):
    each rank compacts its rows on its device, the row counts are
    all-gathered, and the rows travel padded to the largest count (only
    live rows reach the host)."""
    sel = torch.nonzero(keep).reshape(-1)
    counts = all_gather(mesh, torch.tensor(
        [sel.numel()], device=keep.device)).reshape(-1).tolist()
    width = max(counts)
    out = []
    for a in arrays:
        part = torch.zeros(width, dtype=a.dtype, device=a.device)
        part[:sel.numel()] = a[sel]
        rows = all_gather(mesh, part)
        if host:
            rows = rows.cpu().numpy()
        parts = [rows[r, :c] for r, c in enumerate(counts)]
        out.append(np.concatenate(parts) if host else torch.cat(parts))
    return out


def sort_by_dest(dest: torch.Tensor, n_bins: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rows ordered stably by destination (``dest`` in [0, n_bins)): the
    order, the sorted destinations (int64) and each row's position within
    its destination's run.  JAX builds the positions from an
    ``n × n_bins`` one-hot cumsum; these are the same numbers."""
    ds, order = torch.sort(dest.to(torch.int64), stable=True)
    counts = torch.bincount(ds, minlength=n_bins)
    start = torch.cumsum(counts, 0) - counts
    within = torch.arange(ds.shape[0], device=ds.device) - start[ds]
    return order, ds, within


# ------------------------------------------------------------------ tables
@dataclass
class ShardedTable:
    """Columns of one table, row-sharded over the mesh with padding: this
    rank's window ``[rank·shard_rows, (rank+1)·shard_rows)`` of each
    zero-padded column."""

    mesh: Mesh
    n_rows: int
    shard_rows: int
    columns: Dict[str, torch.Tensor]

    @classmethod
    def put(cls, mesh: Mesh, columns: Dict[str, np.ndarray]
            ) -> "ShardedTable":
        """Every rank passes the full columns and keeps its own rows."""
        n = len(next(iter(columns.values())))
        shard_rows = -(-n // mesh.size)
        out = {name: shard_window(mesh, arr, shard_rows)
               for name, arr in columns.items()}
        return cls(mesh=mesh, n_rows=n, shard_rows=shard_rows, columns=out)


def shard_window(mesh: Mesh, arr: np.ndarray, shard_rows: int
                 ) -> torch.Tensor:
    """This rank's window ``[rank·shard_rows, (rank+1)·shard_rows)`` of
    ``arr`` on its device, zero-padded to ``shard_rows`` (empty past the
    end of ``arr``)."""
    lo = mesh.rank * shard_rows
    part = np.asarray(arr)[lo:lo + shard_rows]
    buf = np.zeros(shard_rows, dtype=part.dtype)
    buf[:len(part)] = part
    return torch.from_numpy(buf).to(mesh.device)


def dense_sums(terms: List[torch.Tensor], ids_ok: torch.Tensor,
                domain: int) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """[domain] int64 sum of each term per group id, and the rows per id;
    rows whose id is ``domain`` are left out.  Small domains reduce once per
    id (segred); larger ones sort the ids once and difference an int64
    prefix sum at the run bounds (wrapping as ``segment_sum`` does), so no
    group funnels its rows through one atomic address."""
    if domain <= segred.SMALL_DOMAIN:
        return ([segred.masked_group_reduce(t, ids_ok, domain, "sum")
                 for t in terms], segred.group_counts(ids_ok, domain))
    sid, order = torch.sort(ids_ok)
    bounds = torch.searchsorted(
        sid, torch.arange(domain + 1, device=sid.device))
    sums = []
    for t in terms:
        cs = torch.cat([t.new_zeros(1), torch.cumsum(t[order], 0)])
        sums.append(cs[bounds[1:]] - cs[bounds[:-1]])
    return sums, bounds[1:] - bounds[:-1]


@dataclass
class DistQuery:
    """A distributed scan -> filter -> group-by -> sum query.

    mask_fn(cols)        -> boolean row mask (rank-local)
    key_fn(cols)         -> dense int group ids in [0, domain) (rank-local)
    agg_fns              -> name -> per-row term, summed per group as int64
    The callables see this rank's torch columns.  The combine is one
    ``all_reduce`` per aggregate and one for the occupancy; avg-style
    post-ops divide the combined sums host-side.
    """

    table: ShardedTable
    domain: int
    mask_fn: Callable
    key_fn: Callable
    agg_fns: Dict[str, Callable]

    def __post_init__(self):
        self._aggs = sorted(self.agg_fns)

    def __call__(self) -> Dict[str, np.ndarray]:
        """Every rank returns the same dict: ``__group_id``, ``__count``
        and one entry per aggregate, over the occupied groups."""
        t, domain = self.table, self.domain
        mesh, cols = t.mesh, t.columns
        local_n = min(max(t.n_rows - mesh.rank * t.shard_rows, 0),
                      t.shard_rows)
        keep = self.mask_fn(cols)
        if local_n < t.shard_rows:  # padding rows
            keep = keep & (torch.arange(t.shard_rows, device=mesh.device)
                           < local_n)
        ids = torch.clamp(self.key_fn(cols).to(torch.int64), 0, domain - 1)
        ids_ok = torch.where(keep, ids, domain)
        # each term is cast after its callable, so int32 arithmetic inside
        # it wraps as it does in the JAX package
        dense, occ = dense_sums(
            [self.agg_fns[a](cols).to(torch.int64) for a in self._aggs],
            ids_ok, domain)
        dense = [psum(mesh, d).cpu().numpy() for d in dense]
        occ = psum(mesh, occ).cpu().numpy()
        sel = np.nonzero(occ > 0)[0]
        res = {"__group_id": sel, "__count": occ[sel]}
        for a, d in zip(self._aggs, dense):
            res[a] = d[sel]
        return res


def shuffle_by_key(mesh: Mesh, keys: torch.Tensor, values: torch.Tensor,
                   key_hi: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-to-all exchange: route each of this rank's (key, value) pairs
    to the rank that owns its key range.

    Keys are range-partitioned: rank i owns keys in
    [i*ceil(key_hi/n), (i+1)*ceil(...)).  Every rank sends one fixed-size
    bucket to every rank (capacity 2x the rank's rows + 8, as JAX's
    ``2 * (global rows // n) + 8``), so the exchange is one all-to-all per
    array.  Returns this rank's ``(size·cap,)`` received keys and values,
    padded with ``key_hi`` keys: the SPMD form of JAX's ``(1, n·cap)``
    block per shard.
    """
    n_dev = mesh.size
    per = -(-key_hi // n_dev)
    cap = 2 * keys.shape[0] + 8  # per-destination bucket capacity
    dest = torch.clamp(torch.div(keys, per, rounding_mode="floor"),
                       0, n_dev - 1)
    order, ds, within = sort_by_dest(dest, n_dev)
    slot = ds * cap + torch.clamp(within, max=cap - 1)
    buck_k = torch.full((n_dev * cap,), key_hi, dtype=keys.dtype,
                        device=keys.device)
    buck_v = torch.zeros((n_dev * cap,), dtype=values.dtype,
                         device=values.device)
    buck_k[slot] = keys[order]
    buck_v[slot] = values[order]
    bk = all_to_all(mesh, buck_k.reshape(n_dev, cap))
    bv = all_to_all(mesh, buck_v.reshape(n_dev, cap))
    return bk.reshape(-1), bv.reshape(-1)
