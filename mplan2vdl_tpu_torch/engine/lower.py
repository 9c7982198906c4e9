"""VIR -> torch: evaluate a query's vector-IR DAG eagerly on one device.

Execution model: every vector is a buffer whose length is the node's count
bound, paired with a ``valid`` count; slots past ``valid`` hold zeros.  The
JAX engine traces the whole DAG into one program with static shapes, so it
resolves data-dependent sizes in a counting pre-pass; the port runs eagerly
and reads each such size where it arises instead: a selection's survivor
count (one host sync per ``Fold FSel``) and an equijoin's output length
(one per join key pair, two for outer sides).  The results are the JAX
engine's rows; within a run of equal join keys the pair order may differ.

Physical dtypes are chosen per node from the catalog's value bounds (int32
when they fit, int64 otherwise); integers are native int64, with no
plane splitting.

The port evaluates every kind of VIR node: Load, RangeC, RangeV, Binop,
``Shuffle GATHER``, ``Shuffle SCATTER`` (the monotone scatter kernel for
unique ascending positions, a plain scatter through a dump slot for any
others), ``Fold FSel``, dense-domain folds (one masked reduction per group
id, or the fused multi-aggregate kernel for families of folds sharing a
group key), the sparse sort-based group-by, ``Fold FDistinct`` (a sort of
(group, value) pairs and a count of the adjacent-unique ones), Partition,
``Semisort`` and ``SortPerm`` (stable sorts), ``Like`` and ``DictMap`` (a
lookup table over the code domain, built once per compiled query),
``CrossProduct``, and ``JoinIndex`` with all seven sides (sort-merge, or
the dense-domain join for a small build side).  A sum, min or max over a
constant group key whose mask and payload are row expressions takes one
pass over their leaf columns (``exprfold.py``), and so do a fused family's
group ids where its key is a ``Partition`` against dense pivots.  On the
GPU, compaction, the gathers, the monotone scatter, the fused aggregate
(with MPLAN2VDL_MXU_AGG=1 its sums on the tensor cores), that one-pass fold
and those group ids run as hand-written CUDA kernels (``kernels/``); the
sorts and the other
scatters are torch ops, as the JAX engine computes them outside its
kernels too.  A node of an
unknown kind raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import device as D
from .. import mplan as M
from .. import tracing
from .. import vir as V
from ..catalog import ColInfo, Config
from ..mtypes import DDate, DDecimal, DString, INT32_MAX, INT32_MIN
from ..names import Name, name_str
from .columnstore import ColumnStore
from . import mergesearch, scan
from .kernels import segred
from .kernels.compact import compact_positions
from .kernels.exprfold import DTYPES as EXPR_DTYPES, expr_fold, group_ids
from .kernels.multiagg import AggSpec, fused_group_aggregate
from .kernels.multiagg_mxu import fused_group_aggregate_mxu, mxu_agg_on
from .kernels.scatter import monotone_scatter
from .kernels.sorted_gather import SMALL_TABLE, gather_many

if TYPE_CHECKING:
    from .exprfold import ExprFold, Program

# The fused-aggregate gate: on automatically when any loaded column holds
# at least this many rows (MPLAN2VDL_FUSED_AGG=1/0 forces it either way).
# The threshold was tuned for the JAX engine's device; the port keeps it
# until measurements on the GPU set it.
FUSED_AUTO_ROWS = 24_000_000

# dense-domain join: the widest key domain (one D-length int32 run table)
# and the most build-side rows.  Run start and run length each fit 16 bits
# and pack into one int32 entry (lo | cnt << 16).  MPLAN2VDL_NO_DENSE_JOIN=1
# forces the sort-merge join everywhere.
DENSE_DOMAIN = 1 << 26
DENSE_RIGHT_MAX = (1 << 16) - 1

# count(DISTINCT): the (group id, value) pairs sort as one packed int64 key
# while (domain + 1) * value width stays at most this; past it, two stable
# sorts (_sort_pairs)
PACK_LIMIT = 2**62

_INT_DTYPES = (torch.int32, torch.int64)


def dtype_for(info: ColInfo):
    """A node's physical dtype as numpy names it: int32 when its value
    bounds fit, int64 otherwise (the JAX engine's ``dtype_for``, whose
    ``__name__`` ``explain`` prints)."""
    l, u = info.bounds
    if INT32_MIN <= l and u <= INT32_MAX:
        return np.int32
    return np.int64


def torch_dtype_for(info: ColInfo) -> torch.dtype:
    """``dtype_for`` as the torch dtype of the node's buffer."""
    return torch.int32 if dtype_for(info) is np.int32 else torch.int64


@dataclass
class Val:
    """A runtime vector: buffer + valid length (an int, or a 0-d int64
    tensor on the device where the count is still there).  A range the
    host knows (``RangeC``, ``RangeV``) stays lazy until a consumer needs
    its buffer (``Compiler._force``); one of step 0 is a constant, which
    most consumers take as a scalar instead."""

    data: Optional[torch.Tensor]  # None for a lazy range
    valid: Union[int, torch.Tensor]
    length: int  # buffer length
    lazy_range: Optional[Tuple[int, int]] = None  # (rmin, rstep) when data is None
    dtype: Optional[torch.dtype] = None  # a lazy range's buffer dtype


def _const(val: Val) -> Optional[int]:
    """The value of a lazy constant (a lazy range of step 0), else None."""
    if val.data is None and val.lazy_range[1] == 0:
        return val.lazy_range[0]
    return None


def _lazy_dtype(val: Val) -> torch.dtype:
    """A lazy range's buffer dtype: its own, or (a ``RangeC``'s) int32
    where its values fit."""
    rmin, rstep = val.lazy_range
    return val.dtype or (torch.int64 if abs(rmin) + abs(rstep) * val.length
                         > INT32_MAX else torch.int32)


def _valid_mask(n: int, valid, device) -> Optional[torch.Tensor]:
    """``arange(n) < valid``, or None where every row is valid (the rule
    ``_mask_tail`` applies)."""
    if isinstance(valid, int) and valid == n:
        return None
    return torch.arange(n, device=device) < valid


def _keep_valid(data: torch.Tensor, valid, other) -> torch.Tensor:
    """``data`` below ``valid``, ``other`` (a scalar) past it: ``data``
    itself where every row is valid."""
    mask = _valid_mask(data.shape[0], valid, data.device)
    return data if mask is None else torch.where(mask, data, other)


def _and(a: Optional[torch.Tensor], b: Optional[torch.Tensor]
         ) -> Optional[torch.Tensor]:
    """Two row masks combined, None meaning every row."""
    if a is None:
        return b
    return a if b is None else a & b


def _sel_positions(mask: torch.Tensor, n_out: Optional[int] = None
                   ) -> torch.Tensor:
    """Ascending positions of mask-true rows (the compaction core), int32;
    entries past the true count are zero.  Always the compaction kernel on
    the GPU (its wrapper runs the plain version on CPU tensors)."""
    return compact_positions(mask, n_out)


def _mask_tail(data: torch.Tensor, valid, length: int) -> torch.Tensor:
    """Re-establish the zeros-past-valid invariant."""
    if isinstance(valid, int) and valid == length:
        return data
    idx = torch.arange(length, device=data.device)
    return torch.where(idx < valid, data, torch.zeros((), dtype=data.dtype,
                                                      device=data.device))


def _dense_tail(agg: torch.Tensor, counts: torch.Tensor, dt,
                L_out: int) -> Val:
    """A dense fold's output from its per-id aggregates and row counts:
    the occupied ids' aggregates, ascending, in ``dt``.  Min and max over
    an empty id hold identity sentinels; the occupancy compaction drops
    those slots."""
    occ = counts > 0
    ngroups = occ.sum()
    out = agg[_sel_positions(occ, L_out).long()]
    return Val(data=_mask_tail(out.to(dt), ngroups, L_out), valid=ngroups,
               length=L_out)


def like_to_regex(pattern: str) -> "re.Pattern":
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def _dense_join_on() -> bool:
    return os.environ.get("MPLAN2VDL_NO_DENSE_JOIN", "0") in ("", "0")


def _dense_tab(r_ok: torch.Tensor, m: int, klo: int, D: int):
    """(rs_idx, packed run table) of one dense-join build side: a stable
    sort of the right keys (sentinel rows last), then each key's first
    sorted row (``min``) and run length (``add``) scattered over the
    domain and packed as ``lo | cnt << 16``.  Sentinel rows go to a dump
    slot past the domain, which is cut off."""
    dev = r_ok.device
    rs, rs_idx = torch.sort(r_ok, stable=True)
    slot = torch.clamp(rs.to(torch.int64) - klo, 0, D)
    pos = torch.arange(m, dtype=torch.int32, device=dev)
    lo_tab = torch.full((D + 1,), m, dtype=torch.int32, device=dev)
    lo_tab.scatter_reduce_(0, slot, pos, "amin")
    cnt_tab = torch.zeros(D + 1, dtype=torch.int32, device=dev)
    cnt_tab.index_add_(0, slot, torch.ones_like(pos))
    return rs_idx.to(torch.int32), lo_tab[:D] | (cnt_tab[:D] << 16)


def _expand_li(cum: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Which left row's run of output slots holds each slot ``k``:
    ``searchsorted(cum, k, side='right')`` over the inclusive counts."""
    return torch.searchsorted(cum, k, right=True)


def _monotone_positions(v: V.Vexp) -> bool:
    """Positions known sorted ascending from the plan alone: selection
    compactions (FSel outputs), non-negative ranges, join-index outputs
    that enumerate the probe side in order, and gather compositions of
    these (monotone of monotone stays monotone)."""
    vx = v.vx
    if isinstance(vx, V.Fold) and vx.foldop == V.FSEL:
        return True
    if isinstance(vx, (V.RangeV, V.RangeC)):
        return vx.rstep >= 0
    if isinstance(vx, V.JoinIndex) and vx.jside in (V.JLEFT, V.JSEMI,
                                                    V.JANTI):
        return True
    if isinstance(vx, V.Shuffle) and vx.shop == V.GATHER:
        return (_monotone_positions(vx.shsource)
                and _monotone_positions(vx.shpos))
    return False


def repeat_scatter(p: torch.Tensor, src: torch.Tensor, L: int
                   ) -> torch.Tensor:
    """``out[p[i]] = src[i]`` into ``L`` zeroed slots through positions in
    any order, repeats included: ``p`` is int64 in [0, L], and slot ``L``
    is a dump slot that takes the rows to drop.  Where two rows write one
    slot, which of them wins is unspecified, as under the JAX engine's
    ``.at[].set``; every VIR emitter writes equal values (ones) through
    repeated positions, so any writer gives the same vector."""
    out = torch.zeros(L + 1, dtype=src.dtype, device=src.device)
    out.scatter_(0, p, src)
    return out[:L]


def _changes(x: torch.Tensor) -> torch.Tensor:
    """Whether each entry differs from the one before it (the first
    always does)."""
    return x != torch.cat([x[:1] - 1, x[:-1]])


def _sort_pairs(ids: torch.Tensor, vals: torch.Tensor, domain: int,
                vlo: int, vhi: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (id, value) pairs sorted by id, then value: (sorted ids, whether
    each sorted pair differs from the one before it).  Ids lie in
    [0, domain] and values in [vlo, vhi].  One sort of the packed key
    ``id * W + (value - vlo)``, in int32 when it fits and in int64 up to
    PACK_LIMIT; two stable sorts, value first, where it does not fit."""
    W = vhi - vlo + 1
    top = (domain + 1) * W
    if top <= PACK_LIMIT:
        kdt = torch.int32 if top <= 2**31 - 1 else torch.int64
        key, _ = torch.sort(ids.to(kdt) * W + (vals.to(kdt) - vlo))
        return torch.div(key, W, rounding_mode="floor"), _changes(key)
    sv, o1 = torch.sort(vals, stable=True)
    sid, o2 = torch.sort(ids[o1], stable=True)
    return sid, _changes(sid) | _changes(sv[o2])


def _binop(op: str, a, b):
    """The engine's ``op`` over ``a`` and ``b``: tensors in the compute
    dtype, or one of them a Python int (a constant, which torch hands the
    kernel as an argument).  A division or modulo by zero divides by one;
    a negative shift amount shifts left (Vlite.hs:205-208)."""
    if op == M.ADD:
        return a + b
    if op == M.SUB:
        return a - b
    if op == M.MUL:
        return a * b
    if op in (M.DIV, M.MOD):
        d = (b or 1) if isinstance(b, int) else torch.where(
            b == 0, torch.ones_like(b), b)
        if isinstance(a, int):
            a = torch.full((), a, dtype=b.dtype, device=b.device)
        if op == M.DIV:
            return torch.div(a, d, rounding_mode="trunc")
        return torch.fmod(a, d)
    if op in (M.MIN, M.MAX):
        t, k = (b, a) if isinstance(a, int) else (a, b)
        if isinstance(k, int):
            return (torch.clamp(t, max=k) if op == M.MIN
                    else torch.clamp(t, min=k))
        return torch.minimum(t, k) if op == M.MIN else torch.maximum(t, k)
    if op == M.GT:
        return a > b
    if op == M.LT:
        return a < b
    if op == M.GEQ:
        return a >= b
    if op == M.LEQ:
        return a <= b
    if op == M.EQ:
        return a == b
    if op == M.NEQ:
        return a != b
    if op in (M.LOGAND, M.LOGOR):
        t, k = (b, a) if isinstance(a, int) else (a, b)
        if not isinstance(k, int):
            return ((t != 0) & (k != 0) if op == M.LOGAND
                    else (t != 0) | (k != 0))
        if (k != 0) == (op == M.LOGOR):  # the constant decides
            return torch.full_like(t, op == M.LOGOR, dtype=torch.bool)
        return t != 0
    if op == M.BITAND:
        return a & b
    if op == M.BITOR:
        return a | b
    if op == M.BITSHIFT:
        if isinstance(b, int):
            return a << min(-b, 63) if b < 0 else a >> min(b, 63)
        if isinstance(a, int):
            a = torch.full((), a, dtype=b.dtype, device=b.device)
        return torch.where(b < 0, a << torch.clamp(-b, 0, 63),
                           a >> torch.clamp(b, 0, 63))
    raise ValueError(f"unknown binop {op}")


def _outside_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to mplan2vdl_tpu_torch yet")


class Compiler:
    """Eager evaluator for one query DAG on one device.

    ``fold_map``/``families`` route fused fold families (engine/fuse.py);
    ``gather_mates`` maps a position vector's key to the gathers sharing
    it, so they batch into one kernel launch; ``dense_sibs`` maps a probe
    key vector's key to the joins sharing it, so their dense run tables
    batch into one gather; ``lookups`` holds the Like/DictMap tables across
    calls (the owner keeps it, so each is built once per compiled query).
    After a call, ``join_log`` holds one entry per JoinIndex evaluated and
    ``host_syncs`` the host's blocking transfers: the counts read and the
    host values uploaded while evaluating, and with ``fetch`` the result
    transfer's reads.  ``consts_scalar`` counts the constants a consumer
    took as a scalar, ``consts_materialized`` those ``_force`` wrote out.
    ``expr_plans`` maps a fold's key to its one-pass program
    (``exprfold.plan``); ``expr_folds`` counts the folds that took it.
    ``key_plans`` maps a fused family's index to its group-id program
    (``exprfold.plan_keys``); ``key_programs`` counts the families whose
    ids took it."""

    def __init__(self, store: ColumnStore, device: torch.device,
                 fold_map: Optional[dict] = None,
                 families: Optional[list] = None,
                 gather_mates: Optional[dict] = None,
                 dense_sibs: Optional[dict] = None,
                 lookups: Optional[dict] = None,
                 expr_plans: Optional[dict] = None,
                 key_plans: Optional[dict] = None):
        self.store = store
        self.device = device
        self.fold_map = fold_map or {}
        self.families = families or []
        self.gather_mates = gather_mates or {}
        self.dense_sibs = dense_sibs or {}
        self.lookups = lookups if lookups is not None else {}
        self.expr_plans = expr_plans or {}
        self.key_plans = key_plans or {}
        self.host_syncs = 0
        self.consts_scalar = 0
        self.consts_materialized = 0
        self.expr_folds = 0
        self.key_programs = 0

    def _monotone(self, v: V.Vexp) -> bool:
        """Positions/values known non-decreasing: the static rules of
        _monotone_positions plus store-level physical sortedness."""
        vx = v.vx
        if isinstance(vx, V.Load):
            return self.store.is_sorted(vx.name)
        if isinstance(vx, V.Shuffle) and vx.shop == V.GATHER:
            return self._monotone(vx.shsource) and self._monotone(vx.shpos)
        return _monotone_positions(v)

    # -------------------------------------------------------------- evaluate
    def trace(self, vexps: List[V.Vexp], tables: Dict[Name, torch.Tensor]
              ) -> List[Val]:
        self.reset(tables)
        return [self._force(self.eval(v)) for v in vexps]

    def reset(self, tables) -> None:
        """Fresh evaluation state over ``tables`` (column name -> device
        tensor; anything with ``get`` and ``[]``): an empty memo and caches,
        no joins logged."""
        self.memo: Dict[int, Val] = {}
        self.group_cache: Dict[tuple, dict] = {}
        self.fused_cache: Dict[int, dict] = {}
        self.gather_multi: Dict[int, torch.Tensor] = {}
        self.join_cache: Dict[tuple, dict] = {}
        self.dense_pre: Dict[tuple, tuple] = {}
        self.join_log: List[dict] = []
        self.tables = tables

    def eval(self, v: V.Vexp) -> Val:
        hit = self.memo.get(v.skey)
        if hit is not None:
            return hit
        out = self._eval(v)
        self.memo[v.skey] = out
        return out

    def _force(self, val: Val) -> Val:
        """``val`` with its buffer: a lazy range written out in
        ``_lazy_dtype``, zeros past ``valid``."""
        if val.data is not None:
            return val
        if _const(val) is not None:
            return self._materialize(val)
        rmin, rstep = val.lazy_range
        n = val.length
        data = torch.arange(rmin, rmin + rstep * n, rstep,
                            dtype=_lazy_dtype(val), device=self.device)
        return Val(data=_mask_tail(data, val.valid, n), valid=val.valid,
                   length=n)

    def _materialize(self, val: Val) -> Val:
        """A constant written out for a consumer that needs its buffer:
        one fill, then the tail past ``valid`` zeroed."""
        self.consts_materialized += 1
        data = torch.full((val.length,), val.lazy_range[0],
                          dtype=_lazy_dtype(val), device=self.device)
        return Val(data=_mask_tail(data, val.valid, val.length),
                   valid=val.valid, length=val.length)

    def _take(self, val: Val) -> Optional[int]:
        """A constant's value, which its consumer takes as a scalar
        (``consts_scalar`` counts it); None for any other value."""
        k = _const(val)
        if k is not None:
            self.consts_scalar += 1
        return k

    def _read(self, t: torch.Tensor, site: str) -> int:
        """A count read to the host at ``site`` (a sync); ``host_syncs``
        counts them."""
        self.host_syncs += 1
        return int(t)

    def _copy(self, t: torch.Tensor) -> np.ndarray:
        """Rows copied to the host (a sync); ``host_syncs`` counts them."""
        self.host_syncs += 1
        return t.cpu().numpy()

    def _upload(self, x, dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
        """Host data (an int, a list, an array) copied to the device.  On
        the GPU the copy leaves pageable memory, so it waits for the stream
        to drain: a sync, which ``host_syncs`` counts."""
        self.host_syncs += 1
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _i64(self, x) -> torch.Tensor:
        """``x`` as an int64 tensor on the device: a count already there,
        or a host value by ``_upload``."""
        if isinstance(x, torch.Tensor):
            return torch.as_tensor(x, dtype=torch.int64, device=self.device)
        return self._upload(x, torch.int64)

    def _vmin(self, a, b):
        if isinstance(a, int) and isinstance(b, int):
            return min(a, b)
        return torch.minimum(self._i64(a), self._i64(b))

    def _run_ends(self, starts: torch.Tensor, nruns, nvalid, n: int
                  ) -> torch.Tensor:
        """The last sorted row of each run, from the runs' first rows
        ``starts`` (ascending, int64), the run count and the count of valid
        sorted rows; 0 past ``nruns``."""
        next_start = torch.cat([starts[1:], starts.new_full((1,), n)])
        kidx = torch.arange(starts.shape[0], device=starts.device)
        ends = torch.where(kidx + 1 < nruns, next_start - 1, 0)
        return torch.where(kidx + 1 == nruns, nvalid - 1, ends)

    def _run_sums(self, cs: torch.Tensor, starts: torch.Tensor,
                  ends: torch.Tensor, nruns) -> torch.Tensor:
        """Each run's sum from the inclusive int64 prefix sum ``cs`` of the
        sorted rows: ``cs[end] - cs[start - 1]``; 0 past ``nruns``."""
        n = cs.shape[0]
        at_end = cs[torch.clamp(ends, 0, n - 1)]
        before = torch.where(starts > 0,
                             cs[torch.clamp(starts - 1, 0, n - 1)], 0)
        kmask = torch.arange(starts.shape[0], device=cs.device) < nruns
        return torch.where(kmask, at_end - before, 0)

    def fetch(self, vals: List[Val]) -> List[np.ndarray]:
        """Each value's valid rows on the host: its count read first when
        it is on the device (``result_valid``), then its rows copied
        (``result_copy``), each read counted in ``host_syncs``."""
        cols = []
        for val in vals:
            n = (self._read(val.valid, "result_valid")
                 if isinstance(val.valid, torch.Tensor) else int(val.valid))
            cols.append(self._copy(val.data[:n]))
        return cols

    # ------------------------------------------------------------------- ops
    def _eval(self, v: V.Vexp) -> Val:
        vx = v.vx
        L = v.info.count
        dt = torch_dtype_for(v.info)

        if isinstance(vx, V.Load):
            arr = self.tables.get(vx.name)
            if arr is None:
                raise KeyError(f"column {name_str(vx.name)} not in store")
            if len(arr) != L:
                raise ValueError(f"column {name_str(vx.name)} holds "
                                 f"{len(arr)} rows, catalog says {L}")
            return Val(data=arr, valid=L, length=L)

        if isinstance(vx, V.RangeC):
            return Val(data=None, valid=vx.rcount, length=vx.rcount,
                       lazy_range=(vx.rmin, vx.rstep))

        if isinstance(vx, V.RangeV):
            ref = self.eval(vx.rref)
            return Val(data=None, valid=ref.valid, length=ref.length,
                       lazy_range=(vx.rmin, vx.rstep), dtype=dt)

        if isinstance(vx, V.Binop):
            return self._eval_binop(v, vx)

        if isinstance(vx, V.Shuffle) and vx.shop == V.GATHER:
            return self._eval_gather(v, vx, dt)

        if isinstance(vx, V.Shuffle) and vx.shop == V.SCATTER:
            return self._eval_scatter(vx, dt)

        if isinstance(vx, V.Fold) and vx.foldop == V.FSEL:
            b = self._force(self.eval(vx.fdata))
            L = b.length
            mask = b.data != 0
            # the survivor count sizes the selection buffer, so every
            # downstream gather runs at the real cardinality (one host
            # sync; the JAX engine resolved it in a counting pre-pass)
            nz = self._read(mask.sum(), "select")
            L_out = min(max(nz, 1), L)
            sel = _sel_positions(mask, L_out)
            sel = _mask_tail(sel.to(dt), nz, L_out)
            return Val(data=sel, valid=nz, length=L_out)

        if isinstance(vx, V.Fold):
            return self._eval_fold(v, vx)

        if isinstance(vx, V.Partition):
            return self._eval_partition(v, vx)

        if isinstance(vx, V.Semisort):
            # the stable argsort of the whole buffer, padding included, as
            # the JAX engine sorts it
            s = self._force(self.eval(vx.sdata))
            _, perm = torch.sort(s.data, stable=True)
            return Val(data=perm.to(dt), valid=s.valid, length=s.length)

        if isinstance(vx, V.SortPerm):
            return self._eval_sortperm(vx, dt)

        if isinstance(vx, V.VShuffle):
            # any permutation is legal; identity preserves determinism
            return self.eval(vx.varg)

        if isinstance(vx, V.Like):
            return self._eval_like(v, vx)

        if isinstance(vx, V.DictMap):
            return self._eval_dictmap(v, vx)

        if isinstance(vx, V.CrossProduct):
            return self._eval_cross(v, vx)

        if isinstance(vx, V.JoinIndex):
            return self._eval_join_index(v, vx)

        raise _outside_slice(type(vx).__name__)

    # ---------------------------------------------------------------- gather
    def _eval_gather(self, v: V.Vexp, vx: V.Shuffle, dt) -> Val:
        """Routing: monotone positions take the monotone gather; otherwise
        a source of at most SMALL_TABLE rows takes the small-table gather,
        and a larger one the monotone gather's kernel again, which is right
        for any order (the JAX engine uses XLA's gather there).  The two
        kernels differ only past ``valid``, which ``_mask_tail`` zeroes."""
        src = self._force(self.eval(vx.shsource))
        pos = self._force(self.eval(vx.shpos))
        if src.data.dtype not in _INT_DTYPES:
            raise _outside_slice(f"Shuffle GATHER of {src.data.dtype}")
        small = not self._monotone(vx.shpos) and src.length <= SMALL_TABLE
        data = self._group_gather(v, vx, src, pos, small).to(dt)
        # gathering from an empty source yields an empty vector
        if isinstance(src.valid, int) and src.valid > 0:
            valid = pos.valid
        elif isinstance(src.valid, int):
            valid = 0
        else:
            valid = torch.where(src.valid > 0, self._i64(pos.valid),
                                self._i64(0))
        data = _mask_tail(data, valid, pos.length)
        return Val(data=data, valid=valid, length=pos.length)

    def _group_gather(self, v: V.Vexp, vx: V.Shuffle, src: Val,
                      pos: Val, small: bool) -> torch.Tensor:
        """Gather that BATCHES every other gather node sharing these
        positions (same source length, int32/int64 source) into one kernel
        launch; results cache per member node.  Mates share the positions
        and the source length, so they take the same kernel (``small``).
        ``gather_mates`` carries per-member reachability sets, so a mate
        whose source depends on the node being evaluated is never pulled
        in (no recursion)."""
        hit = self.gather_multi.get(v.skey)
        if hit is not None:
            return hit
        mates = []
        seen_src = {vx.shsource.skey}
        for g2, reach in self.gather_mates.get(vx.shpos.skey, ()):
            if (g2.skey == v.skey or g2.skey in self.gather_multi
                    or v.skey in reach
                    or g2.vx.shsource.skey in seen_src):
                continue
            m2 = self._force(self.eval(g2.vx.shsource))
            if (m2.length != src.length
                    or m2.data.dtype not in _INT_DTYPES):
                continue
            seen_src.add(g2.vx.shsource.skey)
            mates.append((g2, m2))
        outs = gather_many([src.data] + [m.data for _, m in mates],
                           pos.data, pos.valid, small=small)
        for (g2, _), o in zip(mates, outs[1:]):
            self.gather_multi[g2.skey] = o
        return outs[0]

    # --------------------------------------------------------------- scatter
    def _eval_scatter(self, vx: V.Shuffle, dt) -> Val:
        """Scatter into ``L`` slots.  Unique monotone positions (FK mask
        deduction, relational Scatter of compactions) take the monotone
        scatter kernel, whose contract is strictly ascending positions;
        any others (the FK semijoin keeping the dimension side, semi, anti
        and outer joins with extra conditions) take ``repeat_scatter``.
        Invalid rows map to ``L`` and are dropped, as are positions past
        ``L``; VIR positions are never negative."""
        src = self._force(self.eval(vx.shsource))
        pos = self._force(self.eval(vx.shpos))
        if vx.shshape is not None:
            L = self.eval(vx.shshape).length
        else:
            L = vx.shpos.info.bounds[1] + 1
        n = min(src.length, pos.length)
        pdt = pos.data.dtype if L <= INT32_MAX else torch.int64
        limit = self._vmin(src.valid, pos.valid)
        if vx.shpos.quant == V.UNIQUE and self._monotone(vx.shpos):
            p = _keep_valid(pos.data[:n].to(pdt), limit, L)
            out = monotone_scatter(p, src.data[:n].to(dt), L)
        else:
            p = _keep_valid(torch.clamp(pos.data[:n].to(torch.int64), max=L),
                            limit, L)
            out = repeat_scatter(p, src.data[:n].to(dt), L)
        return Val(data=out, valid=L, length=L)

    # ------------------------------------------------------------------ sort
    def _eval_sortperm(self, vx: V.SortPerm, dt) -> Val:
        """ORDER BY's permutation: stable sorts composed last key first,
        each key in int64 (negated when descending).  Rows past the first
        key's ``valid`` take 2**62 and sink to the end in either
        direction."""
        vals = [self._force(self.eval(k)) for k in vx.keys]
        n = vals[0].length
        dev = self.device
        validmask = torch.arange(n, device=dev) < vals[0].valid
        big = self._i64(2**62)
        perm = None  # the identity until the first sort
        for kv, desc in list(zip(vals, vx.descs))[::-1]:
            kd = kv.data.to(torch.int64)
            key = torch.where(validmask, -kd if desc else kd, big)
            if perm is None:
                _, perm = torch.sort(key, stable=True)
            else:
                _, order = torch.sort(key[perm], stable=True)
                perm = perm[order]
        data = _mask_tail(perm.to(dt), vals[0].valid, n)
        return Val(data=data, valid=vals[0].valid, length=n)

    # ------------------------------------------------------ Like / DictMap
    def _eval_like(self, v: V.Vexp, vx: V.Like) -> Val:
        """The pattern is matched against the column's dictionary on the
        host, once per compiled query (the JAX engine does it once at trace
        time); each row then looks its code up in the matching set."""
        dval = self._force(self.eval(vx.ldata))
        tab = self.lookups.get(v.skey)
        if tab is None:
            dec = self.store.decoders.get(vx.lcol)
            if dec is None:
                raise KeyError(
                    f"no string dictionary for column {name_str(vx.lcol)}")
            rx = like_to_regex(vx.lpattern)
            codes = [c for c, st in dec.items() if rx.match(st)]
            tab = self._lookup_table(vx.ldata, codes, [1] * len(codes))
            self.lookups[v.skey] = tab
        found = self._lookup(tab, dval) != 0
        out = _mask_tail(found.to(torch_dtype_for(v.info)), dval.valid,
                         dval.length)
        return Val(data=out, valid=dval.valid, length=dval.length)

    def _eval_dictmap(self, v: V.Vexp, vx: V.DictMap) -> Val:
        """Code -> derived code through the plan's mapping, 0 for a code
        the mapping lacks; the table is built once per compiled query."""
        dval = self._force(self.eval(vx.ldata))
        tab = self.lookups.get(v.skey)
        if tab is None:
            tab = self._lookup_table(vx.ldata, [a for a, _ in vx.mapping],
                                     [b for _, b in vx.mapping])
            self.lookups[v.skey] = tab
        out = _mask_tail(
            self._lookup(tab, dval).to(torch_dtype_for(v.info)),
            dval.valid, dval.length)
        return Val(data=out, valid=dval.valid, length=dval.length)

    def _lookup_table(self, ldata: V.Vexp, codes: List[int],
                      values: List[int]) -> Optional[Tuple[int, torch.Tensor]]:
        """(lo, table) over the code domain [lo, hi] of ``ldata``'s bounds
        (a dictionary's codes), holding ``values`` at ``codes`` and 0
        elsewhere; None when no code lies in the domain."""
        lo, hi = ldata.info.bounds
        pairs = [(c, x) for c, x in zip(codes, values) if lo <= c <= hi]
        if not pairs:
            return None
        c = np.asarray([a for a, _ in pairs], np.int64)
        x = np.asarray([b for _, b in pairs], np.int64)
        tab = np.zeros(hi - lo + 1, np.int32 if x.max() <= INT32_MAX
                       else np.int64)
        tab[c - lo] = x
        return lo, self._upload(tab)

    def _lookup(self, tab: Optional[Tuple[int, torch.Tensor]],
                dval: Val) -> torch.Tensor:
        """Each row's code looked up in ``tab`` (``_lookup_table``): a
        gather through the table, routed by its size as any non-monotone
        gather is."""
        if tab is None:
            return torch.zeros(dval.length, dtype=torch.int32,
                               device=self.device)
        lo, t = tab
        pos = dval.data if lo == 0 else dval.data - lo
        return gather_many([t], pos, dval.valid,
                           small=t.shape[0] <= SMALL_TABLE)[0]

    # ---------------------------------------------------------- cross product
    def _eval_cross(self, v: V.Vexp, vx: V.CrossProduct) -> Val:
        """Row indices of the left (COUTER) or right (CINNER) side of every
        pair, left-major."""
        dev = self.device
        lv, rv = self.eval(vx.left), self.eval(vx.right)
        L = lv.length * rv.length
        total = self._i64(lv.valid) * self._i64(rv.valid)
        i = torch.arange(L, dtype=torch.int64, device=dev)
        mv = torch.clamp(self._i64(rv.valid), min=1)
        data = i // mv if vx.variant == V.COUTER else i % mv
        data = torch.where(i < total, data, self._i64(0))
        if isinstance(lv.valid, int) and isinstance(rv.valid, int):
            total = lv.valid * rv.valid
        return Val(data=data.to(torch_dtype_for(v.info)), valid=total,
                   length=L)

    # -------------------------------------------------------------- equijoins
    def _join_artifacts(self, lkeys: V.Vexp, rkeys: V.Vexp) -> dict:
        """Equijoin core, shared by every JoinIndex over one key pair: per
        left row, the first matching position ``lo`` in the sorted right
        side, the match count ``cnt`` and its inclusive prefix ``cum``;
        ``rs_idx`` is the right side's sort permutation.  The dense-domain
        join (``_dense_join``) builds them for a small build side; else the
        right keys sort and each left key's run is two binary searches."""
        key = (lkeys.skey, rkeys.skey)
        hit = self.join_cache.get(key)
        if hit is not None:
            return hit
        lv = self._force(self.eval(lkeys))
        rv = self._force(self.eval(rkeys))
        n, m = lv.length, rv.length
        # int32 keys when the bounds allow; the sentinels of invalid rows
        # sit just above the key domain and never match each other
        klo = min(lkeys.info.bounds[0], rkeys.info.bounds[0])
        khi = max(lkeys.info.bounds[1], rkeys.info.bounds[1])
        use32 = (klo > -(2**31) and khi < 2**31 - 3 and max(n, m) < 2**31)
        kdt = torch.int32 if use32 else torch.int64
        r_ok = _keep_valid(rv.data.to(kdt), rv.valid,
                           khi + 2 if use32 else 2**62)
        l_ok = _keep_valid(lv.data.to(kdt), lv.valid,
                           khi + 1 if use32 else 2**62 - 1)
        art = self._dense_join(key, lv, rv, l_ok, r_ok, klo, khi, use32,
                               lkeys)
        if art is None:
            rs, rs_idx = torch.sort(r_ok, stable=True)
            lo, hi = mergesearch.lo_hi(rs, l_ok)
            art = dict(path="merge", rs_idx=rs_idx.to(kdt), lo=lo,
                       cnt=hi - lo)
        art["cum"] = scan.cumsum(art["cnt"])
        art["total"] = art["cum"][-1] if n > 0 else self._i64(0)
        art.update(n=n, m=m, lvalid=lv.valid, syncs=0)
        self.join_cache[key] = art
        return art

    def _dense_sib_ok(self, lkeys: V.Vexp, r2: V.Vexp, klo: int,
                      khi: int) -> bool:
        """A sibling join's build side may batch only when it spans the
        same dense domain (same table length and decode) and its subtree
        holds no JoinIndex (building it from inside another join's
        artifacts must not recurse into join machinery)."""
        klo2 = min(lkeys.info.bounds[0], r2.info.bounds[0])
        khi2 = max(lkeys.info.bounds[1], r2.info.bounds[1])
        if (klo2, khi2) != (klo, khi):
            return False
        seen, stack = set(), [r2]
        while stack:
            y = stack.pop()
            if y.skey in seen:
                continue
            seen.add(y.skey)
            if isinstance(y.vx, V.JoinIndex):
                return False
            stack.extend(_children(y.vx))
        return True

    def _dense_join(self, key, lv: Val, rv: Val, l_ok: torch.Tensor,
                    r_ok: torch.Tensor, klo: int, khi: int, use32: bool,
                    lkeys: V.Vexp) -> Optional[dict]:
        """Dense-domain join artifacts, or None when the join is not
        eligible: int32 keys over a domain of at most DENSE_DOMAIN, a build
        side of 1 to DENSE_RIGHT_MAX rows, and probe keys that ascend or a
        domain of at most SMALL_TABLE.  Only the right side sorts; its run
        table (``_dense_tab``) is gathered at every probe key, through the
        small-table gather for a small domain and the monotone gather
        otherwise.  Sibling joins probing the same keys over the same
        domain stack their tables into the same gather launch.  ``lo`` and
        ``rs_idx`` keep the sort-merge path's meaning."""
        n, m = lv.length, rv.length
        D = khi - klo + 1
        small = D <= SMALL_TABLE
        if not (_dense_join_on() and use32 and 0 < D <= DENSE_DOMAIN
                and 1 <= m <= DENSE_RIGHT_MAX
                and (small or self._monotone(lkeys))):
            return None
        dev = self.device
        lk = torch.clamp(l_ok - klo, 0, D - 1)
        hit = self.dense_pre.pop(key, None)
        if hit is not None:
            rs_idx, pk = hit
        else:
            rs_idx, packed = _dense_tab(r_ok, m, klo, D)
            sibs = []
            for l2, r2 in self.dense_sibs.get(key[0], ()):
                k2 = (l2.skey, r2.skey)
                if (k2 == key or k2 in self.dense_pre
                        or k2 in self.join_cache
                        or not self._dense_sib_ok(lkeys, r2, klo, khi)):
                    continue
                rv2 = self._force(self.eval(r2))
                m2 = rv2.length
                if not 1 <= m2 <= DENSE_RIGHT_MAX:
                    continue
                r_ok2 = _keep_valid(rv2.data.to(torch.int32), rv2.valid,
                                    khi + 2)
                sibs.append((k2,) + _dense_tab(r_ok2, m2, klo, D))
            outs = gather_many([packed] + [t[2] for t in sibs], lk,
                               lv.valid, small=small)
            pk = outs[0]
            for (k2, rsi2, _), o in zip(sibs, outs[1:]):
                self.dense_pre[k2] = (rsi2, o)
        # cnt may reach 65,535, so the packed entry may be negative: an
        # arithmetic shift, then the low 16 bits
        lo = pk & 0xFFFF
        cg = (pk >> 16) & 0xFFFF
        in_dom = _and((l_ok >= klo) & (l_ok <= khi),
                      _valid_mask(n, lv.valid, dev))
        cnt = torch.where(in_dom, cg, torch.zeros((), dtype=cg.dtype,
                                                  device=dev))
        return dict(path="dense", rs_idx=rs_idx, lo=lo,
                    cnt=cnt.to(torch.int64))

    def _join_total(self, art: dict) -> int:
        """The pair count, read to the host once per key pair."""
        if "total_host" not in art:
            art["total_host"] = self._read(art["total"], "join_total")
            art["syncs"] += 1
        return art["total_host"]

    def _expansion(self, art: dict, total: int) -> dict:
        """Per output slot k < total: its left row ``li`` (ascending) and
        its right row ``ri``, left rows in order and each left row's
        matches in sorted right order.  Built once per key pair."""
        hit = art.get("exp")
        if hit is not None:
            return hit
        dev = self.device
        n, m = art["n"], art["m"]
        k = torch.arange(total, dtype=torch.int64, device=dev)
        li = torch.clamp(_expand_li(art["cum"], k), 0, max(n - 1, 0))
        if n < 2**31:
            li = li.to(torch.int32)
        cum, cnt, lo = gather_many([art["cum"], art["cnt"], art["lo"]], li,
                                   total)
        rpos = torch.clamp(lo + (k - (cum - cnt)), 0, max(m - 1, 0))
        ri = gather_many([art["rs_idx"]], rpos, total,
                         small=m <= SMALL_TABLE)[0]
        art["exp"] = {"li": li, "ri": ri}
        return art["exp"]

    def _eval_join_index(self, v: V.Vexp, vx: V.JoinIndex) -> Val:
        """One side of an equijoin.  Semi/anti: ascending positions of the
        left rows with (without) a match, at the left side's length.  Inner
        (left/right): one slot per pair, grouped by ascending left row.
        Outer: the inner pairs, then one slot per unmatched left row in
        ascending order (outer_right reads 0 there, outer_valid flags the
        matched slots).  Inner and outer lengths are the pair counts, read
        to the host once per key pair."""
        art = self._join_artifacts(vx.lkeys, vx.rkeys)
        dev = self.device
        dt = torch_dtype_for(v.info)
        n, side = art["n"], vx.jside
        syncs = art["syncs"]
        if side not in (V.JLEFT, V.JRIGHT):
            lmask = _valid_mask(n, art["lvalid"], dev)
        if side in (V.JSEMI, V.JANTI):
            has = art["cnt"] > 0
            keep = _and(has if side == V.JSEMI else ~has, lmask)
            sel = _sel_positions(keep, n)
            nz = keep.sum()
            out = Val(data=_mask_tail(sel.to(dt), nz, n), valid=nz, length=n)
        else:
            total = self._join_total(art)
            exp = self._expansion(art, total)
            if side == V.JLEFT:
                parts, valid = [exp["li"]], total
            elif side == V.JRIGHT:
                parts, valid = [exp["ri"]], total
            else:
                un = art.get("unmatched")
                if un is None:
                    mask = _and(art["cnt"] == 0, lmask)
                    n_un = self._read(mask.sum(), "unmatched")
                    art["syncs"] += 1
                    un = art["unmatched"] = (
                        _sel_positions(mask, max(n_un, 1))[:n_un], n_un)
                un_sel, n_un = un
                valid = total + n_un
                if side == V.JOUTER_LEFT:
                    parts = [exp["li"], un_sel]
                elif side == V.JOUTER_RIGHT:
                    parts = [exp["ri"],
                             torch.zeros(n_un, dtype=dt, device=dev)]
                else:  # JOUTER_VALID
                    parts = [torch.ones(total, dtype=dt, device=dev),
                             torch.zeros(n_un, dtype=dt, device=dev)]
            B = max(valid, 1)
            if valid < B:
                parts.append(torch.zeros(B - valid, dtype=dt, device=dev))
            out = Val(data=torch.cat([p.to(dt) for p in parts]), valid=valid,
                      length=B)
        self.join_log.append({"side": side, "path": art["path"], "n": n,
                              "m": art["m"], "out": out.length,
                              "syncs": art["syncs"] - syncs})
        return out

    # ---------------------------------------------------------------- binops
    def _eval_binop(self, v: V.Vexp, vx: V.Binop) -> Val:
        """A constant operand stays a scalar and only the column operand is
        cast; a Binop of two constants is a constant, computed on the host
        by the same torch ops on 0-d CPU tensors."""
        lv, rv = self.eval(vx.left), self.eval(vx.right)
        ka, kb = self._take(lv), self._take(rv)
        if ka is None:
            lv = self._force(lv)
        if kb is None:
            rv = self._force(rv)
        L = min(lv.length, rv.length)
        dt = torch_dtype_for(v.info)
        # compute in a width that holds operands and result
        cdt = torch.promote_types(torch.promote_types(
            torch_dtype_for(vx.left.info) if ka is not None
            else lv.data.dtype,
            torch_dtype_for(vx.right.info) if kb is not None
            else rv.data.dtype), dt)
        valid = self._vmin(lv.valid, rv.valid)
        if ka is not None and kb is not None:
            k = _binop(vx.binop, torch.tensor(ka, dtype=cdt),
                       torch.tensor(kb, dtype=cdt))
            return Val(data=None, valid=valid, length=L,
                       lazy_range=(int(k.to(dt)), 0), dtype=dt)
        a = ka if ka is not None else lv.data[:L].to(cdt)
        b = kb if kb is not None else rv.data[:L].to(cdt)
        out = _mask_tail(_binop(vx.binop, a, b).to(dt), valid, L)
        return Val(data=out, valid=valid, length=L)

    # ----------------------------------------------------------------- folds
    def _group_artifacts(self, fgroups: V.Vexp, L_out: int,
                         fmask: Optional[V.Vexp] = None) -> dict:
        """What the folds over one group key share.  Over a domain of at
        most SMALL_DOMAIN ids (dense): each row's id, ``domain`` for a
        row the mask drops (``ids_ok``); for a constant key, no ids but
        the key ``key`` and the row mask ``ok`` (None: every row).  Over
        a larger domain, the sort-based group-by's artifacts."""
        key = (fgroups.skey, fmask.skey if fmask is not None else None, L_out)
        hit = self.group_cache.get(key)
        if hit is not None:
            return hit
        g = self.eval(fgroups)
        gmin, gmax = fgroups.info.bounds
        if gmin < 0:
            raise ValueError("group ids must be non-negative")
        domain = gmax + 1
        n = g.length
        ok = _valid_mask(n, g.valid, self.device)
        if fmask is not None:
            m = self._force(self.eval(fmask))
            ok = _and(ok, m.data[:n] != 0)
        if domain > segred.SMALL_DOMAIN:
            art = self._sparse_artifacts(self._force(g), ok, domain, L_out)
        elif _const(g) is not None:
            # every row the mask keeps is in one group
            art = {"dense": True, "n": n, "domain": domain, "ids_ok": None,
                   "key": min(max(self._take(g), 0), domain - 1), "ok": ok}
        else:
            ids = torch.clamp(self._force(g).data, 0, domain - 1)
            art = {"dense": True, "n": n, "domain": domain,
                   "ids_ok": ids if ok is None
                   else torch.where(ok, ids, domain)}
        self.group_cache[key] = art
        return art

    def _sparse_artifacts(self, g: Val, validmask: Optional[torch.Tensor],
                          domain: int, L_out: int) -> dict:
        """The sort-based group-by: a stable sort of the masked ids (the
        masked-out rows carry the sentinel ``domain`` and sort last), then
        runs of equal ids.  ``perm`` orders each fold's payload; ``starts``
        and ``ends`` are the first and last sorted row of each run (entries
        past ``ngroups`` are 0); ``run_ok`` is each sorted row's run, or
        ``L_out`` for a masked-out row.  The JAX engine's co-sorted payloads
        (``fold_payload_map``, ``MPLAN2VDL_COSORT_CAP``) bound XLA's compile
        time and have no counterpart: every payload gathers through
        ``perm`` with the gather kernel, which is right for any order."""
        n = g.length
        # int32 sort keys when the id domain allows (sentinel included)
        kdt = torch.int32 if (domain < 2**31 - 1 and n < 2**31) \
            else torch.int64
        ids_ok = g.data[:n].to(kdt)
        if validmask is not None:
            ids_ok = torch.where(validmask, ids_ok, domain)
        sorted_ids, perm = torch.sort(ids_ok, stable=True)
        if n < 2**31:
            perm = perm.to(torch.int32)
        sorted_valid = sorted_ids < domain
        head = _changes(sorted_ids)
        run_id = scan.cumsum_flags(head) - 1
        run_ok = torch.where(sorted_valid, run_id, L_out)
        ngroups = (head & sorted_valid).sum()
        nvalid = sorted_valid.sum()
        # run starts ascend (the compaction kernel); L_out <= n
        starts = _sel_positions(head, L_out).to(torch.int64)
        ends = self._run_ends(starts, ngroups, nvalid, n)
        return {"dense": False, "n": n, "perm": perm, "run_ok": run_ok,
                "ngroups": ngroups, "nvalid": nvalid, "starts": starts,
                "ends": ends}

    def _eval_fold(self, v: V.Vexp, vx: V.Fold) -> Val:
        fam = self.fold_map.get(v.skey)
        if fam is not None:
            return self._eval_fused(v, fam)
        plan = self.expr_plans.get(v.skey)
        if plan is not None:
            out = self._eval_expr_fold(v, vx, plan)
            if out is not None:
                return out
        dt = torch_dtype_for(v.info)
        g = self.eval(vx.fgroups)
        domain = vx.fgroups.info.bounds[1] + 1
        dval = self.eval(vx.fdata)
        L_out = min(domain, g.length, dval.length)
        if vx.foldop == V.FDISTINCT:
            return self._eval_fold_distinct(vx, dt, domain, L_out)
        art = self._group_artifacts(vx.fgroups, L_out, vx.fmask)
        n = art["n"]
        if dval.length < n:
            raise ValueError(f"fold payload of {dval.length} rows under "
                             f"{n} group ids")
        # a constant payload c sums to c times the count, and is its own
        # min, max and choice wherever its group is occupied
        c = self._take(dval)
        data = None if c is not None else self._force(dval).data[:n].to(dt)
        if not art["dense"]:
            return self._eval_sparse_fold(vx, art, data, c, dt, L_out)
        opname = {V.FSUM: "sum", V.FMAX: "max", V.FMIN: "min",
                  V.FCHOOSE: "max"}[vx.foldop]
        ids_ok, domain = art["ids_ok"], art["domain"]
        if ids_ok is not None:
            counts = segred.group_counts(ids_ok, domain)
        else:
            counts = segred.one_group_counts(art["ok"], art["key"], domain,
                                             n, self.device)
        if c is not None:
            agg = counts * c if vx.foldop == V.FSUM else torch.full_like(
                counts, c)
        elif ids_ok is not None:
            agg = segred.masked_group_reduce(data, ids_ok, domain, opname)
        else:
            agg = segred.one_group_reduce(data, art["ok"], art["key"],
                                          domain, opname)
        return _dense_tail(agg, counts, dt, L_out)

    def _program_args(self, plan: "Program", n: int
                      ) -> Optional[Tuple[List[torch.Tensor], List[int]]]:
        """The leaf columns and immediates of a one-pass program over ``n``
        rows, where every leaf and constant spans them (``valid`` a host int
        equal to the length, as a resident column's is), each leaf has a
        buffer of a dtype the kernel reads, each constant fits its dtype and
        ``n`` is under 2^31; None otherwise, before any constant is
        counted."""
        def whole(val: Val) -> bool:
            return (isinstance(val.valid, int) and val.valid == n
                    and val.length == n)

        if not 0 < n < 2**31:
            return None
        leaves = [self.eval(x) for x in plan.leaves]
        if not all(whole(x) and x.data is not None
                   and x.data.dtype in EXPR_DTYPES for x in leaves):
            return None
        for c in plan.consts:
            if c is not None:
                val = self.eval(c)
                k = _const(val)
                info = torch.iinfo(torch_dtype_for(c.info))
                if (k is None or not whole(val)
                        or not info.min <= k <= info.max):
                    return None
        imms = []
        for c, imm, shift in zip(plan.consts, plan.imms, plan.shifts):
            if c is not None:
                imm = self._take(self.eval(c))
            # a shift by 63 or more moves as far as one by 63
            imms.append(max(-63, min(imm, 63)) if shift else imm)
        return [x.data for x in leaves], imms

    def _eval_expr_fold(self, v: V.Vexp, vx: V.Fold,
                        plan: "ExprFold") -> Optional[Val]:
        """A planned fold (``exprfold.plan``) in one pass over its leaf
        columns, where the key is a constant that spans its rows and
        ``_program_args`` takes the program over them; None otherwise,
        before anything is counted, and ``_eval_fold`` takes its usual
        path."""
        g = self.eval(vx.fgroups)
        n = g.length
        if not (isinstance(g.valid, int) and g.valid == n
                and _const(g) is not None):
            return None
        args = self._program_args(plan, n)
        if args is None:
            return None
        leaves, imms = args
        domain = vx.fgroups.info.bounds[1] + 1
        key = min(max(self._take(g), 0), domain - 1)
        res = expr_fold(leaves, plan.program, imms, plan.foldop, plan.fold32)
        self.expr_folds += 1
        tab = res.new_zeros((2, domain))
        tab[:, key] = res
        return _dense_tail(tab[0], tab[1], torch_dtype_for(v.info),
                           min(domain, n))

    def _eval_fold_distinct(self, vx: V.Fold, dt, domain: int,
                            L_out: int) -> Val:
        """count(DISTINCT x) per group: sort the (group id, value) pairs,
        flag the adjacent-unique ones, and count the flags per group, by
        one masked reduction per id over a small domain or by a prefix sum
        read at the group runs' ends otherwise.  Output slots are the
        ascending occupied group ids, aligned with the sibling folds on the
        same key.  Masked-out rows take the id ``domain`` and value 0."""
        dev = self.device
        gv = self._force(self.eval(vx.fgroups))
        dv = self._force(self.eval(vx.fdata))
        n = min(gv.length, dv.length)
        validmask = _valid_mask(n, self._vmin(gv.valid, dv.valid), dev)
        if vx.fmask is not None:
            m = self._force(self.eval(vx.fmask))
            validmask = _and(validmask, m.data[:n] != 0)
        # int32 keys when the bounds allow
        dlo, dhi = vx.fdata.info.bounds
        use32 = (domain < 2**31 - 1 and dlo > -(2**31) + 1
                 and dhi < 2**31 - 1)
        kdt = torch.int32 if use32 else torch.int64
        ids_ok = torch.clamp(gv.data[:n].to(kdt), 0, domain - 1)
        vals = dv.data[:n].to(kdt)
        if validmask is not None:
            ids_ok = torch.where(validmask, ids_ok, domain)
            vals = torch.where(validmask, vals, 0)
        sid, fresh = _sort_pairs(ids_ok, vals, domain, min(dlo, 0),
                                 max(dhi, 0))
        svalid = sid < domain
        new_pair = fresh & svalid
        if domain <= segred.SMALL_DOMAIN:
            agg, counts = segred.masked_group_reduce_with_counts(
                new_pair.to(torch.int64), sid, domain, "sum")
            occ = counts > 0
            ngroups = occ.sum()
            out = agg[_sel_positions(occ, L_out).long()]
        else:
            # the group runs of the sorted stream: their heads, first and
            # last rows, and the new-pair flags counted between them
            head = _changes(sid) & svalid
            ngroups = head.sum()
            starts = _sel_positions(head, L_out).to(torch.int64)
            out = self._run_sums(scan.cumsum_flags(new_pair), starts,
                                 self._run_ends(starts, ngroups,
                                                svalid.sum(), n),
                                 ngroups)
        out = _mask_tail(out.to(dt), ngroups, L_out)
        return Val(data=out, valid=ngroups, length=L_out)

    def _eval_sparse_fold(self, vx: V.Fold, art: dict,
                          data: Optional[torch.Tensor], c: Optional[int],
                          dt, L_out: int) -> Val:
        """One fold over the sorted runs: a sum is the difference of an
        int64 prefix sum at run ends, choose reads run starts, and min/max
        reduce each run with ``scatter_reduce`` over the run ids.  A
        constant payload ``c`` (``data`` None) takes no pass over the rows:
        ``c`` times each run's length, or ``c``."""
        dev = self.device
        n, ngroups = art["n"], art["ngroups"]
        kmask = torch.arange(L_out, device=dev) < ngroups
        if c is not None:
            out = (art["ends"] - art["starts"] + 1) * c \
                if vx.foldop == V.FSUM else c
            out = torch.where(kmask, out, 0)
            return Val(data=_mask_tail(out.to(dt), ngroups, L_out),
                       valid=ngroups, length=L_out)
        sd = _mask_tail(gather_many([data], art["perm"], n)[0],
                        art["nvalid"], n)
        starts = torch.clamp(art["starts"], 0, n - 1)
        if vx.foldop == V.FSUM:
            out = self._run_sums(torch.cumsum(sd.to(torch.int64), 0),
                            art["starts"], art["ends"], ngroups)
        elif vx.foldop == V.FCHOOSE:
            out = torch.where(kmask, sd[starts].to(torch.int64), 0)
        else:  # FMIN / FMAX
            info = torch.iinfo(torch.int64)
            ident, how = ((info.max, "amin") if vx.foldop == V.FMIN
                          else (info.min, "amax"))
            red = torch.full((L_out + 1,), ident, dtype=torch.int64,
                             device=dev)
            red.scatter_reduce_(0, torch.clamp(art["run_ok"], 0, L_out),
                                sd.to(torch.int64), how)
            out = torch.where(kmask, red[:L_out], 0)
        out = _mask_tail(out.to(dt), ngroups, L_out)
        return Val(data=out, valid=ngroups, length=L_out)

    def _eval_fused(self, v: V.Vexp, key: tuple) -> Val:
        """One fold of a fused multi-aggregate family: the whole family
        computes in ONE kernel pass over the rows (engine/fuse.py,
        kernels/multiagg.py) and is cached; each fold takes its column and
        compacts to occupied groups exactly like the dense path.

        With MPLAN2VDL_MXU_AGG on, as in the JAX engine, the family's "sum"
        specs (the appended count spec included) go to the tensor-core
        contraction (kernels/multiagg_mxu.py) and its "max" specs (FChoose
        group-key representatives) to kernels/multiagg.py, and the two
        outputs are stacked back into spec order.  The JAX engine's
        MPLAN2VDL_MXU_DOT picks between two Mosaic operand layouts and has
        no counterpart here."""
        fam_idx, agg_idx = key
        fam = self.families[fam_idx]
        hit = self.fused_cache.get(fam_idx)
        if hit is None:
            gid = self._fused_ids(v, fam_idx)
            if gid is None:
                gid = self._node_ids(fam)
            n = gid.shape[0]
            cols = []
            for nm in fam.load_names:
                arr = self.tables[nm]
                if len(arr) != n:
                    raise ValueError(f"fused column {name_str(nm)} holds "
                                     f"{len(arr)} rows, group ids {n}")
                cols.append(arr.to(torch.int32))
            specs = list(fam.specs) + [AggSpec(base=None, bits=1)]
            if mxu_agg_on():
                s_idx = [i for i, s in enumerate(specs) if s.op == "sum"]
                m_idx = [i for i, s in enumerate(specs) if s.op == "max"]
                out_s = fused_group_aggregate_mxu(
                    cols, gid, [specs[i] for i in s_idx], fam.domain)
                parts = {i: out_s[:, j] for j, i in enumerate(s_idx)}
                if m_idx:
                    out_m = fused_group_aggregate(
                        cols, gid, [specs[i] for i in m_idx], fam.domain)
                    parts.update(
                        {i: out_m[:, j] for j, i in enumerate(m_idx)})
                out = torch.stack([parts[i] for i in range(len(specs))],
                                  dim=1)
            else:
                out = fused_group_aggregate(cols, gid, specs, fam.domain)
            occ = out[:, -1] > 0
            hit = {"out": out, "occ": occ, "ngroups": occ.sum()}
            self.fused_cache[fam_idx] = hit
        dt = torch_dtype_for(v.info)
        L_out = min(fam.domain, v.info.count)
        sel = _sel_positions(hit["occ"], L_out)
        vals = hit["out"][sel.long(), agg_idx]
        data = _mask_tail(vals.to(dt), hit["ngroups"], L_out)
        return Val(data=data, valid=hit["ngroups"], length=L_out)

    def _node_ids(self, fam) -> torch.Tensor:
        """The int32 group ids of fused family ``fam`` from its key and
        mask nodes, evaluated one by one: -1 where the mask or the key's
        validity drops a row."""
        g = self._force(self.eval(fam.fgroups))
        n = g.length
        valid = _valid_mask(n, g.valid, self.device)
        if fam.fmask is not None:
            m = self._force(self.eval(fam.fmask))
            valid = _and(valid, m.data[:n] != 0)
        gid = g.data[:n].to(torch.int32)
        return gid if valid is None else torch.where(valid, gid, -1)

    def _fused_ids(self, v: V.Vexp, fam_idx: int) -> Optional[torch.Tensor]:
        """The int32 group ids of fused family ``fam_idx`` (-1 where its
        mask drops a row) in one pass over its planned program's leaves
        (``exprfold.plan_keys``), where ``_program_args`` takes it over the
        first leaf's rows; None otherwise, and ``_eval_fused`` evaluates
        the key and mask nodes.  ``v`` is the fold being evaluated."""
        plan = self.key_plans.get(fam_idx)
        if plan is None:
            return None
        args = self._program_args(plan, self.eval(plan.leaves[0]).length)
        if args is None:
            return None
        leaves, imms = args
        self.key_programs += 1
        return group_ids(leaves, plan.program, imms, plan.rmin, plan.rcount)

    # ------------------------------------------------------------ partitions
    def _eval_partition(self, v: V.Vexp, vx: V.Partition) -> Val:
        dval = self._force(self.eval(vx.pdata))
        dt = torch_dtype_for(v.info)
        piv = vx.pivots.vx
        if isinstance(piv, V.RangeC) and piv.rstep == 1:
            out = torch.clamp(dval.data.to(torch.int64) - piv.rmin, 0,
                              piv.rcount - 1)
        else:
            pv = self._force(self.eval(vx.pivots))
            out = mergesearch.searchsorted_fast(pv.data, dval.data, "left")
        out = _mask_tail(out.to(dt), dval.valid, dval.length)
        return Val(data=out, valid=dval.valid, length=dval.length)


# ------------------------------------------------------------------ query API
@dataclass
class QueryResult:
    names: List[Optional[Name]]
    dtypes: List[object]
    columns: List[np.ndarray]  # raw encoded values, trimmed to valid length

    def decoded(self, store: ColumnStore) -> List[Tuple[str, np.ndarray]]:
        """Decode raw ints per display type (the resolve.py step)."""
        out = []
        for nm, dt, col in zip(self.names, self.dtypes, self.columns):
            label = name_str(nm) if nm else "val"
            if isinstance(dt, DDecimal) and dt.point > 0:
                out.append((label, col / (10 ** dt.point)))
            elif isinstance(dt, DString):
                dec = store.decoders.get(dt.decoder, {})
                out.append((label,
                            np.array([dec.get(int(c), str(c)) for c in col])))
            elif isinstance(dt, DDate):
                import datetime

                out.append((label, np.array(
                    [datetime.date.fromordinal(int(c) - 365).isoformat()
                     for c in col])))
            else:
                out.append((label, col))
        return out


def gather_mate_map(roots: List[V.Vexp]) -> dict:
    """pos.skey -> [(gather node, reachable-member-skeys)] for every
    GATHER under roots, grouped by shared position vector.  The
    reachability set (which OTHER members of the same group appear in
    this member's source subtree) lets the batched evaluation skip
    mates that would recurse into the node being evaluated."""
    seen, groups = set(), {}

    def go(x: V.Vexp):
        if x.skey in seen:
            return
        seen.add(x.skey)
        for c in _children(x.vx):
            go(c)
        if isinstance(x.vx, V.Shuffle) and x.vx.shop == V.GATHER:
            groups.setdefault(x.vx.shpos.skey, []).append(x)

    for x in roots:
        go(x)
    out = {}
    for pk, nodes in groups.items():
        if len(nodes) < 2:
            continue
        member_keys = {n.skey for n in nodes}
        entries = []
        for n in nodes:
            reach, stack, vis = set(), [n.vx.shsource], set()
            while stack:
                y = stack.pop()
                if y.skey in vis:
                    continue
                vis.add(y.skey)
                if y.skey in member_keys:
                    reach.add(y.skey)
                stack.extend(_children(y.vx))
            entries.append((n, frozenset(reach)))
        out[pk] = tuple(entries)
    return out


def join_key_pairs(roots: List[V.Vexp]):
    """(lkeys, rkeys) of every JoinIndex under ``roots``, each pair once,
    in dependency post-order."""
    seen, seenp, out = set(), set(), []

    def go(v: V.Vexp):
        if v.skey in seen:
            return
        seen.add(v.skey)
        for c in _children(v.vx):
            go(c)
        if isinstance(v.vx, V.JoinIndex):
            kp = (v.vx.lkeys.skey, v.vx.rkeys.skey)
            if kp not in seenp:
                seenp.add(kp)
                out.append((v.vx.lkeys, v.vx.rkeys))

    for v in roots:
        go(v)
    return out


def fused_agg_on(store: ColumnStore, loads) -> bool:
    """The fused-aggregate gate: MPLAN2VDL_FUSED_AGG=1/0 forces it; unset
    (or ``auto``) turns it on when a loaded column has FUSED_AUTO_ROWS."""
    fused = os.environ.get("MPLAN2VDL_FUSED_AGG", "")
    if fused in ("", "auto"):
        return any(len(store.columns[n]) >= FUSED_AUTO_ROWS for n in loads)
    return fused != "0"


def _nbytes(val: Val) -> int:
    """Bytes of a runtime vector's buffer (none for a lazy range)."""
    d = val.data
    return 0 if d is None else d.numel() * d.element_size()


def _node_kind(vx: V.Vx) -> str:
    """A VIR node's kind in traffic tables: its class, with the op of a
    Shuffle, Fold or Binop."""
    op = (getattr(vx, "shop", None) or getattr(vx, "foldop", None)
          or getattr(vx, "binop", None))
    return f"{type(vx).__name__} {op}" if op else type(vx).__name__


def _node_label(v: V.Vexp) -> str:
    name = f" {name_str(v.name)}" if v.name else ""
    return f"{_node_kind(v.vx)} #{v.skey}{name}"


# span name of each VIR node, by structural key (a node's kind is fixed by
# its structure); filled as traced calls evaluate nodes
_SPAN_NAMES: Dict[int, str] = {}


class TracedCompiler(Compiler):
    """The instrumented ``Compiler``.  While torch.profiler records, each
    VIR node it evaluates is a span ``m2v_node.<kind>``, each count read
    to the host a span ``m2v_sync.<site>``, each upload a span
    ``m2v_sync.upload``, and ``fetch`` a span ``m2v_result`` around its
    reads (``tracing``): one ``m2v_sync.*`` span for each of the call's
    ``host_syncs``; each constant written out is a span
    ``m2v_const.materialize``, one for each of ``consts_materialized``.
    ``order`` keeps the evaluated nodes, from which ``charges`` computes
    their byte traffic; ``expr_reads`` the leaf columns that each one-pass
    fold read in place of its children.
    ``CompiledQuery`` uses it for ``cost_report`` and for a call while the
    profiler records; otherwise a call evaluates with ``Compiler`` and
    records nothing."""

    def trace(self, vexps: List[V.Vexp], tables: Dict[Name, torch.Tensor]
              ) -> List[Val]:
        self.order: List[V.Vexp] = []
        self.expr_reads: Dict[int, Tuple[V.Vexp, ...]] = {}
        return super().trace(vexps, tables)

    def eval(self, v: V.Vexp) -> Val:
        hit = self.memo.get(v.skey)
        if hit is not None:
            return hit
        name = _SPAN_NAMES.get(v.skey)
        if name is None:
            name = _SPAN_NAMES[v.skey] = "m2v_node." + _node_kind(v.vx)
        with tracing.span(name):
            out = super().eval(v)
        self.order.append(v)
        return out

    def charges(self) -> List[Tuple[V.Vexp, int, int]]:
        """(node, bytes, output bytes) of each evaluated node in evaluation
        order, the rule the JAX package's ``engine/hloprof.py`` applies to
        HLO instructions: its output buffer, plus the buffers of its
        operands already evaluated when it was (of a one-pass fold, its
        leaf columns).  Loads are charged to the nodes that read them, as
        HLO parameters are."""
        done, out = set(), []
        for v in self.order:
            if not isinstance(v.vx, V.Load):
                ob = _nbytes(self.memo[v.skey])
                reads = self.expr_reads.get(v.skey) or _children(v.vx)
                ib = sum(_nbytes(self.memo[c.skey]) for c in reads
                         if c.skey in done)
                out.append((v, ib + ob, ob))
            done.add(v.skey)
        return out

    def _read(self, t: torch.Tensor, site: str) -> int:
        with tracing.span("m2v_sync." + site):
            return super()._read(t, site)

    def _copy(self, t: torch.Tensor) -> np.ndarray:
        with tracing.span("m2v_sync.result_copy"):
            return super()._copy(t)

    def _upload(self, x, dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
        with tracing.span("m2v_sync.upload"):
            return super()._upload(x, dtype)

    def _materialize(self, val: Val) -> Val:
        with tracing.span("m2v_const.materialize"):
            return super()._materialize(val)

    def _eval_expr_fold(self, v: V.Vexp, vx: V.Fold,
                        plan: "ExprFold") -> Optional[Val]:
        out = super()._eval_expr_fold(v, vx, plan)
        if out is not None:
            self.expr_reads[v.skey] = plan.leaves
        return out

    def _fused_ids(self, v: V.Vexp, fam_idx: int) -> Optional[torch.Tensor]:
        out = super()._fused_ids(v, fam_idx)
        if out is not None:
            self.expr_reads[v.skey] = self.key_plans[fam_idx].leaves
        return out

    def fetch(self, vals: List[Val]) -> List[np.ndarray]:
        with tracing.span("m2v_result"):
            return super().fetch(vals)


class CompiledQuery:
    """One query bound to one store and one device.  The loaded columns go
    to the device once, on the first call; each call evaluates the DAG
    eagerly there."""

    def __init__(self, cfg: Config, vexps: List[V.Vexp], store: ColumnStore,
                 device=None):
        self.device = D.resolve(device)
        self.cfg = cfg
        self.vexps = vexps
        self.store = store
        self.loads = sorted({vx.name for vx in _all_loads(vexps)})
        self._args: Optional[Tuple[torch.Tensor, ...]] = None
        self.fold_map, self.families = {}, []
        if fused_agg_on(store, self.loads):
            from .fuse import plan_fusions

            self.fold_map, self.families = plan_fusions(vexps)
        from .exprfold import plan, plan_keys

        self.expr_plans = plan(vexps, self.fold_map)
        self.key_plans = plan_keys(self.families)
        self.gather_mates = gather_mate_map(vexps)
        sibs: Dict[int, list] = {}
        for lk, rk in join_key_pairs(vexps):
            sibs.setdefault(lk.skey, []).append((lk, rk))
        self.dense_sibs = {k: tuple(ps) for k, ps in sibs.items()
                           if len(ps) > 1}
        self.lookups: dict = {}
        self.join_log: List[dict] = []
        # after a call, its blocking transfers (``Compiler.host_syncs``):
        # the counts read and host values uploaded while evaluating, then
        # each result column's count (where it is on the device) and rows;
        # after ``run``, all but the result's
        self.host_syncs = 0
        # after a call, the constants its consumers took as scalars and
        # those written out (``Compiler.consts_scalar`` and
        # ``consts_materialized``), the folds computed in one pass
        # (``Compiler.expr_folds``) and the fused families whose group ids
        # were (``Compiler.key_programs``)
        self.consts_scalar = self.consts_materialized = 0
        self.expr_folds = self.key_programs = 0

    def device_args(self, upload=None) -> Tuple[torch.Tensor, ...]:
        """The loaded columns on the device, copied there on first use: by
        ``upload`` (a call's ``Compiler._upload``, which counts the copies)
        when given."""
        if self._args is None:
            up = upload or (lambda a: torch.as_tensor(a, device=self.device))
            self._args = tuple(
                up(np.require(self.store.columns[n], requirements=["C", "W"]))
                for n in self.loads)
        return self._args

    def run(self) -> List[Val]:
        """Evaluate the DAG; results stay on the device."""
        return self._run(Compiler)[0]

    def _run(self, cls) -> Tuple[List[Val], Compiler]:
        c = cls(self.store, self.device, self.fold_map, self.families,
                self.gather_mates, self.dense_sibs, self.lookups,
                self.expr_plans, self.key_plans)
        args = self.device_args(c._upload)
        out = c.trace(self.vexps, dict(zip(self.loads, args)))
        self.join_log, self.host_syncs = c.join_log, c.host_syncs
        self.consts_scalar = c.consts_scalar
        self.consts_materialized = c.consts_materialized
        self.expr_folds = c.expr_folds
        self.key_programs = c.key_programs
        return out, c

    def cost_report(self, hbm_gbps: Optional[float] = None,
                    per_op: bool = False) -> dict:
        """Memory-roofline accounting of one call (the JAX engine's
        ``cost_report``).

        ``scan_bytes`` is one read of every loaded column (the bytes of
        ``device_args()``), the least traffic a call can make.
        ``bytes_accessed`` comes from one extra evaluation by
        ``TracedCompiler``, which charges each evaluated VIR node its
        operand and output buffer bytes; ``amplification`` is their ratio.
        It is an estimate, as the JAX engine's is: a kernel may read an
        operand more than once, or not all of it.  There is no program to
        count operations in, so ``flops`` is None.  With the device's
        memory rate ``hbm_gbps`` (GB/s; no default), ``roofline_floor_s``
        is the scan at that rate and ``traffic_time_s`` the estimated
        traffic.  With ``per_op``, ``per_op`` holds ``by_kind`` (bytes per
        VIR node kind, largest first) and ``top_nodes`` (label, bytes and
        output bytes of the costliest nodes)."""
        scan = sum(a.numel() * a.element_size() for a in self.device_args())
        charges = self._run(TracedCompiler)[1].charges()
        total = sum(b for _, b, _ in charges)
        out = {"scan_bytes": scan, "bytes_accessed": total, "flops": None,
               "amplification": total / scan if total and scan else None}
        if hbm_gbps:
            out["roofline_floor_s"] = scan / (hbm_gbps * 1e9)
            out["traffic_time_s"] = total / (hbm_gbps * 1e9)
        if per_op:
            by_kind: Dict[str, int] = {}
            for v, b, _ in charges:
                k = _node_kind(v.vx)
                by_kind[k] = by_kind.get(k, 0) + b
            top = sorted(charges, key=lambda r: -r[1])[:12]
            out["per_op"] = {
                "total_bytes": total,
                "by_kind": dict(sorted(by_kind.items(),
                                       key=lambda kv: -kv[1])),
                "top_nodes": [(_node_label(v), b, ob) for v, b, ob in top]}
        return out

    def __call__(self) -> QueryResult:
        """One call, its rows on the host.  While torch.profiler records,
        the call is a span ``m2v_query`` evaluated by ``TracedCompiler``."""
        if not tracing.recording():
            return self._fetch(Compiler)
        with tracing.span("m2v_query"):
            return self._fetch(TracedCompiler)

    def _fetch(self, cls) -> QueryResult:
        vals, c = self._run(cls)
        cols = c.fetch(vals)
        self.host_syncs = c.host_syncs
        return QueryResult(names=[v.name for v in self.vexps],
                           dtypes=[v.info.dtype for v in self.vexps],
                           columns=cols)


def _all_loads(vexps: List[V.Vexp]):
    seen = set()
    out = []

    def go(v: V.Vexp):
        if v.skey in seen:
            return
        seen.add(v.skey)
        if isinstance(v.vx, V.Load):
            out.append(v.vx)
        for c in _children(v.vx):
            go(c)
        if v.lineage is not None:
            go(v.lineage.mask)

    for v in vexps:
        go(v)
    return out


def _children(vx: V.Vx) -> List[V.Vexp]:
    if isinstance(vx, (V.Load, V.RangeC)):
        return []
    if isinstance(vx, V.RangeV):
        return [vx.rref]
    if isinstance(vx, V.Binop):
        return [vx.left, vx.right]
    if isinstance(vx, V.Shuffle):
        out = [vx.shsource, vx.shpos]
        if vx.shshape is not None:
            out.append(vx.shshape)
        return out
    if isinstance(vx, V.Fold):
        out = [vx.fgroups, vx.fdata]
        if vx.fmask is not None:
            out.append(vx.fmask)
        return out
    if isinstance(vx, V.Semisort):
        return [vx.sdata]
    if isinstance(vx, V.SortPerm):
        return list(vx.keys)
    if isinstance(vx, V.Partition):
        return [vx.pivots, vx.pdata]
    if isinstance(vx, V.Like):
        return [vx.ldata]
    if isinstance(vx, V.DictMap):
        return [vx.ldata]
    if isinstance(vx, V.VShuffle):
        return [vx.varg]
    if isinstance(vx, V.CrossProduct):
        return [vx.left, vx.right]
    if isinstance(vx, V.JoinIndex):
        return [vx.lkeys, vx.rkeys]
    raise TypeError(vx)


def plan_to_vexps(text: str, cfg: Config) -> List[V.Vexp]:
    """mplan text -> engine vector IR after the engine passes (frontend
    half of ``compile``, MainFuns.hs:172-186)."""
    from ..fe import lexer, plan_parser
    from .. import mplan, passes, vir

    rel = plan_parser.parse(lexer.strip_plan_comments(text))
    m = mplan.mplan_from_parse_tree(rel, cfg)
    return passes.engine_passes(vir.vexps_from_mplan(m, cfg))


def compile_plan_text(text: str, cfg: Config, store: ColumnStore,
                      device=None) -> CompiledQuery:
    """mplan text -> CompiledQuery on ``device`` (default ``cuda``)."""
    return CompiledQuery(cfg, plan_to_vexps(text, cfg), store, device=device)
