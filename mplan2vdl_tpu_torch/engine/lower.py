"""VIR -> torch: evaluate a query's vector-IR DAG eagerly on one device.

Execution model: every vector is a buffer whose length is the node's count
bound, paired with a ``valid`` count; slots past ``valid`` hold zeros.  The
JAX engine traces the whole DAG into one program with static shapes, so it
resolves data-dependent sizes in a counting pre-pass; the port runs eagerly
and reads each such size where it arises instead — so far that is only a
selection's survivor count (one host sync per ``Fold FSel``).  The results
are the JAX engine's, row for row.

Physical dtypes are chosen per node from the catalog's value bounds (int32
when they fit, int64 otherwise); integers are native int64, with no
plane splitting.

The port evaluates Load, RangeC, RangeV, Binop, ``Shuffle GATHER``,
``Shuffle SCATTER`` through unique monotone positions, ``Fold FSel``,
dense-domain folds (one masked reduction per group id, or the fused
multi-aggregate kernel for families of folds sharing a group key), the
sparse sort-based group-by and Partition.  On the GPU, compaction, the
gathers, the scatter and the fused aggregate (with MPLAN2VDL_MXU_AGG=1 its
sums on the tensor cores) run as hand-written CUDA kernels (``kernels/``).
Every other node kind raises ``NotImplementedError`` naming it: a plan
beyond the port fails loudly.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import device as D
from .. import mplan as M
from .. import vir as V
from ..catalog import ColInfo, Config
from ..mtypes import DDate, DDecimal, DString, INT32_MAX, INT32_MIN
from ..names import Name, name_str
from .columnstore import ColumnStore
from . import mergesearch, scan
from .kernels import segred
from .kernels.compact import compact_positions
from .kernels.multiagg import AggSpec, fused_group_aggregate
from .kernels.multiagg_mxu import fused_group_aggregate_mxu, mxu_agg_on
from .kernels.scatter import monotone_scatter
from .kernels.sorted_gather import SMALL_TABLE, gather_many

# The fused-aggregate gate: on automatically when any loaded column holds
# at least this many rows (MPLAN2VDL_FUSED_AGG=1/0 forces it either way).
# The threshold was tuned for the JAX engine's device; the port keeps it
# until measurements on the GPU set it.
FUSED_AUTO_ROWS = 24_000_000

_INT_DTYPES = (torch.int32, torch.int64)


def dtype_for(info: ColInfo):
    l, u = info.bounds
    if INT32_MIN <= l and u <= INT32_MAX:
        return torch.int32
    return torch.int64


@dataclass
class Val:
    """A runtime vector: buffer + valid length (an int, or a 0-d int64
    tensor on the device where the count is still there)."""

    data: Optional[torch.Tensor]  # None for an unmaterialized RangeC
    valid: Union[int, torch.Tensor]
    length: int  # buffer length
    lazy_range: Optional[Tuple[int, int]] = None  # (rmin, rstep) when data is None


def _i64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def _vmin(a, b, device):
    if isinstance(a, int) and isinstance(b, int):
        return min(a, b)
    return torch.minimum(_i64(a, device), _i64(b, device))


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


def _outside_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to mplan2vdl_tpu_torch yet")


class Compiler:
    """Eager evaluator for one query DAG on one device.

    ``fold_map``/``families`` route fused fold families (engine/fuse.py);
    ``gather_mates`` maps a position vector's key to the gathers sharing
    it, so they batch into one kernel launch."""

    def __init__(self, store: ColumnStore, device: torch.device,
                 fold_map: Optional[dict] = None,
                 families: Optional[list] = None,
                 gather_mates: Optional[dict] = None):
        self.store = store
        self.device = device
        self.fold_map = fold_map or {}
        self.families = families or []
        self.gather_mates = gather_mates or {}

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
        self.memo: Dict[int, Val] = {}
        self.group_cache: Dict[tuple, dict] = {}
        self.fused_cache: Dict[int, dict] = {}
        self.gather_multi: Dict[int, torch.Tensor] = {}
        self.tables = tables
        return [self._force(self.eval(v)) for v in vexps]

    def eval(self, v: V.Vexp) -> Val:
        hit = self.memo.get(v.skey)
        if hit is not None:
            return hit
        out = self._eval(v)
        self.memo[v.skey] = out
        return out

    def _force(self, val: Val) -> Val:
        if val.data is not None:
            return val
        rmin, rstep = val.lazy_range
        dt = torch.int64 if (abs(rmin) + abs(rstep) * val.length
                             > INT32_MAX) else torch.int32
        data = rmin + rstep * torch.arange(val.length, dtype=dt,
                                           device=self.device)
        data = _mask_tail(data, val.valid, val.length)
        return Val(data=data, valid=val.valid, length=val.length)

    # ------------------------------------------------------------------- ops
    def _eval(self, v: V.Vexp) -> Val:
        vx = v.vx
        L = v.info.count
        dt = dtype_for(v.info)

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
            data = (vx.rmin + vx.rstep * torch.arange(
                ref.length, dtype=torch.int64, device=self.device)).to(dt)
            data = _mask_tail(data, ref.valid, ref.length)
            return Val(data=data, valid=ref.valid, length=ref.length)

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
            nz = int(mask.sum())
            L_out = min(max(nz, 1), L)
            sel = _sel_positions(mask, L_out)
            sel = _mask_tail(sel.to(dt), nz, L_out)
            return Val(data=sel, valid=nz, length=L_out)

        if isinstance(vx, V.Fold):
            return self._eval_fold(v, vx)

        if isinstance(vx, V.Partition):
            return self._eval_partition(v, vx)

        if isinstance(vx, V.VShuffle):
            # any permutation is legal; identity preserves determinism
            return self.eval(vx.varg)

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
            valid = torch.where(src.valid > 0, _i64(pos.valid, self.device),
                                _i64(0, self.device))
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
        """Scatter through unique monotone positions (FK mask deduction,
        relational Scatter of compactions) into ``L`` slots: the monotone
        scatter kernel.  Invalid rows map to ``L`` and are dropped."""
        if not (vx.shpos.quant == V.UNIQUE and self._monotone(vx.shpos)):
            raise _outside_slice("Shuffle SCATTER with non-unique or "
                                 "non-monotone positions")
        src = self._force(self.eval(vx.shsource))
        pos = self._force(self.eval(vx.shpos))
        if vx.shshape is not None:
            L = self.eval(vx.shshape).length
        else:
            L = vx.shpos.info.bounds[1] + 1
        n = min(src.length, pos.length)
        pdt = pos.data.dtype if L <= INT32_MAX else torch.int64
        idx = torch.arange(n, device=self.device)
        limit = _vmin(src.valid, pos.valid, self.device)
        p = torch.where(idx < limit, pos.data[:n].to(pdt),
                        torch.full((), L, dtype=pdt, device=self.device))
        out = monotone_scatter(p, src.data[:n].to(dt), L)
        return Val(data=out, valid=L, length=L)

    # ---------------------------------------------------------------- binops
    def _eval_binop(self, v: V.Vexp, vx: V.Binop) -> Val:
        lv = self._force(self.eval(vx.left))
        rv = self._force(self.eval(vx.right))
        L = min(lv.length, rv.length)
        dt = dtype_for(v.info)
        # compute in a width that holds operands and result
        cdt = torch.promote_types(
            torch.promote_types(lv.data.dtype, rv.data.dtype), dt)
        a = lv.data[:L].to(cdt)
        b = rv.data[:L].to(cdt)
        op = vx.binop
        valid = _vmin(lv.valid, rv.valid, self.device)
        if op == M.ADD:
            out = a + b
        elif op == M.SUB:
            out = a - b
        elif op == M.MUL:
            out = a * b
        elif op == M.DIV:
            out = torch.div(a, torch.where(b == 0, torch.ones_like(b), b),
                            rounding_mode="trunc")
        elif op == M.MOD:
            out = torch.fmod(a, torch.where(b == 0, torch.ones_like(b), b))
        elif op == M.MIN:
            out = torch.minimum(a, b)
        elif op == M.MAX:
            out = torch.maximum(a, b)
        elif op == M.GT:
            out = a > b
        elif op == M.LT:
            out = a < b
        elif op == M.GEQ:
            out = a >= b
        elif op == M.LEQ:
            out = a <= b
        elif op == M.EQ:
            out = a == b
        elif op == M.NEQ:
            out = a != b
        elif op == M.LOGAND:
            out = (a != 0) & (b != 0)
        elif op == M.LOGOR:
            out = (a != 0) | (b != 0)
        elif op == M.BITAND:
            out = a & b
        elif op == M.BITOR:
            out = a | b
        elif op == M.BITSHIFT:
            # sign of rhs encodes direction: negative shifts left
            # (Vlite.hs:205-208)
            out = torch.where(b < 0, a << torch.clamp(-b, 0, 63),
                              a >> torch.clamp(b, 0, 63))
        else:
            raise ValueError(f"unknown binop {op}")
        out = _mask_tail(out.to(dt), valid, L)
        return Val(data=out, valid=valid, length=L)

    # ----------------------------------------------------------------- folds
    def _group_artifacts(self, fgroups: V.Vexp, L_out: int,
                         fmask: Optional[V.Vexp] = None) -> dict:
        key = (fgroups.skey, fmask.skey if fmask is not None else None, L_out)
        hit = self.group_cache.get(key)
        if hit is not None:
            return hit
        g = self._force(self.eval(fgroups))
        gmin, gmax = fgroups.info.bounds
        if gmin < 0:
            raise ValueError("group ids must be non-negative")
        domain = gmax + 1
        n = g.length
        idx = torch.arange(n, device=self.device)
        validmask = idx < g.valid
        if fmask is not None:
            m = self._force(self.eval(fmask))
            validmask = validmask & (m.data[:n] != 0)
        if domain <= segred.SMALL_DOMAIN:
            ids = torch.clamp(g.data.to(torch.int64), 0, domain - 1)
            ids_ok = torch.where(validmask, ids, _i64(domain, self.device))
            art = {"dense": True, "n": n, "domain": domain,
                   "ids_ok": ids_ok}
        else:
            art = self._sparse_artifacts(g, validmask, domain, L_out)
        self.group_cache[key] = art
        return art

    def _sparse_artifacts(self, g: Val, validmask: torch.Tensor,
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
        dev = self.device
        n = g.length
        # int32 sort keys when the id domain allows (sentinel included)
        kdt = torch.int32 if (domain < 2**31 - 1 and n < 2**31) \
            else torch.int64
        ids_ok = torch.where(validmask, g.data[:n].to(kdt),
                             torch.full((), domain, dtype=kdt, device=dev))
        sorted_ids, perm = torch.sort(ids_ok, stable=True)
        if n < 2**31:
            perm = perm.to(torch.int32)
        sorted_valid = sorted_ids < domain
        prev = torch.cat([sorted_ids[:1] - 1, sorted_ids[:-1]])
        head = sorted_ids != prev
        run_id = scan.cumsum_flags(head) - 1
        run_ok = torch.where(sorted_valid, run_id, _i64(L_out, dev))
        ngroups = (head & sorted_valid).sum()
        nvalid = sorted_valid.sum()
        # run starts ascend (the compaction kernel); L_out <= n
        starts = _sel_positions(head, L_out).to(torch.int64)
        next_start = torch.cat([starts[1:], _i64([n], dev)])
        kidx = torch.arange(L_out, device=dev)
        ends = torch.where(kidx + 1 < ngroups, next_start - 1,
                           _i64(0, dev))
        ends = torch.where(kidx + 1 == ngroups, nvalid - 1, ends)
        return {"dense": False, "n": n, "perm": perm, "run_ok": run_ok,
                "ngroups": ngroups, "nvalid": nvalid, "starts": starts,
                "ends": ends}

    def _eval_fold(self, v: V.Vexp, vx: V.Fold) -> Val:
        fam = self.fold_map.get(v.skey)
        if fam is not None:
            return self._eval_fused(v, fam)
        if vx.foldop == V.FDISTINCT:
            raise _outside_slice("Fold FDistinct")
        dt = dtype_for(v.info)
        g = self.eval(vx.fgroups)
        domain = vx.fgroups.info.bounds[1] + 1
        dval = self._force(self.eval(vx.fdata))
        L_out = min(domain, g.length, dval.length)
        art = self._group_artifacts(vx.fgroups, L_out, vx.fmask)
        n = art["n"]
        if dval.length < n:
            raise ValueError(f"fold payload of {dval.length} rows under "
                             f"{n} group ids")
        data = dval.data[:n].to(dt)
        if not art["dense"]:
            return self._eval_sparse_fold(vx, art, data, dt, L_out)
        opname = {V.FSUM: "sum", V.FMAX: "max", V.FMIN: "min",
                  V.FCHOOSE: "max"}[vx.foldop]
        agg, counts = segred.masked_group_reduce_with_counts(
            data, art["ids_ok"], art["domain"], opname)
        occ = counts > 0
        ngroups = occ.sum()
        sel = _sel_positions(occ, L_out)
        # min/max over empty segments yield identity sentinels; the
        # occupancy compaction drops those slots
        out = agg[sel.long()]
        out = _mask_tail(out.to(dt), ngroups, L_out)
        return Val(data=out, valid=ngroups, length=L_out)

    def _eval_sparse_fold(self, vx: V.Fold, art: dict, data: torch.Tensor,
                          dt, L_out: int) -> Val:
        """One fold over the sorted runs: a sum is the difference of an
        int64 prefix sum at run ends, choose reads run starts, and min/max
        reduce each run with ``scatter_reduce`` over the run ids."""
        dev = self.device
        n, ngroups = art["n"], art["ngroups"]
        kmask = torch.arange(L_out, device=dev) < ngroups
        sd = _mask_tail(gather_many([data], art["perm"], n)[0],
                        art["nvalid"], n)
        zero = _i64(0, dev)
        starts = torch.clamp(art["starts"], 0, n - 1)
        if vx.foldop == V.FSUM:
            cs = torch.cumsum(sd.to(torch.int64), 0)
            at_end = cs[torch.clamp(art["ends"], 0, n - 1)]
            before = torch.where(starts > 0,
                                 cs[torch.clamp(starts - 1, 0, n - 1)], zero)
            out = torch.where(kmask, at_end - before, zero)
        elif vx.foldop == V.FCHOOSE:
            out = torch.where(kmask, sd[starts].to(torch.int64), zero)
        else:  # FMIN / FMAX
            info = torch.iinfo(torch.int64)
            ident, how = ((info.max, "amin") if vx.foldop == V.FMIN
                          else (info.min, "amax"))
            red = torch.full((L_out + 1,), ident, dtype=torch.int64,
                             device=dev)
            red.scatter_reduce_(0, torch.clamp(art["run_ok"], 0, L_out),
                                sd.to(torch.int64), how)
            out = torch.where(kmask, red[:L_out], zero)
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
            g = self._force(self.eval(fam.fgroups))
            n = g.length
            valid = torch.arange(n, device=self.device) < g.valid
            if fam.fmask is not None:
                m = self._force(self.eval(fam.fmask))
                valid = valid & (m.data[:n] != 0)
            gid = torch.where(valid, g.data[:n].to(torch.int32),
                              torch.full((), -1, dtype=torch.int32,
                                         device=self.device))
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
        dt = dtype_for(v.info)
        L_out = min(fam.domain, v.info.count)
        sel = _sel_positions(hit["occ"], L_out)
        vals = hit["out"][sel.long(), agg_idx]
        data = _mask_tail(vals.to(dt), hit["ngroups"], L_out)
        return Val(data=data, valid=hit["ngroups"], length=L_out)

    # ------------------------------------------------------------ partitions
    def _eval_partition(self, v: V.Vexp, vx: V.Partition) -> Val:
        dval = self._force(self.eval(vx.pdata))
        dt = dtype_for(v.info)
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


def fused_agg_on(store: ColumnStore, loads) -> bool:
    """The fused-aggregate gate: MPLAN2VDL_FUSED_AGG=1/0 forces it; unset
    (or ``auto``) turns it on when a loaded column has FUSED_AUTO_ROWS."""
    fused = os.environ.get("MPLAN2VDL_FUSED_AGG", "")
    if fused in ("", "auto"):
        return any(len(store.columns[n]) >= FUSED_AUTO_ROWS for n in loads)
    return fused != "0"


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
        self.gather_mates = gather_mate_map(vexps)

    def device_args(self) -> Tuple[torch.Tensor, ...]:
        """The loaded columns on the device (copied there on first use)."""
        if self._args is None:
            self._args = tuple(
                torch.from_numpy(np.require(self.store.columns[n],
                                            requirements=["C", "W"]))
                .to(self.device) for n in self.loads)
        return self._args

    def run(self) -> List[Val]:
        """Evaluate the DAG; results stay on the device."""
        c = Compiler(self.store, self.device, self.fold_map, self.families,
                     self.gather_mates)
        return c.trace(self.vexps, dict(zip(self.loads, self.device_args())))

    def __call__(self) -> QueryResult:
        cols, names, dts = [], [], []
        for v, val in zip(self.vexps, self.run()):
            n = int(val.valid)
            cols.append(val.data[:n].cpu().numpy())
            names.append(v.name)
            dts.append(v.info.dtype)
        return QueryResult(names=names, dtypes=dts, columns=cols)


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
