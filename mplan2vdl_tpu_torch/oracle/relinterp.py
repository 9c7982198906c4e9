"""Independent RelExpr interpreter: the execution oracle.

Evaluates the typed logical plan (mplan.RelExpr) directly over the column
store with numpy alone — generic sort-based equijoins, generic group-bys —
sharing *no* code with the vector-IR or the engine.  Running a query
through both paths and comparing rows exactly is the framework's primary
correctness gate (BASELINE.json).

A copy of the JAX package's ``oracle/relinterp.py`` that differs in one
definition: ``Interp._join`` pairs equal key tuples with
``equi_join_pairs`` (numpy) where the original calls pandas' ``merge``,
which is not installed where the port runs.  The pairs come out in
``merge``'s own order (by left row, then by right row), so both oracles
return the same frames in the same order.

Deliberate semantic mirrors (these are part of the framework's contract,
inherited from the reference):
  * integer division truncates toward zero (C semantics)
  * year() uses the approximation ((days*1000)+1100)/365243
    (Vlite.hs:988-994; exact within 1992-1997)
  * avg = trunc(sum / count) on scaled ints (Vlite.hs:1038-1041)
  * count(col) is null-aware for outer-join columns (an extension
    over the reference, which always counts rows, Mplan.hs:175-180)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import mplan as M
from ..engine.columnstore import ColumnStore
from ..engine.lower import like_to_regex
from ..names import Name, NameTable, concat_name, name_str


def tdiv(a, b):
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    bz = np.where(b == 0, 1, b)
    q = np.abs(a) // np.abs(bz)
    return np.where((a >= 0) == (bz >= 0), q, -q)


def equi_join_pairs(lkeys: List[np.ndarray], rkeys: List[np.ndarray]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The (left row, right row) pairs whose key tuples are equal, as two
    int64 arrays: ``lkeys[i]`` and ``rkeys[i]`` are the i-th key column of
    each side.  The pairs come in the order of pandas' inner ``merge``
    (``sort=False``): by left row, then by right row, both ascending.

    The right side's keys sort stably, each left key takes its run of
    equal right keys by two binary searches, and the runs expand into
    pairs.  Several key columns first become one int64 key each side, as
    pandas builds it (``_pandas_keys``).  One order of pandas' is copied
    too: when the right keys repeat and the pair count happens to equal
    the left row count, ``merge`` takes its shortcut for one-to-one joins
    and returns another permutation of the same pairs
    (``_pandas_one_to_one_order``)."""
    lk = [np.asarray(k).astype(np.int64) for k in lkeys]
    rk = [np.asarray(k).astype(np.int64) for k in rkeys]
    n, m = len(lk[0]), len(rk[0])
    if n == 0 or m == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    lc, rc = _pandas_keys(lk, rk) if len(lk) > 1 else (lk[0], rk[0])
    order = np.argsort(rc, kind="stable")
    rs = rc[order]
    lo = np.searchsorted(rs, lc, side="left")
    cnt = np.searchsorted(rs, lc, side="right") - lo
    li = np.repeat(np.arange(n, dtype=np.int64), cnt)
    first = np.cumsum(cnt) - cnt  # each left row's first pair
    ri = order[lo[li] + np.arange(len(li), dtype=np.int64) - first[li]]
    ri = ri.astype(np.int64)
    r_unique = bool(np.all(rs[1:] != rs[:-1]))
    if len(li) != n or r_unique or (
            _ascending(lc) and _ascending(rc)
            and bool(np.all(np.sort(lc)[1:] != np.sort(lc)[:-1]))):
        return li, ri
    return _pandas_one_to_one_order(lc, rc, li, ri)


def _ascending(a: np.ndarray) -> bool:
    return bool(np.all(a[1:] >= a[:-1]))


def _first_labels(a: np.ndarray, b: np.ndarray):
    """Codes of the values of ``a`` and ``b`` numbered in order of first
    appearance, ``a`` before ``b`` (pandas' factorization without
    sorting): (codes of a, codes of b, count)."""
    u, first, inv = np.unique(np.concatenate([a, b]), return_index=True,
                              return_inverse=True)
    rank = np.empty(len(u), dtype=np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(u))
    lab = rank[inv.reshape(-1)]
    return lab[:len(a)], lab[len(a):], len(u)


def _pandas_keys(lk: List[np.ndarray], rk: List[np.ndarray]):
    """One int64 key per row of each side from several key columns, as
    pandas' ``get_join_indexers`` builds it: each column factorized
    (``_first_labels``, left side first), then the codes combined in mixed
    radix, the first column most significant, as many columns as fit
    below 2**63 - 1 at a time; the combined codes are factorized again
    before the next columns join them."""
    pairs = [_first_labels(a, b) for a, b in zip(lk, rk)]
    llab = [p[0] for p in pairs]
    rlab = [p[1] for p in pairs]
    shape = [p[2] for p in pairs]
    while True:
        nlev = next(lev for lev in range(len(shape), 0, -1)
                    if int(np.prod([int(x) for x in shape[:lev]],
                                   dtype=object)) < 2**63 - 1)
        stride = 1
        for x in shape[1:nlev]:
            stride *= int(x)
        lkey, rkey = stride * llab[0], stride * rlab[0]
        for i in range(1, nlev):
            stride //= int(shape[i])
            lkey = lkey + llab[i] * stride
            rkey = rkey + rlab[i] * stride
        if nlev == len(shape):
            return lkey, rkey
        x, y, c = _first_labels(lkey, rkey)
        llab, rlab, shape = ([x] + llab[nlev:], [y] + rlab[nlev:],
                             [c] + shape[nlev:])


def _pandas_one_to_one_order(lc: np.ndarray, rc: np.ndarray,
                             li: np.ndarray, ri: np.ndarray):
    """The pairs (``li``, ``ri``, by left row) in the order pandas' inner
    join returns when the pair count equals the left row count but the
    right keys repeat (its shortcut assumes each left row matched once):
    the keys are numbered by first appearance on the right, then on the
    left; the pairs are listed by (number, left row, right row); and the
    i-th pair returned is the one at the i-th left row's place in the
    left rows' stable order by number."""
    rlab, llab, _ = _first_labels(rc, lc)
    lsorter = np.argsort(llab, kind="stable")
    byl = np.lexsort((ri, li, llab[li]))
    rev = np.empty(len(lc), dtype=np.int64)
    rev[lsorter] = np.arange(len(lc))
    return li[byl][rev], ri[byl][rev]

@dataclass
class Frame:
    """An operator's output: named columns, all the same length.
    ``nullmasks`` maps a column name to its validity vector (outer-join
    nullability; rows with 0 are SQL NULL)."""

    cols: List[Tuple[Optional[Name], np.ndarray]]
    nullmasks: Dict[Name, np.ndarray] = None

    def __post_init__(self):
        if self.nullmasks is None:
            self.nullmasks = {}

    @property
    def n(self) -> int:
        return len(self.cols[0][1]) if self.cols else 0

    def scope(self) -> NameTable:
        t: NameTable = NameTable()
        for nm, arr in self.cols:
            if nm is not None:
                t.insert_weak(nm, arr)
        return t

    def lookup(self, n: Name) -> np.ndarray:
        return self.scope().lookup(n)[1]

    def take(self, idx: np.ndarray) -> "Frame":
        return Frame([(nm, arr[idx]) for nm, arr in self.cols],
                     {k: v[idx] for k, v in self.nullmasks.items()})


class Interp:
    def __init__(self, store: ColumnStore):
        self.store = store

    # --------------------------------------------------------------- scalars
    def _mask_of(self, frame: Frame, e: M.ScalarExpr):
        """Validity vector (1 = present) of an expression, or None when it
        can never be null — mirrors vir.sc's nullmask propagation rules
        (boolean results coerce to false and drop the mask; arithmetic
        combines operand masks)."""
        if isinstance(e, M.MRef):
            hit = [k for k in frame.nullmasks
                   if k[-len(e.name):] == e.name]
            return frame.nullmasks[hit[0]] if hit else None
        if isinstance(e, M.MCast):
            return self._mask_of(frame, e.arg)
        if isinstance(e, M.MUnary):
            if e.unop in (M.YEAR, M.NEG):
                return self._mask_of(frame, e.arg)
            return None  # ISNULL itself is never null
        if isinstance(e, M.MBinop):
            if e.binop in (M.GT, M.LT, M.GEQ, M.LEQ, M.EQ, M.NEQ,
                           M.LOGAND, M.LOGOR):
                return None
            a = self._mask_of(frame, e.left)
            b = self._mask_of(frame, e.right)
            if a is None:
                return b
            if b is None:
                return a
            return a * b
        if isinstance(e, M.MIfThenElse):
            mt = self._mask_of(frame, e.then_)
            mf = self._mask_of(frame, e.else_)
            if mt is None and mf is None:
                return None
            c = self.scalar(frame, e.if_) != 0
            one = np.ones(frame.n, dtype=np.int64)
            return np.where(c, one if mt is None else mt,
                            one if mf is None else mf)
        if isinstance(e, M.MSubstring):
            return self._mask_of(frame, e.arg)
        return None

    def _combined_mask(self, frame: Frame, *exprs):
        m = None
        for e in exprs:
            em = self._mask_of(frame, e)
            if em is not None:
                m = em if m is None else m * em
        return m

    def scalar(self, frame: Frame, e: M.ScalarExpr) -> np.ndarray:
        n = frame.n
        if isinstance(e, M.MRef):
            return frame.lookup(e.name)
        if isinstance(e, M.MLiteral):
            return np.full(n, e.rep, dtype=np.int64)
        if isinstance(e, M.MIdentity):
            return np.arange(n, dtype=np.int64)
        if isinstance(e, M.MCast):
            # scale adjustment is what matters; mirror vir.sc (Vlite.hs:939-958)
            from ..mtypes import DDecimal

            inner, dt = self.scalar_dt(frame, e.arg)
            if e.mtype.kind == "double":
                return inner
            sto = None
            if e.mtype.kind == "decimal":
                sto = e.mtype.p2
            elif e.mtype.kind in ("int", "bigint", "smallint", "tinyint"):
                sto = 0  # int casts of decimals drop the fraction
            if sto is not None and isinstance(dt, DDecimal):
                sfrom = dt.point
                if sto > sfrom:
                    return inner * (10 ** (sto - sfrom))
                if sto < sfrom:
                    return tdiv(inner, 10 ** (sfrom - sto))
            return inner
        if isinstance(e, M.MUnary):
            if e.unop == M.YEAR:
                d = self.scalar(frame, e.arg)
                return tdiv(d * 1000 + 1100, 365243)
            if e.unop == M.NEG:
                val = 1 - self.scalar(frame, e.arg)
                m = self._mask_of(frame, e.arg)
                return val * m if m is not None else val
            if e.unop == M.ISNULL:
                m = self._mask_of(frame, e.arg)
                return (1 - m if m is not None
                        else np.zeros(n, dtype=np.int64))
            raise ValueError(e.unop)
        if isinstance(e, M.MBinop):
            a = self.scalar(frame, e.left).astype(np.int64)
            b = self.scalar(frame, e.right).astype(np.int64)
            m = self._combined_mask(frame, e.left, e.right)
            val = self._binop_val(e.binop, a, b)
            # SQL null propagation, vir.sc mirror: value slots coerce
            # to 0 (booleans read as false)
            return val * m if m is not None else val
        if isinstance(e, M.MIfThenElse):
            c = self.scalar(frame, e.if_)
            val = np.where(c != 0, self.scalar(frame, e.then_),
                           self.scalar(frame, e.else_))
            m = self._mask_of(frame, e)
            return val * m if m is not None else val
        if isinstance(e, M.MIn):
            return self._in_val(frame, e)
        if isinstance(e, M.MSubstring):
            mapping, _ = self._substring_dicts(frame, e)
            vals = self.scalar(frame, e.arg).astype(np.int64)
            src = np.array(sorted(mapping), dtype=np.int64)
            dst = np.array([mapping[c] for c in sorted(mapping)],
                           dtype=np.int64)
            pos = np.clip(np.searchsorted(src, vals), 0, len(src) - 1)
            return np.where(src[pos] == vals, dst[pos], 0)
        if isinstance(e, M.MLike):
            vals, dt = self.scalar_dt(frame, e.ldata)
            from ..mtypes import DString

            assert isinstance(dt, DString), f"LIKE over non-string {dt}"
            dec = self.store.decoders[dt.decoder]
            rx = like_to_regex(e.pattern)
            ok = np.array(sorted(c for c, s in dec.items() if rx.match(s)),
                          dtype=np.int64)
            val = np.isin(vals, ok).astype(np.int64)
            m = self._mask_of(frame, e.ldata)
            return val * m if m is not None else val
        raise ValueError(f"oracle cannot evaluate {e}")

    def _binop_val(self, op, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        if op == M.ADD:
            return a + b
        if op == M.SUB:
            return a - b
        if op == M.MUL:
            return a * b
        if op == M.DIV:
            return tdiv(a, b)
        if op == M.MOD:
            return np.sign(a) * (np.abs(a) % np.abs(np.where(b == 0, 1, b)))
        if op == M.MIN:
            return np.minimum(a, b)
        if op == M.MAX:
            return np.maximum(a, b)
        if op == M.GT:
            return (a > b).astype(np.int64)
        if op == M.LT:
            return (a < b).astype(np.int64)
        if op == M.GEQ:
            return (a >= b).astype(np.int64)
        if op == M.LEQ:
            return (a <= b).astype(np.int64)
        if op == M.EQ:
            return (a == b).astype(np.int64)
        if op == M.NEQ:
            return (a != b).astype(np.int64)
        if op == M.LOGAND:
            return ((a != 0) & (b != 0)).astype(np.int64)
        if op == M.LOGOR:
            return ((a != 0) | (b != 0)).astype(np.int64)
        if op == M.BITAND:
            return a & b
        if op == M.BITOR:
            return a | b
        if op == M.BITSHIFT:
            return np.where(b < 0, a << np.minimum(-b, 63),
                            a >> np.minimum(b, 63))
        raise ValueError(op)

    def _in_val(self, frame: Frame, e: "M.MIn") -> np.ndarray:
        a = self.scalar(frame, e.left)

        def unlit(x):
            while isinstance(x, M.MCast):
                x = x.arg
            return x if isinstance(x, M.MLiteral) else None

        lits = [unlit(x) for x in e.set]
        if (isinstance(e.left, M.MSubstring)
                and all(x is not None and x.raw is not None
                        for x in lits)):
            _, codes = self._substring_dicts(frame, e.left)
            out = np.zeros(frame.n, dtype=bool)
            for x in lits:
                out |= a == codes.get(x.raw, -1)
        else:
            out = np.zeros(frame.n, dtype=bool)
            for x in e.set:
                out |= a == self.scalar(frame, x)
        val = out.astype(np.int64)
        m = self._mask_of(frame, e.left)
        return val * m if m is not None else val  # NULL IN (...) is false

    def _substring_dicts(self, frame: Frame, e: "M.MSubstring"):
        """(source code -> derived code, derived string -> code), derived the
        same deterministic way as vir.sc: sorted distinct substrings."""
        from ..mtypes import DString

        _, dt = self.scalar_dt(frame, e.arg)
        assert isinstance(dt, DString), f"substring over non-string {dt}"
        dic = self.store.decoders[dt.decoder]  # code -> string
        lo, n = e.start - 1, e.length
        outs = sorted({s[lo:lo + n] for s in dic.values()})
        codes = {s: i for i, s in enumerate(outs)}
        mapping = {c: codes[s[lo:lo + n]] for c, s in dic.items()}
        return mapping, codes

    def scalar_dt(self, frame: Frame, e: M.ScalarExpr):
        """Value plus display-type (scale/dictionary) tracking."""
        from ..mtypes import DDecimal, DString

        if isinstance(e, M.MRef):
            # resolve dtype through the store's schema when it is a real column
            val = frame.lookup(e.name)
            dt = self._dtype_of_ref(frame, e.name)
            return val, dt
        if isinstance(e, M.MLiteral):
            return self.scalar(frame, e), e.dtype
        if isinstance(e, M.MCast):
            if e.mtype.kind == "decimal":
                return self.scalar(frame, e), DDecimal(e.mtype.p2)
            if e.mtype.kind in ("int", "bigint", "smallint", "tinyint"):
                return self.scalar(frame, e), DDecimal(0)
            inner, dt = self.scalar_dt(frame, e.arg)
            if e.mtype.kind == "double":
                return inner, dt
            return self.scalar(frame, e), dt
        if isinstance(e, M.MBinop):
            _, ld = self.scalar_dt(frame, e.left)
            _, rd = self.scalar_dt(frame, e.right)
            val = self.scalar(frame, e)
            if (e.binop == M.MUL and isinstance(ld, DDecimal)
                    and isinstance(rd, DDecimal)):
                return val, DDecimal(ld.point + rd.point)
            if (e.binop == M.DIV and isinstance(ld, DDecimal)
                    and isinstance(rd, DDecimal)):
                return val, DDecimal(ld.point - rd.point)
            if e.binop in (M.GT, M.LT, M.GEQ, M.LEQ, M.EQ, M.NEQ,
                           M.LOGAND, M.LOGOR):
                return val, DDecimal(0)
            return val, ld
        if isinstance(e, M.MIfThenElse):
            _, dt = self.scalar_dt(frame, e.then_)
            return self.scalar(frame, e), dt
        return self.scalar(frame, e), DDecimal(0)

    def _dtype_of_ref(self, frame: Frame, name: Name):
        from ..mtypes import DDecimal

        # track provenance: frame columns remember their source dtype
        dts = getattr(frame, "dtypes", None)
        if dts is not None:
            hit = dts.lookup_opt(name)
            if hit is not None:
                return hit[1]
        return DDecimal(0)

    # ------------------------------------------------------------------ rels
    def rel(self, r: M.RelExpr) -> Frame:
        f = self._rel(r)
        # attach dtype scope lazily for scalar_dt
        f.dtypes = self._frame_dtypes(f)
        return f

    def _frame_dtypes(self, f: Frame) -> NameTable:
        t: NameTable = NameTable()
        for nm, arr in f.cols:
            if nm is not None and getattr(arr, "_dt", None) is not None:
                t.insert_weak(nm, arr._dt)
        return t

    def _rel(self, r: M.RelExpr) -> Frame:
        if isinstance(r, M.RTable):
            return self._table(r)
        if isinstance(r, M.RSelect):
            child = self.rel(r.child)
            mask = self.scalar(child, r.predicate) != 0
            return self._with_dts(child.take(np.nonzero(mask)[0]), child)
        if isinstance(r, M.RProject):
            child = self.rel(r.child)
            out: List[Tuple[Optional[Name], np.ndarray]] = []
            dts: List = []
            for expr, nm in r.projectout:
                tmp = Frame(child.cols + out)
                tmp.dtypes = self._frame_dtypes_of(child, out, dts)
                val, dt = self.scalar_dt(tmp, expr)
                val = _tag(np.asarray(val), dt)
                out.append((nm, val))
                dts.append((nm, dt))
            masks = {}
            for (expr, nm), (_, arr) in zip(r.projectout, out):
                if (nm is not None and isinstance(expr, M.MRef)
                        and expr.name in child.nullmasks):
                    masks[nm] = child.nullmasks[expr.name]
                elif (nm is not None and isinstance(expr, M.MRef)):
                    hit = [k for k in child.nullmasks
                           if k[-len(expr.name):] == expr.name]
                    if hit:
                        masks[nm] = child.nullmasks[hit[0]]
            frame = Frame(out, masks)
            if r.order:
                scope = Frame(child.cols + out)
                keys = []
                for n, d in reversed(r.order):
                    k = scope.lookup(n).astype(np.int64)
                    keys.append(-k if d == "desc" else k)
                perm = np.lexsort(keys)  # stable, last key primary
                frame = frame.take(perm)
            return frame
        if isinstance(r, M.RGroupBy):
            return self._groupby(r)
        if isinstance(r, M.RJoin):
            return self._join(r)
        if isinstance(r, M.RCartesianProduct):
            lf = self.rel(r.leftch)
            rf = self.rel(r.rightch)
            li = np.repeat(np.arange(lf.n), rf.n)
            ri = np.tile(np.arange(rf.n), lf.n)
            return Frame([(nm, _keep(arr, arr[li])) for nm, arr in lf.cols]
                         + [(nm, _keep(arr, arr[ri])) for nm, arr in rf.cols])
        if isinstance(r, M.RTopN):
            child = self.rel(r.child)
            return self._with_dts(child.take(np.arange(min(r.n, child.n))),
                                  child)
        raise ValueError(type(r).__name__)

    def _frame_dtypes_of(self, child: Frame, out, dts) -> NameTable:
        t = self._frame_dtypes(child)
        for nm, dt in dts:
            if nm is not None:
                t.insert_weak(nm, dt)
        return t

    def _with_dts(self, f: Frame, src: Frame) -> Frame:
        return f

    def _table(self, r: M.RTable) -> Frame:
        from ..mtypes import DDate, DDecimal, DString

        tab = r.tablename
        cols = []
        n = self.store.table_count(tab)
        declared = {}
        t = next(t for t in self.store.tables if t.name == tab)
        for cn, ts in t.columns:
            declared[concat_name(tab, cn)] = ts
        pk_constraint = t.pkey.constraint[0]
        fk_constraints = {fk.constraint[0] for fk in t.fkeys}
        for colname, alias in r.tablecolumns:
            outname = alias if alias is not None else colname
            base = colname[1].lstrip("%") if len(colname) == 2 else ""
            if len(colname) == 2 and (colname[1] == "%TID%"
                                      or base == pk_constraint):
                arr = np.arange(n, dtype=np.int64)
                dt = DDecimal(0)
            else:
                if base in fk_constraints:
                    colname = (colname[0], base)
                arr = self.store.columns[colname]
                ts = declared.get(colname)
                if ts is None:
                    dt = DDecimal(0)  # join-index pseudo column
                elif ts.tname.lower() in ("char", "varchar"):
                    dt = DString(colname)
                elif ts.tname.lower() == "date":
                    dt = DDate()
                elif ts.tname.lower() == "decimal":
                    dt = DDecimal(ts.tparams[1])
                else:
                    dt = DDecimal(0)
            cols.append((outname, _tag(arr, dt)))
        return Frame(cols)

    def _groupby(self, r: M.RGroupBy) -> Frame:
        from ..mtypes import DDecimal

        child = self.rel(r.child)
        keyvals = [child.lookup(k) for k, _ in r.inputkeys]
        n = child.n
        if keyvals:
            packed = np.stack([v.astype(np.int64) for v in keyvals], axis=1)
            uniq, inv = np.unique(packed, axis=0, return_inverse=True)
            ng = len(uniq)
        else:
            inv = np.zeros(n, dtype=np.int64)
            ng = 1 if n > 0 else 0
        # aliased keys join the scope (Vlite.hs:631-635)
        extra = [(a, child.lookup(k)) for k, a in r.inputkeys if a is not None]
        scope_frame = Frame(child.cols + extra)
        scope_frame.dtypes = self._frame_dtypes(scope_frame)

        out: List[Tuple[Optional[Name], np.ndarray]] = []
        for agg, alias in r.outputaggs:
            # a Ref to an earlier agg output reuses the grouped column
            # (``L1.L1 as L2.L2`` in Q11; Vlite.hs:1065-1070)
            if (isinstance(agg, M.GFold) and agg.op == M.FCHOOSE
                    and isinstance(agg.expr, M.MRef)):
                acc_scope = Frame([c for c in out if c[0] is not None])
                hit = acc_scope.scope().lookup_opt(agg.expr.name) \
                    if acc_scope.cols else None
                if hit is not None:
                    out.append((alias if alias is not None else agg.expr.name,
                                hit[1]))
                    continue
            if isinstance(agg, M.GCount):
                mask_arr = None
                if agg.col is not None:
                    hit = [k for k in child.nullmasks
                           if k[-len(agg.col):] == agg.col]
                    if hit:
                        mask_arr = child.nullmasks[hit[0]]
                if mask_arr is not None:
                    val = np.zeros(ng, dtype=np.int64)
                    np.add.at(val, inv, mask_arr.astype(np.int64))
                else:
                    val = np.bincount(inv, minlength=ng).astype(np.int64)
                dt = DDecimal(0)
                nm = alias
            elif isinstance(agg, M.GCountDistinct):
                v, _ = self.scalar_dt(scope_frame, agg.expr)
                pairs = np.stack([inv, v.astype(np.int64)], axis=1)
                upairs = np.unique(pairs, axis=0)
                val = np.bincount(upairs[:, 0],
                                  minlength=ng).astype(np.int64)
                dt = DDecimal(0)
                nm = alias
            elif isinstance(agg, M.GAvg):
                v, dt = self.scalar_dt(scope_frame, agg.expr)
                mk = self._mask_of(scope_frame, agg.expr)
                s = np.zeros(ng, dtype=np.int64)
                np.add.at(s, inv, v.astype(np.int64))
                if mk is not None:
                    # null-aware avg: count NON-null rows (vir mirror)
                    c = np.zeros(ng, dtype=np.int64)
                    np.add.at(c, inv, mk.astype(np.int64))
                else:
                    c = np.bincount(inv, minlength=ng)
                val = tdiv(s, np.maximum(c, 1))
                if mk is not None:
                    val = np.where(c > 0, val, 0)  # all-null group -> 0
                nm = alias
            else:
                assert isinstance(agg, M.GFold)
                v, dt = self.scalar_dt(scope_frame, agg.expr)
                v = v.astype(np.int64)
                mk = (self._mask_of(scope_frame, agg.expr)
                      if agg.op in (M.FSUM, M.FMAX, M.FMIN) else None)
                sel = (np.ones(len(v), dtype=bool) if mk is None
                       else mk.astype(bool))
                if agg.op == M.FSUM:
                    # null slots are 0-coerced, so the plain sum is
                    # already null-aware
                    val = np.zeros(ng, dtype=np.int64)
                    np.add.at(val, inv, v)
                elif agg.op == M.FMAX:
                    val = np.full(ng, np.iinfo(np.int64).min)
                    np.maximum.at(val, inv[sel], v[sel])
                elif agg.op == M.FMIN:
                    val = np.full(ng, np.iinfo(np.int64).max)
                    np.minimum.at(val, inv[sel], v[sel])
                else:  # FCHOOSE: any representative
                    val = np.zeros(ng, dtype=np.int64)
                    # last occurrence wins; all values equal within a group
                    val[inv] = v
                if mk is not None:
                    # groups whose rows are all null read 0 (the
                    # framework-wide NULL-encodes-as-0 convention)
                    cc = np.zeros(ng, dtype=np.int64)
                    np.add.at(cc, inv, mk.astype(np.int64))
                    val = np.where(cc > 0, val, 0)
                nm = alias
                if (nm is None and agg.op == M.FCHOOSE
                        and isinstance(agg.expr, M.MRef)):
                    nm = agg.expr.name
            out.append((nm, _tag(np.asarray(val), dt if not isinstance(agg, M.GCount) else DDecimal(0))))
        return Frame(out)

    def _join(self, r: M.RJoin) -> Frame:
        lf = self.rel(r.leftch)
        rf = self.rel(r.rightch)
        lscope, rscope = lf.scope(), rf.scope()

        eq_pairs = []  # (left array, right array)
        leftovers = []
        for cond in r.conds:
            pair = None
            if (isinstance(cond, M.MBinop) and cond.binop == M.EQ
                    and isinstance(cond.left, M.MRef)
                    and isinstance(cond.right, M.MRef)):
                a = lscope.lookup_opt(cond.left.name)
                b = rscope.lookup_opt(cond.right.name)
                if a is not None and b is not None:
                    pair = (a[1], b[1])
                else:
                    a = rscope.lookup_opt(cond.left.name)
                    b = lscope.lookup_opt(cond.right.name)
                    if a is not None and b is not None:
                        pair = (b[1], a[1])
            if pair is not None:
                eq_pairs.append(pair)
            else:
                leftovers.append(cond)

        if eq_pairs:
            li, ri = equi_join_pairs([p[0] for p in eq_pairs],
                                     [p[1] for p in eq_pairs])
        else:
            li = np.repeat(np.arange(lf.n), rf.n)
            ri = np.tile(np.arange(rf.n), lf.n)

        joined = Frame([(nm, _keep(arr, arr[li])) for nm, arr in lf.cols]
                       + [(nm, _keep(arr, arr[ri])) for nm, arr in rf.cols])
        joined.dtypes = self._frame_dtypes(joined)
        if leftovers:
            m = np.ones(joined.n, dtype=bool)
            for cond in leftovers:
                m &= self.scalar(joined, cond) != 0
            sel = np.nonzero(m)[0]
            li, ri = li[sel], ri[sel]
            joined = joined.take(sel)
            joined.dtypes = self._frame_dtypes(joined)

        if r.joinvariant == M.PLAIN:
            return joined
        if r.joinvariant == M.LEFTSEMI:
            keep = np.unique(li)
            return self._with_dts(lf.take(keep), lf)
        if r.joinvariant == M.LEFTANTI:
            keep = np.setdiff1d(np.arange(lf.n), np.unique(li))
            return self._with_dts(lf.take(keep), lf)
        if r.joinvariant == M.LEFTOUTER:
            matched = np.unique(li)
            unmatched = np.setdiff1d(np.arange(lf.n), matched)
            cols = []
            masks = {}
            for nm, arr in lf.cols:
                cols.append((nm, _keep(arr, np.concatenate([arr[li],
                                                            arr[unmatched]]))))
                if nm in lf.nullmasks:
                    masks[nm] = np.concatenate(
                        [lf.nullmasks[nm][li], lf.nullmasks[nm][unmatched]])
            valid = np.concatenate([np.ones(len(li), np.int64),
                                    np.zeros(len(unmatched), np.int64)])
            for nm, arr in rf.cols:
                pad = np.zeros(len(unmatched), dtype=np.int64)
                cols.append((nm, _keep(arr, np.concatenate([arr[ri], pad]))))
                if nm is not None:
                    masks[nm] = valid
            return Frame(cols, masks)
        raise ValueError(r.joinvariant)


class _Tagged(np.ndarray):
    def __array_finalize__(self, obj):
        if obj is not None:
            self._dt = getattr(obj, "_dt", None)


def _tag(arr: np.ndarray, dt) -> np.ndarray:
    out = np.asarray(arr).view(_Tagged)
    out._dt = dt
    return out


def _keep(src: np.ndarray, new: np.ndarray) -> np.ndarray:
    if hasattr(src, "_dt"):
        return _tag(new, src._dt)
    return np.asarray(new)


def run_oracle(store: ColumnStore, rel: M.RelExpr) -> Frame:
    return Interp(store).rel(rel)
