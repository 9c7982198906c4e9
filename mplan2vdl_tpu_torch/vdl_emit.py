"""Textual VDL emission — the reference's output format, kept as a
conformance artifact (reference src/Vdl.hs).

Emits the numbered ``id,Op,args...`` statement list with global value
numbering (hash-consed DAG -> shared statement ids, Vdl.hs:294-320), the
``MaterializeCompact(Project rename)`` output wrapping with
``name__table__col`` labels (Vdl.hs:271-292), and optional ``;; Metadata``
annotations (Vdl.hs:455-477).  Statement-id arguments print through the
``Id`` newtype's derived Show ("Id 7") while the statement's own leading
id prints bare (printLine destructures it, Vdl.hs:456).

Vocabulary mapping notes:
  * Leq/Geq lower into Greater/Equals/LogicalOr combos and Neq into
    arithmetic exactly as Vdl.hs:143-156 (run passes.reference_passes
    first for the Min/Max/Neq rewrites of Vlite.hs:1332-1340).
  * This compiler's id-based Fold emits directly as Binary FoldOp over
    (groups, data); the reference's scatter-sort prelude is a Voodoo
    backend idiosyncrasy with no executable target here.
  * JoinIndex/DictMap are capability extensions; they emit as the
    ``HashJoin<Side>`` / ``DictMap`` extension vocabulary.
  * The vlite variant (``--vliteformat``) drops the "val" fillers, prints
    outputs with no leading id as ``name,Output,typestring,Id N``
    (toVList, Vdl.hs:371-407,467-476).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

from . import vir as V
from . import mplan as M
from .catalog import Config
from .mtypes import DDate, DDecimal, DString
from .names import Name, name_str

# statement parts: plain strings are literals; ("id", N) is a statement
# reference, rendered "Id N"
Part = Union[str, Tuple[str, int]]


def _render(parts: List[Part]) -> List[str]:
    return [p if isinstance(p, str) else f"Id {p[1]}" for p in parts]


class _Emitter:
    """Shared numbering/CSE core; ``vlite`` switches the per-op argument
    layout (toVoodooList vs toVList)."""

    def __init__(self, cfg: Config, show_metadata: bool = False,
                 vlite: bool = False):
        self.cfg = cfg
        self.show_metadata = show_metadata
        self.vlite = vlite
        self.lines: List[str] = []
        self.ids: Dict[tuple, int] = {}
        self.next_id = 1

    def line(self, key: tuple, parts: List[Part],
             meta: Optional[str] = None) -> int:
        hit = self.ids.get(key)
        if hit is not None:
            return hit
        iden = self.next_id
        self.next_id += 1
        self.ids[key] = iden
        txt = ",".join([str(iden)] + _render(parts))
        if meta and self.show_metadata:
            txt += " ;; " + meta
        self.lines.append(txt)
        return iden

    # helpers mirroring Vdl.hs combinators
    def binary(self, op: str, a: int, b: int) -> int:
        if self.vlite:
            return self.line(("bin", op, a, b), [op, ("id", a), ("id", b)])
        return self.line(("bin", op, a, b),
                         [op, "val", ("id", a), "val", ("id", b), "val"])

    def rangev(self, rmin: int, ref: int, rstep: int) -> int:
        if self.vlite:
            parts = ["RangeV", str(rmin), ("id", ref), str(rstep)]
        else:
            parts = ["RangeV", "val", str(rmin), ("id", ref), str(rstep)]
        return self.line(("rangev", rmin, ref, rstep), parts)

    def const(self, k: int, ref: int) -> int:
        return self.rangev(k, ref, 0)

    def pos(self, ref: int) -> int:
        return self.rangev(0, ref, 1)

    def gt(self, a, b):
        return self.binary("Greater", a, b)

    def eq(self, a, b):
        return self.binary("Equals", a, b)

    def lor(self, a, b):
        return self.binary("LogicalOr", a, b)

    def emit(self, v: V.Vexp) -> int:
        key = ("v", v.skey)
        hit = self.ids.get(key)
        if hit is not None:
            return hit
        iden = self._emit(v)
        self.ids[key] = iden
        return iden

    def _load(self, n: Name) -> int:
        # Load wrapped in a full val rename (makeload, Vdl.hs:161-168);
        # vlite's Project prints only the vector arg (toVList, Vdl.hs:374)
        inner = self.line(("load", n), ["Load", name_str(n)])
        keypath = name_str((n[1],) if len(n) > 1 else n)
        if self.vlite:
            return self.line(("loadp", n), ["Project", ("id", inner)])
        return self.line(("loadp", n),
                         ["Project", "val", ("id", inner), keypath])

    def _emit(self, v: V.Vexp) -> int:
        vx = v.vx
        if isinstance(vx, V.Load):
            return self._load(vx.name)
        if isinstance(vx, V.RangeC):
            parts = (["RangeC", str(vx.rmin), str(vx.rcount), str(vx.rstep)]
                     if self.vlite else
                     ["RangeC", "val", str(vx.rmin), str(vx.rcount),
                      str(vx.rstep)])
            return self.line(("rangec", vx.rmin, vx.rcount, vx.rstep), parts)
        if isinstance(vx, V.RangeV):
            ref = self.emit(vx.rref)
            return self.rangev(vx.rmin, ref, vx.rstep)
        if isinstance(vx, V.Binop):
            a = self.emit(vx.left)
            b = self.emit(vx.right)
            op = vx.binop
            if op == M.GT:
                return self.gt(a, b)
            if op == M.LT:
                return self.gt(b, a)  # argument swap (Vdl.hs:139)
            if op == M.EQ:
                return self.eq(a, b)
            if op == M.LEQ:  # a<b || a==b (Vdl.hs:143)
                return self.lor(self.gt(b, a), self.eq(a, b))
            if op == M.GEQ:
                return self.lor(self.gt(a, b), self.eq(a, b))
            if op == M.NEQ:  # 1 - (a==b) (Vdl.hs:152)
                one = self.const(1, a)
                return self.binary("Subtract", one, self.eq(a, b))
            if op in (M.MIN, M.MAX):  # ?. arithmetic select (Vdl.hs:221-222)
                cmp = self.lor(self.gt(a, b) if op == M.MAX else self.gt(b, a),
                               self.eq(a, b))
                one = self.const(1, a)
                zero = self.const(0, a)
                neg = self.eq(cmp, zero)
                posc = self.binary("Subtract", one, neg)
                return self.binary(
                    "Add", self.binary("Multiply", posc, a),
                    self.binary("Multiply", neg, b))
            name = {M.LOGAND: "LogicalAnd", M.LOGOR: "LogicalOr",
                    M.BITAND: "BitwiseAnd", M.BITOR: "BitwiseOr",
                    M.BITSHIFT: "BitShift", M.ADD: "Add", M.SUB: "Subtract",
                    M.MUL: "Multiply", M.DIV: "Divide", M.MOD: "Modulo"}[op]
            return self.binary(name, a, b)
        if isinstance(vx, V.Shuffle) and vx.shop == V.GATHER:
            src = self.emit(vx.shsource)
            pos = self.emit(vx.shpos)
            parts = (["Gather", ("id", src), ("id", pos)] if self.vlite else
                     ["Gather", ("id", src), ("id", pos), "val"])
            return self.line(("gather", src, pos), parts)
        if isinstance(vx, V.Shuffle) and vx.shop == V.SCATTER:
            src = self.emit(vx.shsource)
            pos = self.emit(vx.shpos)
            fold = self.pos(src)  # scatterfold arg (Vdl.hs:239-242)
            parts = (["Scatter", ("id", src), ("id", fold), ("id", pos)]
                     if self.vlite else
                     ["Scatter", ("id", src), ("id", fold), "val",
                      ("id", pos), "val"])
            return self.line(("scatter", src, fold, pos), parts)
        if isinstance(vx, V.Fold):
            g = self.emit(vx.fgroups)
            d = self.emit(vx.fdata)
            op = {V.FSUM: "FoldSum", V.FMAX: "FoldMax", V.FMIN: "FoldMin",
                  V.FCHOOSE: "FoldChoose", V.FSEL: "FoldSelect",
                  # extension vocabulary: count(distinct) fold
                  V.FDISTINCT: "FoldDistinct"}[vx.foldop]
            return self.binary(op, g, d)
        if isinstance(vx, V.Partition):
            d = self.emit(vx.pdata)
            p = self.emit(vx.pivots)
            return self.binary("Partition", d, p)
        if isinstance(vx, V.Semisort):
            s = self.emit(vx.sdata)
            return self.line(("semisort", s), ["Semisort", ("id", s)])
        if isinstance(vx, V.SortPerm):  # extension vocabulary
            ks = [self.emit(k) for k in vx.keys]
            dirs = "".join("d" if d else "a" for d in vx.descs)
            return self.line(("sortperm", tuple(ks), vx.descs),
                             ["SortPerm", dirs] + [("id", k) for k in ks])
        if isinstance(vx, V.VShuffle):
            a = self.emit(vx.varg)
            return self.line(("vshuffle", a), ["Shuffle", ("id", a)])
        if isinstance(vx, V.Like):
            d = self.emit(vx.ldata)
            heap = self._load(vx.lcol + ("heap",))
            parts = (["Like", ("id", d), ("id", heap), vx.lpattern]
                     if self.vlite else
                     ["Like", "val", ("id", d), "val", ("id", heap), "val",
                      vx.lpattern])
            return self.line(("like", d, heap, vx.lpattern), parts)
        if isinstance(vx, V.CrossProduct):
            a = self.emit(vx.left)
            b = self.emit(vx.right)
            op = ("CrossProductOuter" if vx.variant == V.COUTER
                  else "CrossProductInner")
            return self.line(("cross", op, a, b), [op, ("id", a), ("id", b)])
        if isinstance(vx, V.JoinIndex):  # extension vocabulary
            a = self.emit(vx.lkeys)
            b = self.emit(vx.rkeys)
            op = "HashJoin" + vx.jside.replace("_", " ").title().replace(" ", "")
            return self.line(("join", vx.jside, a, b),
                             [op, ("id", a), ("id", b)])
        if isinstance(vx, V.DictMap):  # extension vocabulary
            d = self.emit(vx.ldata)
            return self.line(("dictmap", d, vx.mapping),
                             ["DictMap", ("id", d), name_str(vx.lcol)])
        raise TypeError(vx)

    def metadata_of(self, v: V.Vexp) -> str:
        dt = v.info.dtype
        if isinstance(dt, DDecimal):
            disp = f"DDecimal {{point = {dt.point}}}"
        elif isinstance(dt, DString):
            disp = f"DString {{decoder = {name_str(dt.decoder)}}}"
        else:
            disp = "DDate"
        origin = name_str(v.lineage.col) if v.lineage else "None"
        return (f"Metadata {{databounds = {v.info.bounds}, "
                f"sizebound = {v.info.count}, "
                f"name = {name_str(v.name) if v.name else 'None'}, "
                f"displaytype = {disp}, origin = {origin}}}")


def _output_label(v: V.Vexp) -> str:
    # output renaming: name__table__col (Vdl.hs:278-290)
    if v.name is not None and v.lineage is not None:
        label = name_str((v.name[-1],) + v.lineage.col)
    elif v.name is not None:
        label = v.name[-1]
    elif v.lineage is not None:
        label = name_str(("val",) + v.lineage.col)
    else:
        label = "val"
    return label.replace(".", "__")


def emit_vdl(vexps: List[V.Vexp], cfg: Config,
             show_metadata: bool = False) -> str:
    """Vexp DAG -> numbered VDL text (Vdl.hs:490-495)."""
    em = _Emitter(cfg, show_metadata)
    for v in vexps:
        iden = em.emit(v)
        label = _output_label(v)
        proj = em.line(("outp", iden, label),
                       ["Project", label, ("id", iden), "val"],
                       meta=em.metadata_of(v))
        em.line(("mat", proj), ["MaterializeCompact", ("id", proj)])
    return "\n".join(em.lines)


def emit_vlite(vexps: List[V.Vexp], cfg: Config) -> str:
    """The vlite output variant: every output's MaterializeCompact prints
    with NO leading id as ``name,Output,typestring,Id N`` with display-type
    strings (printLine's VliteFormat special case, Vdl.hs:467-476)."""
    em = _Emitter(cfg, False, vlite=True)
    lines: List[str] = []
    for v in vexps:
        iden = em.emit(v)
        dt = v.info.dtype
        if isinstance(dt, DDecimal):
            typ = f"decimal_{dt.point}"
        elif isinstance(dt, DString):
            typ = f"string_{name_str(dt.decoder)}"
        else:
            typ = "date"
        nm = v.name[-1] if v.name else "val"
        lines.append(f"{nm},Output,{typ},Id {iden}")
    return "\n".join(em.lines + lines)
