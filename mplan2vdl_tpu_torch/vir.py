"""Vector IR: the data-parallel op DAG the TPU engine executes.

Semantics of reference src/Vlite.hs (the heart of the reference compiler),
re-designed in two places for TPU execution:

* **Fold semantics.** The reference emits group-bys as
  Partition -> Scatter(sort) -> Fold-over-contiguous-runs, leaning on the
  Voodoo backend's scatter machinery (Vlite.hs:1048-1098).  Here ``Fold``
  is defined directly on *group ids*: ``Fold{op, fgroups, fdata}`` where
  fgroups holds ids in ``[0, domain)`` aggregates fdata per distinct id and
  outputs one row per occupied id in ascending id order.  The engine picks a
  dense (segment-reduce) or sparse (sort-based) kernel from the static
  domain bound.  ``FSel`` keeps its reference meaning: positions of nonzero
  entries (stream compaction, Vlite.hs:331-335).

* **Bounds tightness.** Metadata inference follows Vlite.hs:269-467 but
  bounds are kept *sound* (they size real HBM buffers here, unlike the
  reference where they are hints): RangeV uses ``rmin + (count-1)*rstep``,
  Scatter output size is ``pos_upper_bound + 1``, and division by a range
  containing zero widens to int64 bounds.

Every node carries ColInfo (bounds / count upper bound / storage + display
type / trailing zeros), lineage ("these values are column C gathered through
mask M", Vlite.hs:136-166), a uniqueness flag, and a structural hash-cons key
used for CSE and memoized passes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

from . import mplan as M
from .catalog import (AGG_SERIAL, ColInfo, Config, DIM_FACT, FACT_DIM,
                      FKInstance)
from .mtypes import (DDate, DDecimal, DString, DType, INT64_MAX, INT64_MIN,
                     SDecimal, SInt32, SInt64, SType, stype_of_mtype,
                     dtype_of_mtype)
from .names import Name, NameTable, name_str

UNIQUE, ANY = "Unique", "Any"
GATHER, SCATTER = "Gather", "Scatter"
FSUM, FMAX, FMIN, FSEL, FCHOOSE = "FSum", "FMax", "FMin", "FSel", "FChoose"
# extension: per-group count of DISTINCT fdata values (count(distinct x);
# the reference lacks this entirely, src/notes.txt:60-63 lists it as a gap)
FDISTINCT = "FDistinct"
COUTER, CINNER = "COuter", "CInner"


# ------------------------------------------------------------------ node defs
@dataclass(frozen=True)
class Load:
    name: Name


@dataclass(frozen=True)
class RangeV:
    rmin: int
    rstep: int
    rref: "Vexp"  # sized like this vector


@dataclass(frozen=True)
class RangeC:
    rmin: int
    rstep: int
    rcount: int


@dataclass(frozen=True)
class Binop:
    binop: str  # M.GT etc
    left: "Vexp"
    right: "Vexp"


@dataclass(frozen=True)
class Shuffle:
    shop: str  # GATHER | SCATTER
    shsource: "Vexp"
    shpos: "Vexp"
    shshape: Optional["Vexp"] = None


@dataclass(frozen=True)
class Fold:
    """Aggregate fdata per group id (see module doc).  ``fmask`` is an
    optional row predicate: rows with a zero mask are excluded — the
    predicated-aggregation form that replaces compact-then-gather chains
    (filter via selection vector) with a masked scan (filter via
    predication), which is the TPU-native shape of filter+aggregate."""

    foldop: str
    fgroups: "Vexp"
    fdata: "Vexp"
    fmask: Optional["Vexp"] = None


@dataclass(frozen=True)
class Semisort:
    sdata: "Vexp"


@dataclass(frozen=True)
class SortPerm:
    """Stable multi-key sort permutation for ORDER BY (extension: the
    reference parses order clauses but cannot lower them,
    Mplan.hs:267-269).  ``descs[i]`` flips key i's direction."""

    keys: Tuple["Vexp", ...]
    descs: Tuple[bool, ...]


@dataclass(frozen=True)
class Partition:
    pivots: "Vexp"
    pdata: "Vexp"


@dataclass(frozen=True)
class Like:
    ldata: "Vexp"
    lpattern: str
    lcol: Name


@dataclass(frozen=True)
class DictMap:
    """Recode a dictionary-encoded column through a compile-time-computed
    string function (e.g. substring): ``out[i] = mapping[data[i]]`` where
    the mapping and the derived dictionary were evaluated over the source
    column's (small) dictionary on the host.  New capability vs the
    reference (Q22's substring; SURVEY.md §7.4)."""

    ldata: "Vexp"
    lcol: Name
    mapping: Tuple[Tuple[int, int], ...]  # (source code -> derived code)
    derived: Tuple[Tuple[int, str], ...]  # derived code -> string


@dataclass(frozen=True)
class VShuffle:
    varg: "Vexp"


@dataclass(frozen=True)
class CrossProduct:
    left: "Vexp"
    right: "Vexp"
    variant: str  # COUTER | CINNER


# JoinIndex sides
JLEFT, JRIGHT = "left", "right"
JSEMI, JANTI = "semi", "anti"
JOUTER_LEFT, JOUTER_RIGHT, JOUTER_VALID = ("outer_left", "outer_right",
                                           "outer_valid")


@dataclass(frozen=True)
class JoinIndex:
    """General equijoin match indices — the op the reference lacks
    (its joins require precomputed FK indices or 1-row sides; SURVEY.md
    §7.4).  ``lkeys`` / ``rkeys`` are equality keys; the op yields, per
    ``jside``:

      left / right            row indices of the matching pairs
      semi / anti             left-row indices with (no) match — static bound
      outer_left/right/valid  pairs plus unmatched-left rows; outer_right
                              is clipped for unmatched rows and outer_valid
                              flags real matches

    The inner/outer variants have data-dependent cardinality: the engine
    resolves their buffer sizes with a counting pre-pass (two-phase
    execution) rather than the unusable static n*m bound."""

    lkeys: "Vexp"
    rkeys: "Vexp"
    jside: str


Vx = Union[Load, RangeV, RangeC, Binop, Shuffle, Fold, Semisort, SortPerm,
           Partition, Like, DictMap, VShuffle, CrossProduct, JoinIndex]


@dataclass(frozen=True)
class Lineage:
    col: Name
    mask: "Vexp"


@dataclass(frozen=True, eq=False)
class Vexp:
    vx: Vx
    info: ColInfo
    lineage: Optional[Lineage]
    name: Optional[Name]
    skey: int  # structural hash-cons key; clones (renames) keep it
    quant: str = ANY
    comment: str = ""
    # validity mask for nullable columns (set by outer joins; rows where
    # the mask is 0 are SQL NULL).  Metadata only — the data itself holds
    # 0 in null slots, matching the engine padding convention.
    nullmask: Optional["Vexp"] = None

    # equality/hash by structural key, mirroring the reference's memoized
    # sha1 identity (Vlite.hs:152-157): renamed clones compare equal.
    def __eq__(self, other):
        return isinstance(other, Vexp) and self.skey == other.skey

    def __hash__(self):
        return self.skey

    def __repr__(self):
        # the DAG is deep and shared: the dataclass default repr recurses
        # exponentially (a failing pytest assertion would never return)
        op = type(self.vx).__name__
        nm = f" as {self.name}" if self.name else ""
        return f"<Vexp #{self.skey} {op}{nm} count<={self.info.count}>"

    def with_(self, **kw) -> "Vexp":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------- hash consing
class _Intern:
    def __init__(self) -> None:
        self.table: Dict[tuple, int] = {}

    def key_of(self, vx: Vx) -> int:
        k = _struct_key(vx)
        uid = self.table.get(k)
        if uid is None:
            uid = len(self.table)
            self.table[k] = uid
        return uid


_INTERN = _Intern()


def reset_intern() -> None:
    _INTERN.table.clear()


def _struct_key(vx: Vx) -> tuple:
    if isinstance(vx, Load):
        return ("Load", vx.name)
    if isinstance(vx, RangeV):
        return ("RangeV", vx.rmin, vx.rstep, vx.rref.skey)
    if isinstance(vx, RangeC):
        return ("RangeC", vx.rmin, vx.rstep, vx.rcount)
    if isinstance(vx, Binop):
        return ("Binop", vx.binop, vx.left.skey, vx.right.skey)
    if isinstance(vx, Shuffle):
        return ("Shuffle", vx.shop, vx.shsource.skey, vx.shpos.skey,
                vx.shshape.skey if vx.shshape is not None else None)
    if isinstance(vx, Fold):
        return ("Fold", vx.foldop, vx.fgroups.skey, vx.fdata.skey,
                vx.fmask.skey if vx.fmask is not None else None)
    if isinstance(vx, Semisort):
        return ("Semisort", vx.sdata.skey)
    if isinstance(vx, SortPerm):
        return ("SortPerm", tuple(k.skey for k in vx.keys), vx.descs)
    if isinstance(vx, Partition):
        return ("Partition", vx.pivots.skey, vx.pdata.skey)
    if isinstance(vx, Like):
        return ("Like", vx.ldata.skey, vx.lpattern, vx.lcol)
    if isinstance(vx, DictMap):
        return ("DictMap", vx.ldata.skey, vx.lcol, vx.mapping)
    if isinstance(vx, VShuffle):
        return ("VShuffle", vx.varg.skey)
    if isinstance(vx, CrossProduct):
        return ("CrossProduct", vx.left.skey, vx.right.skey, vx.variant)
    if isinstance(vx, JoinIndex):
        return ("JoinIndex", vx.lkeys.skey, vx.rkeys.skey, vx.jside)
    raise TypeError(vx)


# ------------------------------------------------------------------- metadata
_POINT0 = DDecimal(0)


def _bitsize(num: int) -> int:
    """Bit width to represent a non-negative value (Vlite.hs:1151-1159)."""
    assert num >= 0, f"bitwidth of negative number {num}"
    return num.bit_length()


def get_bit_width(v: "Vexp") -> int:
    l, u = v.info.bounds
    return max(_bitsize(l), _bitsize(u))


def _max_for_width(v: "Vexp") -> int:
    w = get_bit_width(v)
    assert w < 65
    return (1 << w) - 1


def infer_bounds(vx: Binop) -> Tuple[int, int]:
    """Interval arithmetic over operand bounds (Vlite.hs:417-467)."""
    op = vx.binop
    l1, u1 = vx.left.info.bounds
    l2, u2 = vx.right.info.bounds
    if op in (M.GT, M.LT, M.EQ, M.NEQ, M.GEQ, M.LEQ, M.LOGAND, M.LOGOR):
        return (0, 1)
    if op == M.ADD:
        return (l1 + l2, u1 + u2)
    if op == M.SUB:
        return (l1 - u2, u1 - l2)
    if op == M.MUL:
        prods = [a * b for a in (l1, u1) for b in (l2, u2)]
        return (min(prods), max(prods))
    if op == M.DIV:
        if l2 <= 0 <= u2:
            # divisor range contains zero: no finite bound (ref would crash)
            return (INT64_MIN, INT64_MAX)
        divs = [_tdiv(a, b) for a in (l1, u1) for b in (l2, u2)]
        return (min(divs), max(divs))
    if op == M.MIN:
        return (min(l1, l2), min(u1, u2))
    if op == M.MAX:
        return (max(l1, l2), max(u1, u2))
    if op == M.MOD:
        # lax.rem is C-style: sign follows the dividend, so a negative
        # dividend yields results in (-(|u2|-1), 0]; widen the lower bound
        # accordingly or composite-key packing would get unsound bounds
        hi = max(abs(l2), abs(u2))
        ub = max(hi - 1, 0)
        lb = -ub if l1 < 0 else 0
        return (lb, ub)
    if op == M.BITAND:
        if l1 >= 0 and l2 >= 0:
            return (0, min(_max_for_width(vx.left), _max_for_width(vx.right)))
        return (INT64_MIN, INT64_MAX)
    if op == M.BITOR:
        if l1 >= 0 and l2 >= 0:
            return (0, max(_max_for_width(vx.left), _max_for_width(vx.right)))
        return (INT64_MIN, INT64_MAX)
    if op == M.BITSHIFT:
        # sign of the shift amount encodes direction: negative = left shift
        # (Vlite.hs:205-208,449-458)
        def mshift(a: int, b: int) -> int:
            return a << -b if b < 0 else a >> b

        ext = [mshift(a, b) for a, b in ((l1, l2), (l1, u2), (u1, l2), (u1, u2))]
        return (min(ext), max(ext))
    raise ValueError(f"no bounds rule for {op}")


def _tdiv(a: int, b: int) -> int:
    """C-style truncating division (the engine's integer division)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def infer_metadata(vx: Vx) -> ColInfo:
    """Vlite.hs:269-414, with the soundness tweaks noted in the module doc."""
    if isinstance(vx, JoinIndex):
        n = vx.lkeys.info.count
        m = vx.rkeys.info.count
        if vx.jside in (JLEFT, JRIGHT):
            count = n * m  # loose; rebound by the engine's counting pass
        elif vx.jside in (JSEMI, JANTI):
            count = n
        else:  # outer: every match plus at most one row per unmatched left
            count = n * m + n
        if vx.jside in (JRIGHT, JOUTER_RIGHT):
            bounds = (0, max(m - 1, 0))
        elif vx.jside == JOUTER_VALID:
            bounds = (0, 1)
        else:
            bounds = (0, max(n - 1, 0))
        return ColInfo(bounds=bounds, count=count, stype=SInt64(),
                       dtype=_POINT0, trailing_zeros=0)

    if isinstance(vx, CrossProduct):
        n = vx.left.info.count
        m = vx.right.info.count
        if vx.variant == COUTER:
            bounds = (0, max(n - 1, 0))
        else:
            bounds = (0, max(m - 1, 0))
        return ColInfo(bounds=bounds, count=n * m, stype=SInt32(),
                       dtype=_POINT0, trailing_zeros=0)

    if isinstance(vx, Load):
        raise ValueError("Load metadata comes from the catalog (use load_as)")

    if isinstance(vx, VShuffle):
        return vx.varg.info

    if isinstance(vx, Like):
        return ColInfo(bounds=(0, 1), count=vx.ldata.info.count,
                       stype=SInt32(), trailing_zeros=0, dtype=_POINT0)

    if isinstance(vx, DictMap):
        hi = max((c for c, _ in vx.derived), default=0)
        return ColInfo(bounds=(0, hi), count=vx.ldata.info.count,
                       stype=SInt64(), trailing_zeros=0,
                       dtype=DString(("%derived%",) + vx.lcol))

    if isinstance(vx, RangeV):
        cnt = vx.rref.info.count
        ext = [vx.rmin, vx.rmin + max(cnt - 1, 0) * vx.rstep]
        return ColInfo(bounds=(min(ext), max(ext)), count=cnt,
                       stype=SInt64(), dtype=_POINT0, trailing_zeros=0)

    if isinstance(vx, RangeC):
        ext = [vx.rmin, vx.rmin + max(vx.rcount - 1, 0) * vx.rstep]
        return ColInfo(bounds=(min(ext), max(ext)), count=vx.rcount,
                       stype=SInt64(), dtype=_POINT0, trailing_zeros=0)

    if isinstance(vx, Shuffle) and vx.shop == SCATTER:
        src = vx.shsource.info
        posmax = vx.shpos.info.bounds[1]
        if vx.shshape is not None:
            out_count = vx.shshape.info.count
        else:
            out_count = posmax + 1
        # uncovered slots default to zero, so widen bounds to include it
        b = (min(src.bounds[0], 0), max(src.bounds[1], 0))
        return ColInfo(bounds=b, count=out_count, stype=src.stype,
                       dtype=src.dtype, trailing_zeros=0)

    if isinstance(vx, Semisort):
        return vx.sdata.info

    if isinstance(vx, SortPerm):
        n = vx.keys[0].info.count
        return ColInfo(bounds=(0, max(n - 1, 0)), count=n, stype=SInt64(),
                       dtype=_POINT0, trailing_zeros=0)

    if isinstance(vx, Shuffle) and vx.shop == GATHER:
        src = vx.shsource.info
        # gathered padding defaults to zero as well
        b = (min(src.bounds[0], 0), max(src.bounds[1], 0))
        return ColInfo(bounds=b, count=vx.shpos.info.count, stype=src.stype,
                       dtype=src.dtype, trailing_zeros=src.trailing_zeros)

    if isinstance(vx, Fold) and vx.foldop == FSEL:
        cnt = vx.fdata.info.count
        return ColInfo(bounds=(0, max(cnt - 1, 0)), count=cnt,
                       stype=SInt64(), dtype=_POINT0, trailing_zeros=0)

    if isinstance(vx, Fold):
        g = vx.fgroups.info
        d = vx.fdata.info
        glower, gupper = g.bounds
        dlower, dupper = d.bounds
        count_bound = min(gupper - glower + 1, g.count, d.count)
        count_bound = max(count_bound, 1)
        dt = d.dtype
        if vx.foldop == FDISTINCT:
            # per-group distinct-value count: at most the group's row count
            # and at most the value domain size
            dist_max = min(max(d.count, 1), dupper - dlower + 1)
            return ColInfo(bounds=(0, dist_max), count=count_bound,
                           stype=SInt64(), dtype=_POINT0, trailing_zeros=0)
        if vx.foldop == FSUM:
            dcount = max(d.count, 1)
            ext = [dlower, dlower * dcount, dupper, dupper * dcount]
            dtout = dt if isinstance(dt, DDecimal) else _POINT0
            return ColInfo(bounds=(min(ext), max(ext)), count=count_bound,
                           stype=d.stype, dtype=dtout,
                           trailing_zeros=d.trailing_zeros)
        # FMax / FMin / FChoose keep value bounds
        return ColInfo(bounds=(dlower, dupper), count=count_bound,
                       stype=d.stype, dtype=dt,
                       trailing_zeros=d.trailing_zeros)

    if isinstance(vx, Partition):
        pcount = vx.pivots.info.count
        return ColInfo(bounds=(0, max(pcount - 1, 0)),
                       count=vx.pdata.info.count, stype=SInt64(),
                       dtype=_POINT0, trailing_zeros=0)

    if isinstance(vx, Binop):
        li = vx.left.info
        ri = vx.right.info
        count = min(li.count, ri.count)
        bounds = infer_bounds(vx)
        tz = 0
        if vx.binop == M.BITSHIFT:
            tz = max(li.trailing_zeros - ri.bounds[1], 0)
        stype = _binop_stype(vx.binop, li.stype, ri.stype)
        dtype = _binop_dtype(vx.binop, li.dtype, ri.dtype)
        return ColInfo(bounds=bounds, count=count, stype=stype, dtype=dtype,
                       trailing_zeros=tz)

    raise TypeError(vx)


def _binop_stype(op: str, lt: SType, rt: SType) -> SType:
    """Decimal precision/scale propagation (Vlite.hs:378-391)."""
    if op == M.MUL:
        if isinstance(lt, SDecimal) and isinstance(rt, SDecimal):
            return SDecimal(lt.precision + rt.precision, lt.scale + rt.scale)
        if isinstance(lt, SDecimal):
            return lt
        if isinstance(rt, SDecimal):
            return rt
        return lt
    if op == M.DIV:
        if isinstance(lt, SDecimal) and isinstance(rt, SDecimal):
            diff = lt.scale - rt.scale
            if diff < 0:
                raise ValueError("division where numerator scale < denominator")
            return SDecimal(max(lt.precision, rt.precision), diff)
        if isinstance(lt, SDecimal):
            return lt
        return lt
    return lt


def _binop_dtype(op: str, ld: DType, rd: DType) -> DType:
    """Display-scale propagation (Vlite.hs:392-413)."""
    if op == M.MUL and isinstance(ld, DDecimal) and isinstance(rd, DDecimal):
        return DDecimal(ld.point + rd.point)
    if op == M.DIV and isinstance(ld, DDecimal) and isinstance(rd, DDecimal):
        diff = ld.point - rd.point
        if diff < 0:
            raise ValueError("division needs scale conversion first")
        return DDecimal(diff)
    if op in (M.GT, M.LT, M.LEQ, M.GEQ, M.EQ, M.NEQ):
        return _POINT0
    return ld


def infer_lineage(vx: Vx) -> Optional[Lineage]:
    """Gather/scatter and min/max/choose folds preserve lineage (Vlite.hs:469-494)."""
    if isinstance(vx, Shuffle) and vx.shsource.lineage is not None:
        lv = vx.shsource.lineage
        return Lineage(col=lv.col,
                       mask=complete(Shuffle(shop=vx.shop, shsource=lv.mask,
                                             shpos=vx.shpos,
                                             shshape=vx.shshape)))
    if (isinstance(vx, Fold) and vx.foldop in (FMIN, FMAX, FCHOOSE)
            and vx.fdata.lineage is not None):
        lv = vx.fdata.lineage
        return Lineage(col=lv.col,
                       mask=complete(Fold(foldop=vx.foldop,
                                          fgroups=vx.fgroups,
                                          fdata=lv.mask,
                                          fmask=vx.fmask)))
    return None


def infer_uniqueness(vx: Vx) -> str:
    """Vlite.hs:496-520."""
    if isinstance(vx, Shuffle) and vx.shop == SCATTER:
        return vx.shsource.quant
    if isinstance(vx, Shuffle) and vx.shop == GATHER:
        return vx.shsource.quant if vx.shpos.quant == UNIQUE else ANY
    if isinstance(vx, Partition):
        return UNIQUE
    if isinstance(vx, (RangeV, RangeC)) and vx.rstep != 0:
        return UNIQUE
    if isinstance(vx, Fold) and vx.foldop == FSEL:
        return UNIQUE
    if isinstance(vx, SortPerm):
        return UNIQUE
    if isinstance(vx, JoinIndex) and vx.jside in (JSEMI, JANTI):
        return UNIQUE
    return ANY


def _check_lineage(l: Optional[Lineage]) -> Optional[Lineage]:
    if l is not None:
        assert l.mask.lineage is None and l.mask.name is None, \
            "lineage vector should not itself have lineage or name"
    return l


def complete(vx: Vx) -> Vexp:
    """The only constructor: computes all derived fields (Vlite.hs:247-257)."""
    info = infer_metadata(vx).check()
    lineage = _check_lineage(infer_lineage(vx))
    quant = infer_uniqueness(vx)
    name = vx.shsource.name if isinstance(vx, Shuffle) else None
    return Vexp(vx=vx, info=info, lineage=lineage, name=name,
                skey=_INTERN.key_of(vx), quant=quant)


# --------------------------------------------------------- convenience ctors
def pos_(v: Vexp) -> Vexp:
    return complete(RangeV(rmin=0, rstep=1, rref=v))


def const_(k: int, v: Vexp) -> Vexp:
    return complete(RangeV(rmin=k, rstep=0, rref=v))


def typedconst_(k: int, v: Vexp, dt: DType) -> Vexp:
    """Literal constant keeping its display type (Vlite.hs:183-186)."""
    p = const_(k, v)
    return p.with_(info=dataclasses.replace(p.info, stype=SInt32(), dtype=dt))


def zeros_(v: Vexp) -> Vexp:
    return const_(0, v)


def ones_(v: Vexp) -> Vexp:
    return const_(1, v)


def binop(op: str, l: Vexp, r: Vexp) -> Vexp:
    return complete(Binop(binop=op, left=l, right=r))


def eq_(a, b):
    return binop(M.EQ, a, b)


def gt_(a, b):
    return binop(M.GT, a, b)


def lt_(a, b):
    return binop(M.GT, b, a)  # notice switch (Vlite.hs:199-200)


def shr_(a, b):
    return binop(M.BITSHIFT, a, b)


def shl_(a, b):
    z = zeros_(b)
    return shr_(a, binop(M.SUB, z, b))


def or_(a, b):
    return binop(M.LOGOR, a, b)


def bitor_(a, b):
    return binop(M.BITOR, a, b)


def bitand_(a, b):
    return binop(M.BITAND, a, b)


def sub_(a, b):
    return binop(M.SUB, a, b)


def mul_(a, b):
    return binop(M.MUL, a, b)


def add_(a, b):
    return binop(M.ADD, a, b)


def div_(a, b):
    return binop(M.DIV, a, b)


def mod_(a, b):
    return binop(M.MOD, a, b)


def gather(values: Vexp, positions: Vexp) -> Vexp:
    return complete(Shuffle(shop=GATHER, shsource=values, shpos=positions))


def scatter(values: Vexp, positions: Vexp,
            shape: Optional[Vexp] = None) -> Vexp:
    return complete(Shuffle(shop=SCATTER, shsource=values, shpos=positions,
                            shshape=shape))


def if_then_else(cond: Vexp, a: Vexp, b: Vexp) -> Vexp:
    """Arithmetic select: cond*a + (1-cond)*b (Vlite.hs:237-245)."""
    ones = ones_(cond)
    zeros = zeros_(cond)
    negcond = eq_(cond, zeros)
    poscond = sub_(ones, negcond)
    return add_(mul_(poscond, a), mul_(negcond, b))


# --------------------------------------------------------------- environments
class Env:
    """Operator output: the column list plus a suffix-resolving scope
    (Vlite.hs:532-548).  Carries the catalog so scalar lowering can reach
    column dictionaries (LIKE / substring)."""

    def __init__(self, cols: List[Vexp], weak: bool = False,
                 cfg: "Config" = None):
        self.cfg = cfg
        self.cols = cols
        self.table: NameTable = NameTable()
        for v in cols:
            if v.name is not None:
                if weak:
                    self.table.insert_weak(v.name, v)
                else:
                    self.table.insert(v.name, v)

    def lookup(self, n: Name) -> Vexp:
        return self.table.lookup(n)[1]


class VirError(ValueError):
    pass


# -------------------------------------------------------------------- loading
def get_ref_vector(cfg: Config, tablename: Name) -> Vexp:
    """A vector sized like the table, used as the size reference for row-id
    ranges (Vlite.hs:734-741).  TPU build: always a RangeC (pure iota)."""
    pkname = cfg.lookup_pkey(tablename)
    _, pkinfo = cfg.colinfo.lookup(pkname)
    return complete(RangeC(rmin=0, rstep=1, rcount=pkinfo.count))


def load_as(cfg: Config, tablename: Name, colname: Name,
            alias: Optional[Name]) -> Vexp:
    """Materialize a stored column, patching metadata from the catalog
    (Vlite.hs:743-755)."""
    mask = pos_(get_ref_vector(cfg, tablename))
    outname = alias if alias is not None else colname
    colname = cfg.canonical(colname)
    if len(colname) == 2 and colname[1] == "%TID%":
        return mask.with_(lineage=Lineage(col=colname, mask=mask),
                          name=outname)
    if len(colname) != 2:
        raise VirError(f"unexpected column name {name_str(colname)}")
    # canonicalize constraint pseudo-columns:
    #  * '%<fkconstraint>'  -> the stored join-index column
    #  * '[%]<pkconstraint>' -> a virtual row id, equivalent to %TID%
    #    (MonetDB's pkey oid column is the row TID), so that
    #    fk-index = pkey-oid conditions classify through the %TID% machinery
    stripped = (colname[0],
                colname[1][1:] if colname[1].startswith("%") else colname[1])
    if cfg.table_pkeys.get(tablename) == stripped:
        tid = (colname[0], "%TID%")
        return mask.with_(lineage=Lineage(col=tid, mask=mask), name=outname)
    if colname[1].startswith("%") and cfg.colinfo.lookup_opt(stripped):
        colname = stripped
    _, clinfo = cfg.colinfo.lookup(colname)
    clquant = UNIQUE if cfg.is_pkey((colname,)) is not None else ANY
    vx = Load(colname)
    return Vexp(vx=vx, info=clinfo, quant=clquant,
                lineage=Lineage(col=colname, mask=mask),
                skey=_INTERN.key_of(vx), name=outname)


def load_raw(cfg: Config, colname: Name) -> Vexp:
    """Load a column with no lineage/name (join indexes, Vlite.hs:1250-1258)."""
    _, info = cfg.colinfo.lookup(colname)
    vx = Load(colname)
    return Vexp(vx=vx, info=info, quant=ANY, lineage=None,
                skey=_INTERN.key_of(vx), name=None)


# ------------------------------------------------------------------- lowering
def vexps_from_mplan(r: M.RelExpr, cfg: Config) -> List[Vexp]:
    """Entry point (Vlite.hs:522-523)."""
    return solve_prime(cfg, r)


def solve(cfg: Config, r: M.RelExpr) -> Env:
    cols = solve_prime(cfg, r)
    sizes = {c.info.count for c in cols}
    assert len(sizes) == 1, f"column size bounds disagree: {sizes}"
    return Env(cols, cfg=cfg)


def solve_prime(cfg: Config, r: M.RelExpr) -> List[Vexp]:
    if isinstance(r, M.RTable):
        return [load_as(cfg, r.tablename, col, alias)
                for col, alias in r.tablecolumns]

    if isinstance(r, M.RProject):
        return _solve_project(cfg, r)

    if isinstance(r, M.RGroupBy):
        return _solve_groupby(cfg, r)

    if isinstance(r, M.RSelect):
        env = solve(cfg, r.child)
        fdata = sc(env, r.predicate)
        idx = complete(Fold(foldop=FSEL, fgroups=pos_(fdata), fdata=fdata))
        out = []
        for col in env.cols:
            sel = gather(col, idx)
            if col.nullmask is not None:
                sel = sel.with_(nullmask=gather(col.nullmask, idx))
            out.append(sel.with_(name=col.name))
        return out

    if isinstance(r, M.RJoin):
        return _solve_join(cfg, r)

    if isinstance(r, M.RTopN):
        # keep the first n rows of the (ordered) child; positions < n among
        # valid rows
        cols = solve(cfg, r.child).cols
        rows = pos_(cols[0])
        b = lt_(rows, const_(r.n, rows))
        sel = complete(Fold(foldop=FSEL, fgroups=pos_(b), fdata=b))
        return gather_all(cols, sel)

    if isinstance(r, M.RCartesianProduct):
        lcols = solve(cfg, r.leftch).cols
        rcols = solve(cfg, r.rightch).cols
        outer = complete(CrossProduct(left=lcols[0], right=rcols[0],
                                      variant=COUTER))
        inner = complete(CrossProduct(left=lcols[0], right=rcols[0],
                                      variant=CINNER))
        return gather_all(lcols, outer) + gather_all(rcols, inner)

    raise VirError(f"unsupported relational op: {type(r).__name__}")


def gather_all(cols: List[Vexp], shpos: Vexp) -> List[Vexp]:
    """Gather a group of columns, names (and null masks) preserved
    (Vlite.hs:1285-1288)."""
    out = []
    for c in cols:
        g = gather(c, shpos)
        if c.nullmask is not None:
            g = g.with_(nullmask=gather(c.nullmask, shpos))
        out.append(g)
    return out


def _solve_project(cfg: Config, r: M.RProject) -> List[Vexp]:
    """Sequential scoping: later outputs see earlier ones (Vlite.hs:587-619).
    Ordered projects additionally sort every output through a stable
    multi-key permutation (extension; reference cannot lower order
    clauses)."""
    base = solve(cfg, r.child).cols
    acc: List[Vexp] = []
    for expr, outname in r.projectout:
        env = Env(base + acc, weak=True, cfg=cfg)
        anon = sc(env, expr)
        acc.append(anon.with_(name=outname))
    if r.order:
        scope = Env(base + acc, weak=True, cfg=cfg)
        keys = tuple(scope.lookup(n) for n, _ in r.order)
        descs = tuple(d == "desc" for _, d in r.order)
        perm = complete(SortPerm(keys=keys, descs=descs))
        acc = [gather(c, perm).with_(name=c.name) for c in acc]
    return acc


# ----------------------------------------------------------------- scalar -> V
# Binops whose result is boolean: under SQL three-valued logic a NULL
# comparison reads as FALSE in filter position, so the result's value is
# coerced to 0 in null slots and no nullmask is attached.
_BOOL_BINOPS = frozenset({M.GT, M.LT, M.GEQ, M.LEQ, M.EQ, M.NEQ,
                          M.LOGAND, M.LOGOR})


def _mask_and(a: Optional[Vexp], b: Optional[Vexp]) -> Optional[Vexp]:
    """Combine operand nullmasks: null iff any operand is null."""
    if a is None:
        return b
    if b is None:
        return a
    if a is b or a.skey == b.skey:
        return a
    return mul_(a, b)


def sc(env: Env, e: M.ScalarExpr) -> Vexp:
    """Vlite.hs:924-1020.

    Null propagation (extension — the reference punts on nulls,
    src/notes.txt:60-63): every Vexp may carry a ``nullmask`` validity
    vector (1 = value present).  The framework-wide encoding is *value 0
    in null slots*; arithmetic over nullable operands multiplies by the
    combined mask to preserve it and carries the mask forward, boolean
    results coerce to 0 (SQL WHERE reads NULL as false) and drop it."""
    if isinstance(e, M.MRef):
        return env.lookup(e.name)

    if isinstance(e, M.MCast):
        if e.mtype.kind == "double":
            # cast-to-double only precedes averages; ignored (Vlite.hs:931)
            return sc(env, e.arg)
        v = sc(env, e.arg)
        input_dt = v.info.dtype
        out_stype = stype_of_mtype(e.mtype)
        nm = input_dt.decoder if isinstance(input_dt, DString) else ("",)
        out_dt = dtype_of_mtype(e.mtype, nm)
        out = v
        if (isinstance(input_dt, DDecimal) and isinstance(out_dt, DDecimal)
                and input_dt.point != out_dt.point):
            factor = 10 ** abs(out_dt.point - input_dt.point)
            if out_dt.point > input_dt.point:
                out = mul_(v, const_(factor, v))
            else:
                out = div_(v, const_(factor, v))
        ret = out.with_(info=dataclasses.replace(out.info, stype=out_stype,
                                                 dtype=out_dt))
        if v.nullmask is not None:
            # scale factors multiply/divide the 0-coerced null slots, so
            # the value encoding survives the cast unchanged
            ret = ret.with_(nullmask=v.nullmask)
        return ret

    if isinstance(e, M.MBinop):
        l = sc(env, e.left)
        r = sc(env, e.right)
        res = binop(e.binop, l, r)
        m = _mask_and(l.nullmask, r.nullmask)
        if m is not None:
            res = mul_(res, m)
            if e.binop not in _BOOL_BINOPS:
                res = res.with_(nullmask=m)
        return res

    if isinstance(e, M.MIn):
        left = sc(env, e.left)

        def unlit(x):
            while isinstance(x, M.MCast):
                x = x.arg
            return x if isinstance(x, M.MLiteral) else None

        lits = [unlit(x) for x in e.set]
        if isinstance(left.vx, DictMap) and all(
                x is not None and x.raw is not None for x in lits):
            # membership against a derived (e.g. substring) dictionary:
            # re-resolve the raw strings in the derived code space
            codes = {st: c for c, st in left.vx.derived}
            eqs = [eq_(typedconst_(codes.get(x.raw, -1), left,
                                   left.info.dtype), left)
                   for x in lits]
        else:
            eqs = [eq_(sc(env, x), left) for x in e.set]
        acc = eqs[0]
        for x in eqs[1:]:
            acc = or_(acc, x)
        if left.nullmask is not None:
            acc = mul_(acc, left.nullmask)  # NULL IN (...) reads false
        return acc

    if isinstance(e, M.MLiteral):
        ref = env.cols[0]
        return typedconst_(e.rep, ref, e.dtype)

    if isinstance(e, M.MIdentity):
        return pos_(env.cols[0])

    if isinstance(e, M.MUnary) and e.unop == M.YEAR:
        # ((days*1000)+1100)/365243 — deliberately approximate, valid
        # 1992-1997 (Vlite.hs:988-994); reproduced bit-for-bit.
        d = sc(env, e.arg)
        res = div_(add_(mul_(d, const_(1000, d)), const_(1100, d)),
                   const_(365243, d))
        if d.nullmask is not None:
            # null slot: (0*1000+1100)/365243 == 0, encoding preserved
            res = res.with_(nullmask=d.nullmask)
        return res

    if isinstance(e, M.MIfThenElse):
        # isnull elision (Vlite.hs:996-1000)
        if (isinstance(e.if_, M.MUnary) and e.if_.unop == M.ISNULL
                and isinstance(e.then_, M.MLiteral) and e.then_.rep == 0
                and e.if_.arg == e.else_):
            return sc(env, e.else_)
        c = sc(env, e.if_)
        t = sc(env, e.then_)
        el = sc(env, e.else_)
        res = if_then_else(c, t, el)
        # a NULL condition coerces to 0 and picks the else branch (SQL
        # CASE); nullability of the result follows the chosen branch
        if t.nullmask is not None or el.nullmask is not None:
            mt = t.nullmask if t.nullmask is not None else ones_(c)
            mf = el.nullmask if el.nullmask is not None else ones_(c)
            m = if_then_else(c, mt, mf)
            res = mul_(res, m).with_(nullmask=m)
        return res

    if isinstance(e, M.MLike):
        v = sc(env, e.ldata)
        if v.lineage is None:
            raise VirError("LIKE requires lineage to locate the dictionary")
        res = complete(Like(ldata=v, lpattern=e.pattern, lcol=v.lineage.col))
        if v.nullmask is not None:
            res = mul_(res, v.nullmask)  # NULL LIKE p reads false
        return res

    if isinstance(e, M.MSubstring):
        v = sc(env, e.arg)
        if v.lineage is None:
            raise VirError("substring requires lineage to find the dictionary")
        lcol = v.lineage.col
        # A column with no dictionary entries degrades like a literal miss
        # (mplan._resolve_char_literal's -1 sentinel): the derived map is
        # empty, every comparison against it is never-true, and compilation
        # proceeds — the reference stays compilable too because it defers
        # strings to the backend heap (reference src/Vdl.hs:244-247).
        if env.cfg is None:
            raise VirError(f"no catalog to find dictionary of {name_str(lcol)}")
        dic = env.cfg.col_dictionary.get(lcol, {})  # string -> code
        lo, n = e.start - 1, e.length
        outs = sorted({st[lo:lo + n] for st in dic})
        newcode = {st: i for i, st in enumerate(outs)}
        mapping = tuple(sorted((code, newcode[st[lo:lo + n]])
                               for st, code in dic.items()))
        derived = tuple((i, st) for st, i in sorted(newcode.items(),
                                                    key=lambda kv: kv[1]))
        res = complete(DictMap(ldata=v, lcol=lcol, mapping=mapping,
                               derived=derived))
        if v.nullmask is not None:
            # derived codes in null slots are garbage; every consumer is
            # a comparison, which the mask coerces to false
            res = res.with_(nullmask=v.nullmask)
        return res

    if isinstance(e, M.MUnary) and e.unop == M.NEG:
        v = sc(env, e.arg)
        res = sub_(ones_(v), v)
        if v.nullmask is not None:
            # NOT NULL is NULL: coerce to 0 (false) and keep the mask
            res = mul_(res, v.nullmask).with_(nullmask=v.nullmask)
        return res

    if isinstance(e, M.MUnary) and e.unop == M.ISNULL:
        v = sc(env, e.arg)
        if v.nullmask is not None:
            return sub_(ones_(v.nullmask), v.nullmask)
        return zeros_(v)  # non-nullable: never null

    raise VirError(f"unhandled scalar expression: {e}")


# ------------------------------------------------------------------- group by
def shift_to_zero(v: Vexp) -> Vexp:
    """Normalize a key vector to min 0 with no trailing zeros (Vlite.hs:1139-1144)."""
    vmin = v.info.bounds[0]
    tz = v.info.trailing_zeros
    if vmin == 0 and tz == 0:
        return v
    norm = shr_(v, const_(tz, v)) if tz != 0 else v
    vmin2 = norm.info.bounds[0]
    ret = sub_(norm, const_(vmin2, norm))
    assert ret.info.bounds[0] == 0 and ret.info.trailing_zeros == 0
    return ret


def compose_keys(l: Vexp, r: Vexp) -> Vexp:
    """Bit-pack two normalized keys into one integer (Vlite.hs:1162-1170)."""
    sl = shift_to_zero(l)
    sr = shift_to_zero(r)
    newbits = get_bit_width(sl) + get_bit_width(sr)
    assert newbits < 65, f"composite key needs {newbits} bits"
    return bitor_(shl_(sl, const_(get_bit_width(sr), sl)), sr)


def make_composite_key(cfg: Config, keys: List[Vexp]) -> Vexp:
    """Vlite.hs:1123-1136."""
    out = shift_to_zero(keys[0])
    for k in keys[1:]:
        out = compose_keys(out, k)
    if cfg.gboffset > 0:
        out = add_(out, const_(cfg.gboffset, out))
    mx = out.info.bounds[1]
    return out.with_(info=dataclasses.replace(out.info, bounds=(0, mx)))


def _group_ids(gkey: Vexp) -> Vexp:
    """Dense group ids in [0, domain) from a composite key.

    The reference's Partition-against-dense-RangeC (Vlite.hs:1082-1098); the
    engine lowers the dense case to a plain subtraction."""
    kmin, kmax = gkey.info.bounds
    if kmax == kmin:
        # degenerate single-value domain: the reference skips the Partition
        # entirely ("pivots would be empty", Vlite.hs:1085-1087) and the
        # identity-scatter peephole leaves the key vector as the groups
        if kmin == 0:
            return gkey
        return sub_(gkey, const_(kmin, gkey))
    pivots = complete(RangeC(rmin=kmin, rstep=1, rcount=kmax - kmin + 1))
    return complete(Partition(pivots=pivots, pdata=gkey))


def _strategy_fold(cfg: Config, fop: str, ids: Vexp, gdata: Vexp) -> Vexp:
    """Build the aggregate fold under the configured strategy
    (Vlite.hs:1076-1098, make2LevelFold :1173-1194), conformance path only.

    * serial — plain segmented fold
    * shuffle — permute (ids, data) pairs through ``VShuffle`` first to
      spread scatter contention; also forced for key domains > 32000
      (``getSparsity`` hardcodes the threshold, Vlite.hs:1076-1079)
    * hierarchical — 2-level grain tree: level-1 key appends the grain bit
      ``(pos >> log2 g) & 1``, fold, then fold the partials
    """
    from .catalog import AGG_HIERARCHICAL, AGG_SHUFFLE

    strat = cfg.agg_strategy if cfg.conformance_agg else None
    domain = ids.info.bounds[1] + 1
    if cfg.conformance_agg and domain > 32000:
        strat = AGG_SHUFFLE
    if strat == AGG_SHUFFLE:
        # pair-preserving encoding of the reference's row shuffle: one
        # random permutation gathers BOTH vectors (any permutation is a
        # legal execution; the engine lowers VShuffle to identity)
        perm = complete(VShuffle(varg=pos_(ids)))
        ids = complete(Shuffle(shop=GATHER, shsource=ids, shpos=perm))
        gdata = complete(Shuffle(shop=GATHER, shsource=gdata, shpos=perm))
    elif strat == AGG_HIERARCHICAL and cfg.grainsize_log > 0:
        pos = pos_(ids)
        grain = bitand_(shr_(pos, const_(cfg.grainsize_log, pos)),
                        const_(1, pos))
        ids2 = bitor_(shl_(ids, const_(1, ids)), grain)
        partial = complete(Fold(foldop=fop, fgroups=ids2, fdata=gdata))
        base = complete(Fold(foldop=FCHOOSE, fgroups=ids2, fdata=ids))
        return complete(Fold(foldop=fop, fgroups=base, fdata=partial))
    return complete(Fold(foldop=fop, fgroups=ids, fdata=gdata))


def solve_agg(cfg: Config, env: Env, after_env: Env, gkey: Vexp,
              agg: M.GroupAgg) -> Vexp:
    """Vlite.hs:1033-1070 under the id-based Fold semantics."""
    if isinstance(agg, M.GAvg):
        probe = sc(env, agg.expr)
        if probe.nullmask is not None:
            # null-aware avg (SQL: nulls are skipped): sum of the
            # 0-coerced values over count of NON-null rows; an all-null
            # group reads 0 with its own nullmask (the framework's
            # NULL-encodes-as-0 output convention)
            ids = _group_ids(gkey)
            gsums = _strategy_fold(cfg, FSUM, ids, probe)
            gcounts = _strategy_fold(cfg, FSUM, ids, probe.nullmask)
            nz = gt_(gcounts, zeros_(gcounts))
            safe = binop(M.MAX, gcounts, ones_(gcounts))
            return mul_(div_(gsums, safe), nz).with_(nullmask=nz)
        gsums = solve_agg(cfg, env, after_env, gkey, M.GFold(M.FSUM, agg.expr))
        gcounts = solve_agg(cfg, env, after_env, gkey, M.GCount())
        return div_(gsums, gcounts)
    if isinstance(agg, M.GCountDistinct):
        # first-class distinct fold: the engine lowers it as a (group,
        # value) sort + adjacent-unique count; the distributed planner
        # rewrites it into the groupby-of-groupby decomposition
        # (parallel/auto.py) when the composite key budget allows
        gdata = sc(env, agg.expr)
        ids = _group_ids(gkey)
        return complete(Fold(foldop=FDISTINCT, fgroups=ids, fdata=gdata))
    if isinstance(agg, M.GCount):
        if agg.col is not None:
            hit = env.table.lookup_opt(agg.col)
            if hit is not None and hit[1].nullmask is not None:
                # null-aware count(col): sum the validity mask
                ids = _group_ids(gkey)
                return _strategy_fold(cfg, FSUM, ids, hit[1].nullmask)
        return solve_agg(cfg, env, after_env, gkey,
                         M.GFold(M.FSUM, M.MLiteral(DDecimal(0), 1)))
    assert isinstance(agg, M.GFold)
    # already-grouped column reuse (Vlite.hs:1065-1070)
    if agg.op == M.FCHOOSE and isinstance(agg.expr, M.MRef):
        hit = after_env.table.lookup_opt(agg.expr.name)
        if hit is not None:
            return hit[1]
    fop = {M.FSUM: FSUM, M.FMAX: FMAX, M.FMIN: FMIN, M.FCHOOSE: FCHOOSE}[agg.op]
    gdata = sc(env, agg.expr)
    ids = _group_ids(gkey)
    if gdata.nullmask is not None and fop in (FSUM, FMIN, FMAX):
        # null-aware fold (SQL: nulls are skipped).  Neutral-value
        # substitution instead of a Fold fmask so the occupied-group
        # slot set — and therefore alignment with sibling folds on the
        # same key — never changes: min substitutes the column's upper
        # bound, max its lower bound (no bound widening), sum keeps the
        # 0-coerced values.  All-null groups read 0 (output convention)
        # with their own nullmask.
        m = gdata.nullmask
        if fop == FSUM:
            gd = gdata
        else:
            lo, hi = gdata.info.bounds
            neutral = typedconst_(hi if fop == FMIN else lo, gdata,
                                  gdata.info.dtype)
            gd = if_then_else(m, gdata, neutral)
        res = _strategy_fold(cfg, fop, ids, gd)
        cnt = _strategy_fold(cfg, FSUM, ids, m)
        nz = gt_(cnt, zeros_(cnt))
        return mul_(res, nz).with_(nullmask=nz)
    return _strategy_fold(cfg, fop, ids, gdata)


def _solve_groupby(cfg: Config, r: M.RGroupBy) -> List[Vexp]:
    """Vlite.hs:624-669."""
    env0 = solve(cfg, r.child)
    if not env0.cols:
        raise VirError("empty group-by input")
    refv = env0.cols[0]
    keys = [n for n, _ in r.inputkeys]
    keyvecs = [env0.lookup(n) for n in keys]
    keyaliases = [v.with_(name=a)
                  for v, (_, a) in zip(keyvecs, r.inputkeys) if a is not None]
    list1 = env0.cols + keyaliases
    if not keyvecs:
        gb = zeros_(refv)
        assert gb.info.bounds == (0, 0)
        gkeys = [gb]
    else:
        gkeys = keyvecs
    gkey = make_composite_key(cfg, gkeys).with_(comment="groupBy key")
    assert gkey.info.bounds[0] == 0

    acc: List[Vexp] = []
    for agg, alias in r.outputaggs:
        env = Env(list1 + acc, weak=True, cfg=cfg)
        after_env = Env(acc, weak=True, cfg=cfg)
        anon = solve_agg(cfg, env, after_env, gkey, agg)
        # output naming (Vlite.hs:645-648)
        outalias = alias
        if (outalias is None and isinstance(agg, M.GFold)
                and agg.op == M.FCHOOSE and isinstance(agg.expr, M.MRef)):
            outalias = agg.expr.name
        # uniqueness of a single group key's output version (Vlite.hs:649-652)
        out_quant = anon.quant
        if (len(keys) == 1 and isinstance(agg, M.GFold)
                and agg.op == M.FCHOOSE and isinstance(agg.expr, M.MRef)
                and agg.expr.name == keys[0]):
            out_quant = UNIQUE
        out_lineage = anon.lineage
        if out_lineage is not None and out_quant == UNIQUE:
            out_lineage = Lineage(col=out_lineage.col,
                                  mask=out_lineage.mask.with_(quant=UNIQUE))
        acc.append(anon.with_(name=outalias, quant=out_quant,
                              lineage=out_lineage))
    return acc


# ----------------------------------------------------------------------- joins
@dataclass(frozen=True, eq=False)
class PartialFKJoinSpec:
    pfactmask: Vexp
    pcols: Tuple[Tuple[Name, Name], ...]
    pdimmask: Vexp
    pjoinorder: str

    def __eq__(self, o):
        return (isinstance(o, PartialFKJoinSpec)
                and self.pfactmask == o.pfactmask and self.pcols == o.pcols
                and self.pdimmask == o.pdimmask
                and self.pjoinorder == o.pjoinorder)

    def __hash__(self):
        return hash((self.pfactmask.skey, self.pcols, self.pdimmask.skey,
                     self.pjoinorder))


@dataclass(frozen=True, eq=False)
class PartialSelfJoinSpec:
    pleftmask: Vexp
    prightmask: Vexp
    ppkcols: Tuple[Name, ...]

    def __eq__(self, o):
        return (isinstance(o, PartialSelfJoinSpec)
                and self.pleftmask == o.pleftmask
                and self.prightmask == o.prightmask
                and self.ppkcols == o.ppkcols)

    def __hash__(self):
        return hash((self.pleftmask.skey, self.prightmask.skey, self.ppkcols))


@dataclass
class FKJoinSpec:
    factmask: Vexp
    factunique: str
    joinidx: Name
    dimmask: Vexp
    joinorder: str
    dimref: Vexp


@dataclass
class SelfJoinSpec:
    leftmask: Vexp
    rightmask: Vexp
    pkconstraint: Name


@dataclass
class JoinIdx:
    selectmask: Vexp
    gathermask: Vexp


def separate_fk_joinable(cfg: Config, conds: List[M.ScalarExpr], left: Env,
                         right: Env):
    """Split join conditions into resolvable FK/self-join specs and leftovers
    (Vlite.hs:764-799)."""
    joinenv: NameTable = NameTable()
    for n, v in left.table.items():
        joinenv.insert(n, ("L", v))
    for n, v in right.table.items():
        joinenv.insert(n, ("R", v))

    partials: Dict[object, Tuple[object, List[M.ScalarExpr]]] = {}
    non: List[M.ScalarExpr] = []
    for expr in conds:
        handled = _classify_expr(cfg, partials, joinenv, expr)
        if not handled:
            non.append(expr)

    joinspecs = []
    for pspec, (acc, origs) in partials.items():
        if isinstance(pspec, PartialFKJoinSpec):
            kp, quant = acc
            if tuple(sorted(kp)) == pspec.pcols:
                inst = cfg.is_fk_ref(pspec.pcols)
                assert inst is not None and inst.fkjoinorder == FACT_DIM
                joinspecs.append(FKJoinSpec(
                    factmask=pspec.pfactmask.with_(comment="factmask"),
                    dimmask=pspec.pdimmask.with_(comment="dimmask"),
                    factunique=quant, joinorder=pspec.pjoinorder,
                    joinidx=inst.idxname,
                    dimref=get_ref_vector(cfg, inst.dim)))
            else:
                non.extend(origs)
        else:
            acccols = acc
            if tuple(sorted(acccols)) == tuple(sorted(pspec.ppkcols)):
                pkc = cfg.is_pkey(tuple(acccols))
                assert pkc is not None
                joinspecs.append(SelfJoinSpec(leftmask=pspec.pleftmask,
                                              rightmask=pspec.prightmask,
                                              pkconstraint=pkc))
            else:
                non.extend(origs)
    return joinspecs, non


def _classify_expr(cfg: Config, partials, joinenv: NameTable,
                   expr: M.ScalarExpr) -> bool:
    """Vlite.hs:857-873; returns True when absorbed into a partial spec."""
    if not (isinstance(expr, M.MBinop) and expr.binop == M.EQ
            and isinstance(expr.left, M.MRef)
            and isinstance(expr.right, M.MRef)):
        return False
    h1 = joinenv.lookup_opt(expr.left.name)
    h2 = joinenv.lookup_opt(expr.right.name)
    if h1 is None or h2 is None:
        return False
    (side1, v1), (side2, v2) = h1[1], h2[1]
    if side1 == side2:
        return False
    if side1 == "R":
        (side1, v1), (side2, v2) = (side2, v2), (side1, v1)
    if v1.lineage is None or v2.lineage is None:
        return False
    return _process_partials(cfg, partials,
                             (v1.lineage.col, v1.lineage.mask, v1.quant),
                             (v2.lineage.col, v2.lineage.mask, v2.quant),
                             expr)


def _add_partial(partials, key, acc, expr) -> None:
    if key in partials:
        acc0, exprs0 = partials[key]
        partials[key] = (_acc_merge(acc0, acc), exprs0 + [expr])
    else:
        partials[key] = (acc, [expr])


def _acc_merge(a, b):
    """Vlite.hs:838-846."""
    if isinstance(a, tuple) and len(a) == 2 and isinstance(a[0], tuple):
        # FK accumulator: (colpairs, quant)
        cols = tuple(sorted(set(a[0]) | set(b[0])))
        quant = UNIQUE if (a[1] == UNIQUE or b[1] == UNIQUE) else ANY
        return (cols, quant)
    return tuple(sorted(set(a) | set(b)))


def _process_partials(cfg: Config, partials, left_info, right_info,
                      expr) -> bool:
    """Vlite.hs:877-903."""
    leftcol, leftmask, leftquant = left_info
    rightcol, rightmask, rightquant = right_info
    if leftcol == rightcol:
        pks = cfg.is_partial_pk(leftcol)
        if pks is None:
            return False
        if leftmask.quant == UNIQUE or rightmask.quant == UNIQUE:
            key = PartialSelfJoinSpec(pleftmask=leftmask,
                                      prightmask=rightmask, ppkcols=pks)
            _add_partial(partials, key, (leftcol,), expr)
            return True
        return False
    hit = cfg.is_partial_fk((leftcol, rightcol))
    if hit is None:
        return False
    joinorder, kp = hit
    if joinorder == FACT_DIM:
        key = PartialFKJoinSpec(pfactmask=leftmask, pdimmask=rightmask,
                                pcols=kp, pjoinorder=FACT_DIM)
        acc = (((leftcol, rightcol),), leftquant)
    else:
        key = PartialFKJoinSpec(pfactmask=rightmask, pdimmask=leftmask,
                                pcols=kp, pjoinorder=DIM_FACT)
        acc = (((rightcol, leftcol),), rightquant)
    _add_partial(partials, key, acc, expr)
    return True


def deduce_masks(cfg: Config, jspec: FKJoinSpec) -> JoinIdx:
    """The FK-join mask algebra (Vlite.hs:1248-1282; diagram :1420-1447).

    fact' --(factmask)--> fact --(stored fk index)--> dim <--(dimmask)-- dim'
    """
    fact_dim_idx = load_raw(cfg, jspec.joinidx)
    prelim = gather(fact_dim_idx, jspec.factmask)
    fprime_dim_idx = prelim.with_(quant=jspec.factunique)
    dimprime_dim_idx = jspec.dimmask
    if dimprime_dim_idx.quant != UNIQUE:
        raise VirError("the dimension-side mask is not known to be unique")
    ones = ones_(dimprime_dim_idx)
    pos = pos_(dimprime_dim_idx)
    dim_dimprime_valid = scatter(ones, dimprime_dim_idx, shape=jspec.dimref)
    dim_dimprime_idx = scatter(pos, dimprime_dim_idx, shape=jspec.dimref)
    fprime_dimprime_valid = gather(dim_dimprime_valid, fprime_dim_idx)
    fprime_dimprime_pos = gather(dim_dimprime_idx, fprime_dim_idx)
    return JoinIdx(selectmask=fprime_dimprime_valid,
                   gathermask=fprime_dimprime_pos)


def handle_gather_join(cfg: Config, fact_env: Env, dim_env: Env,
                       variant: str, jspec) -> List[Vexp]:
    """Vlite.hs:1199-1246."""
    if isinstance(jspec, FKJoinSpec):
        factcols, dimcols = fact_env.cols, dim_env.cols
        jidx = deduce_masks(cfg, jspec)
        selectboolean = jidx.selectmask
        selectmask = complete(Fold(foldop=FSEL, fgroups=pos_(selectboolean),
                                   fdata=selectboolean)).with_(
                                       comment="selectmask")
        gathered = gather_all([jidx.gathermask] + factcols, selectmask)
        clean_gathermask, cleaned_factcols = gathered[0], gathered[1:]
        if variant == M.PLAIN:
            joined_dimcols = gather_all(dimcols, clean_gathermask)
            return cleaned_factcols + joined_dimcols
        if variant == M.LEFTSEMI:
            if jspec.joinorder == FACT_DIM:
                return cleaned_factcols
            # semijoin keeping the dim side: mark referenced dim rows
            # (Vlite.hs:1214-1222).  Deviation: the reference scatters through
            # the *raw* gather mask, which spuriously marks dim row 0 whenever
            # a fact row has no dim' match; we scatter the compacted mask.
            qualified = scatter(ones_(clean_gathermask), clean_gathermask,
                                shape=jspec.dimref)
            dimsel = complete(Fold(foldop=FSEL, fgroups=pos_(qualified),
                                   fdata=qualified))
            return gather_all(dimcols, dimsel)
        if variant == M.LEFTANTI:
            if jspec.joinorder == FACT_DIM:
                anti = sub_(ones_(selectboolean), selectboolean)
                antigather = complete(Fold(foldop=FSEL, fgroups=pos_(anti),
                                           fdata=anti))
                return gather_all(factcols, antigather)
            # no gather specialization (reference raises, Vlite.hs:1232);
            # _solve_join catches and lowers via the general JoinIndex path
            raise VirError("anti-join keeping the dimension side: "
                           "declined, general equijoin handles it")
        # e.g. LeftOuter (reference: unimplemented, Vlite.hs:1223-1225);
        # caught by _solve_join -> _solve_equi_join's JOUTER_* lowering
        raise VirError(f"FK-gather has no {variant} specialization: "
                       "declined, general equijoin handles it")

    assert isinstance(jspec, SelfJoinSpec)
    leftcols, rightcols = fact_env.cols, dim_env.cols

    def is_identity_range(v: Vexp) -> bool:
        return (isinstance(v.vx, RangeV) and v.vx.rmin == 0
                and v.vx.rstep == 1)

    if is_identity_range(jspec.rightmask):
        factcols, dimcols, gmask = leftcols, rightcols, jspec.leftmask
    elif is_identity_range(jspec.leftmask):
        factcols, dimcols, gmask = rightcols, leftcols, jspec.rightmask
    else:
        # reference requires one unfiltered side (Vlite.hs:1234-1246);
        # caught by _solve_join and lowered as a general PK equijoin
        raise VirError("self-join where both children are filtered: "
                       "declined, general equijoin handles it")
    if variant != M.PLAIN:
        raise VirError(f"non-plain self-join: {variant}")
    return factcols + gather_all(dimcols, gmask)


def _solve_join(cfg: Config, r: M.RJoin) -> List[Vexp]:
    """Vlite.hs:682-719, plus the general-equijoin fallback the reference
    lacks (SURVEY.md §7.4): whenever the FK-gather strategy does not apply
    (no FK constraint, dim side not unique, self-join on a non-key column),
    the join lowers to JoinIndex ops backed by the engine's sort-merge /
    hash kernels."""
    sleft = solve(cfg, r.leftch)
    sright = solve(cfg, r.rightch)
    specs, leftover = separate_fk_joinable(cfg, list(r.conds), sleft, sright)

    if len(specs) == 1 and not leftover:
        spec = specs[0]
        try:
            if isinstance(spec, FKJoinSpec):
                if spec.joinorder == FACT_DIM:
                    return handle_gather_join(cfg, sleft, sright,
                                              r.joinvariant, spec)
                return handle_gather_join(cfg, sright, sleft, r.joinvariant,
                                          spec)
            return handle_gather_join(cfg, sleft, sright, r.joinvariant, spec)
        except VirError:
            return _solve_equi_join(cfg, r, sleft, sright)

    if not specs and len(leftover) == 1 and isinstance(leftover[0], M.MBinop):
        cond = leftover[0]
        # the condition's sides need not match the children's order
        # (monetpch Q2 writes `L2.x = L3.y` with L2 as the RIGHT child);
        # unresolvable shapes go to the general equijoin
        cond_op = cond.binop
        try:
            keyl = sc(sleft, cond.left)
            keyr = sc(sright, cond.right)
        except KeyError:
            try:
                keyl = sc(sleft, cond.right)
                keyr = sc(sright, cond.left)
                # operands swapped: mirror asymmetric comparison ops so the
                # predicate still reads value(cond.left) OP value(cond.right)
                cond_op = {M.GT: M.LT, M.LT: M.GT,
                           M.GEQ: M.LEQ, M.LEQ: M.GEQ}.get(cond_op, cond_op)
            except KeyError:
                return _solve_equi_join(cfg, r, sleft, sright)
        # single-row side: broadcast-compare (Vlite.hs:694-713)
        if keyl.info.count == 1 and len(sleft.cols) == 1:
            bl = gather(keyl, zeros_(keyr))
            boolean = binop(cond_op, bl, keyr)
            gm = complete(Fold(foldop=FSEL, fgroups=pos_(boolean),
                               fdata=boolean))
            return gather_all(sright.cols, gm)
        if keyr.info.count == 1 and len(sright.cols) == 1:
            br = gather(keyr, zeros_(keyl))
            boolean = binop(cond_op, keyl, br)
            gm = complete(Fold(foldop=FSEL, fgroups=pos_(boolean),
                               fdata=boolean))
            return gather_all(sleft.cols, gm)

    if (len(specs) == 1 and len(leftover) == 1
            and r.joinvariant == M.PLAIN):
        # re-solve as Select(Join) without the leftover condition
        # (Vlite.hs:714-718)
        remaining = tuple(c for c in r.conds if c != leftover[0])
        inner = M.RJoin(leftch=r.leftch, rightch=r.rightch, conds=remaining,
                        joinvariant=r.joinvariant)
        return solve_prime(cfg, M.RSelect(child=inner,
                                          predicate=leftover[0]))

    return _solve_equi_join(cfg, r, sleft, sright)


def _compose_join_keys(pairs: List[Tuple[Vexp, Vexp]]) -> Tuple[Vexp, Vexp]:
    """Pack the per-condition key columns of both sides into one integer
    each, using a *shared* offset/width per condition so equality is
    preserved across sides."""
    def norm(v: Vexp, lo: int, hi: int) -> Vexp:
        # shift values into [0, hi-lo]; no trailing-zero tricks here since
        # both sides must use identical transforms
        return sub_(v, const_(lo, v)) if lo != 0 else v

    lk = rk = None
    for lv, rv in pairs:
        lo = min(lv.info.bounds[0], rv.info.bounds[0])
        hi = max(lv.info.bounds[1], rv.info.bounds[1])
        width = _bitsize(hi - lo)
        ln, rn = norm(lv, lo, hi), norm(rv, lo, hi)
        if lk is None:
            lk, rk = ln, rn
        else:
            assert get_bit_width(lk) + width < 64, "join key overflow"
            w = const_(width, lk)
            lk = bitor_(shl_(lk, w), ln)
            rk = bitor_(shl_(rk, const_(width, rk)), rn)
    return lk, rk


def _expr_refs(e: M.ScalarExpr) -> List[Name]:
    out: List[Name] = []

    def go(x):
        if isinstance(x, M.MRef):
            out.append(x.name)
        else:
            for f in dataclasses.fields(x):
                v = getattr(x, f.name)
                if isinstance(v, tuple):
                    for y in v:
                        if dataclasses.is_dataclass(y):
                            go(y)
                elif dataclasses.is_dataclass(v):
                    go(v)

    go(e)
    return out


def _solve_equi_join(cfg: Config, r: M.RJoin, sleft: Env,
                     sright: Env) -> List[Vexp]:
    """General equijoin via JoinIndex (new capability vs the reference)."""
    conds = list(r.conds)
    if r.joinvariant == M.LEFTOUTER:
        # ON-clause conditions that touch only the right side filter the
        # right input before the outer join (Q13's NOT LIKE on o_comment)
        pushable, rest = [], []
        for c in conds:
            refs = _expr_refs(c)
            if refs and all(sright.table.lookup_opt(n) is not None
                            and sleft.table.lookup_opt(n) is None
                            for n in refs):
                pushable.append(c)
            else:
                rest.append(c)
        if pushable:
            pred = pushable[0]
            for c in pushable[1:]:
                pred = M.MBinop(M.LOGAND, pred, c)
            fdata = sc(sright, pred)
            idx = complete(Fold(foldop=FSEL, fgroups=pos_(fdata),
                                fdata=fdata))
            sright = Env(gather_all(sright.cols, idx), weak=True, cfg=cfg)
            conds = rest

    eq_pairs: List[Tuple[Vexp, Vexp]] = []
    others: List[M.ScalarExpr] = []
    for cond in conds:
        pair = None
        if (isinstance(cond, M.MBinop) and cond.binop == M.EQ
                and isinstance(cond.left, M.MRef)
                and isinstance(cond.right, M.MRef)):
            a = sleft.table.lookup_opt(cond.left.name)
            b = sright.table.lookup_opt(cond.right.name)
            if a is not None and b is not None:
                pair = (a[1], b[1])
            else:
                a = sleft.table.lookup_opt(cond.right.name)
                b = sright.table.lookup_opt(cond.left.name)
                if a is not None and b is not None:
                    pair = (a[1], b[1])
        if pair is not None:
            eq_pairs.append(pair)
        else:
            others.append(cond)
    if not eq_pairs:
        raise VirError(
            f"join without any equality condition: {r.conds}")
    lkey, rkey = _compose_join_keys(eq_pairs)

    def joined_env(li: Vexp, ri: Vexp) -> List[Vexp]:
        return gather_all(sleft.cols, li) + gather_all(sright.cols, ri)

    if r.joinvariant == M.PLAIN:
        li = complete(JoinIndex(lkeys=lkey, rkeys=rkey, jside=JLEFT))
        ri = complete(JoinIndex(lkeys=lkey, rkeys=rkey, jside=JRIGHT))
        cols = joined_env(li, ri)
    elif r.joinvariant in (M.LEFTSEMI, M.LEFTANTI):
        if others:
            # existence semantics with extra conditions: a left row is kept
            # iff some (semi) / no (anti) matching pair satisfies them all;
            # handled below via pair marking
            cols = None
        else:
            side = JSEMI if r.joinvariant == M.LEFTSEMI else JANTI
            sel = complete(JoinIndex(lkeys=lkey, rkeys=rkey, jside=side))
            return gather_all(sleft.cols, sel)
    elif r.joinvariant == M.LEFTOUTER:
        li = complete(JoinIndex(lkeys=lkey, rkeys=rkey, jside=JOUTER_LEFT))
        ri = complete(JoinIndex(lkeys=lkey, rkeys=rkey, jside=JOUTER_RIGHT))
        valid = complete(JoinIndex(lkeys=lkey, rkeys=rkey,
                                   jside=JOUTER_VALID))
        lcols = gather_all(sleft.cols, li)
        # unmatched rows read right columns as 0, and each right column
        # carries the join validity as its null mask (null-aware count)
        rcols = [mul_(g, valid).with_(name=g.name, nullmask=valid)
                 for g in gather_all(sright.cols, ri)]
        if others:
            # pair-level extra ON conditions (extension; the reference has
            # no outer join at all, Vlite.hs:1223-1225).  The outer pair
            # stream lays out matched pairs first — grouped by left row,
            # left index non-decreasing — then one null row per
            # eq-unmatched left row (engine JOUTER layout).  Keep:
            #   * matched pairs satisfying the predicate (ok), and
            #   * the FIRST stream row of each left row that has no
            #     qualifying pair — its right payload reads as NULL.
            env = Env(lcols + rcols, weak=True, cfg=cfg)
            pred = others[0]
            for o in others[1:]:
                pred = M.MBinop(M.LOGAND, pred, o)
            ok = mul_(sc(env, pred), valid)
            qualified = complete(Fold(foldop=FSEL, fgroups=pos_(ok),
                                      fdata=ok))
            hit_left = gather(li, qualified)
            refv = sleft.cols[0]
            has_q = scatter(ones_(hit_left), hit_left, shape=refv)
            pos = pos_(li)
            prevpos = binop(M.MAX, sub_(pos, ones_(pos)), zeros_(pos))
            first = or_(binop(M.NEQ, li, gather(li, prevpos)),
                        eq_(pos, zeros_(pos)))
            keep = or_(ok, mul_(first, sub_(ones_(li), gather(has_q, li))))
            sel = complete(Fold(foldop=FSEL, fgroups=pos_(keep),
                                fdata=keep))
            okk = gather(ok, sel)
            lcols = gather_all(lcols, sel)  # names + nullmasks preserved
            rcols = [mul_(gather(g, sel), okk).with_(name=g.name,
                                                     nullmask=okk)
                     for g in rcols]
        return lcols + rcols
    else:
        raise VirError(f"equijoin variant {r.joinvariant}")

    if cols is not None and others:
        env = Env(cols, weak=True, cfg=cfg)
        pred = others[0]
        for o in others[1:]:
            pred = M.MBinop(M.LOGAND, pred, o)
        fdata = sc(env, pred)
        idx = complete(Fold(foldop=FSEL, fgroups=pos_(fdata), fdata=fdata))
        cols = [gather(c, idx).with_(name=c.name) for c in cols]
        return cols
    if cols is not None:
        return cols

    # semi/anti with extra conditions: compute qualified pairs, scatter a
    # "hit" mark back to left rows, keep marked (semi) / unmarked (anti).
    li = complete(JoinIndex(lkeys=lkey, rkeys=rkey, jside=JLEFT))
    ri = complete(JoinIndex(lkeys=lkey, rkeys=rkey, jside=JRIGHT))
    pcols = joined_env(li, ri)
    env = Env(pcols, weak=True, cfg=cfg)
    pred = others[0]
    for o in others[1:]:
        pred = M.MBinop(M.LOGAND, pred, o)
    okpair = sc(env, pred)
    qualified = complete(Fold(foldop=FSEL, fgroups=pos_(okpair),
                              fdata=okpair))
    hit_left = gather(li, qualified)
    refv = sleft.cols[0]
    marks = scatter(ones_(hit_left), hit_left, shape=refv)
    if r.joinvariant == M.LEFTSEMI:
        keep = marks
    else:
        # anti: unmarked VALID rows only — scatter a validity mark per live
        # left row so padding slots cannot pass the 1-marks test
        rowpos = pos_(refv)
        validrows = scatter(ones_(rowpos), rowpos, shape=refv)
        keep = mul_(sub_(ones_(marks), marks), validrows)
    sel = complete(Fold(foldop=FSEL, fgroups=pos_(keep), fdata=keep))
    return gather_all(sleft.cols, sel)
