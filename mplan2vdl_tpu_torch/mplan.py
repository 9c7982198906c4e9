"""Typed logical plan (semantics of reference src/Mplan.hs).

Parse tree -> RelExpr with fully *encoded* scalar literals:
  dates    -> days since 0000-01-01            (Mplan.hs:46-57)
  date +/- interval -> folded at compile time  (Mplan.hs:366-388)
  decimals -> scaled integers                  (Mplan.hs:467)
  booleans -> 0/1                              (Mplan.hs:470-473)
  char     -> dictionary code, resolved under the *expected* display type of
              the surrounding expression       (Mplan.hs:480-482)

Plus the two plan rewrites ``push_fk_joins`` (Mplan.hs:574-604) and
``fuse_selects`` (Mplan.hs:607-620).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

from .catalog import Config
from .fe import plan_parser as P
from .mtypes import (DDate, DDecimal, DString, DType, MType, TypeSpec,
                     resolve_type_spec)
from .names import Name, name_str

# ------------------------------------------------------------------ operators
# binary ops (Mplan.hs:62-67)
GT, LT, LEQ, GEQ = "Gt", "Lt", "Leq", "Geq"
EQ, NEQ = "Eq", "Neq"
LOGAND, LOGOR = "LogAnd", "LogOr"
SUB, ADD, DIV, MUL, MOD = "Sub", "Add", "Div", "Mul", "Mod"
BITAND, BITOR, MIN, MAX, BITSHIFT = "BitAnd", "BitOr", "Min", "Max", "BitShift"

# unary ops (Mplan.hs:103-105)
NEG, YEAR, ISNULL = "Neg", "Year", "IsNull"

# fold ops (Mplan.hs:131)
FSUM, FMAX, FMIN, FCHOOSE = "FSum", "FMax", "FMin", "FChoose"

# join variants (Mplan.hs:187)
PLAIN, LEFTSEMI, LEFTOUTER, LEFTANTI = "Plain", "LeftSemi", "LeftOuter", "LeftAnti"

_INFIX = {"<": LT, ">": GT, "<=": LEQ, ">=": GEQ, "=": EQ, "!=": NEQ,
          "or": LOGOR}  # Mplan.hs:71-81

_BINFUN = {"sql_add": ADD, "sql_sub": SUB, "sql_mul": MUL, "sql_div": DIV,
           "sql_min": MIN, "sql_max": MAX, "=": EQ, "or": LOGOR,
           "and": LOGAND, ">": GT, "<>": NEQ, "scale_down": DIV}  # Mplan.hs:84-99

_UNFUN = {"year": YEAR, "sql_neg": NEG, "isnull": ISNULL}  # Mplan.hs:108-114


# -------------------------------------------------------------- scalar exprs
@dataclass(frozen=True)
class MRef:
    name: Name


@dataclass(frozen=True)
class MLiteral:
    dtype: DType
    rep: int  # encoded representation
    raw: Optional[str] = None  # original text of string literals (for
    # re-resolution against derived dictionaries, e.g. substring outputs)


@dataclass(frozen=True)
class MIdentity:
    e: "ScalarExpr"  # returns a rowid (Mplan.hs:120,392-396)


@dataclass(frozen=True)
class MUnary:
    unop: str
    arg: "ScalarExpr"


@dataclass(frozen=True)
class MBinop:
    binop: str
    left: "ScalarExpr"
    right: "ScalarExpr"


@dataclass(frozen=True)
class MIfThenElse:
    if_: "ScalarExpr"
    then_: "ScalarExpr"
    else_: "ScalarExpr"


@dataclass(frozen=True)
class MCast:
    mtype: MType
    arg: "ScalarExpr"


@dataclass(frozen=True)
class MIn:
    left: "ScalarExpr"
    set: Tuple["ScalarExpr", ...]


@dataclass(frozen=True)
class MLike:
    ldata: "ScalarExpr"
    pattern: str


@dataclass(frozen=True)
class MSubstring:
    """substring(col from start for length) over a dictionary-encoded string
    column.  Not supported by the reference (no Mplan.hs case); evaluated
    over the column's dictionary at compile time (extension for Q22)."""

    arg: "ScalarExpr"
    start: int
    length: int


ScalarExpr = Union[MRef, MLiteral, MIdentity, MUnary, MBinop, MIfThenElse,
                   MCast, MIn, MLike, MSubstring]


# ---------------------------------------------------------------- aggregates
@dataclass(frozen=True)
class GAvg:
    expr: ScalarExpr


@dataclass(frozen=True)
class GCount:
    # count(col) keeps the column so null-aware counting can consult its
    # validity (SQL semantics; the reference counts rows regardless,
    # Mplan.hs:175-180)
    col: Optional[Name] = None


@dataclass(frozen=True)
class GFold:
    op: str  # FSUM | FMAX | FMIN | FCHOOSE
    expr: ScalarExpr


@dataclass(frozen=True)
class GCountDistinct:
    """count(distinct x): MonetDB prints the ``unique`` call modifier
    (``sys.count unique no nil (col)``).  A capability extension — the
    reference has no distinct aggregate (src/notes.txt:60-63); MonetDB
    itself usually rewrites to a groupby-of-groupby (Q16's committed
    shape), which still compiles through the ordinary path."""

    expr: ScalarExpr


GroupAgg = Union[GAvg, GCount, GFold, GCountDistinct]


# -------------------------------------------------------------- relational ops
@dataclass(frozen=True)
class RTable:
    tablename: Name
    tablecolumns: Tuple[Tuple[Name, Optional[Name]], ...]  # (col, alias)


@dataclass(frozen=True)
class RProject:
    child: "RelExpr"
    projectout: Tuple[Tuple[ScalarExpr, Optional[Name]], ...]
    order: Tuple[Tuple[Name, str], ...] = ()


@dataclass(frozen=True)
class RSelect:
    child: "RelExpr"
    predicate: ScalarExpr


@dataclass(frozen=True)
class RGroupBy:
    child: "RelExpr"
    inputkeys: Tuple[Tuple[Name, Optional[Name]], ...]
    outputaggs: Tuple[Tuple[GroupAgg, Optional[Name]], ...]


@dataclass(frozen=True)
class RJoin:
    leftch: "RelExpr"
    rightch: "RelExpr"
    conds: Tuple[ScalarExpr, ...]  # non-empty
    joinvariant: str


@dataclass(frozen=True)
class RCartesianProduct:
    leftch: "RelExpr"
    rightch: "RelExpr"


@dataclass(frozen=True)
class RTopN:
    child: "RelExpr"
    n: int


RelExpr = Union[RTable, RProject, RSelect, RGroupBy, RJoin,
                RCartesianProduct, RTopN]


# ------------------------------------------------------------- date encoding
def parse_date(s: str) -> datetime.date:
    return datetime.date.fromisoformat(s)


def day_count(d: datetime.date) -> int:
    """Days since 0000-01-01 proleptic Gregorian (Mplan.hs:50-57).

    ``date(1,1,1).toordinal() == 1`` and year 0 is a leap year, so the
    ordinal of 0000-01-01 is -365.
    """
    return d.toordinal() + 365


def _days_in_month(y: int, m: int) -> int:
    if m == 12:
        return 31
    return (datetime.date(y, m + 1, 1) - datetime.date(y, m, 1)).days


def add_months_rollover(d: datetime.date, months: int) -> datetime.date:
    """Data.Time addGregorianMonthsRollOver: excess days roll into the next month."""
    total = (d.year * 12 + (d.month - 1)) + months
    y, m = divmod(total, 12)
    m += 1
    dim = _days_in_month(y, m)
    if d.day <= dim:
        return datetime.date(y, m, d.day)
    extra = d.day - dim
    if m == 12:
        return datetime.date(y + 1, 1, extra)
    return datetime.date(y, m + 1, extra)


_MILLIS_IN_DAY = 1000 * 60 * 60 * 24


def _quot(a: int, b: int) -> int:
    """Haskell ``quot`` / C integer division: truncation toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


# ---------------------------------------------------------------- scalar ctx
class LowerError(ValueError):
    pass


def _read_int(s: str) -> int:
    return int(s)


def _resolve_char_literal(cfg: Config, s: str) -> int:
    code = cfg.dictionary.get(s)
    if code is None:
        # A literal absent from every column's dictionary can never compare
        # equal to any stored code; encode it as a sentinel no column uses.
        # (The reference errors instead, Mplan.hs:42-44; extension.)
        return -1
    if cfg.quirk_trace_dict:
        # reference quirk: every resolved char literal is traced to stderr
        # as ",,<string>,<code>" (Mplan.hs:44) — reproduced under --quirks
        import sys

        print(f",,{s},{code}", file=sys.stderr)
    return code


def _ref_dtype(cfg: Config, n: Name) -> Optional[DType]:
    hit = cfg.colinfo.lookup_opt(n)
    return hit[1].dtype if hit else None


def _sc(cfg: Config, e: P.ScalarExpr, dt: Optional[DType]) -> ScalarExpr:
    """Parser scalar -> Mplan scalar under an expected display type ``dt``
    (the Reader Context of Mplan.hs:359)."""
    if isinstance(e, P.Ref):
        return MRef(e.name)

    if isinstance(e, P.Call):
        fname = e.fname
        args = e.args
        key = fname[-1] if fname else ""
        # date +/- interval folding (Mplan.hs:366-388)
        if (len(fname) == 1 and key in ("sql_add", "sql_sub")
                and len(args) == 2
                and isinstance(args[0].expr, P.Literal)
                and args[0].expr.tspec.tname == "date"
                and isinstance(args[1].expr, P.Literal)
                and args[1].expr.tspec.tname in ("month_interval", "sec_interval")):
            datestr = args[0].expr.rep
            rawnum = _read_int(args[1].expr.rep)
            num = -rawnum if key == "sql_sub" else rawnum
            d = parse_date(datestr)
            if args[1].expr.tspec.tname == "month_interval":
                out = add_months_rollover(d, num)
            else:
                out = d + datetime.timedelta(days=_quot(num, _MILLIS_IN_DAY))
            return _sc(cfg, P.Literal(TypeSpec("date"), out.isoformat()), dt)
        if fname == ("identity",) and len(args) == 1:
            return MIdentity(_sc(cfg, args[0].expr, dt))
        if fname == ("like",):
            # sys.like(arg, char[]-cast pattern)  (Mplan.hs:399-419)
            if (len(args) == 2 and isinstance(args[1].expr, P.Cast)
                    and isinstance(args[1].expr.value.expr, P.Literal)):
                return MLike(_sc(cfg, args[0].expr, dt),
                             args[1].expr.value.expr.rep)
            raise LowerError(f"unsupported 'like' call shape: {e}")
        if fname == ("ifthenelse",) and len(args) == 3:
            return MIfThenElse(_sc(cfg, args[0].expr, dt),
                               _sc(cfg, args[1].expr, dt),
                               _sc(cfg, args[2].expr, dt))
        if key == "substring" and len(args) == 3:
            inner = _sc(cfg, args[0].expr, dt)
            start = _sc(cfg, args[1].expr, None)
            length = _sc(cfg, args[2].expr, None)

            def unlit(x):
                while isinstance(x, MCast):
                    x = x.arg
                if not isinstance(x, MLiteral):
                    raise LowerError("substring needs literal start/length")
                return x.rep

            return MSubstring(inner, unlit(start), unlit(length))
        if len(args) == 1:
            if key not in _UNFUN:
                raise LowerError(f"unknown unary function {name_str(fname)}")
            return MUnary(_UNFUN[key], _sc(cfg, args[0].expr, dt))
        if len(args) == 2:
            if key not in _BINFUN:
                raise LowerError(f"unknown binary function {name_str(fname)}")
            left = _sc(cfg, args[0].expr, dt)
            newdt = _ref_dtype(cfg, left.name) if isinstance(left, MRef) else None
            right = _sc(cfg, args[1].expr, newdt)
            return MBinop(_BINFUN[key], left, right)
        raise LowerError(f"unhandled call: {e}")

    if isinstance(e, P.Cast):
        return MCast(resolve_type_spec(e.tspec), _sc(cfg, e.value.expr, dt))

    if isinstance(e, P.Literal):
        mtype = resolve_type_spec(e.tspec)
        k = mtype.kind
        if k == "date":
            return MLiteral(DDate(), day_count(parse_date(e.rep)))
        if k == "decimal":
            # sql 0.06 shows up as ``decimal(,2) "6"`` — reinterpret the int
            # as an already-scaled decimal (Mplan.hs:465-468)
            return MLiteral(DDecimal(mtype.p2), _read_int(e.rep))
        if k == "boolean":
            if e.rep == "true":
                return MLiteral(DDecimal(0), 1)
            if e.rep == "false":
                return MLiteral(DDecimal(0), 0)
            raise LowerError(f"invalid boolean literal {e.rep!r}")
        if k in ("tinyint", "smallint", "int", "bigint"):
            return MLiteral(DDecimal(0), _read_int(e.rep))
        if k == "char":
            if isinstance(dt, DString):
                return MLiteral(dt, _resolve_char_literal(cfg, e.rep),
                                raw=e.rep)
            # The display-type context is unavailable when the compared column
            # is a derived alias (e.g. ``L5.r_name`` in Q2) — the reference
            # errors here (Mplan.hs:480-482 forces a failing colinfo lookup).
            # The dictionary is global and keyed by string only
            # (Config.hs:83-86), so the code resolves without the context;
            # we attach an anonymous decoder.  (Deviation: extends coverage.)
            return MLiteral(DString(("?",)), _resolve_char_literal(cfg, e.rep),
                            raw=e.rep)
        raise LowerError(f"unexpected literal: {e}")

    if isinstance(e, P.Infix):
        left = _sc(cfg, e.left.expr, dt)
        newdt = _ref_dtype(cfg, left.name) if isinstance(left, MRef) else None
        right = _sc(cfg, e.right.expr, newdt)
        op = _INFIX.get(e.op)
        if op is None:
            raise LowerError(f"unexpected infix symbol {e.op!r}")
        return MBinop(op, left, right)

    if isinstance(e, P.Interval):
        # a <= x < b -> (a <= x) AND (x < b)  (Mplan.hs:498-511)
        first = _sc(cfg, e.first.expr, dt)
        middle = _sc(cfg, e.middle.expr, dt)
        last = _sc(cfg, e.last.expr, dt)
        fop, sop = _INFIX[e.firstop], _INFIX[e.secondop]
        return MBinop(LOGAND,
                      MBinop(fop, first, middle),
                      MBinop(sop, middle, last))

    if isinstance(e, P.In):
        # The reference only supports a non-negated IN over a plain column
        # reference (Mplan.hs:514-522); extended here to any operand (Q22
        # applies IN to a substring call) and to NOT IN via negation.
        arg = e.arg.expr
        left_dtype = _ref_dtype(cfg, arg.name) if isinstance(arg, P.Ref) else None
        left = _sc(cfg, arg, dt)
        elems = tuple(_sc(cfg, x.expr, left_dtype) for x in e.set)
        out: ScalarExpr = MIn(left, elems)
        if e.negated:
            out = MUnary(NEG, out)
        return out

    if isinstance(e, P.Nested):
        return conjunction(cfg, list(e.exprs))

    if isinstance(e, P.Filter):
        # X FILTER like (char[char(n) "pat"], char "")  (Mplan.hs:528-547)
        if e.oper != "like":
            raise LowerError(f"unexpected FILTER operator {e.oper!r}")
        pat = e.pattern.expr
        if not (isinstance(pat, P.Cast) and isinstance(pat.value.expr, P.Literal)):
            raise LowerError(f"unsupported FILTER pattern shape: {pat}")
        arg = _sc(cfg, e.arg.expr, dt)
        like = MLike(arg, pat.value.expr.rep)
        if e.negated:
            return MUnary(NEG, like)
        return like

    raise LowerError(f"unexpected scalar operator: {e}")


def rsc(cfg: Config, e: P.ScalarExpr) -> ScalarExpr:
    return _sc(cfg, e, None)


def conjunction(cfg: Config, exprs: List[P.Expr]) -> ScalarExpr:
    """Fold a bracket list into a left-assoc AND tree (Mplan.hs:552-559)."""
    solved = [rsc(cfg, x.expr) for x in exprs]
    if not solved:
        raise LowerError("empty conjunction list")
    acc = solved[0]
    for x in solved[1:]:
        acc = MBinop(LOGAND, acc, x)
    return acc


# -------------------------------------------------------------- group outputs
def _solve_group_output(cfg: Config, e: P.Expr) -> Tuple[GroupAgg, Optional[Name]]:
    """Mplan.hs:138-181."""
    inner = e.expr
    if isinstance(inner, P.Ref):
        outname = e.alias if e.alias is not None else inner.name
        return GFold(FCHOOSE, MRef(inner.name)), outname
    if isinstance(inner, P.Call):
        fname = inner.fname
        if fname == ("count",) and len(inner.args) == 0:
            return GCount(None), e.alias
        if len(inner.args) == 1:
            arg = inner.args[0].expr
            sub = rsc(cfg, arg)
            if inner.unique:
                # the `unique` call modifier = SQL DISTINCT aggregates;
                # min/max over distinct values equal plain min/max
                if fname == ("count",):
                    return GCountDistinct(sub), e.alias
                if fname == ("max",):
                    return GFold(FMAX, sub), e.alias
                if fname == ("min",):
                    return GFold(FMIN, sub), e.alias
                raise LowerError(
                    f"unsupported distinct aggregate: {fname}")
            if fname == ("sum",):
                return GFold(FSUM, sub), e.alias
            if fname == ("avg",):
                return GAvg(sub), e.alias
            if fname == ("max",):
                return GFold(FMAX, sub), e.alias
            if fname == ("min",):
                return GFold(FMIN, sub), e.alias
            if fname == ("count",) and isinstance(arg, P.Ref):
                # count(col): null-aware when the column carries an
                # outer-join validity mask; count(*) otherwise
                return GCount(arg.name), e.alias
    raise LowerError(f"unexpected group-by output expression: {e}")


# ------------------------------------------------------------------- solving
def _get_joinidx(attrs: Tuple[P.Attr, ...]) -> List[Name]:
    return [a.name for a in attrs if a.kind == "joinidx"]


def _solve_table(leaf: P.Leaf) -> RTable:
    """Mplan.hs:236-252: JOINIDX attrs swap in the fk-index column."""
    cols: List[Tuple[Name, Optional[Name]]] = []
    for col in leaf.columns:
        inner = col.expr
        if not isinstance(inner, P.Ref):
            raise LowerError("table outputs must be plain references")
        jidx = _get_joinidx(inner.attrs)
        if col.alias is None:
            if len(jidx) == 1:
                cols.append((jidx[0], inner.name))  # notice reversal
            elif not jidx:
                cols.append((inner.name, None))
            else:
                raise LowerError("multiple fkey indices on one column")
        else:
            if len(jidx) == 1:
                cols.append((jidx[0], col.alias))
            elif not jidx:
                cols.append((inner.name, col.alias))
            else:
                raise LowerError("multiple fkey indices on one column")
    if not cols:
        raise LowerError("table with no columns")
    return RTable(tablename=leaf.source, tablecolumns=tuple(cols))


def solve(cfg: Config, rel: P.Rel) -> RelExpr:
    """Parse tree -> RelExpr (Mplan.hs:227-332)."""
    if isinstance(rel, P.Leaf):
        return _solve_table(rel)

    op = rel.relop
    if op == "project":
        if len(rel.children) != 1:
            raise LowerError("project expects one child")
        out = rel.arg_lists[0]
        rest = rel.arg_lists[1:]
        order: List[Tuple[Name, str]] = []
        if rest and any(rest):
            # ordered project (the reference parses but cannot lower these,
            # Mplan.hs:267-269; extension).  ASC is annotated explicitly;
            # an unannotated order column is descending (Parser.y:169-171).
            if len(rest) != 1:
                raise LowerError("multiple order lists")
            for x in rest[0]:
                if not isinstance(x.expr, P.Ref):
                    raise LowerError("non-ref order-by column")
                asc = any(a.kind == "asc" for a in x.expr.attrs)
                order.append((x.expr.name, "asc" if asc else "desc"))
        child = solve(cfg, rel.children[0])
        projectout = tuple((rsc(cfg, x.expr), _output_name(x)) for x in out)
        return RProject(child=child, projectout=projectout,
                        order=tuple(order))

    if op == "group by":
        if len(rel.children) != 1 or len(rel.arg_lists) != 2:
            raise LowerError("group by expects one child and two arg lists")
        child = solve(cfg, rel.children[0])
        keys = []
        for x in rel.arg_lists[0]:
            if not isinstance(x.expr, P.Ref):
                raise LowerError("non-ref in group by key")
            keys.append((x.expr.name, x.alias))
        aggs = tuple(_solve_group_output(cfg, x) for x in rel.arg_lists[1])
        return RGroupBy(child=child, inputkeys=tuple(keys), outputaggs=aggs)

    if op == "select":
        if len(rel.children) != 1 or len(rel.arg_lists) != 1:
            raise LowerError("select expects one child and one arg list")
        child = solve(cfg, rel.children[0])
        return RSelect(child=child,
                       predicate=conjunction(cfg, list(rel.arg_lists[0])))

    if op in ("join", "semijoin", "antijoin", "left outer join"):
        if len(rel.children) != 2 or len(rel.arg_lists) != 1:
            raise LowerError(f"{op} expects two children and one arg list")
        if cfg.cross_product and op == "join":
            # --use-cross-product (Mplan.hs:309-314)
            cross = RCartesianProduct(leftch=solve(cfg, rel.children[0]),
                                      rightch=solve(cfg, rel.children[1]))
            return RSelect(child=cross,
                           predicate=conjunction(cfg, list(rel.arg_lists[0])))
        variant = {"join": PLAIN, "semijoin": LEFTSEMI,
                   "antijoin": LEFTANTI, "left outer join": LEFTOUTER}[op]
        conds = tuple(rsc(cfg, x.expr) for x in rel.arg_lists[0])
        if not conds:
            raise LowerError("empty join condition list")
        return RJoin(leftch=solve(cfg, rel.children[0]),
                     rightch=solve(cfg, rel.children[1]),
                     conds=conds, joinvariant=variant)

    if op == "top N":
        if len(rel.children) != 1:
            raise LowerError("top N expects one child")
        lit = rel.arg_lists[0][0].expr
        if not (isinstance(lit, P.Literal) and lit.tspec.tname == "wrd"):
            raise LowerError("top N expects a wrd literal")
        return RTopN(child=solve(cfg, rel.children[0]), n=_read_int(lit.rep))

    raise LowerError(f"relational operator not implemented: {op!r}")


def _output_name(x: P.Expr) -> Optional[Name]:
    if x.alias is not None:
        return x.alias
    if isinstance(x.expr, P.Ref):
        return x.expr.name
    return None


def mplan_from_parse_tree(rel: P.Rel, cfg: Config) -> RelExpr:
    return solve(cfg, rel)


# -------------------------------------------------------------- plan rewrites
def _map_rel_children(f, r: RelExpr) -> RelExpr:
    import dataclasses

    if isinstance(r, (RProject, RSelect, RGroupBy, RTopN)):
        return dataclasses.replace(r, child=f(r.child))
    if isinstance(r, (RJoin, RCartesianProduct)):
        return dataclasses.replace(r, leftch=f(r.leftch), rightch=f(r.rightch))
    return r


def _rewrite(rule, r: RelExpr) -> RelExpr:
    """uniplate ``rewrite``: bottom-up, to fixpoint."""
    r = _map_rel_children(lambda c: _rewrite(rule, c), r)
    out = rule(r)
    return r if out is None else _rewrite(rule, out)


def push_fk_joins(r: RelExpr) -> RelExpr:
    """Hoist selects above plain single-condition joins (Mplan.hs:574-604).

    Dimension-side selects hoist first, then fact-side ones, so after
    ``fuse_selects`` the bottom-most predicate lands left-most."""

    def swap(n: RelExpr):
        if (isinstance(n, RJoin) and n.joinvariant == PLAIN
                and len(n.conds) == 1):
            if isinstance(n.rightch, RSelect):
                s = n.rightch
                return RSelect(child=RJoin(leftch=n.leftch, rightch=s.child,
                                           conds=n.conds,
                                           joinvariant=n.joinvariant),
                               predicate=s.predicate)
            if isinstance(n.leftch, RSelect):
                s = n.leftch
                return RSelect(child=RJoin(leftch=s.child, rightch=n.rightch,
                                           conds=n.conds,
                                           joinvariant=n.joinvariant),
                               predicate=s.predicate)
        return None

    return _rewrite(swap, r)


def fuse_selects(r: RelExpr) -> RelExpr:
    """Merge stacked selects into one AND predicate (Mplan.hs:607-620)."""

    def fuse(n: RelExpr):
        if isinstance(n, RSelect) and isinstance(n.child, RSelect):
            inner = n.child
            return RSelect(child=inner.child,
                           predicate=MBinop(LOGAND, inner.predicate,
                                            n.predicate))
        return None

    return _rewrite(fuse, r)
