"""The JAX package's CPU plan census, for the port's CPU tests and for
``chip_smoke.py``'s phase 9, which runs it on the card.

Every plan is built from the ``mplan`` module (and ``DDecimal``) given as a
parameter, so that each package builds and lowers its own tree from the
same draws.  The families:

* ``fuzz``: the 40 random group-by plans of tests/test_fuzz.py
  (``rand_plan``, over copies of its ``LI``, ``VALUE_COLS`` and
  ``KEY_COLS``);
* ``ordered``: each of them ordered by every output in random directions,
  cut by a top N for odd seeds (``ordered_rand_plan``);
* ``null``: the seven single-device plans of tests/test_null_semantics.py
  (outer joins with null-aware aggregates, comparisons, ``isnull``, extra
  ON conditions), each with its SQL (``null_sql``), which that file holds
  them against;
* ``corners``: the three plans of tests/test_join_corners.py, and a semi
  and an inner join on a non-FK pair (``corner``);
* ``semi_anti``: orders semi (anti) joined with lineitem under an extra
  condition (``extra_condition_join``);
* ``distinct``: tests/test_distinct.py's two count(DISTINCT) plan texts,
  held against a numpy distinct count (``numpy_distinct``);
* ``tpch``: tests/torch_plans.py's in-code plans (``AUTO_PLANS`` but
  ``CENSUS_SKIP``: TPC-H Q1, Q3, Q4, Q5, Q6, Q9, Q13, Q16, Q17 and Q3's top
  10, a filter-project, two group-bys, a dense-domain join, two
  count(DISTINCT) plans, Q4 over all orders, a self-join and Q13 by
  nation), the only ones here that take the FK-join path and its mask
  scatters; no plan of the JAX package's census does.

This module imports neither jax nor pytest.
"""

from __future__ import annotations

import importlib
import random

import numpy as np

import torch_plans

# ------------------------------------------------------ tests/test_fuzz.py
LI = "lineitem"
# (column, lo, hi) — value columns for predicates/arithmetic
VALUE_COLS = [
    ("l_quantity", 100, 5000),
    ("l_extendedprice", 90101, 6520000),
    ("l_discount", 0, 10),
    ("l_tax", 0, 8),
    ("l_shipdate", 727564, 729933),
    ("l_linenumber", 1, 7),
]
# low-cardinality columns usable as group keys (composite stays < 65 bits)
KEY_COLS = ["l_returnflag", "l_linestatus", "l_shipmode", "l_shipinstruct"]
FUZZ_SEEDS = range(40)


def rand_plan(M, DDecimal, rng):
    """tests/test_fuzz.py's ``_rand_plan`` over the ``mplan`` module ``M``:
    the same draws from ``rng`` give the same tree."""
    def ref(col):
        return M.MRef(name=(LI, col))

    def lit(v):
        return M.MLiteral(DDecimal(0), int(v))

    def pred():
        if rng.random() < 0.15:
            kcol = rng.choice(KEY_COLS)
            vals = sorted({rng.randint(0, 7)
                           for _ in range(rng.randint(1, 3))})
            return M.MIn(ref(kcol), tuple(lit(v) for v in vals))
        col, lo, hi = rng.choice(VALUE_COLS)
        op = rng.choice([M.LT, M.GT, M.LEQ, M.GEQ, M.EQ, M.NEQ])
        v = rng.choice([lo, hi, rng.randint(lo, hi),
                        rng.randint(lo, hi), lo - 1, hi + 1])
        p = M.MBinop(op, ref(col), lit(v))
        if rng.random() < 0.4:
            col2, lo2, hi2 = rng.choice(VALUE_COLS)
            q = M.MBinop(rng.choice([M.LT, M.GEQ]), ref(col2),
                         lit(rng.randint(lo2, hi2)))
            p = M.MBinop(rng.choice([M.LOGAND, M.LOGOR]), p, q)
        return p

    def expr(depth=0):
        r = rng.random()
        if depth < 2 and r < 0.12:
            return M.MIfThenElse(pred(), expr(depth + 1), expr(depth + 1))
        if depth < 2 and r < 0.2:
            return M.MBinop(M.DIV, expr(depth + 1), lit(rng.randint(1, 50)))
        if depth < 2 and r < 0.26:
            return M.MUnary(M.NEG, M.MBinop(
                rng.choice([M.LT, M.GEQ]),
                ref(rng.choice(VALUE_COLS)[0]),
                lit(rng.randint(0, 6000))))
        if depth >= 2 or r < 0.55:
            if rng.random() < 0.75:
                return ref(rng.choice(VALUE_COLS)[0])
            return lit(rng.randint(1, 100))
        op = rng.choice([M.ADD, M.SUB, M.MUL, M.MIN, M.MAX])
        return M.MBinop(op, expr(depth + 1), expr(depth + 1))

    cols = tuple(((LI, c), None) for c, _, _ in VALUE_COLS) + tuple(
        ((LI, c), None) for c in KEY_COLS)
    rel = M.RTable(tablename=(LI,), tablecolumns=cols)
    for _ in range(rng.randint(0, 2)):
        rel = M.RSelect(child=rel, predicate=pred())
    nkeys = rng.randint(0, 2)
    keys = tuple(((LI, k), None) for k in rng.sample(KEY_COLS, nkeys))
    aggs = []
    for i in range(rng.randint(1, 3)):
        kind = rng.random()
        if kind < 0.2:
            agg = M.GCount()
        elif kind < 0.35:
            agg = M.GAvg(expr())
        else:
            agg = M.GFold(rng.choice([M.FSUM, M.FMAX, M.FMIN]), expr())
        aggs.append((agg, ("out%d" % i,)))
    for k, _ in keys:
        aggs.append((M.GFold(M.FCHOOSE, M.MRef(name=k)), (k[-1],)))
    return M.RGroupBy(child=rel, inputkeys=keys, outputaggs=tuple(aggs))


def ordered_rand_plan(M, DDecimal, seed):
    """test_fuzz's plan of ``seed`` ordered by every output in random
    directions, cut by a top N for odd seeds."""
    rng = random.Random(seed)
    gb = rand_plan(M, DDecimal, rng)
    names = [nm for _, nm in gb.outputaggs]
    proj = M.RProject(child=gb,
                      projectout=tuple((M.MRef(nm), nm) for nm in names),
                      order=tuple((nm, rng.choice(["asc", "desc"]))
                                  for nm in names))
    if seed % 2:
        return M.RTopN(child=proj, n=rng.randint(1, 12))
    return proj


# ---------------------------------------------- tests/test_join_corners.py
def corner(M, DDecimal, which):
    """The join-corner plan ``which`` (a key of CORNERS) built with one
    package's ``mplan`` module."""
    def scan(tab, cols, aliases=None):
        aliases = aliases or {}
        return M.RTable(tablename=(tab,), tablecolumns=tuple(
            ((tab, c), aliases.get(c)) for c in cols))

    def lit(v):
        return M.MLiteral(DDecimal(0), int(v))

    def eq(a, b):
        return (M.MBinop(M.EQ, M.MRef(a), M.MRef(b)),)

    def lt(a, v):
        return M.MBinop(M.LT, M.MRef(a), lit(v))

    if which == "antijoin_dim_side":
        li = M.RSelect(child=scan("lineitem", ["l_orderkey", "l_quantity"]),
                       predicate=lt(("lineitem", "l_quantity"), 500))
        return M.RJoin(leftch=scan("orders", ["o_orderkey", "o_custkey"]),
                       rightch=li, conds=eq(("orders", "o_orderkey"),
                                            ("lineitem", "l_orderkey")),
                       joinvariant=M.LEFTANTI)
    if which == "left_outer_fk":
        od = M.RSelect(child=scan("orders", ["o_orderkey", "o_custkey"]),
                       predicate=lt(("orders", "o_custkey"), 200))
        return M.RJoin(leftch=scan("lineitem", ["l_orderkey",
                                                "l_linenumber"]),
                       rightch=od, conds=eq(("lineitem", "l_orderkey"),
                                            ("orders", "o_orderkey")),
                       joinvariant=M.LEFTOUTER)
    if which == "self_join_filtered":
        left = M.RSelect(child=scan("orders", ["o_orderkey", "o_custkey"]),
                         predicate=lt(("orders", "o_custkey"), 400))
        right = M.RSelect(
            child=scan("orders", ["o_orderkey", "o_totalprice"],
                       aliases={"o_orderkey": ("O2", "o_orderkey"),
                                "o_totalprice": ("O2", "o_totalprice")}),
            predicate=M.MBinop(M.GT, M.MRef(("O2", "o_totalprice")),
                               lit(1000)))
        return M.RJoin(leftch=left, rightch=right,
                       conds=eq(("orders", "o_orderkey"),
                                ("O2", "o_orderkey")),
                       joinvariant=M.PLAIN)
    # customers against suppliers of their nation: no FK pair, so the
    # semi and inner joins take the general equijoin
    sup = M.RSelect(child=scan("supplier", ["s_suppkey", "s_nationkey",
                                            "s_acctbal"]),
                    predicate=lt(("supplier", "s_acctbal"), 100000))
    return M.RJoin(leftch=scan("customer", ["c_custkey", "c_nationkey"]),
                   rightch=sup, conds=eq(("customer", "c_nationkey"),
                                         ("supplier", "s_nationkey")),
                   joinvariant={"semi_nonfk": M.LEFTSEMI,
                                "inner_nonfk": M.PLAIN}[which])


# each corner plan and the join sides the port's engine evaluates for it
CORNERS = {"antijoin_dim_side": {"anti"},
           "left_outer_fk": {"outer_left", "outer_right", "outer_valid"},
           "self_join_filtered": {"left", "right"},
           "semi_nonfk": {"semi"},
           "inner_nonfk": {"left", "right"}}


# --------------------------------------------- tests/test_null_semantics.py
NULL_PLANS = ("min_max_sum_avg_count", "mixed_groups", "arithmetic_agg",
              "comparison", "isnull", "outer_extra_condition",
              "outer_extra_condition_aggs")


def null_plan(M, DDecimal, which, tp):
    """The single-device plan of tests/test_null_semantics.py that
    ``which`` names, over ``M``; ``tp`` is o_totalprice (the comparison
    and extra-condition plans take a percentile of it)."""
    def scan(tab, cols):
        return M.RTable(tablename=(tab,),
                        tablecolumns=tuple(((tab, c), None) for c in cols))

    def lit(v):
        return M.MLiteral(DDecimal(0), int(v))

    def ref(n):
        return M.MRef((n,))

    def outer(conds):
        return M.RJoin(leftch=scan("customer", ["c_custkey"]),
                       rightch=scan("orders", ["o_orderkey", "o_custkey",
                                               "o_totalprice"]),
                       conds=conds, joinvariant=M.LEFTOUTER)

    eq = M.MBinop(M.EQ, ref("c_custkey"), ref("o_custkey"))
    by_cust = ((("c_custkey",), None),)
    k = (M.GFold(M.FCHOOSE, ref("c_custkey")), ("k",))
    if which == "min_max_sum_avg_count":
        return M.RGroupBy(child=outer((eq,)), inputkeys=by_cust, outputaggs=(
            k, (M.GFold(M.FMIN, ref("o_totalprice")), ("mn",)),
            (M.GFold(M.FMAX, ref("o_totalprice")), ("mx",)),
            (M.GFold(M.FSUM, ref("o_totalprice")), ("sm",)),
            (M.GAvg(ref("o_totalprice")), ("av",)),
            (M.GCount(col=("o_totalprice",)), ("cn",)),
            (M.GCount(), ("call",))))
    if which == "mixed_groups":
        proj = M.RProject(child=outer((eq,)), projectout=(
            (M.MBinop(M.MOD, ref("c_custkey"), lit(7)), ("g",)),
            (ref("o_totalprice"), ("tp",)), (ref("o_orderkey"), ("ok",))))
        return M.RGroupBy(child=proj, inputkeys=((("g",), None),),
                          outputaggs=(
                              (M.GFold(M.FCHOOSE, ref("g")), ("k",)),
                              (M.GFold(M.FMIN, ref("tp")), ("mn",)),
                              (M.GFold(M.FMAX, ref("tp")), ("mx",)),
                              (M.GAvg(ref("tp")), ("av",)),
                              (M.GCount(col=("ok",)), ("cn",))))
    if which == "arithmetic_agg":
        e = M.MBinop(M.ADD, M.MBinop(M.MUL, ref("o_totalprice"), lit(2)),
                     lit(5))
        return M.RGroupBy(child=outer((eq,)), inputkeys=by_cust, outputaggs=(
            k, (M.GFold(M.FSUM, e), ("sm",)), (M.GAvg(e), ("av",))))
    if which == "comparison":
        sel = M.RSelect(child=outer((eq,)), predicate=M.MBinop(
            M.LT, ref("o_totalprice"), lit(int(np.percentile(tp, 60)))))
        return M.RProject(child=sel, projectout=(
            (ref("c_custkey"), ("ck",)), (ref("o_orderkey"), ("ok",))))
    if which == "isnull":
        return M.RProject(child=outer((eq,)), projectout=(
            (ref("c_custkey"), ("ck",)),
            (M.MUnary(M.ISNULL, ref("o_orderkey")), ("isn",))))
    join = outer((eq, M.MBinop(M.GT, ref("o_totalprice"),
                               lit(int(np.percentile(tp, 75))))))
    if which == "outer_extra_condition":
        return M.RProject(child=join, projectout=(
            (ref("c_custkey"), ("ck",)), (ref("o_orderkey"), ("ok",)),
            (ref("o_totalprice"), ("tp",))))
    assert which == "outer_extra_condition_aggs"
    return M.RGroupBy(child=join, inputkeys=by_cust, outputaggs=(
        k, (M.GFold(M.FMIN, ref("o_totalprice")), ("mn",)),
        (M.GCount(col=("o_orderkey",)), ("cn",))))


def null_sql(which, tp) -> str:
    """The SQL that tests/test_null_semantics.py holds the plan
    ``which`` against, over ``null_db``'s tables."""
    avg = ("CASE WHEN COUNT({c}) = 0 THEN 0 "
           "ELSE SUM({e}) / COUNT({c}) END")
    join = "FROM customer c LEFT JOIN orders o ON c.c_custkey = o.o_custkey"
    x60, x75 = int(np.percentile(tp, 60)), int(np.percentile(tp, 75))
    extra = ("FROM customer c LEFT JOIN orders o "
             f"ON c.c_custkey = o.o_custkey AND o_totalprice > {x75}")
    return {
        "min_max_sum_avg_count": (
            "SELECT c.c_custkey, MIN(o_totalprice), MAX(o_totalprice), "
            "SUM(o_totalprice), "
            + avg.format(c="o_totalprice", e="o_totalprice")
            + f", COUNT(o_totalprice), COUNT(*) {join} GROUP BY c.c_custkey"),
        "mixed_groups": (
            "SELECT c.c_custkey % 7, MIN(o_totalprice), MAX(o_totalprice), "
            + avg.format(c="o_totalprice", e="o_totalprice")
            + f", COUNT(o_orderkey) {join} GROUP BY 1"),
        "arithmetic_agg": (
            "SELECT c.c_custkey, SUM(o_totalprice * 2 + 5), "
            + avg.format(c="o_totalprice", e="o_totalprice * 2 + 5")
            + f" {join} GROUP BY c.c_custkey"),
        "comparison": (f"SELECT c.c_custkey, o_orderkey {join} "
                       f"WHERE o_totalprice < {x60}"),
        "isnull": ("SELECT c.c_custkey, CASE WHEN o_orderkey IS NULL "
                   f"THEN 1 ELSE 0 END {join}"),
        "outer_extra_condition": (
            f"SELECT c.c_custkey, o_orderkey, o_totalprice {extra}"),
        "outer_extra_condition_aggs": (
            "SELECT c.c_custkey, MIN(o_totalprice), COUNT(o_orderkey) "
            f"{extra} GROUP BY c.c_custkey"),
    }[which]


def null_db(store):
    """An in-memory SQLite database of the null plans' columns, as
    tests/test_null_semantics.py builds it."""
    import sqlite3

    db = sqlite3.connect(":memory:")
    for tab, cols in (("customer", ["c_custkey"]),
                      ("orders", ["o_orderkey", "o_custkey",
                                  "o_totalprice"])):
        arrs = [np.asarray(store.columns[(tab, c)], np.int64).tolist()
                for c in cols]
        db.execute(f"CREATE TABLE {tab} "
                   f"({', '.join(c + ' INTEGER' for c in cols)})")
        db.executemany(
            f"INSERT INTO {tab} VALUES ({','.join('?' * len(cols))})",
            zip(*arrs))
    db.execute("CREATE INDEX orders_cust ON orders (o_custkey)")
    db.commit()
    return db


def sql_rows(db, q):
    """The query's rows as a sorted list, SQL NULL read as 0."""
    return sorted(tuple(0 if v is None else int(v) for v in r)
                  for r in db.execute(q))


# ------------------------- semi and anti joins with an extra ON condition
SEMI_ANTI = ("LEFTSEMI", "LEFTANTI")


def extra_condition_join(M, DDecimal, variant):
    """orders semi (anti) joined with lineitem on the order key, under the
    extra condition l_quantity > 45 (two decimal digits)."""
    def scan(tab, cols):
        return M.RTable(tablename=(tab,),
                        tablecolumns=tuple(((tab, c), None) for c in cols))

    conds = (M.MBinop(M.EQ, M.MRef(("orders", "o_orderkey")),
                      M.MRef(("lineitem", "l_orderkey"))),
             M.MBinop(M.GT, M.MRef(("lineitem", "l_quantity")),
                      M.MLiteral(DDecimal(0), 4500)))
    return M.RJoin(leftch=scan("orders", ["o_orderkey", "o_custkey"]),
                   rightch=scan("lineitem", ["l_orderkey", "l_quantity"]),
                   conds=conds, joinvariant=variant)


# ---------------------------------------------------- tests/test_distinct.py
# group by l_linestatus (dense domain) / l_orderkey (sparse domain),
# counting distinct suppliers and parts per group
PLAN_DENSE = """project (
| group by (
| | table(sys.lineitem) [ lineitem.l_linestatus NOT NULL,
| |   lineitem.l_suppkey NOT NULL, lineitem.l_quantity NOT NULL ] COUNT
| ) [ lineitem.l_linestatus ] [ lineitem.l_linestatus,
|   sys.count unique no nil (lineitem.l_suppkey) NOT NULL as L1.L1,
|   sys.count no nil (lineitem.l_quantity) NOT NULL as L2.L2 ]
) [ lineitem.l_linestatus, L1 NOT NULL, L2 NOT NULL ]
"""

PLAN_SPARSE = """project (
| group by (
| | table(sys.lineitem) [ lineitem.l_orderkey NOT NULL,
| |   lineitem.l_suppkey NOT NULL ] COUNT
| ) [ lineitem.l_orderkey ] [ lineitem.l_orderkey,
|   sys.count unique no nil (lineitem.l_suppkey) NOT NULL as L1.L1 ]
) [ lineitem.l_orderkey, L1 NOT NULL ]
"""
# each distinct plan: its text and its group key (the counted values are
# l_suppkey's)
DISTINCT = {"dense": (PLAN_DENSE, "l_linestatus"),
            "sparse": (PLAN_SPARSE, "l_orderkey")}


def _code_plans():
    """The in-code plans of tests/torch_plans.py by name, but those the
    census leaves out (``torch_plans.CENSUS_SKIP``)."""
    return {k: v for k, v in torch_plans.AUTO_PLANS.items()
            if k not in torch_plans.CENSUS_SKIP}


def text_mplan(pkg, text, cfg):
    """A plan text's mplan tree through package ``pkg``'s own front end,
    as tests/test_distinct.py builds it."""
    name = pkg.__name__
    mplan = importlib.import_module(name + ".mplan")
    lexer = importlib.import_module(name + ".fe.lexer")
    plan_parser = importlib.import_module(name + ".fe.plan_parser")
    rel = plan_parser.parse(lexer.strip_plan_comments(text))
    return mplan.fuse_selects(mplan.push_fk_joins(
        mplan.mplan_from_parse_tree(rel, cfg)))


def numpy_distinct(store, keycol, valcol):
    """{group key: count of distinct values} over lineitem, as
    tests/test_distinct.py counts it."""
    k = np.asarray(store.columns[("lineitem", keycol)], np.int64)
    v = np.asarray(store.columns[("lineitem", valcol)], np.int64)
    pairs = np.unique(np.stack([k, v], axis=1), axis=0)
    keys, counts = np.unique(pairs[:, 0], return_counts=True)
    return dict(zip(keys.tolist(), counts.tolist()))


# --------------------------------------------------------------- the census
FAMILIES = ("fuzz", "ordered", "null", "corners", "semi_anti", "distinct",
            "tpch")


def case_names():
    """(family, name) of every census plan, in the census's order."""
    return ([("fuzz", f"fuzz{s}") for s in FUZZ_SEEDS]
            + [("ordered", f"ordered{s}") for s in FUZZ_SEEDS]
            + [("null", w) for w in NULL_PLANS]
            + [("corners", w) for w in CORNERS]
            + [("semi_anti", v) for v in SEMI_ANTI]
            + [("distinct", w) for w in DISTINCT]
            + [("tpch", w) for w in _code_plans()])


def build(pkg, family, name, store, cfg):
    """The census plan ``name`` of ``family``, built with package ``pkg``'s
    own modules (``mplan2vdl_tpu`` or ``mplan2vdl_tpu_torch``) over
    ``store``."""
    M = importlib.import_module(pkg.__name__ + ".mplan")
    DD = importlib.import_module(pkg.__name__ + ".mtypes").DDecimal
    if family == "fuzz":
        return rand_plan(M, DD, random.Random(int(name[len("fuzz"):])))
    if family == "ordered":
        return ordered_rand_plan(M, DD, int(name[len("ordered"):]))
    if family == "null":
        tp = np.asarray(store.columns[("orders", "o_totalprice")])
        return null_plan(M, DD, name, tp)
    if family == "corners":
        return corner(M, DD, name)
    if family == "semi_anti":
        return extra_condition_join(M, DD, getattr(M, name))
    if family == "distinct":
        return text_mplan(pkg, DISTINCT[name][0], cfg)
    assert family == "tpch", family
    return text_mplan(pkg, _code_plans()[name], cfg)


def int_columns(cols):
    """Columns as int64 arrays."""
    return [np.asarray(c, np.int64) for c in cols]


def rows(cols):
    """The rows of equal-length columns as a sorted list of int tuples."""
    return sorted(zip(*[np.asarray(c, np.int64).tolist() for c in cols])
                  ) if len(cols) else []


# ------------------------------------------- the oracle, in worker processes
# the store the oracle reads in a worker process: (store, catalog)
_oracle_store = None


def oracle_worker_init(sf, seed) -> None:
    """A worker process's store: generated from the seed, as the caller's
    (each worker holds its own copy)."""
    global _oracle_store
    from mplan2vdl_tpu_torch.engine import datagen

    store = datagen.generate(sf=sf, seed=seed)
    _oracle_store = (store, store.make_catalog())


def oracle_columns(family, name):
    """The port's relational oracle on one census plan over the worker's
    store: (its columns as int64 arrays, the oracle's seconds)."""
    import time

    import mplan2vdl_tpu_torch
    from mplan2vdl_tpu_torch.oracle import relinterp

    store, cfg = _oracle_store
    plan = build(mplan2vdl_tpu_torch, family, name, store, cfg)
    t0 = time.perf_counter()
    frame = relinterp.run_oracle(store, plan)
    return int_columns([a for _, a in frame.cols]), time.perf_counter() - t0
