"""Plans and rank bodies of the port's plan-distributor tests
(``test_torch_auto.py``, ``test_torch_auto_dist.py``,
``test_torch_fuzz_dist.py``).

The plans are built from the ``mplan`` module given as a parameter, so that
each package builds and lowers its own tree from the same draws: the random
self-join and nested group-by plans of ``tests/test_fuzz_dist.py``, its
hot-key self-join, the two count(DISTINCT) plans of
``tests/test_distinct.py`` and the two ``auto.distribute`` plans of
``tests/test_null_semantics.py``; besides, a self-join under a sparse
group-by, and the small store's plans (``SMALL_CASES``), run over more
ranks than its tables have rows.  The rank bodies run
``parallel/auto.distribute`` over a world of gloo ranks
(``torch_dist_cases.Ranks``) and keep, per case, the rows, the
``describe()`` text or the ``NotDistributable`` text, and the
single-device port's rows.  This module imports no jax.
"""

from __future__ import annotations

import os
import random

import numpy as np

import torch_plans

# the in-code plans of chip_smoke.py's phase 8 (torch_plans.AUTO_PLANS)
# over this store; TPC-H Q17 also over a store where its part filter keeps
# parts (at CLI_SF it keeps none, and the plan's one fold has no group)
CLI_SF, CLI_SEED = 0.002, 1
Q17_SF = 0.01

LI = "lineitem"
VALUE_COLS = [
    ("l_quantity", 100, 5000),
    ("l_extendedprice", 90101, 6520000),
    ("l_discount", 0, 10),
    ("l_shipdate", 727564, 729933),
]
KEY_COLS = ["l_returnflag", "l_linestatus", "l_shipmode"]
JOIN_COLS = ["l_orderkey", "l_partkey", "l_suppkey"]

N_JOIN_SEEDS, N_NESTED_SEEDS = 16, 8
FUZZ_CASES = ([f"join{s}" for s in range(N_JOIN_SEEDS)]
              + [f"nested{s}" for s in range(N_NESTED_SEEDS)]
              + ["hot_key", "sparse_join", "distinct_dense",
                 "distinct_sparse", "null_aggs", "null_outer_extra"])
# a world with more ranks than the small store's tables have rows
SMALL_WORLD = 8
# over the small store (15 customers, 10 suppliers, 25 nations): nation
# joined with supplier (the fact's last rank and the partitioned supplier's
# last three ranks hold empty windows), TPC-H Q13 (the customer fact's last
# rank holds one row), and two self-joins that partition
SMALL_CASES = ["small_outer", "small_plain", "small_rowset", "small_q13",
               "small_join2", "small_hot"]
# the key columns whose upper bound grows with the scale factor, each with
# the generator's row count of the table it numbers at scale sf
# (datagen.generate: keys 1..count)
KEY_COUNTS = {"orders": lambda sf: max(int(1_500_000 * sf), 150),
              "part": lambda sf: max(int(200_000 * sf), 20),
              "supplier": lambda sf: max(int(10_000 * sf), 10),
              "customer": lambda sf: max(int(150_000 * sf), 15)}
KEY_COLUMNS = {("lineitem", "l_orderkey"): "orders",
               ("orders", "o_orderkey"): "orders",
               ("lineitem", "l_partkey"): "part",
               ("part", "p_partkey"): "part",
               ("partsupp", "ps_partkey"): "part",
               ("lineitem", "l_suppkey"): "supplier",
               ("supplier", "s_suppkey"): "supplier",
               ("partsupp", "ps_suppkey"): "supplier",
               ("orders", "o_custkey"): "customer",
               ("customer", "c_custkey"): "customer"}


def widen_keys(cfg, sf: float):
    """``cfg`` (either package's catalog) with the bounds of every key
    column of KEY_COLUMNS set to its range at scale ``sf``, so that a plan
    lowers with the key widths of that scale over a small store: the
    distributor's analysis decides from those widths."""
    import dataclasses

    for col, table in KEY_COLUMNS.items():
        _, info = cfg.colinfo.lookup(col)
        cfg.colinfo.insert_weak(col, dataclasses.replace(
            info, bounds=(1, KEY_COUNTS[table](sf))))
    return cfg


# (sf, seed) of each case's store, as the JAX tests generate them
STORES = {"fuzz": (0.002, 2), "hot_key": (0.002, 4), "distinct": (0.02, 11),
          "null": (0.01, 7), "small": (0.00001, 1)}


def store_of(case: str) -> str:
    if case.startswith(("join", "nested")) or case == "sparse_join":
        return "fuzz"
    return "hot_key" if case == "hot_key" else case.split("_")[0]


def make_store(datagen, which: str):
    """The store of ``which`` (a key of STORES) from a package's
    ``datagen``; the hot-key store rewrites half of l_suppkey to one
    supplier, as tests/test_fuzz_dist.py does."""
    sf, seed = STORES[which]
    store = datagen.generate(sf=sf, seed=seed)
    if which == "hot_key":
        rng = np.random.default_rng(99)
        sk = np.asarray(store.columns[(LI, "l_suppkey")]).copy()
        sk[rng.random(len(sk)) < 0.5] = int(sk[0])
        store.add(LI, "l_suppkey", sk)
    return store


# -------------------------------------------------- tests/test_fuzz_dist.py
def _lit(M, DDecimal, v):
    return M.MLiteral(DDecimal(0), int(v))


def _pred(M, DDecimal, rng, side):
    col, lo, hi = rng.choice(VALUE_COLS)
    op = rng.choice([M.LT, M.GT, M.LEQ, M.GEQ])
    v = rng.randint(lo, hi)
    return M.MBinop(op, M.MRef(name=side(col)), _lit(M, DDecimal, v))


def rand_join_plan(M, DDecimal, rng):
    """``tests/test_fuzz_dist.py``'s ``_rand_join_plan`` over ``M``."""
    left_cols = tuple(((LI, c), None) for c, _, _ in VALUE_COLS) \
        + tuple(((LI, c), None) for c in KEY_COLS) \
        + tuple(((LI, c), None) for c in JOIN_COLS)
    right_cols = tuple(((LI, c), ("R9", "r_" + c))
                       for c, _, _ in VALUE_COLS) \
        + tuple(((LI, c), ("R9", "r_" + c)) for c in JOIN_COLS)

    lhs = M.RTable(tablename=(LI,), tablecolumns=left_cols)
    for _ in range(rng.randint(0, 2)):
        lhs = M.RSelect(child=lhs, predicate=_pred(
            M, DDecimal, rng, lambda c: (LI, c)))
    rhs = M.RTable(tablename=(LI,), tablecolumns=right_cols)
    for _ in range(rng.randint(1, 2)):  # filtered build side
        rhs = M.RSelect(child=rhs, predicate=_pred(
            M, DDecimal, rng, lambda c: ("R9", "r_" + c)))

    jcol = rng.choice(JOIN_COLS)
    variant = rng.choice([M.PLAIN, M.PLAIN, M.LEFTSEMI, M.LEFTANTI,
                          M.LEFTOUTER])
    cond = M.MBinop(M.EQ, M.MRef(name=(LI, jcol)),
                    M.MRef(name=("R9", "r_" + jcol)))
    rel = M.RJoin(leftch=lhs, rightch=rhs, conds=(cond,),
                  joinvariant=variant)

    nkeys = rng.randint(1, 2)
    keys = tuple(((LI, k), None) for k in rng.sample(KEY_COLS, nkeys))
    aggs = [(M.GCount(), ("cnt",))]
    for i in range(rng.randint(1, 2)):
        col = rng.choice(VALUE_COLS)[0]
        aggs.append((M.GFold(rng.choice([M.FSUM, M.FMAX, M.FMIN]),
                             M.MRef(name=(LI, col))), (f"l{i}",)))
    if variant == M.PLAIN:  # right-side values ride the exchange payload
        for i in range(rng.randint(0, 2)):
            col = rng.choice(VALUE_COLS)[0]
            aggs.append((M.GFold(rng.choice([M.FSUM, M.FMIN]),
                                 M.MRef(name=("R9", "r_" + col))),
                         (f"r{i}",)))
    for k, _ in keys:
        aggs.append((M.GFold(M.FCHOOSE, M.MRef(name=k)), (k[-1],)))
    return M.RGroupBy(child=rel, inputkeys=keys, outputaggs=tuple(aggs))


def rand_nested_plan(M, DDecimal, rng):
    """``tests/test_fuzz_dist.py``'s ``_rand_nested_plan`` over ``M``."""
    cols = tuple(((LI, c), None) for c, _, _ in VALUE_COLS) + tuple(
        ((LI, c), None) for c in KEY_COLS)
    rel = M.RTable(tablename=(LI,), tablecolumns=cols)
    for _ in range(rng.randint(0, 2)):
        rel = M.RSelect(child=rel, predicate=_pred(
            M, DDecimal, rng, lambda c: (LI, c)))
    k1, k2 = rng.sample(KEY_COLS, 2)
    inner_aggs = [
        (M.GFold(rng.choice([M.FSUM, M.FMAX, M.FMIN]),
                 M.MRef(name=(LI, rng.choice(VALUE_COLS)[0]))), ("a0",)),
        (M.GCount(), ("a1",)),
        (M.GFold(M.FCHOOSE, M.MRef(name=(LI, k1))), (k1,)),
        (M.GFold(M.FCHOOSE, M.MRef(name=(LI, k2))), (k2,)),
    ]
    inner = M.RGroupBy(child=rel,
                       inputkeys=(((LI, k1), None), ((LI, k2), None)),
                       outputaggs=tuple(inner_aggs))
    outer_aggs = [
        (M.GFold(rng.choice([M.FSUM, M.FMAX, M.FMIN]),
                 M.MRef(name=("a0",))), ("s0",)),
        (M.GFold(M.FSUM, M.MRef(name=("a1",))), ("s1",)),
        (M.GFold(M.FCHOOSE, M.MRef(name=(k1,))), (k1,)),
    ]
    return M.RGroupBy(child=inner, inputkeys=(((k1,), None),),
                      outputaggs=tuple(outer_aggs))


def hot_key_plan(M, DDecimal):
    """The self-equijoin on l_suppkey of ``test_hot_key_join_three_way``."""
    left_cols = (((LI, "l_suppkey"), None), ((LI, "l_quantity"), None),
                 ((LI, "l_returnflag"), None))
    right_cols = (((LI, "l_suppkey"), ("R9", "r_suppkey")),
                  ((LI, "l_extendedprice"), ("R9", "r_price")))
    rhs = M.RSelect(
        child=M.RTable(tablename=(LI,), tablecolumns=right_cols),
        predicate=M.MBinop(M.LT, M.MRef(name=("R9", "r_price")),
                           _lit(M, DDecimal, 200000)))
    rel = M.RJoin(
        leftch=M.RTable(tablename=(LI,), tablecolumns=left_cols),
        rightch=rhs,
        conds=(M.MBinop(M.EQ, M.MRef(name=(LI, "l_suppkey")),
                        M.MRef(name=("R9", "r_suppkey"))),),
        joinvariant=M.PLAIN)
    aggs = ((M.GCount(), ("cnt",)),
            (M.GFold(M.FSUM, M.MRef(name=("R9", "r_price"))), ("sp",)),
            (M.GFold(M.FCHOOSE, M.MRef(name=(LI, "l_returnflag"))),
             ("l_returnflag",)))
    return M.RGroupBy(child=rel, inputkeys=(((LI, "l_returnflag"), None),),
                      outputaggs=aggs)


def sparse_join_plan(M, DDecimal):
    """A self-equijoin on l_orderkey grouped by (l_orderkey, l_shipdate), a
    sparse domain: the join feeds the shuffle aggregation's exchange."""
    left_cols = (((LI, "l_orderkey"), None), ((LI, "l_shipdate"), None))
    right_cols = (((LI, "l_orderkey"), ("R9", "r_orderkey")),
                  ((LI, "l_extendedprice"), ("R9", "r_price")))
    rhs = M.RSelect(
        child=M.RTable(tablename=(LI,), tablecolumns=right_cols),
        predicate=M.MBinop(M.LT, M.MRef(name=("R9", "r_price")),
                           _lit(M, DDecimal, 2000000)))
    rel = M.RJoin(
        leftch=M.RTable(tablename=(LI,), tablecolumns=left_cols),
        rightch=rhs,
        conds=(M.MBinop(M.EQ, M.MRef(name=(LI, "l_orderkey")),
                        M.MRef(name=("R9", "r_orderkey"))),),
        joinvariant=M.PLAIN)
    keys = (((LI, "l_orderkey"), None), ((LI, "l_shipdate"), None))
    aggs = ((M.GCount(), ("cnt",)),
            (M.GFold(M.FSUM, M.MRef(name=("R9", "r_price"))), ("sp",)),
            (M.GFold(M.FCHOOSE, M.MRef(name=(LI, "l_orderkey"))),
             ("l_orderkey",)),
            (M.GFold(M.FCHOOSE, M.MRef(name=(LI, "l_shipdate"))),
             ("l_shipdate",)))
    return M.RGroupBy(child=rel, inputkeys=keys, outputaggs=aggs)


def _scan(M, tab, cols):
    return M.RTable(tablename=(tab,),
                    tablecolumns=tuple(((tab, c), None) for c in cols))


def small_plan(M, which):
    """nation joined with supplier on the nation key: outer and grouped by
    nation (``small_outer``), plain and grouped by region
    (``small_plain``), or outer and projected (``small_rowset``)."""
    def ref(n):
        return M.MRef((n,))

    outer = which != "small_plain"
    join = M.RJoin(
        leftch=_scan(M, "nation", ["n_nationkey", "n_regionkey"]),
        rightch=_scan(M, "supplier", ["s_suppkey", "s_nationkey",
                                      "s_acctbal"]),
        conds=(M.MBinop(M.EQ, ref("n_nationkey"), ref("s_nationkey")),),
        joinvariant=M.LEFTOUTER if outer else M.PLAIN)
    if which == "small_rowset":
        return M.RProject(child=join, projectout=(
            (ref("n_nationkey"), ("nk",)), (ref("s_suppkey"), ("sk",))))
    key = "n_nationkey" if outer else "n_regionkey"
    return M.RGroupBy(child=join, inputkeys=(((key,), None),), outputaggs=(
        (M.GFold(M.FCHOOSE, ref(key)), ("k",)),
        (M.GCount(col=("s_suppkey",)), ("cnt",)),
        (M.GFold(M.FMIN, ref("s_acctbal")), ("mn",)),
        (M.GFold(M.FSUM, ref("s_acctbal")), ("sm",))))


# --------------------------------------------- tests/test_null_semantics.py
def null_plan(M, DDecimal, which, tp):
    """``test_null_aggs_distribute``'s plan (``null_aggs``) or
    ``test_outer_extra_condition_distributes``'s (``null_outer_extra``:
    ``tp`` is o_totalprice, whose 75th percentile the ON condition
    takes)."""
    def scan(tab, cols):
        return M.RTable(tablename=(tab,),
                        tablecolumns=tuple(((tab, c), None) for c in cols))

    def ref(n):
        return M.MRef((n,))

    def outer(conds):
        return M.RJoin(leftch=scan("customer", ["c_custkey"]),
                       rightch=scan("orders", ["o_orderkey", "o_custkey",
                                               "o_totalprice"]),
                       conds=conds, joinvariant=M.LEFTOUTER)

    eq = M.MBinop(M.EQ, ref("c_custkey"), ref("o_custkey"))
    if which == "null_aggs":
        return M.RGroupBy(
            child=outer((eq,)), inputkeys=(((("c_custkey",)), None),),
            outputaggs=(
                (M.GFold(M.FCHOOSE, ref("c_custkey")), ("k",)),
                (M.GFold(M.FMIN, ref("o_totalprice")), ("mn",)),
                (M.GAvg(ref("o_totalprice")), ("av",)),
                (M.GCount(col=("o_orderkey",)), ("cn",))))
    assert which == "null_outer_extra"
    x = int(np.percentile(tp, 75))
    join = outer((eq, M.MBinop(M.GT, ref("o_totalprice"),
                               _lit(M, DDecimal, x))))
    return M.RProject(child=join, projectout=(
        (ref("c_custkey"), ("ck",)), (ref("o_orderkey"), ("ok",))))


def distinct_text(case: str) -> str:
    """``tests/test_distinct.py``'s PLAN_DENSE or PLAN_SPARSE."""
    import test_distinct

    return (test_distinct.PLAN_DENSE if case == "distinct_dense"
            else test_distinct.PLAN_SPARSE)


def case_vexps(pkg, case: str, store, cfg):
    """The engine VIR of fuzz case ``case`` built with package ``pkg``'s
    own modules (``pkg`` is ``mplan2vdl_tpu`` or ``mplan2vdl_tpu_torch``),
    and the mplan tree it came from (None for a plan text)."""
    import importlib

    M = importlib.import_module(pkg.__name__ + ".mplan")
    passes = importlib.import_module(pkg.__name__ + ".passes")
    vir = importlib.import_module(pkg.__name__ + ".vir")
    DDecimal = importlib.import_module(pkg.__name__ + ".mtypes").DDecimal
    plan_to_vexps = importlib.import_module(
        pkg.__name__ + ".engine.lower").plan_to_vexps
    if case.startswith("distinct"):
        from_text = importlib.import_module(pkg.__name__ + ".fe.plan_parser")
        lexer = importlib.import_module(pkg.__name__ + ".fe.lexer")
        rel = from_text.parse(lexer.strip_plan_comments(distinct_text(case)))
        m = M.fuse_selects(M.push_fk_joins(M.mplan_from_parse_tree(rel,
                                                                   cfg)))
        return passes.engine_passes(vir.vexps_from_mplan(m, cfg)), None
    if case == "small_q13":
        return plan_to_vexps(torch_plans.PLAN_Q13, cfg), None
    if case.startswith("small_join"):
        m = rand_join_plan(M, DDecimal, random.Random(1000 + int(case[10:])))
    elif case == "small_hot":
        m = hot_key_plan(M, DDecimal)
    elif case.startswith("small"):
        m = small_plan(M, case)
    elif case == "sparse_join":
        m = sparse_join_plan(M, DDecimal)
    elif case.startswith("join"):
        m = rand_join_plan(M, DDecimal, random.Random(1000 + int(case[4:])))
    elif case.startswith("nested"):
        m = rand_nested_plan(M, DDecimal,
                             random.Random(5000 + int(case[6:])))
    elif case == "hot_key":
        m = hot_key_plan(M, DDecimal)
    else:
        tp = np.asarray(store.columns[("orders", "o_totalprice")])
        m = null_plan(M, DDecimal, case, tp)
    return passes.engine_passes(vir.vexps_from_mplan(m, cfg)), m


def canon_map(vexps, children) -> dict:
    """skey -> the node's place in a post-order walk of ``vexps``: the
    same number for the same node in either package, whatever interning
    came before in the process (``children`` is the package's
    ``engine.lower._children``)."""
    out = {}

    def go(v):
        if v.skey in out:
            return
        out[v.skey] = None
        for c in children(v.vx):
            go(c)
        out[v.skey] = len(out)

    for v in vexps:
        go(v)
    return out


def canon_describe(dq, children) -> str:
    """``dq.describe()`` with each partitioned join's (lkeys, rkeys) skeys
    given as ``canon_map`` places."""
    idx = canon_map(dq.vexps, children)
    text = dq.describe()
    for a, b in dq.part_joins:
        text = text.replace(f"partitioned shuffle join {(a, b)}:",
                            f"partitioned shuffle join {(idx[a], idx[b])}:")
    return text


# ---------------------------------------------------------------- rank side
def _names(cols) -> str:
    return ",".join(".".join(nm) for nm in cols)


def heavy_plan(part_joins) -> str:
    """The heavy-key round's outcome of each partitioned join of a
    distributed plan (either package's ``part_joins``): the sentinel-padded
    heavy keys, their build counts and the two exact capacities, or
    ``none``; joins separated by ``|``."""
    out = []
    for pj in part_joins.values():
        h = pj["caps"]["heavy"]
        out.append("none" if not h else (
            "hk=" + ",".join(str(int(k)) for k in np.asarray(h["hk"]))
            + " rcnt=" + ",".join(str(int(k)) for k in np.asarray(h["rcnt"]))
            + f" cap_hb={int(h['cap_hb'])} cap_hp={int(h['cap_hp'])}"))
    return "|".join(out)


def _distributed(mesh, cfg, store, vexps):
    """{"nd": NotDistributable text or "", "describe": ``canon_describe``,
    "c{i}": rows, "s{i}": the single-device port's rows, "part_joins": how
    many partitioned joins, "heavy": how many of them found heavy keys,
    "heavy_plan": ``heavy_plan``, "part_tables", "part_outer",
    "dim_loads", "part_loads", "extra_full": the partitioned joins' right
    tables (``fact`` for the fact frame) and outer flags, and the column
    lists of the distribution plan}."""
    from mplan2vdl_tpu_torch.engine.lower import CompiledQuery, _children
    from mplan2vdl_tpu_torch.parallel import auto

    single = CompiledQuery(cfg, vexps, store, device="cpu")()
    out = {f"s{i}": c for i, c in enumerate(single.columns)}
    out["ncols"] = len(single.columns)
    try:
        dq = auto.distribute(cfg, store, vexps, mesh)
    except auto.NotDistributable as e:
        out.update(nd=str(e), describe="")
        return out
    out.update(nd="", describe=canon_describe(dq, _children),
               part_joins=len(dq.part_joins),
               heavy=sum(bool(pj["caps"]["heavy"])
                         for pj in dq.part_joins.values()),
               heavy_plan=heavy_plan(dq.part_joins),
               part_tables=",".join(pj["table"] or "fact"
                                    for pj in dq.part_joins.values()),
               part_outer=",".join(str(pj["outer"])
                                   for pj in dq.part_joins.values()),
               dim_loads=_names(dq.dim_loads),
               part_loads=_names(dq.part_loads),
               extra_full=_names(dq.extra_full))
    for i, (_, _, col) in enumerate(dq()):
        out[f"c{i}"] = col
    return out


def cli_suite():
    from mplan2vdl_tpu_torch.engine import datagen
    from mplan2vdl_tpu_torch.engine.lower import plan_to_vexps

    st = datagen.generate(sf=CLI_SF, seed=CLI_SEED)
    cfg = st.make_catalog()
    cases = {f"cli_{name}": (lambda text: lambda m: _distributed(
        m, cfg, st, plan_to_vexps(text, cfg)))(text)
        for name, text in torch_plans.AUTO_PLANS.items()}

    def q17(mesh):
        st17 = datagen.generate(sf=Q17_SF, seed=CLI_SEED)
        cfg17 = st17.make_catalog()
        return _distributed(mesh, cfg17, st17,
                            plan_to_vexps(torch_plans.PLAN_Q17, cfg17))

    cases["q17_rows"] = q17

    def no_part_join(text):
        def run(mesh):
            os.environ["MPLAN2VDL_NO_PART_JOIN"] = "1"
            try:
                return _distributed(mesh, cfg, st, plan_to_vexps(text, cfg))
            finally:
                del os.environ["MPLAN2VDL_NO_PART_JOIN"]
        return run

    cases["nopart_q13"] = no_part_join(torch_plans.PLAN_Q13)
    cases["nopart_self_join"] = no_part_join(torch_plans.PLAN_SELF_JOIN)
    return cases


def fuzz_suite():
    import mplan2vdl_tpu_torch
    from mplan2vdl_tpu_torch.engine import datagen

    stores = {}

    def run(mesh, case):
        which = store_of(case)
        if which not in stores:
            st = make_store(datagen, which)
            stores[which] = (st, st.make_catalog())
        st, cfg = stores[which]
        vexps, _ = case_vexps(mplan2vdl_tpu_torch, case, st, cfg)
        return _distributed(mesh, cfg, st, vexps)

    return {f"fuzz_{c}": (lambda c: lambda m: run(m, c))(c)
            for c in FUZZ_CASES}


def small_suite():
    import mplan2vdl_tpu_torch
    from mplan2vdl_tpu_torch.engine import datagen

    st = make_store(datagen, "small")
    cfg = st.make_catalog()
    return {c: (lambda c: lambda m: _distributed(
        m, cfg, st, case_vexps(mplan2vdl_tpu_torch, c, st, cfg)[0]))(c)
        for c in SMALL_CASES}
