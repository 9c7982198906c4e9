"""The numpy join oracles of tests/torch_plans.py against SQLite, on the
CPU.

The oracles decide whether the port's join plans are right on the GPU,
so they are held here against an independent SQL engine; the oracles of
the ordered plans (Q4, Q3 with its LIMIT 10, Q16) also against the port's
CPU run of each plan, in order.  The store's
columns go into an in-memory SQLite database the way
tests/test_sqlite_oracle.py builds it (dates as ISO-8601 text; the
dictionary columns the queries filter or group on as their strings), and
the queries are written as real SQL.  Every comparison is exact.
"""

import datetime
import sqlite3

import numpy as np
import pytest

import torch_plans
from mplan2vdl_tpu_torch.engine import datagen
from mplan2vdl_tpu_torch.engine import lower

DATE_COLS = {"l_shipdate", "l_commitdate", "l_receiptdate", "o_orderdate"}
TEXT_COLS = {"c_mktsegment", "n_name", "r_name", "p_name", "p_brand",
             "p_container", "o_comment", "c_phone", "p_type", "s_comment",
             "o_orderpriority"}
SEEDS = (13, 17)


def _day_sql(col):
    return f"CAST(julianday({col}) - julianday('0000-01-01') AS INT)"


@pytest.fixture(scope="module", params=SEEDS)
def store_db(request):
    store = datagen.generate(sf=0.01, seed=request.param)
    db = sqlite3.connect(":memory:")
    db.execute("PRAGMA case_sensitive_like = ON")  # as the engine's LIKE
    tables = {}
    for (tab, col), data in store.columns.items():
        if not tab.startswith("%") and not col.startswith("%"):
            tables.setdefault(tab, []).append((col, data))
    for tab, cols in tables.items():
        names, arrays = [], []
        for col, data in cols:
            if col in DATE_COLS:
                names.append(f"{col} TEXT")
                arrays.append([datetime.date.fromordinal(int(v) - 365)
                               .isoformat() for v in data])
            elif col in TEXT_COLS:
                dec = store.decoders[(tab, col)]
                names.append(f"{col} TEXT")
                arrays.append([dec[int(v)] for v in data])
            else:
                names.append(f"{col} INTEGER")
                arrays.append([int(v) for v in data])
        db.execute(f"CREATE TABLE {tab} ({', '.join(names)})")
        ph = ", ".join("?" * len(names))
        db.executemany(f"INSERT INTO {tab} VALUES ({ph})", zip(*arrays))
    for tab, key in (("customer", "c_custkey"), ("orders", "o_orderkey"),
                     ("supplier", "s_suppkey"), ("nation", "n_nationkey"),
                     ("lineitem", "l_orderkey"), ("part", "p_partkey"),
                     ("lineitem", "l_partkey"), ("orders", "o_custkey"),
                     ("partsupp", "ps_partkey, ps_suppkey")):
        db.execute(f"CREATE INDEX {tab}_{key[:10]} ON {tab} ({key})")
    db.commit()
    return store, db


def _decode(store, tab, col, codes):
    dec = store.decoders[(tab, col)]
    return [dec[int(c)] for c in codes]


def test_q3_oracle_matches_sqlite(store_db):
    store, db = store_db
    key, revenue, date, prio = torch_plans.oracle_q3(store)
    got = sorted(zip(*[np.asarray(c, np.int64).tolist()
                       for c in (key, revenue, date, prio)]))
    want = sorted(tuple(r) for r in db.execute(f"""
        SELECT l_orderkey, SUM(l_extendedprice * (100 - l_discount)),
               {_day_sql("o_orderdate")}, o_shippriority
        FROM customer, orders, lineitem
        WHERE c_mktsegment = 'BUILDING'
          AND c_custkey = o_custkey AND l_orderkey = o_orderkey
          AND o_orderdate < '1995-03-15' AND l_shipdate > '1995-03-15'
        GROUP BY l_orderkey, o_orderdate, o_shippriority
    """))
    assert got and got == want


def test_q5_oracle_matches_sqlite(store_db):
    store, db = store_db
    name, revenue = torch_plans.oracle_q5(store)
    got = sorted(zip(_decode(store, "nation", "n_name", name),
                     np.asarray(revenue, np.int64).tolist()))
    want = sorted(tuple(r) for r in db.execute("""
        SELECT n_name, SUM(l_extendedprice * (100 - l_discount))
        FROM customer, orders, lineitem, supplier, nation, region
        WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
          AND l_suppkey = s_suppkey AND c_nationkey = s_nationkey
          AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
          AND r_name = 'ASIA'
          AND o_orderdate >= '1994-01-01' AND o_orderdate < '1995-01-01'
        GROUP BY n_name
    """))
    assert got and got == want


def test_sparse_groupby_oracle_matches_sqlite(store_db):
    store, db = store_db
    cols = torch_plans.oracle_sparse_groupby(store)
    got = sorted(zip(*[np.asarray(c, np.int64).tolist() for c in cols]))
    want = sorted(tuple(r) for r in db.execute(f"""
        SELECT l_orderkey, SUM(l_quantity), MIN({_day_sql("l_shipdate")}),
               MAX(l_quantity), COUNT(*)
        FROM lineitem WHERE l_shipdate >= '1995-01-01'
        GROUP BY l_orderkey
    """))
    assert got and got == want


def test_q9_oracle_matches_sqlite(store_db):
    store, db = store_db
    name, year, profit = torch_plans.oracle_q9(store)
    got = sorted(zip(_decode(store, "nation", "n_name", name),
                     np.asarray(year, np.int64).tolist(),
                     np.asarray(profit, np.int64).tolist()))
    want = sorted(tuple(r) for r in db.execute("""
        SELECT n_name, CAST(strftime('%Y', o_orderdate) AS INT),
               SUM(l_extendedprice * (100 - l_discount)
                   - ps_supplycost * l_quantity)
        FROM part, supplier, lineitem, partsupp, orders, nation
        WHERE s_suppkey = l_suppkey AND ps_suppkey = l_suppkey
          AND ps_partkey = l_partkey AND p_partkey = l_partkey
          AND o_orderkey = l_orderkey AND s_nationkey = n_nationkey
          AND p_name LIKE '%green%'
        GROUP BY 1, 2
    """))
    assert got and got == want


def test_q13_oracle_matches_sqlite(store_db):
    store, db = store_db
    cols = torch_plans.oracle_q13(store)
    got = sorted(zip(*[np.asarray(c, np.int64).tolist() for c in cols]))
    want = sorted(tuple(r) for r in db.execute("""
        SELECT c_count, COUNT(*)
        FROM (SELECT c_custkey, COUNT(o_orderkey) AS c_count
              FROM customer LEFT OUTER JOIN orders
                ON c_custkey = o_custkey
               AND o_comment NOT LIKE '%special%requests%'
              GROUP BY c_custkey)
        GROUP BY c_count
    """))
    assert got and got == want
    assert want[0][0] == 0  # customers with no order


def test_q17_oracle_matches_sqlite(store_db):
    """Q17 with the engine's exact-integer avg: sum / count of l_quantity
    (integer division at its two decimal digits), 0.2 of it at three."""
    store, db = store_db
    (got,) = torch_plans.oracle_q17(store)
    (want,) = db.execute("""
        SELECT COALESCE(SUM(l_extendedprice), 0) FROM lineitem, part
        WHERE p_partkey = l_partkey AND p_brand = 'Brand#23'
          AND p_container = 'MED BOX'
          AND l_quantity * 10 < 2 * (SELECT SUM(l2.l_quantity) / COUNT(*)
                                     FROM lineitem AS l2
                                     WHERE l2.l_partkey = p_partkey)
    """).fetchone()
    assert got.tolist() == [want]


def test_substr_groupby_oracle_matches_sqlite(store_db):
    store, db = store_db
    code, n, total = torch_plans.oracle_substr_groupby(store)
    _, derived = torch_plans.substr_codes(store, "customer", "c_phone", 1, 2)
    got = sorted(zip([derived[int(c)] for c in code],
                     np.asarray(n, np.int64).tolist(),
                     np.asarray(total, np.int64).tolist()))
    want = sorted(tuple(r) for r in db.execute("""
        SELECT substr(c_phone, 1, 2), COUNT(*), SUM(c_acctbal)
        FROM customer GROUP BY 1
    """))
    assert len(got) > 1 and got == want


def _port_run(store, plan):
    res = lower.compile_plan_text(plan, store.make_catalog(), store,
                                  device="cpu")()
    return [np.asarray(c, np.int64) for c in res.columns]


def _in_order(got, want):
    return len(got) == len(want) and all(
        np.array_equal(np.asarray(g, np.int64), np.asarray(w, np.int64))
        for g, w in zip(got, want))


def test_q4_oracle_matches_sqlite_and_port(store_db):
    store, db = store_db
    prio, count = torch_plans.oracle_q4(store)
    got = sorted(zip(_decode(store, "orders", "o_orderpriority", prio),
                     np.asarray(count, np.int64).tolist()))
    want = sorted(tuple(r) for r in db.execute("""
        SELECT o_orderpriority, COUNT(*) FROM orders
        WHERE o_orderdate >= '1993-07-01' AND o_orderdate < '1993-10-01'
          AND EXISTS (SELECT * FROM lineitem WHERE l_orderkey = o_orderkey
                      AND l_commitdate < l_receiptdate)
        GROUP BY o_orderpriority
    """))
    assert len(got) > 1 and got == want
    assert _in_order(_port_run(store, torch_plans.PLAN_Q4), [prio, count])


def test_q3_top10_oracle_matches_sqlite_and_port(store_db):
    """Tie-tolerant: the (revenue, o_orderdate) keys of the ten rows, in
    order; rows tied at the cut may differ."""
    store, db = store_db
    cols = torch_plans.oracle_q3_top10(store)
    keys = list(zip(np.asarray(cols[1], np.int64).tolist(),
                    np.asarray(cols[2], np.int64).tolist()))
    want = db.execute(f"""
        SELECT l_orderkey, SUM(l_extendedprice * (100 - l_discount)) AS rev,
               {_day_sql("o_orderdate")} AS odate, o_shippriority
        FROM customer, orders, lineitem
        WHERE c_mktsegment = 'BUILDING'
          AND c_custkey = o_custkey AND l_orderkey = o_orderkey
          AND o_orderdate < '1995-03-15' AND l_shipdate > '1995-03-15'
        GROUP BY l_orderkey, o_orderdate, o_shippriority
        ORDER BY rev DESC, odate LIMIT 10
    """).fetchall()
    assert len(keys) == 10 and keys == [(r[1], r[2]) for r in want]
    port = _port_run(store, torch_plans.PLAN_Q3_TOP10)
    assert list(zip(port[1].tolist(), port[2].tolist())) == keys
    # every oracle row is a row of Q3
    assert set(zip(*[np.asarray(c, np.int64).tolist() for c in cols])) <= \
        set(zip(*[np.asarray(c, np.int64).tolist()
                  for c in torch_plans.oracle_q3(store)]))


def test_q16_oracle_matches_sqlite_and_port(store_db):
    store, db = store_db
    brand, ptype, size, cnt = torch_plans.oracle_q16(store)
    got = sorted(zip(_decode(store, "part", "p_brand", brand),
                     _decode(store, "part", "p_type", ptype),
                     np.asarray(size, np.int64).tolist(),
                     np.asarray(cnt, np.int64).tolist()))
    want = sorted(tuple(r) for r in db.execute("""
        SELECT p_brand, p_type, p_size, COUNT(DISTINCT ps_suppkey)
        FROM partsupp, part
        WHERE p_partkey = ps_partkey AND p_brand <> 'Brand#45'
          AND p_type NOT LIKE 'MEDIUM POLISHED%'
          AND p_size IN (49, 14, 23, 45, 19, 3, 36, 9)
          AND ps_suppkey NOT IN (SELECT s_suppkey FROM supplier
                                 WHERE s_comment LIKE '%Customer%Complaints%')
        GROUP BY p_brand, p_type, p_size
    """))
    assert len(got) > 100 and got == want
    assert _in_order(_port_run(store, torch_plans.PLAN_Q16),
                     [brand, ptype, size, cnt])
    # the order: supplier count descending, then the codes ascending
    order = np.lexsort((size, ptype, brand, -np.asarray(cnt, np.int64)))
    assert np.array_equal(order, np.arange(len(order)))


# ---------------- the plans of the paths no CLI plan reaches at SF10
def test_dense_join_oracle_matches_sqlite(store_db):
    """Each lineitem row against its ship day's average quantity (integer
    sum / count at two decimal digits)."""
    store, db = store_db
    cols = torch_plans.oracle_dense_join(store)
    got = sorted(zip(*[np.asarray(c, np.int64).tolist() for c in cols]))
    want = sorted(tuple(r) for r in db.execute("""
        WITH t AS MATERIALIZED (
            SELECT l_shipdate AS d, SUM(l_quantity) / COUNT(*) AS a
            FROM lineitem GROUP BY l_shipdate)
        SELECT l.l_returnflag, COUNT(*), SUM(l.l_extendedprice)
        FROM lineitem AS l CROSS JOIN t  -- lineitem outer: t is indexed
        WHERE l.l_shipdate = t.d AND l.l_quantity > t.a
        GROUP BY l.l_returnflag
    """))
    assert len(got) > 1 and got == want


def test_distinct_dense_oracle_matches_sqlite(store_db):
    store, db = store_db
    cols = torch_plans.oracle_distinct_dense(store)
    got = sorted(zip(*[np.asarray(c, np.int64).tolist() for c in cols]))
    want = sorted(tuple(r) for r in db.execute("""
        SELECT l_returnflag, l_linestatus, COUNT(DISTINCT l_partkey)
        FROM lineitem GROUP BY l_returnflag, l_linestatus
    """))
    assert len(got) > 1 and got == want


def test_distinct_wide_oracle_matches_sqlite(store_db):
    store, db = store_db
    cols = torch_plans.oracle_distinct_wide(store)
    got = sorted(zip(*[np.asarray(c, np.int64).tolist() for c in cols]))
    want = sorted(tuple(r) for r in db.execute("""
        SELECT l_orderkey, l_partkey, COUNT(DISTINCT l_extendedprice)
        FROM lineitem
        WHERE l_shipdate >= '1995-06-01' AND l_shipdate < '1995-07-01'
        GROUP BY l_orderkey, l_partkey
    """))
    assert len(got) > 100 and got == want


def test_q4_all_oracle_matches_sqlite_and_port(store_db):
    store, db = store_db
    prio, count = torch_plans.oracle_q4_all(store)
    got = sorted(zip(_decode(store, "orders", "o_orderpriority", prio),
                     np.asarray(count, np.int64).tolist()))
    want = sorted(tuple(r) for r in db.execute("""
        SELECT o_orderpriority, COUNT(*) FROM orders
        WHERE EXISTS (SELECT * FROM lineitem WHERE l_orderkey = o_orderkey
                      AND l_commitdate < l_receiptdate)
        GROUP BY o_orderpriority
    """))
    assert len(got) > 1 and got == want
    assert _in_order(_port_run(store, torch_plans.PLAN_Q4_ALL), [prio, count])


# -------------------------- the plans of phase 8's partitioned-join paths
def test_hot_join_oracle_matches_sqlite(store_db):
    """The 1994 lineitems joined on l_linenumber with the lines of the
    first orders: SQLite expands the pairs, the oracle counts them by
    key."""
    store, db = store_db
    cols = torch_plans.oracle_hot_join(store)
    got = sorted(zip(*[np.asarray(c, np.int64).tolist() for c in cols]))
    want = sorted(tuple(r) for r in db.execute("""
        SELECT l.l_returnflag, COUNT(*), SUM(l.l_quantity),
               SUM(r.l_extendedprice)
        FROM lineitem AS l JOIN lineitem AS r
          ON l.l_linenumber = r.l_linenumber
        WHERE l.l_shipdate >= '1994-01-01' AND l.l_shipdate < '1995-01-01'
          AND r.l_orderkey < 9
        GROUP BY l.l_returnflag
    """))
    assert len(got) > 1 and got == want
    sides = torch_plans.hot_join_sides(store)
    assert sides["rc"].sum() == db.execute(
        "SELECT COUNT(*) FROM lineitem WHERE l_orderkey < 9").fetchone()[0]


def test_q13_nation_oracle_matches_sqlite(store_db):
    store, db = store_db
    cols = torch_plans.oracle_q13_nation(store)
    got = sorted(zip(*[np.asarray(c, np.int64).tolist() for c in cols]))
    want = sorted(tuple(r) for r in db.execute("""
        SELECT c_nationkey, COUNT(o_orderkey), COUNT(*)
        FROM customer LEFT OUTER JOIN orders
          ON c_custkey = o_custkey
         AND o_comment NOT LIKE '%special%requests%'
        GROUP BY c_nationkey
    """))
    assert len(got) > 1 and got == want
    # some customers have no order: rows exceed orders somewhere
    assert any(n_rows > n_orders for _, n_orders, n_rows in got)
