"""Each plain torch reference (``reference/<query>.py``) against SQLite and
against the frozen numpy oracles, over gen.py's tables at a small scale:
all three give the same rows."""

import sqlite3

import numpy as np
import pytest
import torch

from h100bench import cells, check, gen
from h100bench.tests import frozen_oracles as fo

SF, SEED = 0.01, 4242424242
D = gen.day

QUERIES = ["q1", "q6", "q3", "q5", "q9", "q13", "q17"]

SQL = {
    "q1": f"""SELECT l_returnflag, l_linestatus, sum(l_quantity),
        sum(l_extendedprice), sum(l_extendedprice * (100 - l_discount)),
        sum(l_extendedprice * (100 - l_discount) * (100 + l_tax)),
        sum(l_quantity) / count(*), sum(l_extendedprice) / count(*),
        sum(l_discount) / count(*), count(*)
        FROM lineitem WHERE l_shipdate <= {D(1998, 9, 2)}
        GROUP BY l_returnflag, l_linestatus""",
    "q6": f"""SELECT sum(l_extendedprice * l_discount) FROM lineitem
        WHERE l_shipdate >= {D(1994, 1, 1)} AND l_shipdate < {D(1995, 1, 1)}
        AND l_discount BETWEEN 5 AND 7 AND l_quantity < 2400""",
    "q3": f"""SELECT l_orderkey, sum(l_extendedprice * (100 - l_discount)),
        o_orderdate, o_shippriority FROM customer, orders, lineitem
        WHERE c_mktsegment = (SELECT code FROM dict WHERE tab = 'customer'
                              AND col = 'c_mktsegment' AND s = 'BUILDING')
        AND c_custkey = o_custkey AND l_orderkey = o_orderkey
        AND o_orderdate < {D(1995, 3, 15)} AND l_shipdate > {D(1995, 3, 15)}
        GROUP BY l_orderkey, o_orderdate, o_shippriority""",
    "q5": f"""SELECT n_name, sum(l_extendedprice * (100 - l_discount))
        FROM customer, orders, lineitem, supplier, nation, region
        WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
        AND l_suppkey = s_suppkey AND c_nationkey = s_nationkey
        AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
        AND r_name = (SELECT code FROM dict WHERE tab = 'region'
                      AND col = 'r_name' AND s = 'ASIA')
        AND o_orderdate >= {D(1994, 1, 1)} AND o_orderdate < {D(1995, 1, 1)}
        GROUP BY n_name""",
    "q9": """SELECT n_name, year(o_orderdate),
        sum(l_extendedprice * (100 - l_discount)
            - ps_supplycost * l_quantity)
        FROM part, supplier, lineitem, partsupp, orders, nation
        WHERE s_suppkey = l_suppkey AND ps_suppkey = l_suppkey
        AND ps_partkey = l_partkey AND p_partkey = l_partkey
        AND o_orderkey = l_orderkey AND s_nationkey = n_nationkey
        AND p_name IN (SELECT code FROM dict WHERE tab = 'part'
                       AND col = 'p_name' AND s GLOB '*green*')
        GROUP BY n_name, year(o_orderdate)""",
    "q13": """SELECT c_count, count(*) FROM (
        SELECT c_custkey, count(o_orderkey) AS c_count
        FROM customer LEFT OUTER JOIN orders ON c_custkey = o_custkey
        AND o_comment NOT IN (SELECT code FROM dict WHERE tab = 'orders'
                              AND col = 'o_comment'
                              AND s GLOB '*special*requests*')
        GROUP BY c_custkey) GROUP BY c_count""",
    "q17": """SELECT sum(l_extendedprice) FROM lineitem, part
        WHERE p_partkey = l_partkey
        AND p_brand = (SELECT code FROM dict WHERE tab = 'part'
                       AND col = 'p_brand' AND s = 'Brand#23')
        AND p_container = (SELECT code FROM dict WHERE tab = 'part'
                           AND col = 'p_container' AND s = 'MED BOX')
        AND l_quantity * 10 < (SELECT 2 * (sum(l2.l_quantity) / count(*))
                               FROM lineitem l2
                               WHERE l2.l_partkey = p_partkey)""",
}


class Store:
    """gen.py's tables as numpy, the shape the frozen oracles read."""

    def __init__(self, t):
        self.columns = {k: v.numpy() for k, v in t.cols.items()}
        self.decoders = t.decoders


def frozen(q, st):
    if q == "q1":
        r = fo.oracle_q1(st)
        return [r[k] for k in cells.cell("tpch_sf10.scan_agg").reference(
            "q1").COLUMNS]
    if q == "q6":
        return [fo.oracle_q6(st)["revenue"]]
    return getattr(fo, f"oracle_{q}")(st)


@pytest.fixture(scope="module")
def tables():
    return gen.generate(SF, SEED, "cpu")


@pytest.fixture(scope="module")
def db(tables):
    import datetime

    con = sqlite3.connect(":memory:")
    con.create_function("year", 1, lambda d: datetime.date.fromordinal(
        d - 365).year, deterministic=True)
    by_tab = {}
    for (tab, col), v in tables.cols.items():
        by_tab.setdefault(tab, {})[col] = v.numpy().astype(np.int64)
    for tab, cols in by_tab.items():
        names = list(cols)
        con.execute(f"CREATE TABLE {tab} ({', '.join(names)})")
        con.executemany(
            f"INSERT INTO {tab} VALUES ({', '.join('?' * len(names))})",
            zip(*[cols[n].tolist() for n in names]))
    con.execute("CREATE TABLE dict (tab, col, code, s)")
    con.executemany("INSERT INTO dict VALUES (?, ?, ?, ?)",
                    [(t, c, k, s) for (t, c), dec in tables.decoders.items()
                     for k, s in dec.items()])
    con.execute("CREATE INDEX li_part ON lineitem (l_partkey)")
    return con


def _rows(cols):
    return sorted(zip(*[np.asarray(c, np.int64).tolist() for c in cols]))


@pytest.mark.parametrize("q", QUERIES)
def test_reference_matches_sqlite_and_frozen_oracle(q, tables, db):
    ref = cells.cell("tpch_sf10.scan_agg").reference(q)
    got = [c.numpy() for c in ref.reference(tables, torch.int64)]
    assert len(got) == len(ref.COLUMNS)
    want_sql = sorted(tuple(int(x) for x in r)
                      for r in db.execute(SQL[q]).fetchall())
    assert len(want_sql) > 0
    assert _rows(got) == want_sql
    assert _rows(got) == _rows(frozen(q, Store(tables)))


@pytest.mark.parametrize("q", QUERIES)
def test_comparison_is_exact(q, tables):
    """rows_off is 0 on the reference's own rows and counts a change in
    one value or a missing row."""
    cols = cells.cell("tpch_sf10.scan_agg").reference(q).reference(
        tables, torch.int64)
    want = check.canonical(cols)
    assert check.rows_off(cols, want) == 0
    bent = [c.clone() for c in cols]
    bent[-1][0] += 1
    assert check.rows_off(bent, want) == 1
    if cols[0].numel() > 1:
        assert check.rows_off([c[1:] for c in cols], want) >= 1
