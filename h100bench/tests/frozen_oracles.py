"""Frozen copies of the numpy oracles the port's smoke test holds its
query runs to (``chip_smoke.py``'s ``oracle_*``, ``oracle/tpch.py``'s
``q1`` and ``q6``), held against SQLite by the repository's tests.  Here
they are the second witness for ``reference/``: each takes a store-like
object with numpy ``columns`` and ``decoders`` keyed by ``(table,
column)``."""

from __future__ import annotations

import datetime

import numpy as np

ColumnStore = object  # the annotations of the copies


def tdiv(a, b):
    """Truncating integer division (C semantics)."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    q = np.abs(a) // np.abs(b)
    return np.where((a >= 0) == (b >= 0), q, -q)


def day(y, m, d):
    return datetime.date(y, m, d).toordinal() + 365


def C(store: ColumnStore, tab: str, col: str) -> np.ndarray:
    return store.columns[(tab, col)]


def groupby_sum(keys: List[np.ndarray], vals: List[np.ndarray]):
    """Group rows by the key tuple; return (key columns, summed columns)."""
    packed = np.stack(keys, axis=1) if keys else np.zeros((len(vals[0]), 0))
    uniq, inv = np.unique(packed, axis=0, return_inverse=True)
    outs = []
    for v in vals:
        acc = np.zeros(len(uniq), dtype=np.int64)
        np.add.at(acc, inv, v.astype(np.int64))
        outs.append(acc)
    return [uniq[:, i] for i in range(uniq.shape[1])], outs, inv, uniq


def oracle_q1(store: ColumnStore):
    ship = C(store, "lineitem", "l_shipdate")
    m = ship <= day(1998, 12, 1) - 90
    rf = C(store, "lineitem", "l_returnflag")[m]
    ls = C(store, "lineitem", "l_linestatus")[m]
    qty = C(store, "lineitem", "l_quantity")[m].astype(np.int64)
    ep = C(store, "lineitem", "l_extendedprice")[m].astype(np.int64)
    disc = C(store, "lineitem", "l_discount")[m].astype(np.int64)
    tax = C(store, "lineitem", "l_tax")[m].astype(np.int64)
    disc_price = ep * (100 - disc)  # scale 4
    charge = disc_price * (100 + tax)  # scale 6
    keys, (s_qty, s_ep, s_dp, s_ch, s_disc, cnt), inv, _ = groupby_sum(
        [rf, ls], [qty, ep, disc_price, charge, disc, np.ones_like(qty)])
    return {
        "l_returnflag": keys[0], "l_linestatus": keys[1],
        "sum_qty": s_qty, "sum_base_price": s_ep, "sum_disc_price": s_dp,
        "sum_charge": s_ch, "avg_qty": tdiv(s_qty, cnt),
        "avg_price": tdiv(s_ep, cnt), "avg_disc": tdiv(s_disc, cnt),
        "count_order": cnt,
    }


def oracle_q6(store: ColumnStore):
    ship = C(store, "lineitem", "l_shipdate")
    disc = C(store, "lineitem", "l_discount").astype(np.int64)
    qty = C(store, "lineitem", "l_quantity").astype(np.int64)
    ep = C(store, "lineitem", "l_extendedprice").astype(np.int64)
    m = ((ship >= day(1994, 1, 1)) & (ship < day(1995, 1, 1))
         & (disc >= 5) & (disc <= 7) & (qty < 2400))
    return {"revenue": np.array([np.sum(ep[m] * disc[m])])}



def _day(y, m, d):
    import datetime

    return datetime.date(y, m, d).toordinal() + 365


def _code(st, tab, col, s):
    return next(c for c, v in st.decoders[(tab, col)].items() if v == s)


def _pk_lookup(keys, probe):
    """Row of ``keys`` (a primary key) holding each ``probe`` value, and
    whether there is one."""
    import numpy as np

    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    if len(sk) == 0:
        return np.zeros(len(probe), np.int64), np.zeros(len(probe), bool)
    i = np.clip(np.searchsorted(sk, probe), 0, len(sk) - 1)
    return order[i], sk[i] == probe


def _group(keys, aggs):
    """Group rows by the key tuple: the distinct keys in ascending order,
    then one column per ``(values, ufunc)`` reduced over each group."""
    import numpy as np

    order = np.lexsort(keys[::-1])
    ks = [np.asarray(k)[order] for k in keys]
    head = np.zeros(len(order), dtype=bool)
    head[:1] = True
    for k in ks:
        head[1:] |= k[1:] != k[:-1]
    starts = np.flatnonzero(head)
    outs = [k[starts] for k in ks]
    for vals, ufunc in aggs:
        v = np.asarray(vals, np.int64)[order]
        outs.append(ufunc.reduceat(v, starts) if len(starts)
                    else v[:0])
    return outs


def oracle_q3(st):
    import numpy as np

    c = lambda t, n: st.columns[(t, n)]  # noqa: E731
    cust_ok = (c("customer", "c_mktsegment")
               == _code(st, "customer", "c_mktsegment", "BUILDING"))
    ci, cfound = _pk_lookup(c("customer", "c_custkey"), c("orders", "o_custkey"))
    ord_ok = (cfound & cust_ok[ci]
              & (c("orders", "o_orderdate") < _day(1995, 3, 15)))
    oi, ofound = _pk_lookup(c("orders", "o_orderkey"),
                            c("lineitem", "l_orderkey"))
    m = (ofound & ord_ok[oi]
         & (c("lineitem", "l_shipdate") > _day(1995, 3, 15)))
    oi = oi[m]
    rev = (c("lineitem", "l_extendedprice")[m].astype(np.int64)
           * (100 - c("lineitem", "l_discount")[m].astype(np.int64)))
    key, date, prio, revenue = _group(
        [c("lineitem", "l_orderkey")[m], c("orders", "o_orderdate")[oi],
         c("orders", "o_shippriority")[oi]], [(rev, np.add)])
    return [key, revenue, date, prio]


def oracle_q5(st):
    import numpy as np

    c = lambda t, n: st.columns[(t, n)]  # noqa: E731
    asia = c("region", "r_regionkey")[
        c("region", "r_name") == _code(st, "region", "r_name", "ASIA")]
    oi, ofound = _pk_lookup(c("orders", "o_orderkey"),
                            c("lineitem", "l_orderkey"))
    si, sfound = _pk_lookup(c("supplier", "s_suppkey"),
                            c("lineitem", "l_suppkey"))
    ci, cfound = _pk_lookup(c("customer", "c_custkey"), c("orders", "o_custkey"))
    odate = c("orders", "o_orderdate")
    ord_ok = cfound & (odate >= _day(1994, 1, 1)) & (odate < _day(1995, 1, 1))
    s_nat = c("supplier", "s_nationkey")[si]
    ni, nfound = _pk_lookup(c("nation", "n_nationkey"), s_nat)
    m = (ofound & sfound & nfound & ord_ok[oi]
         & (c("customer", "c_nationkey")[ci[oi]] == s_nat)
         & np.isin(c("nation", "n_regionkey")[ni], asia))
    rev = (c("lineitem", "l_extendedprice")[m].astype(np.int64)
           * (100 - c("lineitem", "l_discount")[m].astype(np.int64)))
    return _group([c("nation", "n_name")[ni[m]]], [(rev, np.add)])


def _codes_matching(st, tab, col, regex):
    """Dictionary codes of ``tab.col`` whose string ``regex`` finds."""
    import re

    import numpy as np

    rx = re.compile(regex)
    return np.asarray([c for c, v in st.decoders[(tab, col)].items()
                       if rx.search(v)], np.int64)


def _year(days):
    """Calendar year of day counts since 0000-01-01."""
    import numpy as np

    d = (np.asarray(days, np.int64) - 365 - 719163).astype("datetime64[D]")
    return d.astype("datetime64[Y]").astype(np.int64) + 1970


def oracle_q9(st):
    import numpy as np

    c = lambda t, n: st.columns[(t, n)]  # noqa: E731
    green = np.isin(c("part", "p_name"),
                    _codes_matching(st, "part", "p_name", "green"))
    # lineitem rows of a green part, then the other joins on those rows
    _, pfound = _pk_lookup(c("part", "p_partkey")[green],
                           c("lineitem", "l_partkey"))
    rows = np.flatnonzero(pfound)
    lp = c("lineitem", "l_partkey")[rows]
    ls = c("lineitem", "l_suppkey")[rows]
    si, sfound = _pk_lookup(c("supplier", "s_suppkey"), ls)
    # partsupp's key (ps_partkey, ps_suppkey) as one int64
    k = int(max(ls.max(initial=0), c("partsupp", "ps_suppkey").max())) + 1
    psi, psfound = _pk_lookup(
        c("partsupp", "ps_partkey").astype(np.int64) * k
        + c("partsupp", "ps_suppkey"), lp.astype(np.int64) * k + ls)
    oi, ofound = _pk_lookup(c("orders", "o_orderkey"),
                            c("lineitem", "l_orderkey")[rows])
    ni, nfound = _pk_lookup(c("nation", "n_nationkey"),
                            c("supplier", "s_nationkey")[si])
    m = sfound & psfound & ofound & nfound
    i64 = lambda n: c("lineitem", n)[rows[m]].astype(np.int64)  # noqa: E731
    amount = (i64("l_extendedprice") * (100 - i64("l_discount"))
              - c("partsupp", "ps_supplycost")[psi[m]].astype(np.int64)
              * i64("l_quantity"))
    return _group([c("nation", "n_name")[ni[m]],
                   _year(c("orders", "o_orderdate")[oi[m]])],
                  [(amount, np.add)])


def oracle_q13(st):
    import numpy as np

    c = lambda t, n: st.columns[(t, n)]  # noqa: E731
    special = _codes_matching(st, "orders", "o_comment", "special.*requests")
    keep = ~np.isin(c("orders", "o_comment"), special)
    ckeys = c("customer", "c_custkey")
    ci, cfound = _pk_lookup(ckeys, c("orders", "o_custkey")[keep])
    per_cust = np.bincount(ci[cfound], minlength=len(ckeys))
    return _group([per_cust], [(np.ones(len(ckeys), np.int64), np.add)])


def oracle_q17(st):
    import numpy as np

    c = lambda t, n: st.columns[(t, n)]  # noqa: E731
    ok = ((c("part", "p_brand") == _code(st, "part", "p_brand", "Brand#23"))
          & (c("part", "p_container")
             == _code(st, "part", "p_container", "MED BOX")))
    # lineitem rows of those parts
    lp = c("lineitem", "l_partkey")
    _, pfound = _pk_lookup(c("part", "p_partkey")[ok], lp)
    sel = np.flatnonzero(pfound)
    qty = c("lineitem", "l_quantity")[sel].astype(np.int64)
    _, inv = np.unique(lp[sel], return_inverse=True)
    # avg is sum // count in l_quantity's scale (2 digits); 0.2 * avg then
    # has 3, so l_quantity compares at 3 digits too
    avg = np.bincount(inv, qty).astype(np.int64) // np.bincount(inv)
    below = qty * 10 < 2 * avg[inv]
    price = c("lineitem", "l_extendedprice")[sel][below].astype(np.int64)
    return [np.asarray([price.sum()], np.int64)]
