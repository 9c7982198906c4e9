"""TPC-H Q3 without ORDER BY / LIMIT: revenue per (l_orderkey,
o_orderdate, o_shippriority) of BUILDING customers' orders placed before
1995-03-15 with lineitems shipped after it."""

from h100bench.reference._rel import day, group, num, out, pk_lookup

COLUMNS = ["l_orderkey", "revenue", "o_orderdate", "o_shippriority"]


def reference(t, acc):
    c = lambda tab, n: t.cols[(tab, n)]  # noqa: E731
    building = t.code(("customer", "c_mktsegment"), "BUILDING")
    ci, cfound = pk_lookup(c("customer", "c_custkey"), c("orders", "o_custkey"))
    ord_ok = (cfound & (c("customer", "c_mktsegment")[ci] == building)
              & (c("orders", "o_orderdate") < day(1995, 3, 15)))
    oi, ofound = pk_lookup(c("orders", "o_orderkey"),
                           c("lineitem", "l_orderkey"))
    m = ofound & ord_ok[oi] & (c("lineitem", "l_shipdate") > day(1995, 3, 15))
    oi = oi[m]
    rev = (num(c("lineitem", "l_extendedprice")[m], acc)
           * (100 - num(c("lineitem", "l_discount")[m], acc)))
    key, date, prio, revenue = group(
        [c("lineitem", "l_orderkey")[m], c("orders", "o_orderdate")[oi],
         c("orders", "o_shippriority")[oi]], [(rev, "sum")], acc)
    return [key, out(revenue, acc), date, prio]
