"""TPC-H Q5: revenue per ASIAN nation of the 1994 orders whose customer
and supplier share a nation."""

from h100bench.reference._rel import day, group, num, out, pk_lookup

COLUMNS = ["n_name", "revenue"]


def reference(t, acc):
    c = lambda tab, n: t.cols[(tab, n)]  # noqa: E731
    asia = t.code(("region", "r_name"), "ASIA")
    asia_key = c("region", "r_regionkey")[c("region", "r_name") == asia]
    oi, ofound = pk_lookup(c("orders", "o_orderkey"),
                           c("lineitem", "l_orderkey"))
    si, sfound = pk_lookup(c("supplier", "s_suppkey"),
                           c("lineitem", "l_suppkey"))
    ci, cfound = pk_lookup(c("customer", "c_custkey"), c("orders", "o_custkey"))
    odate = c("orders", "o_orderdate")
    ord_ok = cfound & (odate >= day(1994, 1, 1)) & (odate < day(1995, 1, 1))
    s_nat = c("supplier", "s_nationkey")[si]
    ni, nfound = pk_lookup(c("nation", "n_nationkey"), s_nat)
    in_asia = (c("nation", "n_regionkey")[ni][:, None]
               == asia_key[None, :]).any(1)
    m = (ofound & sfound & nfound & ord_ok[oi]
         & (c("customer", "c_nationkey")[ci[oi]] == s_nat) & in_asia)
    rev = (num(c("lineitem", "l_extendedprice")[m], acc)
           * (100 - num(c("lineitem", "l_discount")[m], acc)))
    name, revenue = group([c("nation", "n_name")[ni[m]]], [(rev, "sum")], acc)
    return [name, out(revenue, acc)]
