"""TPC-H Q9 without ORDER BY: profit per (nation, year) of the lineitems
of parts named like '%green%'."""

import torch

from h100bench.reference._rel import codes, group, num, out, pk_lookup, year

COLUMNS = ["nation", "o_year", "sum_profit"]


def reference(t, acc):
    c = lambda tab, n: t.cols[(tab, n)]  # noqa: E731
    green = torch.isin(c("part", "p_name"),
                       codes(t, ("part", "p_name"), "%green%"))
    _, pfound = pk_lookup(c("part", "p_partkey")[green],
                          c("lineitem", "l_partkey"))
    rows = torch.nonzero(pfound).reshape(-1)
    lp = c("lineitem", "l_partkey")[rows].long()
    ls = c("lineitem", "l_suppkey")[rows].long()
    si, sfound = pk_lookup(c("supplier", "s_suppkey"), ls)
    # partsupp's key (ps_partkey, ps_suppkey) as one int64
    k = int(max(int(ls.max()) if ls.numel() else 0,
                int(c("partsupp", "ps_suppkey").max()))) + 1
    psi, psfound = pk_lookup(
        c("partsupp", "ps_partkey").long() * k + c("partsupp", "ps_suppkey"),
        lp * k + ls)
    oi, ofound = pk_lookup(c("orders", "o_orderkey"),
                           c("lineitem", "l_orderkey")[rows])
    ni, nfound = pk_lookup(c("nation", "n_nationkey"),
                           c("supplier", "s_nationkey")[si])
    m = sfound & psfound & ofound & nfound
    li = lambda n: num(c("lineitem", n)[rows[m]], acc)  # noqa: E731
    amount = (li("l_extendedprice") * (100 - li("l_discount"))
              - num(c("partsupp", "ps_supplycost")[psi[m]], acc)
              * li("l_quantity"))
    nation, yr, profit = group(
        [c("nation", "n_name")[ni[m]], year(c("orders", "o_orderdate")[oi[m]])],
        [(amount, "sum")], acc)
    return [nation, yr, out(profit, acc)]
