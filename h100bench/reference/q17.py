"""TPC-H Q17 in its decorrelated form, stopped before SQL's / 7.0: the
price of Brand#23 / MED BOX lineitems whose quantity is below 0.2 times
their part's average (sum // count in l_quantity's scale; 0.2 times it has
three digits, so the quantity compares at three)."""

import torch

from h100bench.reference._rel import group, num, pk_lookup, tdiv, total

COLUMNS = ["sum_price"]


def reference(t, acc):
    c = lambda tab, n: t.cols[(tab, n)]  # noqa: E731
    ok = ((c("part", "p_brand") == t.code(("part", "p_brand"), "Brand#23"))
          & (c("part", "p_container")
             == t.code(("part", "p_container"), "MED BOX")))
    lp = c("lineitem", "l_partkey")
    _, pfound = pk_lookup(c("part", "p_partkey")[ok], lp)
    sel = torch.nonzero(pfound).reshape(-1)
    qty = num(c("lineitem", "l_quantity")[sel], acc)
    _, s, n = group([lp[sel]], [(qty, "sum"), (None, "count")], acc)
    avg = tdiv(s, n, acc)
    _, inv = torch.unique(lp[sel], sorted=True, return_inverse=True)
    below = qty * 10 < 2 * avg[inv]
    return [total(num(c("lineitem", "l_extendedprice")[sel][below], acc),
                  acc)]
