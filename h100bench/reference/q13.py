"""TPC-H Q13: customers per count of their orders whose comment is not
like '%special%requests%' (a customer with none counts 0)."""

import torch

from h100bench.reference._rel import codes, group, out, pk_lookup

COLUMNS = ["c_count", "custdist"]


def reference(t, acc):
    c = lambda tab, n: t.cols[(tab, n)]  # noqa: E731
    special = codes(t, ("orders", "o_comment"), "%special%requests%")
    keep = ~torch.isin(c("orders", "o_comment"), special)
    ckeys = c("customer", "c_custkey")
    ci, cfound = pk_lookup(ckeys, c("orders", "o_custkey")[keep])
    per_cust = torch.bincount(ci[cfound], minlength=ckeys.numel())
    cnt, dist = group([per_cust], [(None, "count")], acc)
    return [cnt, out(dist, acc)]
