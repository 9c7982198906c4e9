"""TPC-H Q1: lineitem shipped by 1998-09-02, summed and averaged per
(l_returnflag, l_linestatus); an average is sum / count truncated, in the
column's own scale."""

from h100bench.reference._rel import day, group, num, out, tdiv

COLUMNS = ["l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
           "sum_disc_price", "sum_charge", "avg_qty", "avg_price",
           "avg_disc", "count_order"]


def reference(t, acc):
    c = lambda n: t.cols[("lineitem", n)]  # noqa: E731
    m = c("l_shipdate") <= day(1998, 9, 2)
    qty, ep, disc, tax = (num(c(n)[m], acc) for n in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    dp = ep * (100 - disc)
    rf, ls, s_qty, s_ep, s_dp, s_ch, s_disc, cnt = group(
        [c("l_returnflag")[m], c("l_linestatus")[m]],
        [(qty, "sum"), (ep, "sum"), (dp, "sum"), (dp * (100 + tax), "sum"),
         (disc, "sum"), (None, "count")], acc)
    return [rf, ls] + [out(x, acc) for x in (
        s_qty, s_ep, s_dp, s_ch, tdiv(s_qty, cnt, acc), tdiv(s_ep, cnt, acc),
        tdiv(s_disc, cnt, acc), cnt)]
