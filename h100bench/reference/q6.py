"""TPC-H Q6: revenue of the 1994 lineitems with a discount of 5 to 7 and a
quantity below 24."""

from h100bench.reference._rel import day, num, total

COLUMNS = ["revenue"]


def reference(t, acc):
    c = lambda n: t.cols[("lineitem", n)]  # noqa: E731
    ship, disc = c("l_shipdate"), c("l_discount")
    m = ((ship >= day(1994, 1, 1)) & (ship < day(1995, 1, 1))
         & (disc >= 5) & (disc <= 7) & (c("l_quantity") < 2400))
    return [total(num(c("l_extendedprice")[m], acc) * num(disc[m], acc),
                  acc)]
