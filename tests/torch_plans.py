"""The plans, numpy oracles and cases that the port's tests and
``chip_smoke.py`` share: the single copy of each.

* The plan texts (``PLAN_*``): TPC-H Q1, Q3 (also with its ORDER BY ...
  LIMIT 10), Q4, Q5, Q6, Q9, Q13, Q16 and Q17 in MonetDB's plan form, and
  plans of the engine's and the distributor's paths that no TPC-H plan
  reaches at SF10; their result columns (``*_COLUMNS``).  Seven of them are
  also ``h100bench/queries/*.mplan``, byte for byte
  (tests/test_torch_plans.py).
* The sets ``chip_smoke.py`` runs them in: ``CLI_PLANS`` (the command line
  and the single-device runs), ``AUTO_PLANS`` (the plan distributor), with
  what each set expects (``EXPECTED_NOT_DISTRIBUTABLE``, ``AUTO_PATHS``,
  ``CENSUS_SKIP``) and the names of the runs of the paths no other plan
  reaches.
* The oracles (``oracle_*``): straightforward numpy versions of the plans
  over a generated store, sharing nothing with the engine.
* ``DistQuery``'s arguments, the scatter's and the probe contractions'
  cases, and helpers of the command-line tests (``write_metadata``,
  ``csv_rows``, ``q16_sql_order``).

Imports numpy and the port only, and needs no CUDA device.
"""

import os

PLAN_Q6 = """project (
| group by (
| | select (
| | | table(sys.lineitem) [ lineitem.l_quantity NOT NULL, lineitem.l_extendedprice NOT NULL,
| | |   lineitem.l_discount NOT NULL, lineitem.l_shipdate NOT NULL ] COUNT
| | ) [ lineitem.l_shipdate NOT NULL >= date "1994-01-01", lineitem.l_shipdate NOT NULL < date "1995-01-01",
| |     lineitem.l_discount NOT NULL >= decimal(15,2) "5", lineitem.l_discount NOT NULL <= decimal(15,2) "7",
| |     lineitem.l_quantity NOT NULL < decimal(15,2) "2400" ]
| ) [  ] [ sys.sum no nil (sys.sql_mul(lineitem.l_extendedprice NOT NULL, lineitem.l_discount NOT NULL)) as L1.L1 ]
) [ L1 as L2.revenue ]
"""

PLAN_Q1 = """project (
| group by (
| | select (
| | | table(sys.lineitem) [ lineitem.l_quantity NOT NULL, lineitem.l_extendedprice NOT NULL,
| | |   lineitem.l_discount NOT NULL, lineitem.l_tax NOT NULL, lineitem.l_returnflag NOT NULL,
| | |   lineitem.l_linestatus NOT NULL, lineitem.l_shipdate NOT NULL ] COUNT
| | ) [ lineitem.l_shipdate NOT NULL <= date "1998-09-02" ]
| ) [ lineitem.l_returnflag, lineitem.l_linestatus ] [ lineitem.l_returnflag, lineitem.l_linestatus,
|   sys.sum no nil (lineitem.l_quantity NOT NULL) as L1.L1,
|   sys.sum no nil (lineitem.l_extendedprice NOT NULL) as L2.L2,
|   sys.sum no nil (sys.sql_mul(lineitem.l_extendedprice NOT NULL, sys.sql_sub(decimal(15,2) "100", lineitem.l_discount NOT NULL))) as L3.L3,
|   sys.sum no nil (sys.sql_mul(sys.sql_mul(lineitem.l_extendedprice NOT NULL, sys.sql_sub(decimal(15,2) "100", lineitem.l_discount NOT NULL)), sys.sql_add(decimal(15,2) "100", lineitem.l_tax NOT NULL))) as L4.L4,
|   sys.avg no nil (lineitem.l_quantity NOT NULL) as L5.L5,
|   sys.avg no nil (lineitem.l_extendedprice NOT NULL) as L6.L6,
|   sys.avg no nil (lineitem.l_discount NOT NULL) as L7.L7,
|   sys.count no nil (lineitem.l_quantity NOT NULL) as L8.L8 ]
) [ lineitem.l_returnflag, lineitem.l_linestatus, L1 as L9.sum_qty, L2 as L9.sum_base_price, L3 as L9.sum_disc_price,
    L4 as L9.sum_charge, L5 as L9.avg_qty, L6 as L9.avg_price, L7 as L9.avg_disc, L8 as L9.count_order ]
"""

# Q6's shipdate window, rows projected (~15.9% of lineitem)
PLAN_FILTER_PROJECT = """project (
| select (
| | table(sys.lineitem) [ lineitem.l_orderkey NOT NULL, lineitem.l_quantity NOT NULL, lineitem.l_extendedprice NOT NULL,
| |   lineitem.l_discount NOT NULL, lineitem.l_shipdate NOT NULL ] COUNT
| ) [ lineitem.l_shipdate NOT NULL >= date "1994-01-01", lineitem.l_shipdate NOT NULL < date "1995-01-01" ]
) [ lineitem.l_orderkey, lineitem.l_quantity, lineitem.l_extendedprice, lineitem.l_discount ]
"""

# TPC-H Q3 in the no-order form (no ORDER BY / LIMIT): two FK joins and a
# sparse group-by over (l_orderkey, o_orderdate, o_shippriority)
PLAN_Q3 = """project (
| group by (
| | join (
| | | join (
| | | | select (
| | | | | table(sys.customer) [ customer.c_custkey NOT NULL, customer.c_mktsegment NOT NULL ] COUNT
| | | | ) [ customer.c_mktsegment NOT NULL = char(10) "BUILDING" ],
| | | | select (
| | | | | table(sys.orders) [ orders.o_orderkey NOT NULL, orders.o_custkey NOT NULL, orders.o_orderdate NOT NULL, orders.o_shippriority NOT NULL ] COUNT
| | | | ) [ orders.o_orderdate NOT NULL < date "1995-03-15" ]
| | | ) [ customer.c_custkey NOT NULL = orders.o_custkey NOT NULL ],
| | | select (
| | | | table(sys.lineitem) [ lineitem.l_orderkey NOT NULL, lineitem.l_extendedprice NOT NULL, lineitem.l_discount NOT NULL, lineitem.l_shipdate NOT NULL ] COUNT
| | | ) [ lineitem.l_shipdate NOT NULL > date "1995-03-15" ]
| | ) [ orders.o_orderkey NOT NULL = lineitem.l_orderkey NOT NULL ]
| ) [ lineitem.l_orderkey, orders.o_orderdate, orders.o_shippriority ] [ lineitem.l_orderkey, sys.sum no nil (sys.sql_mul(lineitem.l_extendedprice NOT NULL, sys.sql_sub(decimal(15,2) "100", lineitem.l_discount NOT NULL))) as L1.L1, orders.o_orderdate, orders.o_shippriority ]
) [ lineitem.l_orderkey, L1 as L2.revenue, orders.o_orderdate, orders.o_shippriority ]
"""

# TPC-H Q3 in its real form: PLAN_Q3 ordered by revenue descending (an
# order column without ASC sorts descending), then o_orderdate, and cut to
# the first 10 rows
PLAN_Q3_TOP10 = ("top N (\n" + PLAN_Q3[:-len("\n")]
                 + " [ L2.revenue, orders.o_orderdate ASC ]\n"
                 + ') [ wrd "10" ]\n')

# TPC-H Q4: the 1993-07-01 to 1993-10-01 orders with a lineitem received
# after its commit date (a semijoin that keeps the orders side), counted per
# o_orderpriority, in order of it
PLAN_Q4 = """project (
| group by (
| | semijoin (
| | | select (
| | | | table(sys.orders) [ orders.o_orderkey NOT NULL, orders.o_orderdate NOT NULL, orders.o_orderpriority NOT NULL ] COUNT
| | | ) [ orders.o_orderdate NOT NULL >= date "1993-07-01", orders.o_orderdate NOT NULL < date "1993-10-01" ],
| | | select (
| | | | table(sys.lineitem) [ lineitem.l_orderkey NOT NULL, lineitem.l_commitdate NOT NULL, lineitem.l_receiptdate NOT NULL ] COUNT
| | | ) [ lineitem.l_commitdate NOT NULL < lineitem.l_receiptdate NOT NULL ]
| | ) [ orders.o_orderkey NOT NULL = lineitem.l_orderkey NOT NULL ]
| ) [ orders.o_orderpriority ] [ orders.o_orderpriority, sys.count() NOT NULL as L1.order_count ]
) [ orders.o_orderpriority, L1.order_count ] [ orders.o_orderpriority ASC ]
"""

# TPC-H Q16: partsupp of the parts outside Brand#45 and MEDIUM POLISHED% in
# eight sizes, without the suppliers whose comment holds
# Customer...Complaints (an antijoin), the distinct suppliers per (brand,
# type, size), ordered by that count descending, then brand, type, size
PLAN_Q16 = """project (
| group by (
| | antijoin (
| | | join (
| | | | table(sys.partsupp) [ partsupp.ps_partkey NOT NULL, partsupp.ps_suppkey NOT NULL ] COUNT,
| | | | select (
| | | | | table(sys.part) [ part.p_partkey NOT NULL, part.p_brand NOT NULL, part.p_type NOT NULL, part.p_size NOT NULL ] COUNT
| | | | ) [ part.p_brand NOT NULL != char(10) "Brand#45", part.p_type NOT NULL ! FILTER like (varchar[char(25) "MEDIUM POLISHED%"], varchar ""), part.p_size NOT NULL in (int "49", int "14", int "23", int "45", int "19", int "3", int "36", int "9") ]
| | | ) [ part.p_partkey NOT NULL = partsupp.ps_partkey NOT NULL ],
| | | select (
| | | | table(sys.supplier) [ supplier.s_suppkey NOT NULL, supplier.s_comment NOT NULL ] COUNT
| | | ) [ supplier.s_comment NOT NULL FILTER like (varchar[char(25) "%Customer%Complaints%"], varchar "") ]
| | ) [ partsupp.ps_suppkey NOT NULL = supplier.s_suppkey NOT NULL ]
| ) [ part.p_brand, part.p_type, part.p_size ] [ part.p_brand, part.p_type, part.p_size, sys.count unique no nil (partsupp.ps_suppkey NOT NULL) NOT NULL as L1.supplier_cnt ]
) [ part.p_brand, part.p_type, part.p_size, L1.supplier_cnt ] [ L1.supplier_cnt, part.p_brand ASC, part.p_type ASC, part.p_size ASC ]
"""

# TPC-H Q5: five FK joins, the non-FK condition c_nationkey = s_nationkey,
# and a dense group-by over n_name
PLAN_Q5 = """project (
| group by (
| | join (
| | | join (
| | | | join (
| | | | | join (
| | | | | | join (
| | | | | | | table(sys.customer) [ customer.c_custkey NOT NULL, customer.c_nationkey NOT NULL ] COUNT,
| | | | | | | select (
| | | | | | | | table(sys.orders) [ orders.o_orderkey NOT NULL, orders.o_custkey NOT NULL, orders.o_orderdate NOT NULL ] COUNT
| | | | | | | ) [ orders.o_orderdate NOT NULL >= date "1994-01-01", orders.o_orderdate NOT NULL < date "1995-01-01" ]
| | | | | | ) [ customer.c_custkey NOT NULL = orders.o_custkey NOT NULL ],
| | | | | | table(sys.lineitem) [ lineitem.l_orderkey NOT NULL, lineitem.l_suppkey NOT NULL, lineitem.l_extendedprice NOT NULL, lineitem.l_discount NOT NULL ] COUNT
| | | | | ) [ orders.o_orderkey NOT NULL = lineitem.l_orderkey NOT NULL ],
| | | | | table(sys.supplier) [ supplier.s_suppkey NOT NULL, supplier.s_nationkey NOT NULL ] COUNT
| | | | ) [ lineitem.l_suppkey NOT NULL = supplier.s_suppkey NOT NULL, customer.c_nationkey NOT NULL = supplier.s_nationkey NOT NULL ],
| | | | table(sys.nation) [ nation.n_nationkey NOT NULL, nation.n_name NOT NULL, nation.n_regionkey NOT NULL ] COUNT
| | | ) [ supplier.s_nationkey NOT NULL = nation.n_nationkey NOT NULL ],
| | | select (
| | | | table(sys.region) [ region.r_regionkey NOT NULL, region.r_name NOT NULL ] COUNT
| | | ) [ region.r_name NOT NULL = char(25) "ASIA" ]
| | ) [ nation.n_regionkey NOT NULL = region.r_regionkey NOT NULL ]
| ) [ nation.n_name ] [ nation.n_name, sys.sum no nil (sys.sql_mul(lineitem.l_extendedprice NOT NULL, sys.sql_sub(decimal(15,2) "100", lineitem.l_discount NOT NULL))) as L1.L1 ]
) [ nation.n_name, L1 as L2.revenue ]
"""

# a masked group-by over the sparse l_orderkey domain: sum, min, max, count
PLAN_SPARSE_GROUPBY = """project (
| group by (
| | select (
| | | table(sys.lineitem) [ lineitem.l_orderkey NOT NULL, lineitem.l_quantity NOT NULL, lineitem.l_shipdate NOT NULL ] COUNT
| | ) [ lineitem.l_shipdate NOT NULL >= date "1995-01-01" ]
| ) [ lineitem.l_orderkey ] [ lineitem.l_orderkey, sys.sum no nil (lineitem.l_quantity NOT NULL) as L1.L1, sys.min no nil (lineitem.l_shipdate NOT NULL) as L2.L2, sys.max no nil (lineitem.l_quantity NOT NULL) as L3.L3, sys.count no nil (lineitem.l_quantity NOT NULL) as L4.L4 ]
) [ lineitem.l_orderkey, L1 as L5.sum_qty, L2 as L5.first_ship, L3 as L5.max_qty, L4 as L5.n ]
"""

# TPC-H Q9 in the no-order form: six tables, five FK joins (the composite
# lineitem -> partsupp key among them), p_name like '%green%', and a sparse
# group-by over (nation, year)
PLAN_Q9 = """project (
| group by (
| | project (
| | | join (
| | | | join (
| | | | | join (
| | | | | | join (
| | | | | | | join (
| | | | | | | | select (
| | | | | | | | | table(sys.part) [ part.p_partkey NOT NULL, part.p_name NOT NULL ] COUNT
| | | | | | | | ) [ part.p_name NOT NULL FILTER like (varchar[char(7) "%green%"], varchar "") ],
| | | | | | | | table(sys.lineitem) [ lineitem.l_orderkey NOT NULL, lineitem.l_partkey NOT NULL, lineitem.l_suppkey NOT NULL,
| | | | | | | |   lineitem.l_quantity NOT NULL, lineitem.l_extendedprice NOT NULL, lineitem.l_discount NOT NULL ] COUNT
| | | | | | | ) [ part.p_partkey NOT NULL = lineitem.l_partkey NOT NULL ],
| | | | | | | table(sys.supplier) [ supplier.s_suppkey NOT NULL, supplier.s_nationkey NOT NULL ] COUNT
| | | | | | ) [ supplier.s_suppkey NOT NULL = lineitem.l_suppkey NOT NULL ],
| | | | | | table(sys.partsupp) [ partsupp.ps_partkey NOT NULL, partsupp.ps_suppkey NOT NULL, partsupp.ps_supplycost NOT NULL ] COUNT
| | | | | ) [ partsupp.ps_suppkey NOT NULL = lineitem.l_suppkey NOT NULL, partsupp.ps_partkey NOT NULL = lineitem.l_partkey NOT NULL ],
| | | | | table(sys.orders) [ orders.o_orderkey NOT NULL, orders.o_orderdate NOT NULL ] COUNT
| | | | ) [ orders.o_orderkey NOT NULL = lineitem.l_orderkey NOT NULL ],
| | | | table(sys.nation) [ nation.n_nationkey NOT NULL, nation.n_name NOT NULL ] COUNT
| | | ) [ supplier.s_nationkey NOT NULL = nation.n_nationkey NOT NULL ]
| | ) [ nation.n_name as profit.nation, sys.year(orders.o_orderdate NOT NULL) as profit.o_year,
| |     sys.sql_sub(sys.sql_mul(lineitem.l_extendedprice NOT NULL, sys.sql_sub(decimal(15,2) "100", lineitem.l_discount NOT NULL)),
| |       sys.sql_mul(partsupp.ps_supplycost NOT NULL, lineitem.l_quantity NOT NULL)) as profit.amount ]
| ) [ profit.nation, profit.o_year ] [ profit.nation, profit.o_year, sys.sum no nil (profit.amount) as L1.L1 ]
) [ profit.nation, profit.o_year, L1 as L2.sum_profit ]
"""

# TPC-H Q13: customer left outer join orders on the custkey with
# o_comment not like '%special%requests%', orders per customer, then
# customers per order count
PLAN_Q13 = """project (
| group by (
| | project (
| | | group by (
| | | | left outer join (
| | | | | table(sys.customer) [ customer.c_custkey NOT NULL ] COUNT,
| | | | | select (
| | | | | | table(sys.orders) [ orders.o_orderkey NOT NULL, orders.o_custkey NOT NULL, orders.o_comment NOT NULL ] COUNT
| | | | | ) [ orders.o_comment NOT NULL ! FILTER like (varchar[char(19) "%special%requests%"], varchar "") ]
| | | | ) [ customer.c_custkey NOT NULL = orders.o_custkey NOT NULL ]
| | | ) [ customer.c_custkey ] [ customer.c_custkey, sys.count no nil (orders.o_orderkey) as L1.L1 ]
| | ) [ customer.c_custkey as c_orders.c_custkey, L1 as c_orders.c_count ]
| ) [ c_orders.c_count ] [ c_orders.c_count, sys.count() NOT NULL as L2.L2 ]
) [ c_orders.c_count, L2 as L3.custdist ]
"""

# TPC-H Q17 in MonetDB's decorrelated shape: lineitem of the Brand#23 /
# MED BOX parts joined with the per-part 0.2 * avg(l_quantity) over the same
# parts (avg lowers to an integer sum / count, in l_quantity's two digits;
# times 0.2 it has three, so l_quantity is cast to three to compare), and
# l_quantity below it; the plan stops at sum(l_extendedprice), before SQL's
# double-typed / 7.0
PLAN_Q17 = """project (
| group by (
| | join (
| | | join (
| | | | table(sys.lineitem) [ lineitem.l_partkey NOT NULL, lineitem.l_quantity NOT NULL, lineitem.l_extendedprice NOT NULL ] COUNT,
| | | | select (
| | | | | table(sys.part) [ part.p_partkey NOT NULL, part.p_brand NOT NULL, part.p_container NOT NULL ] COUNT
| | | | ) [ part.p_brand NOT NULL = char(10) "Brand#23", part.p_container NOT NULL = char(10) "MED BOX" ]
| | | ) [ part.p_partkey NOT NULL = lineitem.l_partkey NOT NULL ],
| | | project (
| | | | group by (
| | | | | join (
| | | | | | table(sys.lineitem) [ lineitem.l_partkey NOT NULL as L1.l_partkey, lineitem.l_quantity NOT NULL as L1.l_quantity ] COUNT,
| | | | | | select (
| | | | | | | table(sys.part) [ part.p_partkey NOT NULL as P2.p_partkey, part.p_brand NOT NULL as P2.p_brand, part.p_container NOT NULL as P2.p_container ] COUNT
| | | | | | ) [ P2.p_brand NOT NULL = char(10) "Brand#23", P2.p_container NOT NULL = char(10) "MED BOX" ]
| | | | | ) [ P2.p_partkey NOT NULL = L1.l_partkey NOT NULL ]
| | | | ) [ L1.l_partkey ] [ L1.l_partkey, sys.avg no nil (L1.l_quantity NOT NULL) as L2.L2 ]
| | | ) [ L1.l_partkey as L3.l_partkey, sys.sql_mul(decimal(2,1) "2", L2.L2) as L3.lim ]
| | ) [ lineitem.l_partkey NOT NULL = L3.l_partkey, decimal(15,3)[lineitem.l_quantity NOT NULL] < L3.lim ]
| ) [  ] [ sys.sum no nil (lineitem.l_extendedprice NOT NULL) as L4.L4 ]
) [ L4 as L5.sum_price ]
"""

# lineitem joined with its own rows of quantity below 11 on l_orderkey,
# grouped by l_returnflag: the right side is a fact-frame chain and the
# domain stays dense, so the plan distributor runs it as a partitioned
# shuffle join (test_fuzz_dist's self-join plans, at full scale)
PLAN_SELF_JOIN = """project (
| group by (
| | join (
| | | table(sys.lineitem) [ lineitem.l_orderkey NOT NULL, lineitem.l_quantity NOT NULL, lineitem.l_returnflag NOT NULL ] COUNT,
| | | select (
| | | | table(sys.lineitem) [ lineitem.l_orderkey NOT NULL as L1.l_orderkey, lineitem.l_quantity NOT NULL as L1.l_quantity, lineitem.l_extendedprice NOT NULL as L1.l_extendedprice ] COUNT
| | | ) [ L1.l_quantity NOT NULL < decimal(15,2) "1100" ]
| | ) [ lineitem.l_orderkey NOT NULL = L1.l_orderkey NOT NULL ]
| ) [ lineitem.l_returnflag ] [ lineitem.l_returnflag, sys.count() NOT NULL as L2.L2, sys.sum no nil (lineitem.l_quantity NOT NULL) as L3.L3, sys.sum no nil (L1.l_extendedprice NOT NULL) as L4.L4 ]
) [ lineitem.l_returnflag, L2 as L5.cnt, L3 as L5.sum_lqty, L4 as L5.sum_rprice ]
"""

# a group-by over substring(c_phone, 1, 2) (Q22's country code) with a count
# and a sum of c_acctbal: the substring recodes c_phone's dictionary
PLAN_SUBSTR_GROUPBY = """project (
| group by (
| | project (
| | | table(sys.customer) [ customer.c_phone NOT NULL, customer.c_acctbal NOT NULL ] COUNT
| | ) [ sys.substring(customer.c_phone NOT NULL, int "1", int "2") as custsale.cntrycode, customer.c_acctbal as custsale.c_acctbal ]
| ) [ custsale.cntrycode ] [ custsale.cntrycode, sys.count() NOT NULL as L1.L1, sys.sum no nil (custsale.c_acctbal) as L2.L2 ]
) [ custsale.cntrycode, L1 as L3.numcust, L2 as L3.totacctbal ]
"""

# the paths no plan above reaches at SF10 (chip_smoke.py's phase 4 shows
# each taken).  lineitem joined, in PLAN_Q17's decorrelated form, with its
# own per-l_shipdate average of l_quantity, the rows above it counted and
# their price summed by l_returnflag: the build side holds one row per ship day
# (2,374 at SF10) over a key domain below SMALL_TABLE, so the join takes the
# dense-domain path although its probe keys do not ascend
PLAN_DENSE_JOIN = """project (
| group by (
| | join (
| | | table(sys.lineitem) [ lineitem.l_shipdate NOT NULL, lineitem.l_quantity NOT NULL, lineitem.l_extendedprice NOT NULL, lineitem.l_returnflag NOT NULL ] COUNT,
| | | project (
| | | | group by (
| | | | | table(sys.lineitem) [ lineitem.l_shipdate NOT NULL as L1.l_shipdate, lineitem.l_quantity NOT NULL as L1.l_quantity ] COUNT
| | | | ) [ L1.l_shipdate ] [ L1.l_shipdate, sys.avg no nil (L1.l_quantity NOT NULL) as L2.L2 ]
| | | ) [ L1.l_shipdate as L3.l_shipdate, L2.L2 as L3.avg_qty ]
| | ) [ lineitem.l_shipdate NOT NULL = L3.l_shipdate, lineitem.l_quantity NOT NULL > L3.avg_qty ]
| ) [ lineitem.l_returnflag ] [ lineitem.l_returnflag, sys.count() NOT NULL as L4.L4, sys.sum no nil (lineitem.l_extendedprice NOT NULL) as L5.L5 ]
) [ lineitem.l_returnflag, L4 as L6.cnt, L5 as L6.sum_price ]
"""

# count(DISTINCT l_partkey) over every lineitem row by (l_returnflag,
# l_linestatus): a group domain of at most segred.SMALL_DOMAIN ids, so the
# distinct counts take the dense masked reductions
PLAN_DISTINCT_DENSE = """project (
| group by (
| | table(sys.lineitem) [ lineitem.l_returnflag NOT NULL, lineitem.l_linestatus NOT NULL, lineitem.l_partkey NOT NULL ] COUNT
| ) [ lineitem.l_returnflag, lineitem.l_linestatus ] [ lineitem.l_returnflag, lineitem.l_linestatus, sys.count unique no nil (lineitem.l_partkey) NOT NULL as L1.L1 ]
) [ lineitem.l_returnflag, lineitem.l_linestatus, L1 as L2.parts ]
"""

# count(DISTINCT l_extendedprice) by (l_orderkey, l_partkey) over the
# lineitems shipped in June 1995 (the filter becomes the fold's mask, so
# every row is sorted): the (group id, price) key needs more than 62 bits
# (a group domain of 2^45 times a price width of about 2^23.3 at SF10: 69
# bits), so the pairs take the two stable sorts
PLAN_DISTINCT_WIDE = """project (
| group by (
| | select (
| | | table(sys.lineitem) [ lineitem.l_orderkey NOT NULL, lineitem.l_partkey NOT NULL, lineitem.l_extendedprice NOT NULL, lineitem.l_shipdate NOT NULL ] COUNT
| | ) [ lineitem.l_shipdate NOT NULL >= date "1995-06-01", lineitem.l_shipdate NOT NULL < date "1995-07-01" ]
| ) [ lineitem.l_orderkey, lineitem.l_partkey ] [ lineitem.l_orderkey, lineitem.l_partkey, sys.count unique no nil (lineitem.l_extendedprice) NOT NULL as L1.L1 ]
) [ lineitem.l_orderkey, lineitem.l_partkey, L1 as L2.prices ]
"""

# TPC-H Q4 without its date window: every order with a late lineitem,
# counted per o_orderpriority; the semijoin marks orders through a scatter
# of all the late lineitems' positions (~63% of lineitem)
PLAN_Q4_ALL = """project (
| group by (
| | semijoin (
| | | table(sys.orders) [ orders.o_orderkey NOT NULL, orders.o_orderpriority NOT NULL ] COUNT,
| | | select (
| | | | table(sys.lineitem) [ lineitem.l_orderkey NOT NULL, lineitem.l_commitdate NOT NULL, lineitem.l_receiptdate NOT NULL ] COUNT
| | | ) [ lineitem.l_commitdate NOT NULL < lineitem.l_receiptdate NOT NULL ]
| | ) [ orders.o_orderkey NOT NULL = lineitem.l_orderkey NOT NULL ]
| ) [ orders.o_orderpriority ] [ orders.o_orderpriority, sys.count() NOT NULL as L1.order_count ]
) [ orders.o_orderpriority, L1.order_count ] [ orders.o_orderpriority ASC ]
"""

# the distributor's paths no plan above reaches at SF10 (chip_smoke.py's
# phase 8 shows each taken).  The lineitems shipped in 1994 joined on
# l_linenumber with the lines of the first orders (l_orderkey < 9, a few
# dozen rows), grouped by l_returnflag: a fact-frame partitioned shuffle
# join whose few keys each pair millions of left rows, so the heavy-key
# round takes the keys of the most lines out of the exchange and leaves the
# rarest ones to it
PLAN_HOT_JOIN = """project (
| group by (
| | join (
| | | select (
| | | | table(sys.lineitem) [ lineitem.l_linenumber NOT NULL, lineitem.l_quantity NOT NULL, lineitem.l_returnflag NOT NULL, lineitem.l_shipdate NOT NULL ] COUNT
| | | ) [ lineitem.l_shipdate NOT NULL >= date "1994-01-01", lineitem.l_shipdate NOT NULL < date "1995-01-01" ],
| | | select (
| | | | table(sys.lineitem) [ lineitem.l_linenumber NOT NULL as L1.l_linenumber, lineitem.l_orderkey NOT NULL as L1.l_orderkey, lineitem.l_extendedprice NOT NULL as L1.l_extendedprice ] COUNT
| | | ) [ L1.l_orderkey NOT NULL < int "9" ]
| | ) [ lineitem.l_linenumber NOT NULL = L1.l_linenumber NOT NULL ]
| ) [ lineitem.l_returnflag ] [ lineitem.l_returnflag, sys.count() NOT NULL as L2.L2, sys.sum no nil (lineitem.l_quantity NOT NULL) as L3.L3, sys.sum no nil (L1.l_extendedprice NOT NULL) as L4.L4 ]
) [ lineitem.l_returnflag, L2 as L5.cnt, L3 as L5.sum_lqty, L4 as L5.sum_rprice ]
"""

# TPC-H Q13's outer join (customer left outer join the orders whose comment
# is not like '%special%requests%') grouped by c_nationkey: a dense domain
# of 25, so the distributor shards orders as the right frame of a
# partitioned shuffle join (Q13 itself groups by c_custkey and goes sparse)
PLAN_Q13_NATION = """project (
| group by (
| | left outer join (
| | | table(sys.customer) [ customer.c_custkey NOT NULL, customer.c_nationkey NOT NULL ] COUNT,
| | | select (
| | | | table(sys.orders) [ orders.o_orderkey NOT NULL, orders.o_custkey NOT NULL, orders.o_comment NOT NULL ] COUNT
| | | ) [ orders.o_comment NOT NULL ! FILTER like (varchar[char(19) "%special%requests%"], varchar "") ]
| | ) [ customer.c_custkey NOT NULL = orders.o_custkey NOT NULL ]
| ) [ customer.c_nationkey ] [ customer.c_nationkey, sys.count no nil (orders.o_orderkey) as L1.L1, sys.count() NOT NULL as L2.L2 ]
) [ customer.c_nationkey, L1 as L3.n_orders, L2 as L3.n_rows ]
"""

Q1_COLUMNS = ["l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
              "sum_disc_price", "sum_charge", "avg_qty", "avg_price",
              "avg_disc", "count_order"]
FP_COLUMNS = ["l_orderkey", "l_quantity", "l_extendedprice", "l_discount"]
Q3_COLUMNS = ["l_orderkey", "revenue", "o_orderdate", "o_shippriority"]
Q5_COLUMNS = ["n_name", "revenue"]
SPARSE_COLUMNS = ["l_orderkey", "sum_qty", "first_ship", "max_qty", "n"]
Q9_COLUMNS = ["nation", "o_year", "sum_profit"]
Q13_COLUMNS = ["c_count", "custdist"]
Q17_COLUMNS = ["sum_price"]
SUBSTR_COLUMNS = ["cntrycode", "numcust", "totacctbal"]
Q4_COLUMNS = ["o_orderpriority", "order_count"]
Q16_COLUMNS = ["p_brand", "p_type", "p_size", "supplier_cnt"]
# every plan of chip_smoke.py's phase 4 under its file name for the
# command line (phase 6): Q1's three runs and the Q3 runs differ only by
# switches and by the ORDER BY ... LIMIT
CLI_PLANS = {"q6": PLAN_Q6, "q1": PLAN_Q1,
             "filter_project": PLAN_FILTER_PROJECT, "q3": PLAN_Q3,
             "q5": PLAN_Q5, "sparse_groupby": PLAN_SPARSE_GROUPBY,
             "q9": PLAN_Q9, "q13": PLAN_Q13, "q17": PLAN_Q17,
             "substr_groupby": PLAN_SUBSTR_GROUPBY, "q4": PLAN_Q4,
             "q3_top10": PLAN_Q3_TOP10, "q16": PLAN_Q16,
             "dense_join": PLAN_DENSE_JOIN,
             "distinct_dense": PLAN_DISTINCT_DENSE,
             "distinct_wide": PLAN_DISTINCT_WIDE, "q4_all": PLAN_Q4_ALL}
# the plans of chip_smoke.py's phase 8: the command line's, and three
# whose distributor paths none of them reaches at SF10: the self-join's
# partitioned shuffle join (Q13 and Q17 go sparse there and replicate their
# right sides), the hot join's heavy keys and the nation count's
# partitioned dimension table
AUTO_PLANS = {**CLI_PLANS, "self_join": PLAN_SELF_JOIN,
              "hot_join": PLAN_HOT_JOIN, "q13_nation": PLAN_Q13_NATION}
# the scale of the generated store when no --sf is given
CARD_SF = 10.0
# the plans of AUTO_PLANS that auto.distribute refuses at CARD_SF, each with
# the refusal's text; any other refusal, or another text, fails
# chip_smoke.py's phase 8.
# PLAN_DISTINCT_WIDE's (group, value) key needs 69 bits at SF10, and the
# distributed count(DISTINCT) composes it into one key of at most 64 (the
# JAX distributor's verdict at SF10's key widths, tests/test_torch_auto.py;
# below about SF1 it fits and the plan distributes)
EXPECTED_NOT_DISTRIBUTABLE = {
    "distinct_wide": "count(distinct): composite (group, values) key "
                     "exceeds the 64-bit budget"}
# the plans of AUTO_PLANS that chip_smoke.py's census (phase 9) leaves out,
# each with the reason
CENSUS_SKIP = {
    "hot_join": "the front end pulls both selects above the join, so the "
                "relational oracle pairs every lineitem row with every other "
                "of its l_linenumber before it filters: about n^2 / 5 pairs, "
                "7 * 10^12 at SF1; oracle_hot_join holds the plan in phase 8"}
# the plans of chip_smoke.py's phase 8 that must take a partitioned
# shuffle join, each with the text its describe() line must hold
AUTO_PATHS = {"self_join": "right=fact frame", "hot_join": "right=fact frame",
              "q13_nation": "right=orders OUTER"}
SELF_JOIN_COLUMNS = ["l_returnflag", "cnt", "sum_lqty", "sum_rprice"]
Q13_NATION_COLUMNS = ["c_nationkey", "n_orders", "n_rows"]
# chip_smoke.py's phase-4 runs of the paths no other phase-4 plan reaches
# at SF10, each shown taken: the dense-domain join, FDistinct's dense path
# and its two-sort fallback, and a repeated-position scatter over most of
# lineitem
DENSE_JOIN_RUN = "dense-domain join"
DISTINCT_DENSE_RUN = "count(DISTINCT) dense"
DISTINCT_WIDE_RUN = "count(DISTINCT) two-sort"
Q4_ALL_RUN = "Q4 all orders"
DENSE_JOIN_COLUMNS = ["l_returnflag", "cnt", "sum_price"]
DISTINCT_DENSE_COLUMNS = ["l_returnflag", "l_linestatus", "parts"]
DISTINCT_WIDE_COLUMNS = ["l_orderkey", "l_partkey", "prices"]


# ---------------------------------------------------------------- oracles
# Straightforward numpy versions of the FK-join plans.  They join through
# the primary keys with np.searchsorted, not through the store's %fk index
# columns, so they share nothing with the engine's join machinery.  Each
# returns the result columns (raw encoded integers) in the plan's order.
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


def oracle_sparse_groupby(st):
    import numpy as np

    c = lambda n: st.columns[("lineitem", n)]  # noqa: E731
    m = c("l_shipdate") >= _day(1995, 1, 1)
    qty = c("l_quantity")[m]
    return _group([c("l_orderkey")[m]],
                  [(qty, np.add), (c("l_shipdate")[m], np.minimum),
                   (qty, np.maximum), (np.ones(len(qty), np.int64), np.add)])


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


def oracle_self_join(st):
    """PLAN_SELF_JOIN: per order, the right side's matching rows and their
    price sum; each left row takes its order's."""
    import numpy as np

    c = lambda n: st.columns[("lineitem", n)]  # noqa: E731
    ok, flag = c("l_orderkey"), c("l_returnflag")
    qty = c("l_quantity").astype(np.int64)
    keep = qty < 1100
    dom = int(ok.max()) + 1
    cnt = np.bincount(ok[keep], minlength=dom)
    price = np.bincount(ok[keep], c("l_extendedprice")[keep].astype(np.float64),
                        minlength=dom)
    # float64 is exact per order (at most 7 rows of < 2^27 each); sum in int64
    price = price.astype(np.int64)
    flags = np.unique(flag)
    out = [[], [], [], []]
    for f in flags:
        m = flag == f
        n = cnt[ok[m]]
        if n.sum() == 0:
            continue
        out[0].append(f)
        out[1].append(n.sum())
        out[2].append((qty[m] * n).sum())
        out[3].append(price[ok[m]].sum())
    return [np.asarray(o, np.int64) for o in out]


def hot_join_sides(st):
    """PLAN_HOT_JOIN's two sides by key: the l_linenumber values ``keys``,
    then per key the right side's rows and their price sum, and per
    (l_returnflag, key) the left side's rows and their quantity sum
    (flags along the first axis, in ``flags``' order)."""
    import numpy as np

    c = lambda n: st.columns[("lineitem", n)]  # noqa: E731
    ship = c("l_shipdate")
    left = (ship >= _day(1994, 1, 1)) & (ship < _day(1995, 1, 1))
    right = c("l_orderkey") < 9
    line = c("l_linenumber")
    keys = np.unique(line)
    lk = np.searchsorted(keys, line[left])
    rk = np.searchsorted(keys, line[right])
    rc = np.bincount(rk, minlength=len(keys))
    rp = np.bincount(rk, c("l_extendedprice")[right].astype(np.float64),
                     minlength=len(keys)).astype(np.int64)
    flags, fi = np.unique(c("l_returnflag")[left], return_inverse=True)
    cell = fi.reshape(-1) * len(keys) + lk
    size = len(flags) * len(keys)
    lc = np.bincount(cell, minlength=size).reshape(len(flags), len(keys))
    # float64 sums are exact: each is below 2^53 at SF10 (at most ~10M
    # rows of quantity < 2^13)
    lq = np.bincount(cell, c("l_quantity")[left].astype(np.float64),
                     minlength=size).astype(np.int64).reshape(lc.shape)
    return dict(keys=keys, rc=rc, rp=rp, flags=flags, lc=lc, lq=lq)


def oracle_hot_join(st):
    """PLAN_HOT_JOIN by key, with no expansion: a left row of key k pairs
    with the rc[k] right rows of k, so count = sum_k lc[f, k] * rc[k], the
    quantity sum sum_k lq[f, k] * rc[k] and the price sum
    sum_k lc[f, k] * rp[k]; flags with no pair are absent."""
    import numpy as np

    s = hot_join_sides(st)
    cnt, lqty, rprice = s["lc"] @ s["rc"], s["lq"] @ s["rc"], s["lc"] @ s["rp"]
    keep = cnt > 0
    return [np.asarray(a, np.int64)[keep]
            for a in (s["flags"], cnt, lqty, rprice)]


def oracle_q13_nation(st):
    """PLAN_Q13_NATION: each customer's orders whose comment is not like
    '%special%requests%', summed by nation; a customer with no order is one
    row of no order."""
    import numpy as np

    c = lambda t, n: st.columns[(t, n)]  # noqa: E731
    special = _codes_matching(st, "orders", "o_comment", "special.*requests")
    keep = ~np.isin(c("orders", "o_comment"), special)
    ckeys = c("customer", "c_custkey")
    ci, cfound = _pk_lookup(ckeys, c("orders", "o_custkey")[keep])
    per_cust = np.bincount(ci[cfound], minlength=len(ckeys))
    return _group([c("customer", "c_nationkey")],
                  [(per_cust, np.add), (np.maximum(per_cust, 1), np.add)])


def _by_order(cols, spec):
    """The rows of ``cols`` sorted by ``spec``, (column, descending) pairs
    with the first the major key; ties keep their order."""
    import numpy as np

    keys = [-np.asarray(cols[i], np.int64) if desc
            else np.asarray(cols[i], np.int64) for i, desc in spec]
    order = np.lexsort(keys[::-1])
    return [np.asarray(c)[order] for c in cols]


def _q4(st, window):
    """The orders (of the o_orderdate ``window``, if any) with a late
    lineitem, counted per o_orderpriority in the order of its codes."""
    import numpy as np

    c = lambda t, n: st.columns[(t, n)]  # noqa: E731
    late = c("lineitem", "l_commitdate") < c("lineitem", "l_receiptdate")
    oi, ofound = _pk_lookup(c("orders", "o_orderkey"),
                            c("lineitem", "l_orderkey")[late])
    m = np.zeros(len(c("orders", "o_orderkey")), bool)
    m[oi[ofound]] = True
    if window is not None:
        odate = c("orders", "o_orderdate")
        m &= (odate >= window[0]) & (odate < window[1])
    # _group's keys ascend: the order of o_orderpriority's codes
    return _group([c("orders", "o_orderpriority")[m]],
                  [(np.ones(int(m.sum()), np.int64), np.add)])


def oracle_q4(st):
    return _q4(st, (_day(1993, 7, 1), _day(1993, 10, 1)))


def oracle_q4_all(st):
    return _q4(st, None)


def oracle_dense_join(st):
    """PLAN_DENSE_JOIN: each row against its ship day's average quantity
    (sum // count in l_quantity's scale)."""
    import numpy as np

    c = lambda n: st.columns[("lineitem", n)]  # noqa: E731
    qty = c("l_quantity").astype(np.int64)
    _, day = np.unique(c("l_shipdate"), return_inverse=True)
    day = day.reshape(-1)
    # float64 sums are exact: a day holds far fewer than 2^53 / 5000 rows
    sums = np.bincount(day, qty.astype(np.float64)).astype(np.int64)
    avg = sums // np.bincount(day)
    keep = qty > avg[day]
    return _group([c("l_returnflag")[keep]],
                  [(np.ones(int(keep.sum()), np.int64), np.add),
                   (c("l_extendedprice")[keep], np.add)])


def _distinct_counts(keys, vals):
    """Per distinct key tuple (ascending), the count of distinct values:
    the (keys, value) rows sorted, as one packed int64 key where their
    ranges fit 62 bits."""
    import numpy as np

    cols = [np.asarray(k, np.int64) for k in keys] + [
        np.asarray(vals, np.int64)]
    n = len(cols[0])
    lo = [int(c.min()) if n else 0 for c in cols]
    bits = [int(c.max()) - b if n else 0 for c, b in zip(cols, lo)]
    bits = [b.bit_length() for b in bits]
    if sum(bits) <= 62:
        key = np.zeros(n, np.int64)
        for c, b, w in zip(cols, lo, bits):
            key = (key << w) | (c - b)
        order = np.argsort(key, kind="stable")
    else:
        order = np.lexsort(cols[::-1])
    s = [c[order] for c in cols]
    fresh = np.zeros(n, bool)
    fresh[:1] = True
    for c in s:
        fresh[1:] |= c[1:] != c[:-1]
    return _group(s[:-1], [(fresh.astype(np.int64), np.add)])


def oracle_distinct_dense(st):
    c = lambda n: st.columns[("lineitem", n)]  # noqa: E731
    return _distinct_counts([c("l_returnflag"), c("l_linestatus")],
                            c("l_partkey"))


def oracle_distinct_wide(st):
    c = lambda n: st.columns[("lineitem", n)]  # noqa: E731
    ship = c("l_shipdate")
    m = (ship >= _day(1995, 6, 1)) & (ship < _day(1995, 7, 1))
    return _distinct_counts([c("l_orderkey")[m], c("l_partkey")[m]],
                            c("l_extendedprice")[m])


def q3_top10(q3):
    """Q3's rows (``oracle_q3``) ordered by revenue descending, then
    o_orderdate; the first 10 (rows tied at the cut may be any of them)."""
    return [col[:10] for col in _by_order(q3, [(1, True), (2, False)])]


def oracle_q3_top10(st):
    return q3_top10(oracle_q3(st))


def oracle_q16(st):
    import numpy as np

    c = lambda t, n: st.columns[(t, n)]  # noqa: E731
    ok = ((c("part", "p_brand") != _code(st, "part", "p_brand", "Brand#45"))
          & ~np.isin(c("part", "p_type"), _codes_matching(
              st, "part", "p_type", "^MEDIUM POLISHED"))
          & np.isin(c("part", "p_size"), [49, 14, 23, 45, 19, 3, 36, 9]))
    pi, pfound = _pk_lookup(c("part", "p_partkey"),
                            c("partsupp", "ps_partkey"))
    complaints = c("supplier", "s_suppkey")[np.isin(
        c("supplier", "s_comment"),
        _codes_matching(st, "supplier", "s_comment", "Customer.*Complaints"))]
    sk = c("partsupp", "ps_suppkey")
    m = pfound & ok[pi] & ~np.isin(sk, complaints)
    pi = pi[m]
    # the distinct (brand, type, size, supplier) rows, then a count of them
    # per (brand, type, size)
    keys = [c("part", "p_brand")[pi], c("part", "p_type")[pi],
            c("part", "p_size")[pi], sk[m]]
    distinct = _group(keys, [])
    cols = _group(distinct[:3], [(np.ones(len(distinct[0]), np.int64),
                                  np.add)])
    return _by_order(cols, [(3, True), (0, False), (1, False), (2, False)])


def substr_codes(st, tab, col, start, length):
    """substring(col, start, length)'s derived dictionary code of each code
    of ``tab.col``: the rank of its substring among the distinct substrings
    of the column's dictionary."""
    dec = st.decoders[(tab, col)]
    sub = {code: v[start - 1:start - 1 + length] for code, v in dec.items()}
    rank = {v: i for i, v in enumerate(sorted(set(sub.values())))}
    return {code: rank[v] for code, v in sub.items()}, sorted(rank)


def oracle_substr_groupby(st):
    import numpy as np

    c = lambda n: st.columns[("customer", n)]  # noqa: E731
    derived, _ = substr_codes(st, "customer", "c_phone", 1, 2)
    lut = np.zeros(max(derived) + 1, np.int64)
    lut[list(derived)] = list(derived.values())
    cc = lut[c("c_phone")]
    return _group([cc], [(np.ones(len(cc), np.int64), np.add),
                         (c("c_acctbal"), np.add)])


def oracle_shuffle_groupby(st):
    """``oracle_sparse_groupby``'s five columns (the same groups, by the
    same code), then sum, min and max of ``l_extendedprice`` per group."""
    import numpy as np

    c = lambda n: st.columns[("lineitem", n)]  # noqa: E731
    m = c("l_shipdate") >= _day(1995, 1, 1)
    qty, price = c("l_quantity")[m], c("l_extendedprice")[m]
    return _group([c("l_orderkey")[m]],
                  [(qty, np.add), (c("l_shipdate")[m], np.minimum),
                   (qty, np.maximum), (np.ones(len(qty), np.int64), np.add),
                   (price, np.add), (price, np.minimum),
                   (price, np.maximum)])


# ------------------------- distribution primitives (chip_smoke.py phase 7)
# DistQuery's arguments, the single copy tests/torch_dist_cases.py imports:
# the operator lambdas of tests/test_parallel.py, which run on JAX and
# torch arrays alike
DIST_Q6_COLUMNS = ["l_shipdate", "l_discount", "l_quantity",
                   "l_extendedprice"]
DIST_Q1_COLUMNS = ["l_shipdate", "l_returnflag", "l_linestatus",
                   "l_quantity", "l_extendedprice"]


def dist_q6_query():
    """TPC-H Q6 as one group: revenue = sum(l_extendedprice * l_discount)
    over the shipdate, discount and quantity window."""
    d94, d95 = _day(1994, 1, 1), _day(1995, 1, 1)
    return dict(
        domain=1,
        mask_fn=lambda c: ((c["l_shipdate"] >= d94)
                           & (c["l_shipdate"] < d95)
                           & (c["l_discount"] >= 5) & (c["l_discount"] <= 7)
                           & (c["l_quantity"] < 2400)),
        key_fn=lambda c: c["l_shipdate"] * 0,
        agg_fns={"revenue": lambda c: c["l_extendedprice"]
                 * c["l_discount"]})


def dist_q1_query(cols):
    """The Q1 group-by over (returnflag, linestatus): sum of quantity and
    of extendedprice, rows per group (``__count``)."""
    cutoff = _day(1998, 12, 1) - 90
    nls = int(cols["l_linestatus"].max()) + 1
    return dict(
        domain=int(cols["l_returnflag"].max() + 1) * nls,
        mask_fn=lambda c: c["l_shipdate"] <= cutoff,
        key_fn=lambda c: c["l_returnflag"] * nls + c["l_linestatus"],
        agg_fns={"sum_qty": lambda c: c["l_quantity"],
                 "sum_base_price": lambda c: c["l_extendedprice"]})


# ------------------------------------------------------ scatter cases
# numpy (id, pos, src, L) cases of the monotone scatter, which
# tests/test_torch_kernels.py runs on the CPU and chip_smoke.py on the card
def scatter_cases():
    """The cases of tests/test_scatter_kernel.py."""
    import numpy as np

    out = []
    for seed in (0, 1):
        for density in (0.02, 0.3, 0.9, 1.0):
            rng = np.random.default_rng(seed)
            L = int(rng.integers(2000, 40000))
            pos = np.flatnonzero(rng.random(L) < density).astype(np.int32)
            src = rng.integers(1, 2**20, len(pos)).astype(np.int32)
            out.append((f"random-{density}-{seed}", pos, src, L))
    L = 3 * 8192
    spreads = [
        np.array([0, 1], np.int32),
        np.arange(100, dtype=np.int32) * 200,
        np.concatenate([np.arange(50), L - 50 + np.arange(50)]
                       ).astype(np.int32),
        np.array([8191, 8192], np.int32),
        np.array([8190, 8191, 8192, 8193, 16383, 16384], np.int32),
    ]
    rng = np.random.default_rng(9)
    for i, pos in enumerate(spreads):
        src = rng.integers(1, 1000, len(pos)).astype(np.int32)
        out.append((f"spread-{i}", pos, src, L))
    out.append(("lsb-first-counterexample", np.array([1, 3], np.int32),
                np.array([7, 9], np.int32), L))
    out.append(("invalid-tail", np.array([5, 17, 9000, 10000, 10000, 10000],
                                         np.int32),
                np.arange(1, 7, dtype=np.int32), 10000))
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        L = int(rng.integers(8192 + 1, 8192 * 4 - 1))
        n_valid = int(rng.integers(100, 4000))
        pos_valid = np.sort(rng.choice(L, n_valid, replace=False))
        n_invalid = int(rng.integers(2, 12000))
        pos = np.concatenate([pos_valid, np.full(n_invalid, L)]
                             ).astype(np.int32)
        src = rng.integers(1, 2**20, len(pos)).astype(np.int32)
        out.append((f"invalid-cluster-at-L-{seed}", pos, src, L))
    out.append(("valid-past-L", np.array([5, 9000, 10500, 12000, 16383,
                                          16385], np.int32),
                np.arange(1, 7, dtype=np.int32), 10000))
    rng = np.random.default_rng(3)
    L = 9000
    pos = np.sort(rng.choice(L, 500, replace=False)).astype(np.int32)
    out.append(("int64", pos, rng.integers(-2**60, 2**60, 500)
                .astype(np.int64), L))
    L = 16384
    out.append(("identity", np.arange(L, dtype=np.int32),
                np.arange(L, dtype=np.int32) * 3 + 1, L))
    return out


def scatter_edge_cases(tile, chunk):
    """Cases at the edges of scatter.cu's design: its output tiles of
    ``tile`` slots and its walk's chunks of ``chunk`` rows, over 3 tiles
    and a 100-slot tail tile."""
    import numpy as np

    T, C = tile, chunk
    L = 3 * T + 100
    rng = np.random.default_rng(11)
    cases = {
        "tile-edges": [T - 1, T, T + 1, 2 * T - 1, 2 * T, 3 * T - 1, 3 * T,
                       L - 1],
        "run-ends-on-tile-last-slot": np.arange(T - 300, T),
        "run-ends-on-tile-last-slot-then-next": np.r_[np.arange(T - 300, T),
                                                      2 * T + 7],
        "chunk-exact": T + np.arange(C) * 4,
        "chunk-plus-one": T + np.arange(C + 1) * 3,
        "two-chunks-exact": T + np.arange(2 * C) * 2,
        "full-tile": np.r_[np.arange(T, 2 * T), 2 * T + 5],
        "full-tile-minus-one": np.r_[np.arange(T, 2 * T - 1), 2 * T + 5],
        "full-output": np.arange(L),
        "tail-tile-only": [3 * T, 3 * T + 50, L - 1, L, L],
        "first-slot-only": [0, L, L + 9],
        "last-slot-only": [L - 1],
        "all-invalid": np.full(3000, L),
        "sparse-over-tiles": np.sort(rng.choice(L, 40, replace=False)),
    }
    out = []
    for name, pos in cases.items():
        pos = np.asarray(pos, np.int32)
        src = rng.integers(1, 2**30, len(pos)).astype(np.int32)
        out.append((f"edge-{name}", pos, src, L))
    return out


def probe_contract_cases():
    """numpy cases (name, op, a, rhs, params) of the probes' contractions
    at the edges of probes.cu's design: ``fma_contract`` in each rhs mode at
    each accumulator width (n = 1, 5, 9, 17, 32), a depth off the 256-row
    tile and three batch items; ``mma_contract`` with 32 planes and 32
    groups at the row-wise depth bound 2^15 with every byte 255 (each
    warp's int32 cell near 2^31, four groups of warps and the largest
    shared buffer), one-hot keys over 196 steps with keys outside the
    groups, the one-mask mode, and 16 one-step batch items."""
    import numpy as np

    rng = np.random.default_rng(5)

    def ints(shape, lo, hi):
        return rng.integers(lo, hi, shape).astype(np.int32)

    out = []
    batch, m, k = 3, 2, 1000
    for mode in range(4):
        for n in (1, 5, 9, 17, 32):
            rhs = (ints((batch, n, k), 0, 2) if mode <= 1
                   else ints((batch, k), -1, n + 1))
            out.append((f"fma mode {mode} n {n}", "fma",
                        ints((batch, m, k), 0, 1 << 12), rhs,
                        dict(m=m, n=n, k=k, mode=mode, key=1, batch=batch)))
    k = 1 << 15
    a = ints((2, 8, k), 0, 2**31 - 1)
    a[0] = 2**31 - 1
    rhs = ints((2, 32, k), 0, 256)
    rhs[0] = 255
    out += [("mma rows 32x32 at 2^15 bytes 255", "mma", a, rhs,
             dict(nlimb=4, m=8, n=32, k=k, mode=0, key=0, batch=2)),
            ("mma one-hot over 196 steps", "mma",
             ints((2, 3, 100_000), 0, 1 << 24), ints((2, 100_000), -1, 22),
             dict(nlimb=3, m=3, n=20, k=100_000, mode=2, key=0, batch=2)),
            ("mma key", "mma", ints((4, 5, 777), 0, 1 << 16),
             ints((4, 777), 0, 9),
             dict(nlimb=2, m=5, n=3, k=777, mode=3, key=7, batch=4)),
            ("mma 16 one-step items", "mma", ints((16, 1, 128), 0, 1000),
             ints((16, 128), 0, 4),
             dict(nlimb=2, m=1, n=4, k=128, mode=2, key=0, batch=16))]
    return out


def same_rows(got, want) -> bool:
    """Whether two column lists hold the same rows, in any order."""
    import numpy as np

    got = [np.asarray(g, np.int64) for g in got]
    want = [np.asarray(w, np.int64) for w in want]
    if len(got) != len(want) or any(len(g) != len(want[0])
                                    for g in got + want):
        return False
    go, wo = np.lexsort(got[::-1]), np.lexsort(want[::-1])
    return all(np.array_equal(g[go], w[wo]) for g, w in zip(got, want))


def write_metadata(store, directory: str) -> None:
    """Writes the four metadata files that ``compile``, ``explain`` and
    ``genplans`` read, for ``store``: ``bounds.csv``, ``storage.csv`` and
    ``dictionary.csv`` hold the rows ``ColumnStore.make_catalog`` builds
    from the data, and ``schema.msqldump`` is DDL that
    ``fe.schema_parser.from_file`` reads back as the store's tables.  Test
    support for the command line; the engine builds its catalog from the
    store itself."""
    import csv

    from mplan2vdl_tpu_torch.engine import nativeio
    from mplan2vdl_tpu_torch.names import concat_name

    declared = {concat_name(t.name, cn): ts for t in store.tables
                for cn, ts in t.columns}
    bounds, storage = [], []
    for (tab, col), data in store.columns.items():
        mn, mx, tz, n = nativeio.column_stats(data)
        bounds.append((tab, col, mn, mx, n, tz))
        ts = declared.get((tab, col))
        typ = "oid" if ts is None else ts.tname.lower()
        storage.append(("sys", tab, col, typ, "", n, 8, 8 * n, 0, 0, 0,
                        "false"))
    # the primary keys' row-id pseudo-columns
    for t in store.tables:
        tab, pk = t.name[0], t.pkey.constraint[0]
        n = store.table_count(t.name)
        bounds.append((tab, pk, 0, max(n - 1, 0), n, 0))
        storage.append(("sys", tab, pk, "oid", "", n, 8, 8 * n, 0, 0, 0,
                        "false"))
    dictrows = [(tab, col, s, code)
                for (tab, col), dec in store.decoders.items()
                for code, s in dec.items()]
    os.makedirs(directory, exist_ok=True)
    for name, rows in (("bounds.csv", bounds), ("storage.csv", storage),
                       ("dictionary.csv", dictrows)):
        with open(os.path.join(directory, name), "w", newline="") as f:
            csv.writer(f).writerows(rows)

    def q(name):
        return ".".join(f'"{part}"' for part in name)

    def cols(names):
        return ", ".join(q(c) for c in names)

    ddl = ['SET SCHEMA "sys";']
    for t in store.tables:
        body = []
        for cn, ts in t.columns:
            params = (f"({', '.join(str(x) for x in ts.tparams)})"
                      if ts.tparams else "")
            body.append(f"\t{q(cn)} {ts.tname}{params} NOT NULL")
        body.append(f"\tCONSTRAINT {q(t.pkey.constraint)} PRIMARY KEY "
                    f"({cols(t.pkey.cols)})")
        for fk in t.fkeys:
            body.append(
                f"\tCONSTRAINT {q(fk.constraint)} FOREIGN KEY "
                f"({cols(a for a, _ in fk.colmap)}) REFERENCES "
                f'"sys".{q(fk.references)} ({cols(b for _, b in fk.colmap)})')
        ddl.append(f'CREATE TABLE "sys".{q(t.name)} (\n'
                   + ",\n".join(body) + "\n);")
    with open(os.path.join(directory, "schema.msqldump"), "w") as f:
        f.write("\n".join(ddl) + "\n")


def csv_rows(text: str):
    """The header and the rows (lists of strings) of ``run``'s CSV."""
    lines = text.rstrip("\n").split("\n")
    return lines[0].split(","), [ln.split(",") for ln in lines[1:]]


def q16_sql_order(rows) -> bool:
    """Whether decoded Q16 rows (brand, type, size, count) follow its ORDER
    BY supplier_cnt DESC, p_brand, p_type, p_size over the strings: the
    order of a store whose codes ascend with their strings (``from_tbl``'s
    sorted dictionaries)."""
    keys = [(-int(c), b, t, int(sz)) for b, t, sz, c in rows]
    return keys == sorted(keys)
