"""Drives the PyTorch/CUDA port (``mplan2vdl_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--sf 10] [--seed 1] [--out FILE] [--profile DIR]
        [--old-lib FILE]

Phases (any failure ends the run with a nonzero exit; nothing is caught):
  1. the card (``nvidia-smi`` name and power limit) and the torch, CUDA,
     nvcc and driver versions;
  2. builds the CUDA kernels from ``mplan2vdl_tpu_torch/engine/kernels/csrc``;
  3. holds each kernel exactly equal to its plain PyTorch version on the
     card, at the shapes of a TPC-H store of the chosen scale (lineitem
     rows, orders slots, dimension tables; the compaction also at its tile
     size +-1, with one true row first or last, a zero tail, and over 50
     calls in a row on masks of changing length, and shown to reuse its
     scratch with no fill per call; the fused aggregate on both of its
     paths, with every row in one group, 16 and 17 groups, 13 specs and
     fewer rows than a block; the tensor-core aggregate on both of its
     paths, with negative and too-large group ids, row counts that are no
     step multiple, unaligned views, 16, 17 and 37 groups, 12 and 13 specs,
     values near the bits bound, and one block (and one warp) over every
     row; the scatter over every case of the CPU tests, the edges of its
     tiles and chunks, 2%, 15% and 100% of an orders-sized table, one row,
     no valid row, L = 0, and a few rows into just over 2^31 slots; the
     digit rank at every width from 1 to 8 bits over random, all-equal,
     ascending and alternating keys and keys whose digit changes at each
     warp's run; the gather over both dtype groups full and mixed, a
     split into two launches, 1, 3 and 5 rows and a ragged last tile,
     position and source views off any alignment, consecutive positions,
     a random permutation, valid = 0 on the host and on the device, and a
     one-row source; the expression fold on Q6's call as the engine makes
     it, over every row, 1,000,003 rows and unaligned views, also equal to
     the library expression, and on the 30 random programs of
     tests/torch_exprfold_cases.py at both counts), and times kernel,
     plain version and library
     yardstick with CUDA events (the scatter at 2%, 15% and 100%; the
     gather at the engine's shapes (a)-(f) of tools/bench_gather.py, with
     the bytes counted in 32-byte sectors beside the byte bound);
  4. drives the port end to end through ``plan_to_vexps`` +
     ``CompiledQuery`` on ``cuda``: TPC-H Q6, Q1 (fused by the automatic
     gate, with its sums on the tensor cores by MPLAN2VDL_MXU_AGG=1, and
     with MPLAN2VDL_FUSED_AGG=0), a lineitem scan-filter-project, the
     FK-join path: TPC-H Q3 (no-order form), Q5 and a sparse group-by over
     l_orderkey, then the general-join path: TPC-H Q9 (no-order form, a
     LIKE), Q13 (a left outer join), Q17 (MonetDB's decorrelated form, a
     join against a derived table) and a group-by over substring(c_phone,
     1, 2) (a dictionary recode), then the ordered path: TPC-H Q4 (a
     semijoin that marks orders through a scatter of repeated positions,
     ORDER BY), Q3 with its ORDER BY revenue DESC, o_orderdate LIMIT 10,
     and Q16 (LIKE, an antijoin, count(DISTINCT), a four-key ORDER BY),
     then four plans of the paths no other plan reaches at SF10: a
     dense-domain join (PLAN_DENSE_JOIN), count(DISTINCT) on its dense
     path (PLAN_DISTINCT_DENSE) and on its two-sort fallback
     (PLAN_DISTINCT_WIDE), and a repeated-position scatter over most of
     lineitem (PLAN_Q4_ALL), each with a spy that must see its path taken
     (one ``{"path": ...}`` line each); last, a hand-built VIR DAG of the
     one node no plan emits, ``Semisort`` over sum(l_quantity) per
     l_orderkey (a buffer with padding past its valid rows), which must
     equal the stable argsort of the whole buffer on the host (its own
     ``{"path": "Semisort"}`` line).
     Each run is row-exact against its oracle (Q4, Q4 over all orders and
     Q16 in order, Q3's top 10 tie-tolerantly), and the engine kernels'
     launch counters are
     read around it (Q6 and every Q1 run must compact; Q6 launches the
     expression fold once and no Q1 run launches it; the fused Q1 runs
     launch the fused aggregate once; the general-join runs launch the
     compaction and both gathers between them; each ordered run launches
     the compaction, the gather and the scatter); the shape of each engine
     scatter is printed, Q4's repeated-position scatter with its count of
     distinct positions, and each equijoin's side, path (dense or merge),
     sizes and host syncs; a ``{"gather_census": ...}`` line groups every
     gather.cu launch by k, dtypes, m, n and the order of its positions;
     ``--profile`` adds each engine kernel's device time per query (the
     device total counts kernels only, not the launch ranges' device-side
     spans) and each census class's device time; ``--old-lib FILE`` (an
     older ``engine/kernels/_lib.py``) also times each run with that
     file's launch path and the checkout's in turns (old, new, new, old;
     one ``lib_ab`` per query record, and a line with the sums);
  5. the probes: ``tools.probe_kernels`` (every pattern probe OK) and
     ``tools.probe_radix`` at its default sizes and the lineitem row count
     rounded up to a block, with the launch counters of the two probe
     kernels read around them; each probe kernel, and the contraction
     kernels on ``probe_contract_cases`` (every rhs mode and accumulator
     width, the tensor-core variant at its depth bound with four groups of
     warps), exactly equal to its plain version; under torch.profiler,
     one device kernel per probe call; then (``tools/bench_probes.py``)
     each probe's device and host microseconds beside its library
     expression's, and the probes, their plain versions, their library
     expressions and an empty launch through the same path timed in 5
     interleaved turns after a warm-up turn: the medians, each turn's
     share of the launch bound (one pass's launches at the empty launch's
     time), and the probes slower than their library expression;
  6. the command line, each command in its own process: ``genplans`` of
     the seventeen plans of phase 4 (``CLI_PLANS``) against metadata files of
     the store (``write_metadata``) must compile all of them, and
     ``compile``, ``compile --dot`` and ``explain`` of each must print a
     program (no device); ``run`` of Q5 on the card at the chosen scale,
     with ``--roofline --hbm-gbps 3350`` and ``--profile``, must be
     row-exact, report scan bytes and an amplification of at least 1, and
     leave a trace that names the ``m2v_compact``, ``m2v_gather``,
     ``m2v_scatter`` and ``m2v_small_gather`` launches and their kernels;
     ``run --tbl --decode`` of Q1 and Q16 over .tbl files written from a
     TBL_SF store must give ``run --decode``'s rows of the generated store
     (Q16 in its ORDER BY over the strings); ``run --devices 2`` without
     ``--cpu`` on fewer than two cards must exit nonzero with the "only N
     device(s)" message and print no rows;
  7. the distribution primitives (``parallel/``) at world size 1 over
     NCCL on the card (``multihost.initialize`` on a free localhost port),
     over the phase-3 store: ``DistQuery`` Q6 and the Q1 group-by against
     ``oracle/tpch``, ``ShuffleGroupBy`` over ``l_orderkey`` with
     ``l_shipdate >= 1995-01-01`` (sum/min/max of ``l_quantity``,
     ``l_shipdate`` and ``l_extendedprice``, and the rows per group)
     against ``oracle_shuffle_groupby`` (whose first five columns must be
     ``oracle_sparse_groupby``'s), and ``ShuffleJoin`` of ``l_orderkey``
     against ``o_orderkey`` (every count 1, every payload the order's row
     by ``_pk_lookup``); one timed JSON line per cell (median of 5 warm
     calls, the peak GB, the bucket capacities, the card).  No engine
     kernel runs there (the counters are read around the phase);
  8. the plan distributor (``parallel/auto.py``) in the same world: each of
     the seventeen ``CLI_PLANS`` and three plans of the partitioned
     shuffle join (``AUTO_PLANS``): a lineitem self-join, the hot join
     (PLAN_HOT_JOIN, whose heavy-key round must find heavy keys and leave
     light ones) and Q13's outer join by nation (PLAN_Q13_NATION, orders
     as a partitioned right frame), each through ``auto.distribute``
     (set-up timed: the join's counting rounds; a ``NotDistributable``
     fails the phase unless ``EXPECTED_NOT_DISTRIBUTABLE`` names the
     plan), one cold call held row-exact against the plan's oracle, then
     3 warm calls; one ``{"auto": ...}`` line each with its ``describe()``
     lines (a partitioned join's capacities among them), each partitioned
     join's heavy keys and capacities, the cold and warm times beside the
     plan's phase-4 (or single-device) median, the peak GB and the engine
     kernels' launches over its calls (``--profile`` traces one more warm
     call of each).  The phase must launch the compaction and the gather
     kernels (the shard-local engine path runs the ported kernels);
  9. the plan census (tests/torch_census_cases.py) over a store of scale
     CENSUS_SF = 1, cut from SF10 because its oracle runs in numpy on the
     host: the JAX package's CPU census (40 fuzz plans, run three times:
     with the default gate, MPLAN2VDL_FUSED_AGG=1, and MPLAN2VDL_MXU_AGG=1
     besides; their 40 ordered forms; 7 null-semantics plans; 5 join
     corners; 2 semi/anti joins with an extra condition; 2 count(DISTINCT)
     plans) and the plans of phase 8 (AUTO_PLANS) but CENSUS_SKIP's, each
     through
     ``passes.engine_passes(vir.vexps_from_mplan(...))`` + ``CompiledQuery``
     on the card and held against the port's relational oracle
     (``oracle/relinterp.py``, computed once a plan in spawned worker
     processes; the ordered family in order), the null plans against
     SQLite, the count(DISTINCT) plans also against a numpy distinct count;
     one ``{"census": ...}`` line per family (plans, rows out, engine and
     oracle seconds, launches, the card); the phase must launch every
     engine kernel.
Each phase's seconds are printed as it ends (``{"phase_s": ...}``).
The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device
the script exits nonzero and prints no result.  The plan texts and the
numpy oracles below are the single copy the tests import.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

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

# the paths no plan above reaches at SF10 (phase 4 shows each taken with a
# spy).  lineitem joined, in PLAN_Q17's decorrelated form, with its own
# per-l_shipdate average of l_quantity, the rows above it counted and their
# price summed by l_returnflag: the build side holds one row per ship day
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

# the distributor's paths no plan above reaches at SF10 (phase 8 shows each
# taken).  The lineitems shipped in 1994 joined on l_linenumber with the
# lines of the first orders (l_orderkey < 9, a few dozen rows), grouped by
# l_returnflag: a fact-frame partitioned shuffle join whose few keys each
# pair millions of left rows, so the heavy-key round takes the keys of the
# most lines out of the exchange and leaves the rarest ones to it
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

# timed launches per kernel (after two warm-up launches)
REPS = 20
# phase 5: interleaved turns of the probes, calls a turn, and host-clock calls
PROBE_TURNS, PROBE_REPS, PROBE_HOST_CALLS = 5, 200, 10_000

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12

# the TPU kernels each CUDA kernel replaces (JAX package, file:line)
KERNELS = {
    "compact": dict(source="mplan2vdl_tpu_torch/engine/kernels/csrc/compact.cu",
                    replaces="mplan2vdl_tpu/engine/kernels/compact.py:176"),
    "gather": dict(source="mplan2vdl_tpu_torch/engine/kernels/csrc/gather.cu",
                   replaces="mplan2vdl_tpu/engine/kernels/sorted_gather.py:297"
                            " + mplan2vdl_tpu/engine/kernels/sorted_gather.py:507"),
    "multiagg": dict(source="mplan2vdl_tpu_torch/engine/kernels/csrc/multiagg.cu",
                     replaces="mplan2vdl_tpu/engine/kernels/multiagg.py:252"),
    "scatter": dict(source="mplan2vdl_tpu_torch/engine/kernels/csrc/scatter.cu",
                    replaces="mplan2vdl_tpu/engine/kernels/scatter.py:236"),
    "small_gather": dict(
        source="mplan2vdl_tpu_torch/engine/kernels/csrc/small_gather.cu",
        replaces="mplan2vdl_tpu/engine/kernels/sorted_gather.py:243"
                 " + mplan2vdl_tpu/engine/kernels/sorted_gather.py:507"),
    "multiagg_mxu": dict(
        source="mplan2vdl_tpu_torch/engine/kernels/csrc/multiagg_mxu.cu",
        replaces="mplan2vdl_tpu/engine/kernels/multiagg_mxu.py:196"),
    "radix_rank": dict(
        source="mplan2vdl_tpu_torch/engine/kernels/csrc/radix_rank.cu",
        replaces="tools/probe_radix.py:65"),
    "probes": dict(source="mplan2vdl_tpu_torch/engine/kernels/csrc/probes.cu",
                   replaces="tools/probe_mosaic.py:39"),
    "exprfold": dict(
        source="mplan2vdl_tpu_torch/engine/kernels/csrc/exprfold.cu",
        replaces="none: XLA's loop fusion of a one-group fold's tree"),
}

# the wrapper module and counter attribute of each kernel's launches: the
# engine kernels, counted over the query runs ...
COUNTERS = {"compact": ("compact", "launches"),
            "gather": ("sorted_gather", "launches"),
            "multiagg": ("multiagg", "launches"),
            "scatter": ("scatter", "launches"),
            "small_gather": ("sorted_gather", "small_launches"),
            "multiagg_mxu": ("multiagg_mxu", "launches"),
            "exprfold": ("exprfold", "launches")}
# ... and the probe kernels, counted over the probe tools' runs
PROBE_COUNTERS = {"radix_rank": ("radix_rank", "launches"),
                  "probes": ("probes", "launches")}

Q1_MXU = "Q1 fused MXU (MPLAN2VDL_MXU_AGG=1)"
Q3_COLUMNS = ["l_orderkey", "revenue", "o_orderdate", "o_shippriority"]
Q5_COLUMNS = ["n_name", "revenue"]
SPARSE_COLUMNS = ["l_orderkey", "sum_qty", "first_ship", "max_qty", "n"]
Q9_COLUMNS = ["nation", "o_year", "sum_profit"]
Q13_COLUMNS = ["c_count", "custdist"]
Q17_COLUMNS = ["sum_price"]
SUBSTR_COLUMNS = ["cntrycode", "numcust", "totacctbal"]
Q4_COLUMNS = ["o_orderpriority", "order_count"]
Q16_COLUMNS = ["p_brand", "p_type", "p_size", "supplier_cnt"]
# every plan of phase 4 under its file name for the command line (phase 6):
# Q1's three runs and the Q3 runs differ only by switches and by the ORDER
# BY ... LIMIT
CLI_PLANS = {"q6": PLAN_Q6, "q1": PLAN_Q1,
             "filter_project": PLAN_FILTER_PROJECT, "q3": PLAN_Q3,
             "q5": PLAN_Q5, "sparse_groupby": PLAN_SPARSE_GROUPBY,
             "q9": PLAN_Q9, "q13": PLAN_Q13, "q17": PLAN_Q17,
             "substr_groupby": PLAN_SUBSTR_GROUPBY, "q4": PLAN_Q4,
             "q3_top10": PLAN_Q3_TOP10, "q16": PLAN_Q16,
             "dense_join": PLAN_DENSE_JOIN,
             "distinct_dense": PLAN_DISTINCT_DENSE,
             "distinct_wide": PLAN_DISTINCT_WIDE, "q4_all": PLAN_Q4_ALL}
# the plans of phase 8: the command line's, and three whose distributor
# paths none of them reaches at SF10: the self-join's partitioned shuffle
# join (Q13 and Q17 go sparse there and replicate their right sides), the
# hot join's heavy keys and the nation count's partitioned dimension table
AUTO_PLANS = {**CLI_PLANS, "self_join": PLAN_SELF_JOIN,
              "hot_join": PLAN_HOT_JOIN, "q13_nation": PLAN_Q13_NATION}
# the scale of the generated store when no --sf is given
CARD_SF = 10.0
# the plans of AUTO_PLANS that auto.distribute refuses at CARD_SF, each with
# the refusal's text; any other refusal, or another text, fails phase 8.
# PLAN_DISTINCT_WIDE's (group, value) key needs 69 bits at SF10, and the
# distributed count(DISTINCT) composes it into one key of at most 64 (the
# JAX distributor's verdict at SF10's key widths, tests/test_torch_auto.py;
# below about SF1 it fits and the plan distributes)
EXPECTED_NOT_DISTRIBUTABLE = {
    "distinct_wide": "count(distinct): composite (group, values) key "
                     "exceeds the 64-bit budget"}
# the plans of AUTO_PLANS that the census (phase 9) leaves out, each with
# the reason
CENSUS_SKIP = {
    "hot_join": "the front end pulls both selects above the join, so the "
                "relational oracle pairs every lineitem row with every other "
                "of its l_linenumber before it filters: about n^2 / 5 pairs, "
                "7 * 10^12 at SF1; oracle_hot_join holds the plan in phase 8"}
# the plans of phase 8 that must take a partitioned shuffle join, each with
# the text its describe() line must hold
AUTO_PATHS = {"self_join": "right=fact frame", "hot_join": "right=fact frame",
              "q13_nation": "right=orders OUTER"}
SELF_JOIN_COLUMNS = ["l_returnflag", "cnt", "sum_lqty", "sum_rprice"]
Q13_NATION_COLUMNS = ["c_nationkey", "n_orders", "n_rows"]
# the phase-4 runs of the paths no other phase-4 plan reaches at SF10, each
# shown taken by a spy: the dense-domain join, FDistinct's dense path and its
# two-sort fallback, and a repeated-position scatter over most of lineitem
DENSE_JOIN_RUN = "dense-domain join"
DISTINCT_DENSE_RUN = "count(DISTINCT) dense"
DISTINCT_WIDE_RUN = "count(DISTINCT) two-sort"
Q4_ALL_RUN = "Q4 all orders"
# phase 4's run of a hand-built VIR DAG: Semisort, which no plan emits
SEMISORT_RUN = "Semisort"
# each of CLI_PLANS under its phase-4 run's name (phase 8 prints that run's
# single-device median beside its own)
AUTO_PHASE4 = {"q6": "Q6", "q1": "Q1 fused (auto gate)",
               "filter_project": "filter-project", "q3": "Q3", "q5": "Q5",
               "sparse_groupby": "sparse group-by", "q9": "Q9",
               "q13": "Q13", "q17": "Q17",
               "substr_groupby": "substring group-by", "q4": "Q4",
               "q3_top10": "Q3 top 10", "q16": "Q16",
               "dense_join": DENSE_JOIN_RUN,
               "distinct_dense": DISTINCT_DENSE_RUN,
               "distinct_wide": DISTINCT_WIDE_RUN, "q4_all": Q4_ALL_RUN}
# (below the fused gate's rows, phase 4's Q1 run under the gate is unfused)
AUTO_PHASE4_SMALL = {"q1": "Q1 (auto gate: unfused)"}
# the C entry points of Q5's kernel launches, which its profiler trace must
# name beside their kernels
Q5_ENTRIES = {"m2v_compact": "compact", "m2v_gather": "gather",
              "m2v_scatter": "scatter", "m2v_small_gather": "small_gather"}
# the scale of the --tbl runs: the ingest parses text in Python loops, and
# SF10's .tbl text is about 10 GB
TBL_SF = 0.1
REPO = os.path.dirname(os.path.abspath(__file__))
# phase 9: the JAX package's CPU plan census (tests/torch_census_cases.py)
# on the card, held against the port's relational oracle.  Its store is SF1
# (lineitem 6,001,215 rows), not SF10: the oracle runs on the host in numpy,
# and its group-bys (np.unique over the key rows, np.add.at folds) take tens
# of seconds a plan over SF10's 60M rows, too long for ~100 plans in one run
CENSUS_SF = 1.0
CENSUS_CUT = ("SF1, not SF10: the numpy oracle takes tens of seconds a plan "
              "over SF10's 60M lineitem rows, too long for ~100 plans")
# the fuzz plans' three passes: (family line, MPLAN2VDL_FUSED_AGG,
# MPLAN2VDL_MXU_AGG); the default gate leaves SF1 unfused
FUZZ_PASSES = (("fuzz", None, None), ("fuzz_fused", "1", None),
               ("fuzz_mxu", "1", "1"))
# what each family is held against besides the row count
CENSUS_REFERENCE = {"fuzz": "relinterp", "ordered": "relinterp, in order",
                    "null": "sqlite", "corners": "relinterp",
                    "semi_anti": "relinterp",
                    "distinct": "relinterp and a numpy distinct count",
                    "tpch": "relinterp"}
# worker processes computing the census oracles while the card runs
CENSUS_WORKERS = 6
DENSE_JOIN_COLUMNS = ["l_returnflag", "cnt", "sum_price"]
DISTINCT_DENSE_COLUMNS = ["l_returnflag", "l_linestatus", "parts"]
DISTINCT_WIDE_COLUMNS = ["l_orderkey", "l_partkey", "prices"]
# the query runs of the general-join slice, and the engine kernels they
# must launch between them
JOIN_RUNS = ("Q9", "Q13", "Q17", "substring group-by")
JOIN_KERNELS = ("compact", "gather", "small_gather")
# the engine kernels each ordered run (ORDER BY, top N, the
# repeated-position scatter, count(DISTINCT)) must launch
ORDERED_KERNELS = ("compact", "gather", "scatter")


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


# ------------------------------------------ distribution primitives (7)
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
# numpy (id, pos, src, L) cases of the monotone scatter, the single copy
# tests/test_torch_kernels.py imports
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


def _sh(cmd):
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def _bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# the functions of engine/kernels/_lib.py that every kernel launch goes
# through (``--old-lib`` swaps them for an older file's)
LAUNCH_PATH = ("lib", "call", "check", "stream", "ptrs", "ints")


def load_old_lib(path: str):
    """An older ``_lib.py`` as a module of its own, bound to the
    checkout's built library (built by phase 2, so it builds nothing)."""
    import importlib.util

    from mplan2vdl_tpu_torch.engine.kernels import _lib

    spec = importlib.util.spec_from_file_location("m2v_old_lib", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.CSRC, mod.BUILD_DIR, mod.LIB_PATH = (_lib.CSRC, _lib.BUILD_DIR,
                                             _lib.LIB_PATH)
    mod._SIGNATURES = {k: v for k, v in mod._SIGNATURES.items()
                       if k in _lib._SIGNATURES}
    mod.lib()
    return mod


# the CUDA function names of each engine kernel, as the profiler reports
# them (a name must not follow an identifier character: small_gather_kernel
# is not gather_kernel)
KERNEL_FUNCTIONS = {"compact": ("compact_kernel",),
                    "gather": ("gather_kernel",),
                    "multiagg": ("lane_kernel", "shared_kernel"),
                    "scatter": ("scatter_kernel",),
                    "small_gather": ("small_gather_kernel",),
                    "multiagg_mxu": ("mxu_kernel", "fast_kernel"),
                    "exprfold": ("expr_fold_kernel",)}


# Itanium-mangled template argument types of the kernels
MANGLED_TYPES = {"i": "int", "x": "long long", "l": "long", "j": "unsigned",
                 "h": "unsigned char", "b": "bool"}


def _template_args(mangled: str) -> str:
    """``Li2ELi1Ei`` -> ``2,1,int``: the template arguments of a mangled
    kernel name (integer and bool literals, builtin types)."""
    import re

    args = []
    for lit, ty in re.findall(r"L[ib](\d+)E|([a-z])", mangled):
        args.append(lit if lit else MANGLED_TYPES.get(ty, ty))
    return ",".join(args)


def _engine_kernel(key: str):
    """The engine kernel whose CUDA function a profiler entry names, or
    None."""
    import re

    for k, fns in KERNEL_FUNCTIONS.items():
        if any(re.search(rf"(?<![A-Za-z0-9_]){f}\b", key) for f in fns):
            return k
    return None


def _dev_us(e) -> float:
    """Device microseconds of a torch.profiler key-average entry."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def gather_shape(srcs, pos):
    """(k, source dtypes, position dtype, m, n) of a gather."""
    return (len(srcs), "/".join(str(s.dtype)[6:] for s in srcs),
            str(pos.dtype)[6:], pos.shape[0], srcs[0].shape[0])


def gather_class(srcs, pos, valid):
    """The census class of a gather: its ``gather_shape`` and the order of
    the valid positions (consecutive, ascending or unordered).  Reads the
    positions back to the host."""
    m = pos.shape[0]
    v = max(min(int(valid), m), 0)
    d = pos[1:v].long() - pos[:max(v - 1, 0)].long()
    order = ("consecutive" if bool((d == 1).all())
             else "ascending" if bool((d >= 0).all()) else "unordered")
    return gather_shape(srcs, pos) + (order,)


def kernel_counters(spec=None):
    """``spec`` (default ``COUNTERS``) with each wrapper module imported:
    kernel name -> (module, counter attribute)."""
    import importlib

    return {k: (importlib.import_module(
        f"mplan2vdl_tpu_torch.engine.kernels.{mod}"), attr)
        for k, (mod, attr) in (spec or COUNTERS).items()}


def part_joins(dq):
    """Each partitioned shuffle join of a distributed plan ``dq``: its
    right frame, whether it is outer, its pair count and, from the
    heavy-key round (``caps["heavy"]``), the heavy keys with their exact
    build-row and pair capacities."""
    import torch

    from mplan2vdl_tpu_torch.parallel.shuffle_join import key_sents

    out = []
    for pj in dq.part_joins.values():
        caps = pj["caps"] or {}
        heavy = caps.get("heavy")
        big = key_sents(torch.int32 if pj.get("k32") else torch.int64)[0]
        keys = [int(k) for k in heavy["hk"] if k != big] if heavy else []
        out.append({"right": pj["table"] or "fact frame",
                    "outer": bool(pj["outer"]), "pairs": caps.get("total"),
                    "n_heavy": len(keys), "heavy_keys": keys,
                    "cap_hb": heavy["cap_hb"] if heavy else None,
                    "cap_hp": heavy["cap_hp"] if heavy else None})
    return out


class Smoke:
    def __init__(self, args):
        import torch

        self.torch = torch
        self.args = args
        self.dev = torch.device("cuda")
        self.records = {"kernel_checks": [], "kernel_times": [],
                        "queries": [], "dist": []}

    # ----------------------------------------------------------- utilities
    def sync(self):
        self.torch.cuda.synchronize()

    def cuda_ms(self, fn, reps):
        """Mean ms per call over ``reps`` calls, timed with CUDA events
        after two warm-up calls."""
        torch = self.torch
        for _ in range(2):
            fn()
        self.sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def equal(self, what, got, want):
        torch = self.torch
        got = got if isinstance(got, (list, tuple)) else [got]
        want = want if isinstance(want, (list, tuple)) else [want]
        err = 0
        for g, w in zip(got, want, strict=True):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{what}: {g.dtype}{tuple(g.shape)} vs "
                                     f"plain {w.dtype}{tuple(w.shape)}")
            g, w = g.reshape(-1), w.reshape(-1)
            for a in range(0, g.numel(), 1 << 27):  # bounded temporaries
                err = max(err, int((g[a:a + (1 << 27)].to(torch.int64)
                                    - w[a:a + (1 << 27)].to(torch.int64))
                                   .abs().max()))
        self.sync()
        print(json.dumps({"check": what, "max_abs_err": err}), flush=True)
        self.records["kernel_checks"].append({"check": what,
                                              "max_abs_err": err})
        if err != 0:
            raise AssertionError(f"{what}: kernel differs from plain "
                                 f"version (max abs err {err})")
        return err

    def oracle(self, fn, *args):
        """``fn(*args)``, its seconds printed as an ``{"oracle": ...}``
        line."""
        t0 = time.perf_counter()
        out = fn(*args)
        print(json.dumps({"oracle": fn.__name__,
                          "s": time.perf_counter() - t0}), flush=True)
        return out

    def tpch_want(self, name):
        """``oracle/tpch``'s Q6 or Q1 result over the store, computed once
        (Q1 takes over a minute at SF10) for phases 4 and 7."""
        from mplan2vdl_tpu_torch.oracle import tpch

        cache = self.__dict__.setdefault("_tpch_want", {})
        if name not in cache:
            cache[name] = self.oracle(getattr(tpch, name), self.st)
        return cache[name]

    # -------------------------------------------------------------- phases
    def card(self):
        torch = self.torch
        self.smi = _sh(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"]).splitlines()[0]
        driver = _sh(["nvidia-smi", "--query-gpu=driver_version",
                      "--format=csv,noheader"]).splitlines()[0]
        from mplan2vdl_tpu_torch.engine.kernels import _lib

        nvcc = _sh([_lib.nvcc(), "--version"]).splitlines()[-1]
        print(self.smi, flush=True)
        print(json.dumps({"torch": torch.__version__,
                          "cuda": torch.version.cuda, "nvcc": nvcc,
                          "driver": driver, "python": sys.version.split()[0],
                          "device": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()}), flush=True)

    def build(self):
        from mplan2vdl_tpu_torch.engine.kernels import _lib

        import re

        secs = _lib.build()
        _lib.lib()
        for src, out in _lib.build_info["ptxas"].items():
            fn = ""  # the kernel ptxas reports on, as name<template args>
            for ln in out.splitlines():
                m = re.search(r"entry function '[^']*?\d([a-z][a-z_]*_kernel)"
                              r"(?:I((?:L[ib]\d+E|[a-z])+)E)?", ln)
                if m:
                    fn = m[1] + (f"<{_template_args(m[2])}>" if m[2] else "")
                if "Used" in ln or "spill" in ln:
                    print(f"ptxas {src} {fn}: {ln.strip()}", flush=True)
        print(json.dumps({"build_s": secs}), flush=True)

    def store(self):
        from mplan2vdl_tpu_torch.engine import datagen

        t0 = time.perf_counter()
        self.st = datagen.generate(sf=self.args.sf, seed=self.args.seed)
        t1 = time.perf_counter()
        self.cfg = self.st.make_catalog()
        self.n = len(self.st.columns[("lineitem", "l_orderkey")])
        self.n_orders = len(self.st.columns[("orders", "o_orderkey")])
        print(json.dumps({"datagen_s": t1 - t0,
                          "catalog_s": time.perf_counter() - t1,
                          "sf": self.args.sf, "lineitem_rows": self.n}),
              flush=True)

    def col(self, name):
        import numpy as np

        return self.torch.from_numpy(np.require(
            self.st.columns[("lineitem", name)],
            requirements=["C", "W"])).to(self.dev)

    def kernel_phase(self):
        torch = self.torch
        from mplan2vdl_tpu_torch.engine.kernels import compact, multiagg
        from mplan2vdl_tpu_torch.engine.kernels import sorted_gather as sg
        from mplan2vdl_tpu_torch.oracle.tpch import day

        reps = REPS
        ship, disc, qty = (self.col("l_shipdate"), self.col("l_discount"),
                           self.col("l_quantity"))
        n = ship.shape[0]
        m159 = (ship >= day(1994, 1, 1)) & (ship < day(1995, 1, 1))
        m19 = m159 & (disc >= 5) & (disc <= 7) & (qty < 2400)
        # Q1's shipdate cut keeps every row of this generator's lineitem;
        # hash the row index for a mask of Q1's TPC-H density instead
        rows = torch.arange(n, device=self.dev)
        m986 = (rows * 2654435761 % 1000) < 986
        cnt = {k: int(m.sum()) for k, m in
               (("1.9%", m19), ("15.9%", m159), ("98.6%", m986))}
        print(json.dumps({"densities": {k: v / n for k, v in cnt.items()}}),
              flush=True)
        self.max_err = {k: 0 for k in KERNELS}
        self.timed = {}

        # ---- compaction
        def cmp_case(what, mask, n_out=None):
            got = compact.compact_positions(mask, n_out)
            want = compact.compact_positions_plain(mask, n_out)
            e = self.equal(f"compact {what}", got, want)
            self.max_err["compact"] = max(self.max_err["compact"], e)

        for k, m in (("1.9%", m19), ("15.9%", m159), ("98.6%", m986)):
            cmp_case(f"density {k} n_out=count", m, max(cnt[k], 1))
            cmp_case(f"density {k} n_out=n", m)
        cmp_case("all-false", torch.zeros(n, dtype=torch.bool,
                                          device=self.dev))
        cmp_case("all-true", torch.ones(n, dtype=torch.bool, device=self.dev))
        odd = 4096 * max(n // 8192, 1) + 77
        cmp_case(f"n={odd} (not a block multiple)", m159[:odd])
        cmp_case("n_out trimmed to half the count", m159, cnt["15.9%"] // 2)
        cmp_case("unaligned view", m159[3:])
        cmp_case("n=1", m159[:1])
        tile = compact.TILE
        one = torch.zeros(n, dtype=torch.bool, device=self.dev)
        one[5] = True
        cmp_case("single true row in the first tile", one)
        one[5], one[n - 1] = False, True
        cmp_case("single true row in the last row", one)
        for k in (tile - 1, tile, tile + 1):
            cmp_case(f"n={k} (tile {tile} {k - tile:+d})", m159[:k])
        cmp_case("n_out = count + 100000 (zero tail)", m159,
                 cnt["15.9%"] + 100_000)
        # many calls in a row on masks of changing length: stale tickets,
        # status words or epochs would show here
        gen = torch.Generator(device=self.dev).manual_seed(self.args.seed + 3)
        for i in range(50):
            k = int(torch.randint(1, min(n, 3 * tile * (i + 1)) + 1, (1,),
                                  generator=gen, device=self.dev))
            m = torch.rand(k, generator=gen, device=self.dev) < (i % 10) / 9
            got = compact.compact_positions(m, k // (1 + i % 3))
            want = compact.compact_positions_plain(m, k // (1 + i % 3))
            if not torch.equal(got, want):
                raise AssertionError(f"compact: call {i} of 50 (n={k}) "
                                     "differs from the plain version")
        self.equal("compact 50 calls in a row, changing n", got, want)
        del one

        # no fill per call: once the look-back scratch exists, calls reuse
        # it (tickets and epochs advance), so a call is the one kernel that
        # m2v_compact launches.  (A profiler session here once left the
        # later --profile tables short of kernel records.)
        c159 = cnt["15.9%"]
        compact.compact_positions(m159, c159)
        key = (self.dev.index or 0, torch.cuda.current_stream().cuda_stream)
        state, buf = compact._scratch[key]
        epoch, ptr = state.epoch, buf.data_ptr()
        for _ in range(3):
            compact.compact_positions(m159, c159)
        state, buf = compact._scratch[key]
        if (state.epoch, buf.data_ptr()) != (epoch + 3, ptr):
            raise AssertionError("compact: the look-back scratch was "
                                 "allocated again between calls")
        print(json.dumps({"compact scratch reused, epoch": state.epoch}),
              flush=True)

        for k, m in (("15.9%", m159), ("1.9%", m19), ("98.6%", m986)):
            c = cnt[k]
            compact.launches = 0
            ms = self.cuda_ms(lambda: compact.compact_positions(m, c), reps)
            timed_launches = compact.launches
            plain_ms = self.cuda_ms(
                lambda: compact.compact_positions_plain(m, c), 3)
            lib_ms = self.cuda_ms(lambda: torch.nonzero(m), reps)
            self.kernel_time("compact" if k == "15.9%" else f"compact {k}",
                             f"mask bool[{n}] {k} -> int32[{c}]", ms,
                             plain_ms, lib_ms, _bound_ms(n + 4 * c),
                             timed_launches)

        # ---- gather
        from mplan2vdl_tpu_torch.engine.kernels import _lib
        from mplan2vdl_tpu_torch.tools import bench_gather

        pos = compact.compact_positions(m159, c159)
        names = ["l_orderkey", "l_quantity", "l_extendedprice", "l_discount"]
        srcs = [self.col(c) for c in names]
        wide = (srcs[2].to(torch.int64) << 33) - srcs[0].to(torch.int64)

        def g_case(what, ss, p, valid):
            got = sg.gather_many(ss, p, valid)
            want = sg.gather_many_plain(ss, p, valid)
            # rows past valid are unspecified to callers but equal here
            e = self.equal(f"gather {what}", got, want)
            self.max_err["gather"] = max(self.max_err["gather"], e)

        g_case("k=4 int32", srcs, pos, c159)
        g_case("k=1 int32", srcs[:1], pos, c159)
        g_case("k=1 int64", [wide], pos, c159)
        g_case("k=4 mixed int32/int64", [srcs[0], wide, srcs[2], wide], pos,
               c159)
        g_case("k=9 (two launches)", srcs * 2 + [wide], pos, c159)
        tail = pos.clone()
        tail[c159 // 2:] = 0
        g_case("masked tail, host valid", srcs, tail, c159 // 2)
        g_case("masked tail, device valid", srcs, tail,
               torch.tensor(c159 // 2, device=self.dev))
        dup = torch.repeat_interleave(pos[: c159 // 2], 2)
        g_case("duplicate positions", srcs, dup, dup.shape[0])
        g_case("int64 positions", srcs, pos.to(torch.int64), c159)
        # the kernel's paths: each dtype group full, both groups in one
        # launch, tiny m and a ragged last tile, position and source views
        # off any alignment, consecutive runs, a permutation, the tail
        # repeat from row 0, a one-row source
        wides = [wide + j for j in range(8)]
        g_case("k=8 int64", wides, pos, c159)
        g_case("k=9 int64 (two launches)", wides + [wide], pos, c159)
        g_case("k=8 mixed 4 int32 + 4 int64", srcs + wides[:4], pos, c159)
        for m in (1, 3, 5):
            g_case(f"m={m}", [srcs[0], wide], pos[:m], m)
        ragged = max(c159 // 1024 * 1024 - 347, 1)
        g_case(f"m={ragged} (a ragged last tile)", [srcs[0], wide],
               pos[:ragged], ragged)
        for off in (1, 2, 3):
            g_case(f"pos[{off}:] int32 view", [srcs[0], wide], pos[off:],
                   c159 - off)
        g_case("pos[1:] int64 view", [srcs[0], wide], pos.to(torch.int64)[1:],
               c159 - 1)
        g_case("source views [1:] (unaligned)", [srcs[0][1:], wide[1:]], pos,
               c159)
        ident = torch.arange(n, dtype=torch.int32, device=self.dev)
        g_case("identity positions k=3 int64/int64/int32", [wide, wides[1],
                                                            srcs[1]], ident, n)
        g_case("identity positions from 1 (a view)", [wide, srcs[1]],
               ident[1:], n - 1)
        g_case("identity positions, source views [1:]", [srcs[1][1:],
                                                         wide[1:]],
               ident[:n - 1], n - 1)
        gen = torch.Generator(device=self.dev).manual_seed(self.args.seed + 5)
        perm = torch.randperm(n, generator=gen, device=self.dev).to(
            torch.int32)
        g_case("random permutation", [srcs[0], wide], perm, n)
        g_case("valid=0, host", [srcs[0], wide], pos, 0)
        g_case("valid=0, device", [srcs[0], wide], pos,
               torch.tensor(0, device=self.dev))
        g_case("n=1", [srcs[0][:1], wide[:1]], pos, c159)
        del tail, dup, wides, ident, perm

        # the engine's shapes (a)-(f) (bench_gather.shapes): the kernel, its
        # plain version, torch.index_select, the byte bound and the bytes
        # counted in 32-byte sectors; (b) and (a) keep their names of
        # earlier runs
        cols = {c: self.col(c) for c in bench_gather.COLUMNS}
        rename = {"a": "gather k=1", "b": "gather"}
        for sh in bench_gather.shapes(cols, self.args.seed):
            ss, p, valid = sh.build()
            g_case(f"({sh.tag}) {sh.what}", ss, p, valid)
            sg.launches = 0
            ms = self.cuda_ms(lambda: sg.gather_many(ss, p, valid), reps)
            timed_launches = sg.launches
            plain_ms = self.cuda_ms(
                lambda: sg.gather_many_plain(ss, p, valid), reps)
            posl = p.long()
            lib_ms = self.cuda_ms(
                lambda: [torch.index_select(s, 0, posl) for s in ss], reps)
            self.kernel_time(
                rename.get(sh.tag, f"gather ({sh.tag})"),
                f"({sh.tag}) {sh.what}: k={len(ss)} "
                f"{'/'.join(str(s.dtype)[6:] for s in ss)}[{ss[0].shape[0]}] "
                f"at {str(p.dtype)[6:]}[{p.shape[0]}]", ms, plain_ms, lib_ms,
                _bound_ms(bench_gather.byte_count(ss, p)), timed_launches,
                sector_ms=_bound_ms(
                    bench_gather.sector_count(ss, p, valid)),
                blocks_per_sm=bench_gather.blocks_per_sm(_lib.lib(), ss, p))
            del ss, p, posl
        del cols

        # ---- fused aggregate
        from mplan2vdl_tpu_torch.engine.lower import CompiledQuery, \
            plan_to_vexps

        os.environ["MPLAN2VDL_FUSED_AGG"] = "1"
        try:
            fam = CompiledQuery(self.cfg, plan_to_vexps(PLAN_Q1, self.cfg),
                                self.st, device="cuda").families[0]
        finally:
            os.environ.pop("MPLAN2VDL_FUSED_AGG")
        specs = list(fam.specs) + [multiagg.AggSpec(base=None, bits=1)]
        cols = [self.col(nm[1]).to(torch.int32) for nm in fam.load_names]
        rf, ls = self.col("l_returnflag"), self.col("l_linestatus")
        gid = torch.where(ship <= day(1998, 9, 2), rf * 2 + ls,
                          -1).to(torch.int32)

        def a_case(what, cs, g, sp, groups):
            path = ("lane" if multiagg.lane_path(groups, len(sp))
                    else "shared")
            got = multiagg.fused_group_aggregate(cs, g, sp, groups)
            want = multiagg.reference_group_aggregate(cs, g, sp, groups)
            e = self.equal(f"multiagg {what} ({path})", got, want)
            self.max_err["multiagg"] = max(self.max_err["multiagg"], e)
            return path

        a_case(f"Q1 specs n={n}", cols, gid, specs, fam.domain)
        gneg = gid.clone()
        gneg[::7] = -5
        a_case("negative gid rows", cols, gneg, specs, fam.domain)
        odd = min(1_000_003, n)
        a_case(f"n={odd} (not a block multiple)", [c[:odd] for c in cols],
               gid[:odd], specs, fam.domain)
        nb = 150_001
        big = torch.full((nb,), 2**31 - 1, dtype=torch.int32, device=self.dev)
        zero = torch.zeros(nb, dtype=torch.int32, device=self.dev)
        near = [multiagg.AggSpec(base=0, factors=((100, -1, 1), (100, 1, 1)),
                                 bits=45),
                multiagg.AggSpec(base=0, bits=31, op="max"),
                multiagg.AggSpec(base=None, bits=1)]
        a_case("values near the bits bound", [big, zero],
               torch.zeros(nb, dtype=torch.int32, device=self.dev), near, 1)
        paths = set()
        g0 = torch.where(gid >= 0, 0, -1).to(torch.int32)
        paths.add(a_case("every row in one group", cols, g0, specs,
                         fam.domain))
        g16 = (rows * 2654435761 % 16).to(torch.int32)
        paths.add(a_case("16 groups x Q1's specs", cols, g16, specs, 16))
        g17 = (rows * 2654435761 % 17).to(torch.int32)
        paths.add(a_case("17 groups", cols, g17, specs, 17))
        many = specs + specs[:multiagg.LANE_MAX_SPECS + 1 - len(specs)]
        paths.add(a_case(f"{len(many)} specs", cols, gid, many, fam.domain))
        for k in (3, 100, 1000):
            paths.add(a_case(f"n={k} (below one block)", [c[:k] for c in cols],
                             gid[:k], specs, fam.domain))
        unaligned = [c[1:] for c in cols]
        paths.add(a_case("unaligned views", unaligned, gid[1:], specs,
                         fam.domain))
        if paths != {"lane", "shared"}:
            raise AssertionError(f"multiagg checked only {paths}")
        del g0, unaligned

        multiagg.launches = 0
        ms = self.cuda_ms(lambda: multiagg.fused_group_aggregate(
            cols, gid, specs, fam.domain), reps)
        timed_launches = multiagg.launches
        plain_ms = self.cuda_ms(lambda: multiagg.reference_group_aggregate(
            cols, gid, specs, fam.domain), 2)
        self.kernel_time("multiagg", f"{len(specs)} Q1 specs x "
                         f"{fam.domain} groups over {len(cols)} int32[{n}] "
                         "columns + int32 gid", ms, plain_ms, None,
                         _bound_ms(4 * (len(cols) + 1) * n), timed_launches)
        # the fast path's largest engine family, and the general path
        for groups, g in ((16, g16), (17, g17)):
            ms = self.cuda_ms(lambda: multiagg.fused_group_aggregate(
                cols, g, specs, groups), reps)
            path = "lane" if multiagg.lane_path(groups, len(specs)) \
                else "shared"
            self.kernel_time(f"multiagg {groups} groups ({path})",
                             f"{len(specs)} Q1 specs x {groups} groups, "
                             "hashed row ids", ms, None, None,
                             _bound_ms(4 * (len(cols) + 1) * n), None)
        del g16, g17

        self.scatter_kernel()
        self.small_gather_kernel()
        self.mxu_kernel(fam, cols, gid)
        self.radix_kernel()
        self.exprfold_kernel(m19)

    def mxu_kernel(self, fam, cols, gid):
        """The tensor-core aggregate on Q1's sum specs (the family's sums
        and the appended count, as the engine routes them), and its corner
        cases on both of its paths; both paths timed beside multiagg.cu on
        the same specs."""
        torch = self.torch
        from mplan2vdl_tpu_torch.engine.kernels import multiagg
        from mplan2vdl_tpu_torch.engine.kernels import multiagg_mxu as mx

        Spec = multiagg.AggSpec
        n = gid.shape[0]
        specs = [s for s in fam.specs if s.op == "sum"] + [
            Spec(base=None, bits=1)]
        used = {i for s in specs for i in
                ([] if s.base is None else [s.base])
                + [f[2] for f in s.factors]}
        rows = torch.arange(n, device=self.dev)

        def path(sp, groups):
            return "fast" if mx.fast_path(groups, sp) else "general"

        def x_case(what, cs, g, sp, groups, **kw):
            got = mx.fused_group_aggregate_mxu(cs, g, sp, groups, **kw)
            want = mx.fused_group_aggregate_mxu_plain(cs, g, sp, groups)
            e = self.equal(f"multiagg_mxu {what} ({path(sp, groups)})", got,
                           want)
            self.max_err["multiagg_mxu"] = max(self.max_err["multiagg_mxu"],
                                               e)
            return path(sp, groups)

        paths = set()
        x_case(f"Q1 {len(specs)} sum specs n={n}", cols, gid, specs,
               fam.domain)
        gneg = gid.clone()
        gneg[::7] = -5
        gneg[3::7] = fam.domain  # past the last group: skipped too
        x_case("negative and too-large gid rows", cols, gneg, specs,
               fam.domain)
        del gneg
        # neither a multiple of 4 rows nor of a 128-row warp step
        for k in (min(1_000_003, n), min(128 * 1000 + 77, n), 3, 100):
            x_case(f"n={k} (not a step multiple)", [c[:k] for c in cols],
                   gid[:k], specs, fam.domain)
        x_case("unaligned views", [c[1:] for c in cols], gid[1:], specs,
               fam.domain)
        g16 = (rows * 2654435761 % 16).to(torch.int32)
        g17 = (rows * 2654435761 % 17).to(torch.int32)
        paths.add(x_case("16 groups", cols, g16, specs, 16))
        paths.add(x_case("17 groups", cols, g17, specs, 17))
        g37 = (rows * 2654435761 % 37).to(torch.int32)
        paths.add(x_case("37 groups (several group tiles)", cols, g37, specs,
                         37))
        del g37
        for k in (mx.FAST_MAX_SPECS, mx.FAST_MAX_SPECS + 1):
            many = (specs * 2)[:k]
            paths.add(x_case(f"{k} sum specs", cols, gid, many, fam.domain))
        # as tests/test_multiagg_mxu.py: base 2^31-1 times 1 + 32766, bits
        # 46; 100,003 rows keep every total below 2^63
        nb = min(100_003, n)
        big = torch.full((nb,), 2**31 - 1, dtype=torch.int32, device=self.dev)
        fac = torch.full((nb,), 32766, dtype=torch.int32, device=self.dev)
        near = [Spec(base=0, bits=31),
                Spec(base=0, factors=((1, 1, 1),), bits=46)]
        for groups in (3, 17):
            paths.add(x_case(f"values near the bits bound, {groups} groups",
                             [big, fac], (rows[:nb] % groups).to(torch.int32),
                             near, groups))
        # one block over every row, every byte plane 255: without the int32
        # flush a cell would pass 2^31 after 2^23 rows of a warp (one warp
        # takes them all) or of a block (the general path)
        full = [torch.full((n,), v, dtype=torch.int32, device=self.dev)
                for v in (2**16 - 1, 2**16, 2**24 - 1)]
        ff = [Spec(base=None, factors=((255, 0, 0),), bits=8),
              Spec(base=0, bits=16),
              Spec(base=2, bits=24),
              Spec(base=0, factors=((1, 1, 1),), bits=32)]  # 2^32 - 1
        zero = torch.zeros(n, dtype=torch.int32, device=self.dev)
        x_case(f"one block over {n} rows, every plane 255", full, zero, ff,
               1, max_blocks=1)
        x_case(f"one warp over {n} rows, every plane 255", full, zero, ff, 1,
               max_blocks=1, max_warps=1)
        paths.add(x_case(f"one block over {n} rows, every plane 255, 13 "
                         "specs", full, zero, (ff * 4)[:13], 1,
                         max_blocks=1))
        if paths != {"fast", "general"}:
            raise AssertionError(f"multiagg_mxu checked only {paths}")
        del full, zero, big, fac

        nbytes = 4 * (len(used) + 1) * n
        shape = (f"{len(specs)} Q1 sum specs x {{}} groups over "
                 f"{len(used)} int32[{n}] columns + int32 gid")
        mx.launches = 0
        ms = self.cuda_ms(lambda: mx.fused_group_aggregate_mxu(
            cols, gid, specs, fam.domain), REPS)
        timed_launches = mx.launches
        plain_ms = self.cuda_ms(lambda: mx.fused_group_aggregate_mxu_plain(
            cols, gid, specs, fam.domain), 2)
        self.kernel_time("multiagg_mxu", shape.format(fam.domain) + " ("
                         f"{path(specs, fam.domain)})", ms, plain_ms, None,
                         _bound_ms(nbytes), timed_launches)
        ms = self.cuda_ms(lambda: multiagg.fused_group_aggregate(
            cols, gid, specs, fam.domain), REPS)
        self.kernel_time("multiagg on the same sum specs",
                         shape.format(fam.domain), ms, None, None,
                         _bound_ms(nbytes), None)
        # the fast path's largest group count and the general path, hashed
        # row ids, each beside multiagg.cu on the same specs
        for groups, g in ((16, g16), (17, g17)):
            ms = self.cuda_ms(lambda: mx.fused_group_aggregate_mxu(
                cols, g, specs, groups), REPS)
            self.kernel_time(f"multiagg_mxu {groups} groups "
                             f"({path(specs, groups)})", shape.format(groups),
                             ms, None, None, _bound_ms(nbytes), None)
            ms = self.cuda_ms(lambda: multiagg.fused_group_aggregate(
                cols, g, specs, groups), REPS)
            self.kernel_time(f"multiagg {groups} groups on the same sum "
                             "specs", shape.format(groups), ms, None, None,
                             _bound_ms(nbytes), None)
        del g16, g17

    def radix_kernel(self):
        """The digit rank over the lineitem row count rounded up to a block
        (the sparse group-by's key count) at every digit width, 1 to 8
        bits, over random 24-bit, all-equal, ascending and alternating
        keys, and keys whose digit changes at each warp's 1024-key run;
        timed on the random keys with torch.sort beside it."""
        torch = self.torch
        from mplan2vdl_tpu_torch.engine.kernels import radix_rank as rr

        n = -(-self.n // rr.BLOCK) * rr.BLOCK
        gen = torch.Generator(device=self.dev).manual_seed(self.args.seed + 2)
        keys = torch.randint(0, 1 << 24, (n,), generator=gen,
                             device=self.dev, dtype=torch.int32)
        i = torch.arange(n, dtype=torch.int32, device=self.dev)
        sets = (("random 24-bit", keys),
                ("all-equal", torch.full((n,), 0xABCDEF, dtype=torch.int32,
                                         device=self.dev)),
                ("ascending", i),
                # two digits that differ in every bit
                ("alternating", torch.where(i % 2 == 0, 0x5A5A5A5A,
                                            0x25A5A5A5).to(torch.int32)),
                ("warp-boundary", i // rr.WARP_KEYS))
        for nbits in range(1, 9):
            for what, x in sets:
                got = rr.radix_rank(x, nbits)
                e = self.equal(f"radix_rank nbits={nbits} {what} keys n={n}",
                               got, rr.radix_rank_plain(x, nbits))
                self.max_err["radix_rank"] = max(self.max_err["radix_rank"],
                                                 e)
        del sets, i
        for nbits, name in ((4, "radix_rank nbits=4"), (8, "radix_rank")):
            rr.launches = 0
            ms = self.cuda_ms(lambda: rr.radix_rank(keys, nbits), REPS)
            timed_launches = rr.launches
            plain_ms = self.cuda_ms(lambda: rr.radix_rank_plain(keys, nbits),
                                    1)
            self.kernel_time(name, f"int32[{n}] random 24-bit keys, "
                             f"{1 << nbits} buckets", ms, plain_ms, None,
                             _bound_ms(8 * n), timed_launches)
        ms = self.cuda_ms(lambda: torch.sort(keys, stable=True), REPS)
        self.kernel_time("torch.sort(stable=True) on the same keys",
                         f"int32[{n}] -> values + int64 indices", ms, None,
                         None, _bound_ms(n * (4 + 4 + 8)), None)

    def scatter_kernel(self):
        """The monotone scatter: every case of the CPU tests and the edges
        of its tiles and chunks, exact against the plain version; then the
        slots of an orders-sized table at 2%, 15% (the density of Q3's and
        Q5's mask-deduction scatters) and 100%, the edge cases there, and
        a few rows into just over 2^31 slots; times at the three
        densities."""
        torch = self.torch
        from mplan2vdl_tpu_torch.engine.kernels import compact, scatter

        dev = self.dev

        def s_case(what, p, src, L):
            got = scatter.monotone_scatter(p, src, L)
            want = scatter.monotone_scatter_plain(p, src, L)
            e = self.equal(f"scatter {what}", got, want)
            self.max_err["scatter"] = max(self.max_err["scatter"], e)

        for what, p, src, L in (scatter_cases() + scatter_edge_cases(
                scatter.TILE, scatter.CHUNK)):
            s_case(f"{what} L={L}", torch.from_numpy(p).to(dev),
                   torch.from_numpy(src).to(dev), L)

        L = self.n_orders
        slots = torch.arange(L, device=dev)
        gen = torch.Generator(device=dev).manual_seed(self.args.seed)

        def positions(percent):
            m = (slots * 2654435761 % 100) < percent
            return compact.compact_positions(m, int(m.sum()))

        def rand(k, dtype):
            bits = 62 if dtype == torch.int64 else 30
            return torch.randint(-(1 << bits), 1 << bits, (k,),
                                 generator=gen, device=dev, dtype=dtype)

        p2, p15 = positions(2), positions(15)
        c2, c15 = p2.shape[0], p15.shape[0]
        pall = slots.to(torch.int32)
        s32 = rand(c15, torch.int32)
        s_case(f"L={L} 2% int32", p2, rand(c2, torch.int32), L)
        s_case(f"L={L} 15% int32", p15, s32, L)
        s_case(f"L={L} 15% int64", p15, rand(c15, torch.int64), L)
        s_case(f"L={L} 100% int32", pall, rand(L, torch.int32), L)
        s_case(f"L={L} 100% int64, int64 positions", slots,
               rand(L, torch.int64), L)
        tail = p15.clone()
        tail[c15 // 2:] = L
        s_case(f"L={L} 15%, invalid tail mapped to L", tail, s32, L)
        s_case(f"L={L} n=0", p15[:0], s32[:0], L)
        s_case(f"L={L} one valid row at L-1", torch.tensor(
            [L - 1], dtype=torch.int32, device=dev), s32[:1], L)
        s_case(f"L={L} all {c15} rows invalid", torch.full_like(p15, L),
               s32, L)
        s_case("L=0", p15, s32, 0)
        # int64 positions past 2^31 (the engine's pdt for L > INT32_MAX):
        # an int32 output of 8.6 GB, rows at its ends and around 2^31
        big = (1 << 31) + 5
        pbig = torch.tensor([0, 5, (1 << 31) - 1, 1 << 31, big - 1, big,
                             big + 3], dtype=torch.int64, device=dev)
        s_case(f"L={big} int64 positions, int32 source", pbig,
               rand(pbig.shape[0], torch.int32), big)
        self.sync()
        del pbig
        torch.cuda.empty_cache()

        for name, p, src in (("scatter", p15, s32),
                             ("scatter 2%", p2, rand(c2, torch.int32)),
                             ("scatter 100%", pall, rand(L, torch.int32))):
            c = p.shape[0]
            scatter.launches = 0
            ms = self.cuda_ms(lambda: scatter.monotone_scatter(p, src, L),
                              REPS)
            timed_launches = scatter.launches
            plain_ms = self.cuda_ms(
                lambda: scatter.monotone_scatter_plain(p, src, L), REPS)
            p64 = p.long()
            lib_ms = self.cuda_ms(lambda: torch.zeros(
                L, dtype=src.dtype, device=dev).index_copy_(0, p64, src),
                REPS)
            self.kernel_time(name, f"int32[{c}] at ascending int32 "
                             f"positions into int32[{L}] "
                             f"({100 * c / L:.1f}%)", ms, plain_ms, lib_ms,
                             _bound_ms(c * (4 + 4) + 4 * L), timed_launches)

    def small_gather_kernel(self):
        """The small-table gather at lineitem-many random positions into
        tables of region, nation and SMALL_TABLE size."""
        torch = self.torch
        from mplan2vdl_tpu_torch.engine.kernels import _lib
        from mplan2vdl_tpu_torch.engine.kernels import sorted_gather as sg

        m = self.n
        budget = _lib.lib().m2v_small_gather_smem_budget()
        gen = torch.Generator(device=self.dev).manual_seed(self.args.seed + 1)

        def table(k, dtype):
            bits = 62 if dtype == torch.int64 else 30
            return torch.randint(-(1 << bits), 1 << bits, (k,),
                                 generator=gen, device=self.dev, dtype=dtype)

        def positions(n):
            return torch.randint(0, n, (m,), generator=gen, device=self.dev,
                                 dtype=torch.int32)

        def g_case(what, ss, p):
            nbytes = sum(-(-s.numel() * s.element_size() // 16) * 16
                         for s in ss)
            branch = "shared" if nbytes <= budget else "ldg"
            got = sg.gather_many(ss, p, m, small=True)
            want = sg.small_gather_plain(ss, p)
            e = self.equal(f"small_gather {what} ({branch})", got, want)
            self.max_err["small_gather"] = max(self.max_err["small_gather"],
                                               e)
            return branch

        branches = set()
        for n in (5, 25, sg.SMALL_TABLE):
            p = positions(n)
            t32, t64 = table(n, torch.int32), table(n, torch.int64)
            branches.add(g_case(f"k=1 int32[{n}]", [t32], p))
            branches.add(g_case(f"k=3 int32/int64/int32 [{n}]",
                                [t32, t64, table(n, torch.int32)], p))
        wild = positions(25)
        wild[::3] = -7
        wild[1::3] = 25 + 1000
        branches.add(g_case("out-of-range positions clip",
                            [table(25, torch.int32)], wild))
        p64 = positions(25).to(torch.int64)
        branches.add(g_case("int64 positions", [table(25, torch.int64)],
                            p64))
        ten = [table(25, torch.int32) for _ in range(9)] + [
            table(25, torch.int64)]
        branches.add(g_case("k=10 (two launches)", ten, positions(25)))
        if branches != {"shared", "ldg"}:
            raise AssertionError(f"small_gather checked only {branches}")

        # Q5's shape: one int32 nation column at lineitem-many positions
        t25, p25 = table(25, torch.int32), positions(25)
        sg.small_launches = 0
        ms = self.cuda_ms(lambda: sg.small_table_gather(t25, p25, m), REPS)
        timed_launches = sg.small_launches
        plain_ms = self.cuda_ms(lambda: sg.small_gather_plain([t25], p25),
                                REPS)
        pl = p25.long()
        lib_ms = self.cuda_ms(lambda: torch.index_select(t25, 0, pl), REPS)
        self.kernel_time("small_gather", f"k=1 int32[25] at int32[{m}] "
                         "random positions", ms, plain_ms, lib_ms,
                         _bound_ms(m * 4 + m * 4 + 25 * 4), timed_launches)
        # the batched call (gather_many(small=True)): three nation-sized
        # columns, mixed widths, sharing the positions
        t3 = [t25, table(25, torch.int64), table(25, torch.int32)]
        sg.small_launches = 0
        ms = self.cuda_ms(lambda: sg.gather_many(t3, p25, m, small=True),
                          REPS)
        timed_launches = sg.small_launches
        plain_ms = self.cuda_ms(lambda: sg.small_gather_plain(t3, p25), REPS)
        lib_ms = self.cuda_ms(
            lambda: [torch.index_select(t, 0, pl) for t in t3], REPS)
        nbytes = m * 4 + sum((m + 25) * t.element_size() for t in t3)
        self.kernel_time("small_gather k=3", "k=3 int32/int64/int32[25] at "
                         f"int32[{m}] random positions", ms, plain_ms,
                         lib_ms, _bound_ms(nbytes), timed_launches)

    def exprfold_kernel(self, q6_mask):
        """The expression fold: Q6's call as the engine makes it (its
        program, immediates and resident lineitem columns), exact against
        the plain version and the library expression over every row, over
        a ragged count of them and over unaligned views; the random
        programs of ``tests/torch_exprfold_cases.py`` (every leaf dtype,
        64-bit values, sum, min and max) at every lineitem row and at a
        ragged count; one launch a call.  Then Q6's call timed beside its
        plain version and ``torch.where(mask, price * disc, 0).sum()``
        (``q6_mask``, Q6's mask, already made)."""
        torch = self.torch
        from mplan2vdl_tpu_torch import mplan as M
        from mplan2vdl_tpu_torch import vir as V
        from mplan2vdl_tpu_torch.engine import datagen, exprfold, lower
        from mplan2vdl_tpu_torch.engine.kernels import exprfold as kx

        tests = os.path.join(REPO, "tests")
        if tests not in sys.path:
            sys.path.insert(0, tests)
        import torch_exprfold_cases as cases

        def check(what, leaves, program, imms, foldop, fold32):
            before = kx.launches
            got = kx.expr_fold(leaves, program, imms, foldop, fold32)
            if kx.launches != before + 1:
                raise AssertionError(f"exprfold {what}: "
                                     f"{kx.launches - before} launches")
            want = kx.expr_fold_plain(leaves, program, imms, foldop, fold32)
            e = self.equal(f"exprfold {what}", got, want)
            self.max_err["exprfold"] = max(self.max_err["exprfold"], e)
            return got

        calls = []
        fold = lower.expr_fold

        def record(*a):
            calls.append(a)
            return fold(*a)

        cq = lower.CompiledQuery(self.cfg, lower.plan_to_vexps(
            PLAN_Q6, self.cfg), self.st, device=self.dev)
        lower.expr_fold = record
        try:
            cq()
        finally:
            lower.expr_fold = fold
        if cq.expr_folds != 1 or len(calls) != 1:
            raise AssertionError(f"Q6: {cq.expr_folds} one-pass folds, "
                                 f"{len(calls)} calls, not one")
        (plan,) = cq.expr_plans.values()
        leaves, program, imms, foldop, fold32 = calls[0]
        n = leaves[0].shape[0]
        col = dict(zip((v.vx.name[1] for v in plan.leaves), leaves))
        price, disc = col["l_extendedprice"], col["l_discount"]
        got = check(f"Q6 {len(leaves)} int32[{n}]", *calls[0])
        lib = [int(torch.where(q6_mask, price * disc, 0).sum()),
               int(q6_mask.sum())]
        if got.tolist() != lib:
            raise AssertionError(f"exprfold Q6: {got.tolist()}, library "
                                 f"expression {lib}")
        ragged = 1_000_003
        check(f"Q6 n={ragged}", [t[:ragged] for t in leaves], program, imms,
              foldop, fold32)
        check("Q6 unaligned views", [t[3:] for t in leaves], program, imms,
              foldop, fold32)
        del cq

        st = datagen.generate(sf=0.001, seed=5)
        cases.add_leaves(st, 5)
        widths = set()
        for i, (name, p) in enumerate(cases.card_plans(
                st.make_catalog(), V, M, exprfold.plan_fold)):
            for rows in (n, ragged):
                data = cases.leaf_data(torch, p, rows, self.dev,
                                       self.args.seed + i)
                check(f"{name} {len(p.program)} steps n={rows}", data,
                      p.program, cases.immediates(p), p.foldop, p.fold32)
                widths.add(any(t.dtype == torch.int64 for t in data))
                del data
        if widths != {False, True}:
            raise AssertionError("exprfold: the random programs read int64 "
                                 f"leaves in none or all ({widths})")

        kx.launches = 0
        args = (leaves, program, imms, foldop, fold32)
        ms = self.cuda_ms(lambda: kx.expr_fold(*args), REPS)
        timed_launches = kx.launches
        plain_ms = self.cuda_ms(lambda: kx.expr_fold_plain(*args), 3)
        lib_ms = self.cuda_ms(lambda: torch.where(
            q6_mask, price * disc, 0).sum(), REPS)
        nbytes = sum(t.numel() * t.element_size() for t in leaves) + 24
        self.kernel_time("exprfold", f"Q6's fold: {len(leaves)} int32[{n}] "
                         f"leaves, {len(program)} steps", ms, plain_ms,
                         lib_ms, _bound_ms(nbytes), timed_launches)

    def kernel_time(self, name, shape, ms, plain_ms, lib_ms, bound_ms,
                    launches, **extra):
        rec = {"kernel": name, "shape": shape, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "launches": launches, **extra,
               "card": self.smi}
        self.timed[name] = rec
        self.records["kernel_times"].append(rec)
        print(json.dumps(rec), flush=True)

    def plan_checks(self):
        """``AUTO_PLANS`` name -> the check of a result of that plan against
        its oracle (Q4 and Q16 in order, Q3's top 10 tie-tolerantly),
        built once for phases 4 and 8; each oracle's seconds are printed
        as it runs."""
        if getattr(self, "_checks", None) is not None:
            return self._checks
        import numpy as np

        from mplan2vdl_tpu_torch.oracle import tpch

        st = self.st
        want_q6, want_q1 = self.tpch_want("q6"), self.tpch_want("q1")
        ship = st.columns[("lineitem", "l_shipdate")]
        fp_mask = (ship >= tpch.day(1994, 1, 1)) & (ship < tpch.day(1995, 1, 1))
        want_fp = [st.columns[("lineitem", c)][fp_mask] for c in FP_COLUMNS]

        def check_q6(res):
            got = [int(c[0]) for c in res.columns]
            assert got == [int(want_q6["revenue"][0])], (got, want_q6)

        def check_q1(res):
            got = sorted(zip(*[c.astype(np.int64).tolist()
                               for c in res.columns]))
            want = sorted(zip(*[np.asarray(want_q1[k], np.int64).tolist()
                                for k in Q1_COLUMNS]))
            assert [nm[-1] for nm in res.names] == Q1_COLUMNS, res.names
            assert got == want, (got, want)

        def check_fp(res):
            assert [nm[-1] for nm in res.names] == FP_COLUMNS, res.names
            for g, w in zip(res.columns, want_fp, strict=True):
                assert np.array_equal(g, w), "filter-project rows differ"

        def check_rows(columns, oracle):
            want = self.oracle(oracle, st)

            def check(res):
                assert [nm[-1] for nm in res.names] == columns, res.names
                assert same_rows(res.columns, want), "rows differ"
            return check

        def check_in_order(columns, oracle):
            want = self.oracle(oracle, st)

            def check(res):
                assert [nm[-1] for nm in res.names] == columns, res.names
                assert len(res.columns) == len(want)
                for g, w in zip(res.columns, want):
                    assert np.array_equal(np.asarray(g, np.int64),
                                          np.asarray(w, np.int64)), \
                        "rows differ or are out of order"
            return check

        want_q3 = self.oracle(oracle_q3, st)
        want_top10 = q3_top10(want_q3)

        def check_q3(res):
            assert [nm[-1] for nm in res.names] == Q3_COLUMNS, res.names
            assert same_rows(res.columns, want_q3), "rows differ"

        def check_top10(res):
            # tie-tolerant: sorted by revenue descending, then o_orderdate,
            # and the same multiset of (revenue, o_orderdate) as the oracle
            assert [nm[-1] for nm in res.names] == Q3_COLUMNS, res.names
            rev = np.asarray(res.columns[1], np.int64)
            date = np.asarray(res.columns[2], np.int64)
            keys = list(zip((-rev).tolist(), date.tolist()))
            assert len(keys) == 10 and keys == sorted(keys), "not sorted"
            assert sorted(zip(rev.tolist(), date.tolist())) == sorted(zip(
                np.asarray(want_top10[1], np.int64).tolist(),
                np.asarray(want_top10[2], np.int64).tolist())), \
                "order keys differ"

        self._checks = {
            "q6": check_q6, "q1": check_q1, "filter_project": check_fp,
            "q3": check_q3, "q5": check_rows(Q5_COLUMNS, oracle_q5),
            "sparse_groupby": check_rows(SPARSE_COLUMNS,
                                         oracle_sparse_groupby),
            "q9": check_rows(Q9_COLUMNS, oracle_q9),
            "q13": check_rows(Q13_COLUMNS, oracle_q13),
            "q17": check_rows(Q17_COLUMNS, oracle_q17),
            "substr_groupby": check_rows(SUBSTR_COLUMNS,
                                         oracle_substr_groupby),
            "q4": check_in_order(Q4_COLUMNS, oracle_q4),
            "q3_top10": check_top10,
            "q16": check_in_order(Q16_COLUMNS, oracle_q16),
            "self_join": check_rows(SELF_JOIN_COLUMNS, oracle_self_join),
            "dense_join": check_rows(DENSE_JOIN_COLUMNS, oracle_dense_join),
            "distinct_dense": check_rows(DISTINCT_DENSE_COLUMNS,
                                         oracle_distinct_dense),
            "distinct_wide": check_rows(DISTINCT_WIDE_COLUMNS,
                                        oracle_distinct_wide),
            "q4_all": check_in_order(Q4_COLUMNS, oracle_q4_all),
            "hot_join": check_rows(SELF_JOIN_COLUMNS, oracle_hot_join),
            "q13_nation": check_rows(Q13_NATION_COLUMNS, oracle_q13_nation)}
        return self._checks

    def query_phase(self):
        from mplan2vdl_tpu_torch.engine import lower
        from mplan2vdl_tpu_torch.engine.kernels import scatter
        from mplan2vdl_tpu_torch.engine.kernels import sorted_gather as sg
        from mplan2vdl_tpu_torch.engine.lower import CompiledQuery, \
            fused_agg_on, plan_to_vexps
        from mplan2vdl_tpu_torch.tools import bench_gather

        counters = kernel_counters()
        st, cfg = self.st, self.cfg
        chk = self.plan_checks()

        q1_auto = "Q1 fused (auto gate)" if fused_agg_on(
            st, [("lineitem", "l_quantity")]) else "Q1 (auto gate: unfused)"
        # (name, plan, MPLAN2VDL_FUSED_AGG, check, kernels it must launch);
        # MPLAN2VDL_MXU_AGG is set for the Q1_MXU run only
        runs = [("Q6", PLAN_Q6, None, chk["q6"], ("compact", "exprfold")),
                (q1_auto, PLAN_Q1, None, chk["q1"],
                 ("compact", "multiagg") if q1_auto.startswith("Q1 fused")
                 else ("compact",))]
        if not q1_auto.startswith("Q1 fused"):
            runs.append(("Q1 fused (forced)", PLAN_Q1, "1", chk["q1"],
                         ("compact", "multiagg")))
        runs += [(Q1_MXU, PLAN_Q1, "1", chk["q1"],
                  ("compact", "multiagg_mxu", "multiagg")),
                 ("Q1 unfused (MPLAN2VDL_FUSED_AGG=0)", PLAN_Q1, "0",
                  chk["q1"], ("compact",)),
                 ("filter-project", PLAN_FILTER_PROJECT, None,
                  chk["filter_project"], ()),
                 ("Q3", PLAN_Q3, None, chk["q3"],
                  ("compact", "gather", "scatter")),
                 ("Q5", PLAN_Q5, None, chk["q5"],
                  ("compact", "gather", "scatter", "small_gather")),
                 ("sparse group-by", PLAN_SPARSE_GROUPBY, None,
                  chk["sparse_groupby"], ("compact", "gather")),
                 ("Q9", PLAN_Q9, None, chk["q9"],
                  ("compact", "gather", "small_gather", "scatter")),
                 ("Q13", PLAN_Q13, None, chk["q13"],
                  ("compact", "gather", "small_gather")),
                 ("Q17", PLAN_Q17, None, chk["q17"], ("compact", "gather")),
                 ("substring group-by", PLAN_SUBSTR_GROUPBY, None,
                  chk["substr_groupby"], ("compact", "small_gather")),
                 ("Q4", PLAN_Q4, None, chk["q4"], ORDERED_KERNELS),
                 ("Q3 top 10", PLAN_Q3_TOP10, None, chk["q3_top10"],
                  ORDERED_KERNELS),
                 ("Q16", PLAN_Q16, None, chk["q16"], ORDERED_KERNELS),
                 (DENSE_JOIN_RUN, PLAN_DENSE_JOIN, None, chk["dense_join"],
                  ("compact", "gather", "small_gather")),
                 (DISTINCT_DENSE_RUN, PLAN_DISTINCT_DENSE, None,
                  chk["distinct_dense"], ("compact",)),
                 (DISTINCT_WIDE_RUN, PLAN_DISTINCT_WIDE, None,
                  chk["distinct_wide"], ("compact", "gather")),
                 (Q4_ALL_RUN, PLAN_Q4_ALL, None, chk["q4_all"],
                  ("compact", "gather", "small_gather"))]
        total = {k: 0 for k in counters}
        join_total = {k: 0 for k in counters}
        ab_total = {}
        os.environ.pop("MPLAN2VDL_MXU_AGG", None)
        # the engine's scatter calls of each query's first run: shapes and
        # in-range rows, for their bounds
        scatters = {}

        def record_scatter(query):
            def call(p, src, L):
                valid = int(((p >= 0) & (p < L)).sum())
                scatters.setdefault(query, []).append({
                    "n": p.shape[0], "valid": valid, "L": L,
                    "pos": str(p.dtype), "src": str(src.dtype),
                    "bound_ms": _bound_ms(p.shape[0] * p.element_size()
                                          + valid * src.element_size()
                                          + L * src.element_size())})
                return scatter.monotone_scatter(p, src, L)
            return call

        # the repeated-position scatters (plain torch) of each query's first
        # run: shapes and the count of distinct in-range positions
        repeats = {}

        def record_repeat(query):
            def call(p, src, L):
                live = p[p < L]
                repeats.setdefault(query, []).append({
                    "n": p.shape[0], "L": L, "valid": live.shape[0],
                    "distinct": int(self.torch.unique(live).numel())})
                return repeat_scatter(p, src, L)
            return call
        repeat_scatter = lower.repeat_scatter

        # the engine paths of each query's first run: the dense-domain joins
        # taken, count(DISTINCT)'s group domains and how its pairs sorted
        paths = {}
        dense_join = lower.Compiler._dense_join
        fold_distinct = lower.Compiler._eval_fold_distinct
        sort_pairs = lower._sort_pairs

        def record_paths(query):
            rec = paths.setdefault(query, {"dense_joins": 0, "merge_joins": 0,
                                           "distinct_domains": [],
                                           "pair_sorts": []})

            def dense(c, *a, **k):
                out = dense_join(c, *a, **k)
                rec["dense_joins" if out is not None else "merge_joins"] += 1
                return out

            def distinct(c, vx, dt, domain, L_out):
                rec["distinct_domains"].append(domain)
                return fold_distinct(c, vx, dt, domain, L_out)

            def pairs(ids, vals, domain, vlo, vhi):
                top = (domain + 1) * (vhi - vlo + 1)
                rec["pair_sorts"].append({
                    "n": ids.shape[0], "domain": domain,
                    "width": vhi - vlo + 1,
                    "packed": top <= lower.PACK_LIMIT,
                    "key_bits": (top - 1).bit_length()})
                return sort_pairs(ids, vals, domain, vlo, vhi)
            return dense, distinct, pairs

        # the census of gather.cu's launches over each query's first run:
        # classes by k, source and position dtypes, m, n and the order of
        # the valid positions; each run's sequence of classes names its
        # calls under the profiler
        census, census_seq = {}, {}
        gather_many = lower.gather_many

        def record_gathers(query):
            seq = census_seq.setdefault(query, [])

            def call(srcs, pos, valid, small=False):
                if small:
                    return gather_many(srcs, pos, valid, small=small)
                key = gather_class(srcs, pos, valid)
                before = sg.launches
                out = gather_many(srcs, pos, valid, small=small)
                rec = census.setdefault(key, {
                    "k": key[0], "srcs": key[1], "pos": key[2], "m": key[3],
                    "n": key[4], "order": key[5], "calls": 0, "launches": 0,
                    "bound_ms": _bound_ms(bench_gather.byte_count(srcs, pos)),
                    "queries": []})
                rec["calls"] += 1
                rec["launches"] += sg.launches - before
                if query not in rec["queries"]:
                    rec["queries"].append(query)
                seq.append(key)
                return out
            return call

        for name, plan, fused, check, must in runs:
            if fused is None:
                os.environ.pop("MPLAN2VDL_FUSED_AGG", None)
            else:
                os.environ["MPLAN2VDL_FUSED_AGG"] = fused
            cq = CompiledQuery(cfg, plan_to_vexps(plan, cfg), st,
                               device=self.dev)
            os.environ.pop("MPLAN2VDL_FUSED_AGG", None)
            if name == Q1_MXU:  # read when the family is evaluated
                os.environ["MPLAN2VDL_MXU_AGG"] = "1"
            t0 = time.perf_counter()
            cq.device_args()
            self.sync()
            load_ms = (time.perf_counter() - t0) * 1e3
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            lower.monotone_scatter = record_scatter(name)
            lower.repeat_scatter = record_repeat(name)
            (lower.Compiler._dense_join, lower.Compiler._eval_fold_distinct,
             lower._sort_pairs) = record_paths(name)
            lower.gather_many = record_gathers(name)
            try:
                res = cq()
            finally:
                lower.gather_many = gather_many
                lower.monotone_scatter = scatter.monotone_scatter
                lower.repeat_scatter = repeat_scatter
                lower.Compiler._dense_join = dense_join
                lower.Compiler._eval_fold_distinct = fold_distinct
                lower._sort_pairs = sort_pairs
            launches = {k: getattr(mod, attr)
                        for k, (mod, attr) in counters.items()}
            for k in total:
                total[k] += launches[k]
                if name in JOIN_RUNS:
                    join_total[k] += launches[k]
            # each equijoin of the first call: side, path, sizes, and the
            # counts it read to the host
            for j in cq.join_log:
                print(json.dumps({"join": name, **j}), flush=True)
            for r in repeats.get(name, ()):
                print(json.dumps({"repeat_scatter": name, **r}), flush=True)
            check(res)
            self.check_path(name, paths[name], cq.join_log,
                            repeats.get(name, []))
            if name == "Q4":
                # the semijoin's marks: one scatter through repeated
                # positions (several late lineitems of one order)
                rs = repeats.get(name, [])
                if len(rs) != 1 or rs[0]["distinct"] >= rs[0]["valid"]:
                    raise AssertionError(f"Q4: repeated-position scatters "
                                         f"{rs}, not one with repeats")
            idle = [k for k in must if launches[k] == 0]
            if idle:
                raise AssertionError(f"{name} launched no {idle} kernel")
            if "multiagg" in must and name != Q1_MXU and launches[
                    "multiagg"] != 1:
                raise AssertionError(f"{name}: {launches['multiagg']} "
                                     "multiagg launches, not one")
            if name == Q1_MXU and (launches["multiagg_mxu"], launches[
                    "multiagg"]) != (1, 1):
                raise AssertionError(f"{name}: {launches}, not one launch "
                                     "each of multiagg_mxu and multiagg")
            # Q6's sum is computed in one pass; Q1's folds take the fused
            # family or the grouped path
            want = {PLAN_Q6: 1, PLAN_Q1: 0}.get(plan)
            if want is not None and launches["exprfold"] != want:
                raise AssertionError(f"{name}: {launches['exprfold']} "
                                     f"exprfold launches, not {want}")
            if name != Q1_MXU and launches["multiagg_mxu"]:
                raise AssertionError(f"{name} launched multiagg_mxu with "
                                     "MPLAN2VDL_MXU_AGG unset")
            self.torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                cq.run()
                self.sync()
                times.append((time.perf_counter() - t0) * 1e3)
            med = statistics.median(times)
            # least time: each loaded column read once, each result written
            nbytes = (sum(a.numel() * a.element_size()
                          for a in cq.device_args())
                      + sum(c.nbytes for c in res.columns))
            # rows of the largest table the query reads
            rows_in = max(a.shape[0] for a in cq.device_args())
            rec = {"query": name, "sf": self.args.sf, "rows_in": rows_in,
                   "rows_out": len(res.columns[0]), "median_ms": med,
                   "ms": times, "rows_per_s": rows_in / (med / 1e3),
                   "bound_ms": _bound_ms(nbytes), "load_ms": load_ms,
                   "peak_gb": self.torch.cuda.max_memory_allocated() / 1e9,
                   "launches": launches, "host_syncs": cq.host_syncs,
                   "joins": cq.join_log,
                   "repeat_scatters": repeats.get(name, []),
                   "paths": paths[name], "card": self.smi}
            if getattr(self.args, "old_lib", None):
                rec["lib_ab"] = self.lib_ab(cq)
                ab_total = {v: ab_total.get(v, 0.0) + ms
                            for v, ms in rec["lib_ab"].items()}
            if self.args.profile:
                index = {k: i for i, k in enumerate(census)}
                rec["profile"] = self.profile(
                    name, cq, [(index[k], k) for k in census_seq[name]])
                for i, (c, t) in rec["profile"]["gather_classes"].items():
                    if i >= 0:
                        cls = census[list(census)[i]]
                        cls["device_ms"] = cls.get("device_ms", 0.0) + t
            self.records["queries"].append(rec)
            print(json.dumps(rec), flush=True)
            os.environ.pop("MPLAN2VDL_MXU_AGG", None)
            del cq
        self.launches = total
        if getattr(self.args, "old_lib", None):
            print(json.dumps({"lib_ab": self.args.old_lib, "runs": len(runs),
                              "median_ms_sum": ab_total, "card": self.smi}),
                  flush=True)
        self.gather_census(census)
        self.records["engine_scatters"] = scatters
        self.records["repeat_scatters"] = repeats
        print(json.dumps({"engine_scatters": scatters}), flush=True)
        if self.args.profile:
            dev = {k: [0, 0.0] for k in counters}
            for rec in self.records["queries"]:
                for k, (c, t) in rec["profile"]["kernels"].items():
                    dev[k][0] += c
                    dev[k][1] += t
            self.records["main_path_device_ms"] = dev
            print(json.dumps({"main_path_device_ms": dev}), flush=True)
        for k, v in total.items():
            if v == 0:
                raise AssertionError(f"kernel {k} was not launched by the "
                                     "queries")
        idle = [k for k in JOIN_KERNELS if join_total[k] == 0]
        if idle:
            raise AssertionError(f"the general-join runs launched no {idle}")
        print(json.dumps({"main_path_launches": total,
                          "general_join_launches": join_total}), flush=True)
        self.semisort_run()

    def semisort_run(self):
        """Phase 4's run of the one VIR node no plan emits: ``Semisort``
        over sum(l_quantity) per l_orderkey, a sparse fold whose buffer
        has rows past its valid count, built by hand as
        tests/test_torch_ordered.py builds it.  The fold's valid rows must
        be the per-order sums, and the permutation must equal the stable
        argsort of the whole buffer, padding included, on the host
        (``np.argsort(kind="stable")``); then 5 warm calls are timed.  One
        ``{"path": "Semisort", ...}`` line."""
        import numpy as np

        from mplan2vdl_tpu_torch import vir as V
        from mplan2vdl_tpu_torch.engine.lower import CompiledQuery

        cfg = self.cfg
        fold = V.complete(V.Fold(
            foldop=V.FSUM, fgroups=V.load_raw(cfg, ("lineitem", "l_orderkey")),
            fdata=V.load_raw(cfg, ("lineitem", "l_quantity"))))
        cq = CompiledQuery(cfg, [fold, V.complete(V.Semisort(sdata=fold))],
                           self.st, device=self.dev)
        cq.device_args()
        counters = kernel_counters()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        self.sync()
        t0 = time.perf_counter()
        buf, perm = cq.run()
        self.sync()
        cold_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: getattr(mod, attr)
                    for k, (mod, attr) in counters.items()}
        valid, length = int(buf.valid), buf.length
        data = buf.data.cpu().numpy()
        got = perm.data.cpu().numpy()
        t0 = time.perf_counter()
        want = np.argsort(data, kind="stable")
        argsort_s = time.perf_counter() - t0
        c = lambda n: self.st.columns[("lineitem", n)]  # noqa: E731
        _, sums = _group([c("l_orderkey")], [(c("l_quantity"), np.add)])
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            cq.run()
            self.sync()
            times.append((time.perf_counter() - t0) * 1e3)
        rec = {"path": SEMISORT_RUN, "sf": self.args.sf, "n": length,
               "valid": valid, "padding": length - valid,
               "dtype": str(perm.data.dtype), "cold_ms": cold_ms,
               "median_ms": statistics.median(times), "ms": times,
               "host_argsort_s": argsort_s, "launches": launches,
               "card": self.smi}
        self.records["semisort"] = rec
        print(json.dumps(rec), flush=True)
        if not (length - valid > 0 and np.array_equal(data[:valid], sums)):
            raise AssertionError(f"Semisort: the fold's buffer ({valid} of "
                                 f"{length} rows valid) is not the per-order"
                                 " sums with padding past them")
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError("Semisort: the permutation differs from the "
                                 "stable argsort of the whole buffer")

    def lib_ab(self, cq):
        """The median of 5 warm calls of ``cq`` with the launch path
        (``LAUNCH_PATH`` of ``_lib``) of the ``--old-lib`` file and with
        the checkout's, in turns (old, new, new, old); each one's mean."""
        from mplan2vdl_tpu_torch.engine.kernels import _lib

        if not hasattr(self, "old_lib"):
            self.old_lib = load_old_lib(self.args.old_lib)
        new = {k: getattr(_lib, k) for k in LAUNCH_PATH}
        turns = {"old": [], "new": []}
        try:
            for v in ("old", "new", "new", "old"):
                for k in LAUNCH_PATH:
                    setattr(_lib, k, getattr(self.old_lib, k) if v == "old"
                            else new[k])
                ms = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    cq.run()
                    self.sync()
                    ms.append((time.perf_counter() - t0) * 1e3)
                turns[v].append(statistics.median(ms))
        finally:
            for k, fn in new.items():
                setattr(_lib, k, fn)
        return {v: sum(t) / len(t) for v, t in turns.items()}

    def gather_census(self, census):
        """Prints the ``{"gather_census": ...}`` line: every class of
        gather.cu launches of the phase's first runs, largest byte total
        first, with the device ms the profiler gave each class (under
        ``--profile``) beside the gather kernels' device ms of the same
        profiles."""
        classes = sorted(census.values(), reverse=True,
                         key=lambda c: c["bound_ms"] * c["calls"])
        line = {"gather_census": classes,
                "calls": sum(c["calls"] for c in classes),
                "launches": sum(c["launches"] for c in classes)}
        if self.args.profile:
            line["device_ms"] = sum(c.get("device_ms", 0.0) for c in classes)
            line["profile_gather_ms"] = sum(
                q["profile"]["kernels"].get("gather", (0, 0.0))[1]
                for q in self.records["queries"])
            # the classes' ranges hold every gather kernel the profiles saw
            if abs(line["device_ms"] - line["profile_gather_ms"]) > 1e-6 * (
                    1 + line["profile_gather_ms"]):
                raise AssertionError(
                    f"the gather census's classes hold {line['device_ms']} "
                    f"device ms, the profiles' gather kernels "
                    f"{line['profile_gather_ms']}")
        self.records["gather_census"] = line
        print(json.dumps(line), flush=True)

    def check_path(self, name, rec, joins, repeats):
        """The run of a path no CLI plan reaches at SF10 must take it, as
        the spies of ``query_phase`` saw its first call: every equijoin
        dense; every count(DISTINCT) over at most segred.SMALL_DOMAIN ids;
        a pair sort past lower.PACK_LIMIT (two stable sorts); one
        repeated-position scatter with repeats, of more positions than half
        of lineitem.  The run's ``{"path": ...}`` line shows what was
        taken."""
        from mplan2vdl_tpu_torch.engine.kernels import segred

        if name == DENSE_JOIN_RUN:
            ok = (rec["dense_joins"] > 0 and rec["merge_joins"] == 0
                  and {j["path"] for j in joins} == {"dense"})
        elif name == DISTINCT_DENSE_RUN:
            ok = (rec["distinct_domains"] != [] and max(
                rec["distinct_domains"]) <= segred.SMALL_DOMAIN)
        elif name == DISTINCT_WIDE_RUN:
            ok = any(not p["packed"] for p in rec["pair_sorts"])
        elif name == Q4_ALL_RUN:
            ok = (len(repeats) == 1 and repeats[0]["n"] > self.n // 2
                  and repeats[0]["distinct"] < repeats[0]["valid"])
        else:
            return
        print(json.dumps({"path": name, **rec, "joins": joins,
                          "repeat_scatters": repeats}), flush=True)
        if not ok:
            raise AssertionError(f"{name} did not take its path: {rec}, "
                                 f"joins {joins}, scatters {repeats}")

    def probe_phase(self):
        """Runs the two probe tools on the card with their launch counters
        reset around them; holds every pattern kernel, and the contraction
        kernels at the edges of their design (``probe_contract_cases``),
        exactly equal to its plain version; checks under torch.profiler
        that one call of each probe runs one device kernel; then records
        each probe's device and host microseconds beside its library
        expression's, and times the probes, their plain versions, their
        library expressions and an empty launch in interleaved turns
        (``tools/bench_probes.py``)."""
        from mplan2vdl_tpu_torch.engine.kernels import probes as P
        from mplan2vdl_tpu_torch.engine.kernels import radix_rank as rr
        from mplan2vdl_tpu_torch.tools import bench_probes as B
        from mplan2vdl_tpu_torch.tools import probe_kernels, probe_radix

        torch = self.torch
        counters = kernel_counters(PROBE_COUNTERS)
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        rows = probe_kernels.run(self.dev)
        n = -(-self.n // rr.BLOCK) * rr.BLOCK
        sizes = list(probe_radix.DEFAULT_SIZES) + [n]
        self.records["probe_radix"] = probe_radix.run(sizes, dev=self.dev)
        self.probe_launches = {k: getattr(mod, attr)
                               for k, (mod, attr) in counters.items()}
        print(json.dumps({"probe_launches": self.probe_launches}),
              flush=True)
        bad = [name for name, ok in rows if not ok]
        if bad:
            raise AssertionError(f"kernel probes wrong: {bad}")
        for k, v in self.probe_launches.items():
            if v == 0:
                raise AssertionError(f"kernel {k} was not launched by the "
                                     "probe tools")

        probes = probe_kernels.make_probes(self.dev)
        for p in probes:
            e = self.equal(f"probes {p.name}", p.run(P), p.run(P.PLAIN))
            self.max_err["probes"] = max(self.max_err["probes"], e)
            if not B.check_library(p):
                raise AssertionError(f"{p.name}: the library expression "
                                     f"{B.library(p)[0]} is wrong")
        for name, op, a, rhs, kw in probe_contract_cases():
            a = torch.from_numpy(a).to(self.dev)
            rhs = torch.from_numpy(rhs).to(self.dev)
            if op == "fma":
                def run(ops):
                    return ops.fma_contract(a, rhs, kw["m"], kw["n"],
                                            kw["k"], kw["mode"], kw["key"],
                                            kw["batch"])
            else:
                def run(ops):
                    return ops.mma_contract(a, kw["nlimb"], rhs, kw["m"],
                                            kw["n"], kw["k"], kw["mode"],
                                            kw["key"], kw["batch"])
            e = self.equal(f"probes {name}", run(P), run(P.PLAIN))
            self.max_err["probes"] = max(self.max_err["probes"], e)
            del a, rhs
        one = B.one_kernel_each(probes)
        print(json.dumps({"probe_kernels_per_call": {
            k: v["kernels"] for k, v in one.items()}}), flush=True)

        timed = B.turns(probes, self.dev, PROBE_TURNS, PROBE_REPS)
        tot = {"plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        for p in probes:
            text, calls, lib = B.library(p)
            rec = {"probe": p.name, **timed["probes"][p.name],
                   "library": text, "library_calls": calls,
                   "bound_ms": _bound_ms(p.nbytes(p.run(P))),
                   "device": B.device(lambda: p.run(P)),
                   "host_us": B.host_us(lambda: p.run(P), PROBE_HOST_CALLS),
                   "library_device": B.device(lib),
                   "library_host_us": B.host_us(lib, PROBE_HOST_CALLS),
                   "card": self.smi}
            for k in tot:
                tot[k] += rec[k]
            self.records.setdefault("probe_times", []).append(rec)
            print(json.dumps(rec), flush=True)
        # the probes are launch-bound: their bound is the larger of their
        # bytes at the memory rate and their launches, one pass of the 15
        # runs, at the time of an empty launch through the same path
        per_pass, noop_ms = timed["launches"], timed["noop_ms"]
        slower = [p.name for p in probes
                  if timed["probes"][p.name]["ms"]
                  > timed["probes"][p.name]["library_ms"]]
        self.probe_bound = {"bytes_ms": tot["bound_ms"], "noop_ms": noop_ms,
                            "launches": per_pass,
                            "launches_ms": per_pass * noop_ms,
                            "turns": timed["turns"],
                            "min_share": timed["min_share"],
                            "slower_than_library": slower,
                            "noop_host_us": B.host_us(
                                lambda: P.noop(self.dev), PROBE_HOST_CALLS)}
        print(json.dumps({"probe_bound": self.probe_bound}), flush=True)
        self.kernel_time("probes", "the 15 probe runs (12 probes and 3 "
                         "tensor-core variants), summed; the median of "
                         f"{PROBE_TURNS} interleaved turns", timed["ms"],
                         tot["plain_ms"], tot["library_ms"],
                         max(tot["bound_ms"], per_pass * noop_ms), per_pass)

    def cli(self, argv, timeout):
        """``python -m mplan2vdl_tpu_torch ARGV`` from the repo's root, run
        to its end; the finished process, with its wall ``seconds``.  Fails
        with the end of its stderr when it exits nonzero."""
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "mplan2vdl_tpu_torch",
                            *argv], cwd=REPO, capture_output=True,
                           text=True, timeout=timeout)
        p.seconds = time.perf_counter() - t0
        if p.returncode != 0:
            raise AssertionError(f"{' '.join(argv[:2])} exited "
                                 f"{p.returncode}: {p.stderr[-3000:]}")
        return p

    def cli_phase(self):
        """Phase 6: the command line, each command in its own process.
        ``genplans``, ``compile``, ``compile --dot`` and ``explain`` of every
        in-code plan against metadata files of the store (no device); Q5
        through ``run`` on the card with ``--roofline`` and ``--profile``,
        row-exact, its trace naming its four kernels' launches; Q1 and Q16
        through ``run --tbl`` of .tbl files written from a TBL_SF store,
        equal to ``run`` of the generated store as decoded rows."""
        import re
        import tempfile
        from concurrent.futures import ThreadPoolExecutor

        import numpy as np

        from mplan2vdl_tpu_torch.engine import datagen, tblingest

        t_phase = time.perf_counter()
        self.torch.cuda.empty_cache()  # the children share the card
        seed = str(self.args.seed)
        with tempfile.TemporaryDirectory(prefix="m2v_cli_") as tmp:
            meta, plans = os.path.join(tmp, "meta"), os.path.join(tmp, "plans")
            write_metadata(self.st, meta)
            os.makedirs(plans)
            path = {}
            for name, text in CLI_PLANS.items():
                path[name] = os.path.join(plans, f"{name}.mplan")
                with open(path[name], "w") as f:
                    f.write(text)
            out = self.cli(["genplans", meta, plans], 600).stdout
            total = f"SUCCESS/TOTAL: {len(CLI_PLANS)}/{len(CLI_PLANS)}"
            print(json.dumps({"genplans": out.strip().splitlines()[-1]}),
                  flush=True)
            if total not in out:
                raise AssertionError(f"genplans: {out}")
            flags = ["-b", os.path.join(meta, "bounds.csv"),
                     "-t", os.path.join(meta, "storage.csv"),
                     "-s", os.path.join(meta, "schema.msqldump"),
                     "--dictionary", os.path.join(meta, "dictionary.csv")]
            kinds = {"vdl": ["compile"], "dot": ["compile", "--dot"],
                     "explain": ["explain"]}
            with ThreadPoolExecutor(8) as pool:
                futs = {(name, kind): pool.submit(
                    self.cli, [cmd[0], path[name], *flags, *cmd[1:]], 600)
                    for name in CLI_PLANS for kind, cmd in kinds.items()}
                done = {k: f.result().stdout for k, f in futs.items()}
            for name in CLI_PLANS:
                vdl = done[(name, "vdl")].strip().splitlines()
                if ("MaterializeCompact" not in vdl[-1]
                        or not done[(name, "dot")].startswith("digraph")
                        or "-- output 0:" not in done[(name, "explain")]):
                    raise AssertionError(f"{name}: compile, --dot or "
                                         "explain printed no program")
                print(json.dumps({
                    "cli_compile": name, "statements": len(vdl),
                    "dot_lines": done[(name, "dot")].count("\n"),
                    "explain_lines": done[(name, "explain")].count("\n")}),
                    flush=True)

            # Q5 on the card, with the roofline and a profile of the call
            prof = os.path.join(tmp, "q5_profile")
            p = self.cli(["run", path["q5"], "--sf", f"{self.args.sf:g}",
                          "--seed", seed, "--roofline", "--hbm-gbps",
                          f"{HBM_BYTES_PER_S / 1e9:g}", "--profile", prof],
                         900)
            head, rows = csv_rows(p.stdout)
            got = [np.array([int(r[i]) for r in rows], np.int64)
                   for i in range(len(head))]
            if head != Q5_COLUMNS or not same_rows(got, oracle_q5(self.st)):
                raise AssertionError("run Q5: rows differ from the oracle")
            roof = dict(re.findall(r"^# (\w+): (\S+)$", p.stderr, re.M))
            scan, amp = int(roof["scan_bytes"]), float(roof["amplification"])
            if not (scan > 0 and amp >= 1):
                raise AssertionError(f"run Q5 --roofline: {roof}")
            with open(os.path.join(prof, "trace.json")) as f:
                trace = f.read()
            missing = [e for e, k in Q5_ENTRIES.items()
                       if f'"{e}"' not in trace or not any(
                           fn in trace for fn in KERNEL_FUNCTIONS[k])]
            if missing:
                raise AssertionError(f"run Q5 --profile: the trace lacks "
                                     f"{missing} or their kernels")
            rec = {"query": "Q5", "sf": self.args.sf, "wall_s": p.seconds,
                   "scan_bytes": scan,
                   "bytes_accessed": int(roof["bytes_accessed"]),
                   "amplification": amp,
                   "roofline_floor_s": float(roof["roofline_floor_s"]),
                   "traffic_time_s": float(roof["traffic_time_s"]),
                   "card": self.smi}
            self.records["cli_run"] = rec
            print(json.dumps({"cli_run": rec}), flush=True)

            # run --devices 2 on fewer cards than that, without --cpu: an
            # error naming the card count, and no rows
            p = subprocess.run([sys.executable, "-m", "mplan2vdl_tpu_torch",
                                "run", path["q6"], "--sf", "0.01",
                                "--devices", "2"], cwd=REPO,
                               capture_output=True, text=True, timeout=300)
            n_cards = self.torch.cuda.device_count()
            if n_cards < 2 and (p.returncode == 0 or p.stdout
                                or f"only {n_cards} device(s)"
                                not in p.stderr):
                raise AssertionError(f"run --devices 2 on {n_cards} card(s)"
                                     f": exit {p.returncode}, {p.stderr}")
            print(json.dumps({"cli_devices": 2, "cards": n_cards,
                              "exit": p.returncode,
                              "stderr": p.stderr.strip()[-200:]}), flush=True)

            # --tbl: Q1 and Q16 of an ingested store against the generated
            # one (decoded: the ingest's dictionary codes follow the sorted
            # strings, the generator's do not)
            tbl = os.path.join(tmp, "tbl")
            t0 = time.perf_counter()
            tblingest.to_tbl(datagen.generate(sf=TBL_SF, seed=self.args.seed),
                             tbl)
            to_tbl_s = time.perf_counter() - t0
            with ThreadPoolExecutor(4) as pool:
                futs = {(name, src): pool.submit(self.cli, [
                    "run", path[name], *arg, "--decode"], 900)
                    for name in ("q1", "q16") for src, arg in (
                        ("tbl", ["--tbl", tbl]),
                        ("gen", ["--sf", f"{TBL_SF:g}", "--seed", seed]))}
                runs = {k: f.result() for k, f in futs.items()}
            for name in ("q1", "q16"):
                (h, got), (wh, want) = (csv_rows(runs[(name, s)].stdout)
                                        for s in ("tbl", "gen"))
                if h != wh or len(got) < 2 or sorted(got) != sorted(want):
                    raise AssertionError(f"run --tbl {name}: decoded rows "
                                         "differ from the generated store's")
                if name == "q16" and not q16_sql_order(got):
                    raise AssertionError("run --tbl q16: rows out of order")
                print(json.dumps({
                    "cli_tbl": name, "sf": TBL_SF, "rows": len(got),
                    "to_tbl_s": to_tbl_s,
                    "tbl_run_s": runs[(name, "tbl")].seconds,
                    "generated_run_s": runs[(name, "gen")].seconds}),
                    flush=True)
        self.records["cli_phase_s"] = time.perf_counter() - t_phase
        print(json.dumps({"cli_phase_s": self.records["cli_phase_s"]}),
              flush=True)

    def dist_phase(self, coordinator=None, phases=("dist",)):
        """Phase 7 (``"dist"`` in ``phases``): the distribution primitives
        (``parallel/``) at world size 1 over NCCL on this card, over the
        phase-3 store: DistQuery Q6 and the Q1 group-by, ShuffleGroupBy
        over ``l_orderkey``, and ShuffleJoin of ``l_orderkey`` against
        ``o_orderkey``, each exact against its oracle, then timed (median
        of 5 warm calls).  Then phase 8 (``"auto"``, ``auto_phase``) in the
        same world.  The one rank meets itself at ``coordinator`` (default:
        a free localhost port)."""
        import socket

        import torch.distributed as tdist

        from mplan2vdl_tpu_torch.parallel import multihost

        dev = self.dev
        counters = kernel_counters()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t_phase = time.perf_counter()
        # one rank on this machine: NCCL's bootstrap over the loopback
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        if coordinator is None:
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                coordinator = f"localhost:{sock.getsockname()[1]}"
        multihost.initialize(coordinator, 1, 0, device=dev)
        try:
            mesh = multihost.data_mesh(device=dev)
            if "dist" in phases:
                self.primitives(mesh, counters, t_phase)
            if "auto" in phases:
                self.auto_phase(mesh)
        finally:
            tdist.destroy_process_group()

    def primitives(self, mesh, counters, t_phase):
        """Phase 7's four cells over ``mesh``; the engine kernels'
        counters (``counters``, zeroed by the caller) are read after
        them."""
        import numpy as np
        import torch.distributed as tdist

        from mplan2vdl_tpu_torch.parallel import dist
        from mplan2vdl_tpu_torch.parallel.shuffle_agg import (
            _SENT, ShuffleGroupBy, shard_shuffle_combine)
        from mplan2vdl_tpu_torch.parallel.shuffle_join import ShuffleJoin

        torch, st, dev = self.torch, self.st, self.dev
        backend = str(tdist.get_backend(mesh.group))

        def cell(name, call, check, caps, nbytes, step=None):
            self.sync()
            t0 = time.perf_counter()
            res = call()
            self.sync()
            cold = (time.perf_counter() - t0) * 1e3
            check(res)
            del res

            def median(fn):
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    fn()
                    self.sync()
                    times.append((time.perf_counter() - t0) * 1e3)
                return statistics.median(times), times

            torch.cuda.reset_peak_memory_stats()
            med, times = median(call)
            rec = {"dist": name, "world_size": mesh.size,
                   "backend": backend, "device": str(mesh.device),
                   "sf": self.args.sf, "median_ms": med, "ms": times,
                   "cold_ms": cold, "bound_ms": _bound_ms(nbytes),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   **caps(), "card": self.smi}
            if step is not None:  # device work alone, no host gather
                rec["step_median_ms"], rec["step_ms"] = median(step)
            self.records["dist"].append(rec)
            print(json.dumps(rec), flush=True)

        line = {c: st.columns[("lineitem", c)] for c in set(
            DIST_Q6_COLUMNS + DIST_Q1_COLUMNS + ["l_orderkey"])}
        n = len(line["l_orderkey"])

        # -- DistQuery: Q6, and the Q1 group-by
        def check_q6(res):
            want = self.tpch_want("q6")
            assert res["revenue"].tolist() == want["revenue"].tolist(), (
                res, want)

        def check_q1(res):
            nls = int(line["l_linestatus"].max()) + 1
            got = sorted(zip((res["__group_id"] // nls).tolist(),
                             (res["__group_id"] % nls).tolist(),
                             res["sum_qty"].tolist(),
                             res["sum_base_price"].tolist(),
                             res["__count"].tolist()))
            want = self.tpch_want("q1")
            exp = sorted(zip(*[np.asarray(want[k]).tolist() for k in (
                "l_returnflag", "l_linestatus", "sum_qty",
                "sum_base_price", "count_order")]))
            assert got == exp, (got, exp)

        for name, cols, spec_of, check in (
                ("DistQuery Q6", DIST_Q6_COLUMNS,
                 lambda c: dist_q6_query(), check_q6),
                ("DistQuery Q1 group-by", DIST_Q1_COLUMNS, dist_q1_query,
                 check_q1)):
            sub = {c: line[c] for c in cols}
            t0 = time.perf_counter()
            table = dist.ShardedTable.put(mesh, sub)
            self.sync()
            load_ms = (time.perf_counter() - t0) * 1e3
            q = dist.DistQuery(table=table, **spec_of(sub))
            cell(name, q, check,
                 lambda: {"domain": q.domain, "shard_rows":
                          table.shard_rows, "load_ms": load_ms},
                 sum(line[c].nbytes for c in cols))
            del q, table

        # -- ShuffleGroupBy over l_orderkey, l_shipdate >= 1995-01-01
        want = self.oracle(oracle_shuffle_groupby, st)
        sparse = self.oracle(oracle_sparse_groupby, st)
        for g, w in zip(want[:5], sparse, strict=True):
            assert np.array_equal(g, w), "oracles disagree"

        def i64(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

        ship = self.col("l_shipdate")
        live = ship >= _day(1995, 1, 1)
        keys = torch.where(live, i64(line["l_orderkey"]), _SENT)
        qty, price = i64(line["l_quantity"]), self.col("l_extendedprice")
        price = price.to(torch.int64)
        vals = [qty, ship.to(torch.int64), qty,
                torch.ones(n, dtype=torch.int64, device=dev),
                price, price, price]
        ops = ["sum", "min", "max", "sum", "sum", "min", "max"]
        key_hi = int(line["l_orderkey"].max()) + 1
        gb = ShuffleGroupBy(mesh=mesh, shard_rows=n, key_hi=key_hi,
                            ops=ops)

        def check_gb(res):
            gk, gv = res
            got = [gk] + gv
            assert len(got) == len(want)
            for i, (g, w) in enumerate(zip(got, want)):
                assert np.array_equal(np.asarray(g, np.int64),
                                      np.asarray(w, np.int64)), \
                    f"ShuffleGroupBy column {i} differs"

        cell("ShuffleGroupBy", lambda: gb(keys, vals), check_gb,
             lambda: {"cap": gb.cap, "groups": len(want[0]),
                      "shard_rows": n},
             (1 + len(vals)) * n * 8 + len(want[0]) * 8 * len(want),
             step=lambda: shard_shuffle_combine(
                 keys, vals, ops, n, mesh.size, gb.per_owner, gb.cap,
                 mesh))
        del keys, vals, qty, price, ship, live

        # -- ShuffleJoin: every lineitem row against the orders keys
        okey = st.columns[("orders", "o_orderkey")]
        row, found = self.oracle(_pk_lookup, okey, line["l_orderkey"])
        assert found.all()
        lk = self.col("l_orderkey")
        rk = torch.from_numpy(np.ascontiguousarray(okey)).to(dev)
        rpos = torch.arange(len(okey), dtype=torch.int64, device=dev)
        sj = ShuffleJoin(mesh=mesh, shard_rows_l=n,
                         shard_rows_r=len(okey),
                         key_bounds=(0, int(okey.max()) + 1))

        def check_join(res):
            lidx, ok, cnt, (pay,) = res
            assert (cnt == 1).all(), "a lineitem row without one match"
            li, pj = lidx[ok], pay[ok]
            assert len(li) == n and (np.bincount(li, minlength=n)
                                     == 1).all(), "pairs differ"
            by_row = np.empty(n, np.int64)
            by_row[li] = pj
            assert np.array_equal(by_row, row), "payloads differ"

        cell("ShuffleJoin", lambda: sj(lk, rk, [rpos]), check_join,
             lambda: {"caps": list(sj._caps),
                      "cap_scale": sj.cap_scale,
                      "heavy_keys": (len(sj._heavy_plan[0])
                                     if sj._heavy_plan else 0),
                      "probe_rows": n, "build_rows": len(okey)},
             lk.numel() * 4 + rk.numel() * 4 + rpos.numel() * 8
             + n * (8 + 8 + 1 + 8),
             step=lambda: sj._build()(lk, rk, [rpos]))
        del lk, rk, rpos, sj
        launches = {k: getattr(mod, attr)
                    for k, (mod, attr) in counters.items()}
        self.records["dist_phase_s"] = time.perf_counter() - t_phase
        print(json.dumps({"dist_phase_s": self.records["dist_phase_s"],
                          "dist_launches": launches}), flush=True)

    def auto_phase(self, mesh):
        """Phase 8: the plan distributor (``parallel/auto.py``) over
        ``mesh`` on the phase-3 store: each of ``AUTO_PLANS`` through
        ``auto.distribute`` (its set-up timed: the partitioned joins'
        counting rounds), one cold call checked row-exact against the
        plan's oracle (``plan_checks``), then 3 warm calls; one ``{"auto":
        ...}`` line each with the distribution plan, the medians beside
        the plan's phase-4 single-device median, the peak GB and the
        engine kernels' launches over the calls.  The phase must launch
        the compaction and the gather kernels."""
        import types

        from mplan2vdl_tpu_torch.engine.lower import plan_to_vexps
        from mplan2vdl_tpu_torch.parallel import auto

        torch, st, cfg = self.torch, self.st, self.cfg
        counters = kernel_counters()
        checks = self.plan_checks()
        single = {rec["query"]: rec["median_ms"]
                  for rec in self.records["queries"]}
        total = {k: 0 for k in counters}
        t_phase = time.perf_counter()
        self.records["auto"] = []
        for name, text in AUTO_PLANS.items():
            vexps = plan_to_vexps(text, cfg)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            self.sync()
            t0 = time.perf_counter()
            rec = {"auto": name, "world_size": mesh.size,
                   "device": str(mesh.device), "sf": self.args.sf}
            try:
                dq = auto.distribute(cfg, st, vexps, mesh)
            except auto.NotDistributable as e:
                rec["not_distributable"] = str(e)
                print(json.dumps(rec), flush=True)
                self.records["auto"].append(rec)
                if str(e) != EXPECTED_NOT_DISTRIBUTABLE.get(name):
                    raise AssertionError(f"{name} is not distributable: "
                                         f"{e}") from e
                continue
            if (name in EXPECTED_NOT_DISTRIBUTABLE
                    and self.args.sf == CARD_SF):
                raise AssertionError(
                    f"{name} distributes at SF{CARD_SF:g}, but "
                    f"EXPECTED_NOT_DISTRIBUTABLE says: "
                    f"{EXPECTED_NOT_DISTRIBUTABLE[name]}")
            self.sync()
            rec["setup_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            res = dq.result()
            self.sync()
            rec["cold_ms"] = (time.perf_counter() - t0) * 1e3
            checks[name](res)
            rows_out = len(res.columns[0]) if res.columns else 0
            del res
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                dq()
                self.sync()
                times.append((time.perf_counter() - t0) * 1e3)
            launches = {k: getattr(mod, attr)
                        for k, (mod, attr) in counters.items()}
            for k in total:
                total[k] += launches[k]
            rec.update(
                describe=dq.describe().splitlines(), rows_out=rows_out,
                part_joins=part_joins(dq), warm_ms=times,
                median_ms=statistics.median(times),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches=launches, card=self.smi)
            self.check_auto_path(name, rec)
            if name in AUTO_PHASE4:
                rec["single_device_median_ms"] = single.get(
                    AUTO_PHASE4[name], single.get(AUTO_PHASE4_SMALL.get(
                        name)))
            else:  # no phase-4 run: the single-device engine here, checked
                rec["single_device_median_ms"] = self.single_device_ms(
                    vexps, checks[name])
            if self.args.profile:  # one more warm call, traced
                rec["profile"] = self.profile(f"auto {name}",
                                              types.SimpleNamespace(run=dq))
            print(json.dumps(rec), flush=True)
            self.records["auto"].append(rec)
            del dq
        idle = [k for k in ("compact", "gather") if total[k] == 0]
        if idle:
            raise AssertionError(f"the distributed plans launched no "
                                 f"{idle} kernel")
        self.records["auto_phase_s"] = time.perf_counter() - t_phase
        print(json.dumps({"auto_phase_s": self.records["auto_phase_s"],
                          "auto_launches": total}), flush=True)

    def check_auto_path(self, name, rec):
        """A plan of ``AUTO_PATHS`` must run a partitioned shuffle join
        whose ``describe()`` line names its right frame as the map says;
        the hot join's must have both heavy keys and light keys (keys
        with pairs that stay in the exchange), which ``rec`` gets."""
        if name not in AUTO_PATHS:
            return
        lines = [ln for ln in rec["describe"]
                 if ln.startswith("partitioned shuffle join ")]
        if not any(AUTO_PATHS[name] in ln for ln in lines):
            raise AssertionError(f"{name}: no partitioned shuffle join with "
                                 f"{AUTO_PATHS[name]}: {rec['describe']}")
        if name != "hot_join":
            return
        (pj,) = rec["part_joins"]
        sides = hot_join_sides(self.st)
        paired = sides["keys"][(sides["lc"].sum(0) * sides["rc"]) > 0]
        pj["light_keys"] = [int(k) for k in paired
                            if k not in pj["heavy_keys"]]
        pj["oracle_pairs"] = int(sides["lc"].sum(0) @ sides["rc"])
        if not (pj["n_heavy"] > 0 and pj["light_keys"]
                and set(pj["heavy_keys"]) <= set(paired.tolist())
                and pj["pairs"] == pj["oracle_pairs"]):
            raise AssertionError(f"hot_join: {pj}, keys with pairs "
                                 f"{paired.tolist()}")

    def single_device_ms(self, vexps, check):
        """The median of 3 warm calls of the single-device engine on
        ``vexps`` over the phase-3 store, after one call held to
        ``check``."""
        from mplan2vdl_tpu_torch.engine.lower import CompiledQuery

        cq = CompiledQuery(self.cfg, vexps, self.st, device=self.dev)
        check(cq())
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            cq()
            self.sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def census_phase(self, sf=CENSUS_SF, workers=CENSUS_WORKERS):
        """Phase 9: the JAX package's CPU plan census
        (tests/torch_census_cases.py: 40 fuzz, 40 ordered fuzz, 7
        null-semantics, 5 join-corner, 2 semi/anti and 2 count(DISTINCT)
        plans) and the plans of phase 8 (AUTO_PLANS) but CENSUS_SKIP's,
        through
        ``vir.vexps_from_mplan`` + ``passes.engine_passes`` +
        ``CompiledQuery`` on the card over a store of scale ``sf``, each
        result held against the port's relational oracle as rows (the
        ordered family in order), the null plans against SQLite and the
        count(DISTINCT) plans also against a numpy distinct count; the fuzz
        plans run three times: with the default gate, with
        MPLAN2VDL_FUSED_AGG=1 and with MPLAN2VDL_MXU_AGG=1 besides.  The
        oracles run once a plan, in ``workers`` spawned processes, each
        with its own copy of the store, while the card runs.  One
        ``{"census": ...}`` line per family; the engine kernels' counters
        are read around the phase, and each of them must have launched."""
        import concurrent.futures as cf
        import multiprocessing

        import numpy as np

        import mplan2vdl_tpu_torch
        from mplan2vdl_tpu_torch import passes, vir
        from mplan2vdl_tpu_torch.engine import datagen
        from mplan2vdl_tpu_torch.engine.lower import CompiledQuery

        tests = os.path.join(REPO, "tests")
        if tests not in sys.path:
            sys.path.insert(0, tests)
        import torch_census_cases as census

        counters = kernel_counters()
        t_phase = time.perf_counter()
        st = datagen.generate(sf=sf, seed=self.args.seed)
        cfg = st.make_catalog()
        n_li = st.table_count(("lineitem",))
        datagen_s = time.perf_counter() - t_phase
        cases = census.case_names()
        # the oracle of every plan the port's oracle checks, computed once
        pool = cf.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=census.oracle_worker_init,
            initargs=(sf, self.args.seed))
        futures = {c: pool.submit(census.oracle_columns, *c)
                   for c in cases if c[0] != "null"}
        tp = np.asarray(st.columns[("orders", "o_totalprice")])
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        try:
            # every run on the card first: (family line, name) -> columns
            got, joins, stats = {}, {}, {}
            for family, name in cases:
                plan = census.build(mplan2vdl_tpu_torch, family, name, st,
                                    cfg)
                lines = FUZZ_PASSES if family == "fuzz" else (
                    (family, None, None),)
                for line, fused, mxu in lines:
                    rec = stats.setdefault(line, {
                        "plans": 0, "rows_out": 0, "engine_s": 0.0,
                        "launches": {k: 0 for k in counters}})
                    before = {k: getattr(m, a)
                              for k, (m, a) in counters.items()}
                    t0 = time.perf_counter()
                    for var, val in (("MPLAN2VDL_FUSED_AGG", fused),
                                     ("MPLAN2VDL_MXU_AGG", mxu)):
                        if val is None:
                            os.environ.pop(var, None)
                        else:
                            os.environ[var] = val
                    try:
                        cq = CompiledQuery(cfg, passes.engine_passes(
                            vir.vexps_from_mplan(plan, cfg)), st,
                            device=self.dev)
                        res = cq()
                    finally:
                        os.environ.pop("MPLAN2VDL_FUSED_AGG", None)
                        os.environ.pop("MPLAN2VDL_MXU_AGG", None)
                    rec["engine_s"] += time.perf_counter() - t0
                    for k, (m, a) in counters.items():
                        rec["launches"][k] += getattr(m, a) - before[k]
                    rec["plans"] += 1
                    rec["rows_out"] += (len(res.columns[0])
                                        if res.columns else 0)
                    got[line, name] = census.int_columns(res.columns)
                    joins[line, name] = {j["side"] for j in cq.join_log}
                    del cq
            launched = {k: getattr(m, a) for k, (m, a) in counters.items()}
            # then every check: the oracle's rows (in order for the ordered
            # family), SQLite's for the null plans
            db = None
            for family, name in cases:
                lines = FUZZ_PASSES if family == "fuzz" else (
                    (family, None, None),)
                t0 = time.perf_counter()
                if family == "null":
                    if db is None:
                        db = census.null_db(st)
                    ref = census.sql_rows(db, census.null_sql(name, tp))
                    oracle_s = time.perf_counter() - t0
                else:
                    cols, oracle_s = futures[family, name].result()
                for line, _, _ in lines:
                    rec = stats[line]
                    rec["oracle_s"] = rec.get("oracle_s", 0.0) + (
                        oracle_s if line == family else 0.0)
                    g = got[line, name]
                    if family == "null":
                        ok = census.rows(g) == ref
                    elif family == "ordered":
                        ok = len(g) == len(cols) and all(
                            np.array_equal(a, b) for a, b in zip(g, cols))
                    else:
                        ok = census.rows(g) == census.rows(cols)
                    if ok and family == "distinct":
                        key = census.DISTINCT[name][1]
                        ok = dict(zip(g[0].tolist(), g[1].tolist())) == \
                            census.numpy_distinct(st, key, "l_suppkey")
                    if ok and family == "corners":
                        ok = joins[line, name] == census.CORNERS[name]
                    if not ok:
                        raise AssertionError(
                            f"census {line} {name}: the card's rows differ "
                            f"from the {CENSUS_REFERENCE[family]}")
                    rec["checked"] = rec.get("checked", 0) + 1
        finally:
            pool.shutdown(cancel_futures=True)
        wall = time.perf_counter() - t_phase
        for line, rec in stats.items():
            family = line.split("_")[0] if line.startswith("fuzz") else line
            out = {"census": line, **rec,
                   "reference": CENSUS_REFERENCE[family], "sf": sf,
                   "lineitem_rows": n_li, "cut": CENSUS_CUT,
                   "card": self.smi}
            self.records.setdefault("census", []).append(out)
            print(json.dumps(out), flush=True)
        idle = [k for k, v in launched.items() if v == 0]
        end = {"census_phase_s": wall, "datagen_s": datagen_s,
               "oracle_workers": workers, "census_launches": launched,
               "plans": len(cases),
               "runs": sum(r["plans"] for r in stats.values())}
        self.records["census_phase"] = end
        print(json.dumps(end), flush=True)
        if idle:
            raise AssertionError(f"the census launched no {idle} kernel")

    def profile(self, name, cq, gather_calls=None):
        """One warm call under torch.profiler: device (kernel) time beside
        the host wall time, and the ops that own the most device time.
        The engine kernels' launch counters and launch ranges (``m2v_*``)
        are read around the same call, and a launch the profiler holds no
        kernel record of is printed as a ``profile_lost`` line.  Given
        ``gather_calls``, [(index, class)] of the first run's gather.cu
        calls, the i-th call runs in a range named after the index of
        ``gather_calls[i]`` and must have that class's shape, the warm call
        must make as many, and each class's device time is returned."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, record_function

        from mplan2vdl_tpu_torch.engine import lower
        from mplan2vdl_tpu_torch.engine.kernels import _lib

        counters = kernel_counters()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        gather_many, tagged = lower.gather_many, []
        call = _lib.call

        def named(srcs, pos, valid, small=False):
            if small:
                return gather_many(srcs, pos, valid, small=small)
            i = len(tagged)
            if i >= len(gather_calls) or gather_calls[i][1][:5] != \
                    gather_shape(srcs, pos):
                raise AssertionError(
                    f"{name}: the profiled call's gather {i} "
                    f"{gather_shape(srcs, pos)} is not the first run's")
            tagged.append(i)
            tag = f"gather_class {gather_calls[i][0]}"

            def in_range(entry, *a):  # the launch's range, named by class
                with record_function(tag):
                    return getattr(_lib.lib(), entry)(*a)
            _lib.call = in_range
            try:
                return gather_many(srcs, pos, valid, small=small)
            finally:
                _lib.call = call

        act = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        if gather_calls is not None:
            lower.gather_many = named
        try:
            with profile(activities=act) as prof:
                t0 = time.perf_counter()
                cq.run()
                self.sync()
                wall = (time.perf_counter() - t0) * 1e3
        finally:
            lower.gather_many = gather_many
        if gather_calls is not None and len(tagged) != len(gather_calls):
            raise AssertionError(f"{name}: the profiled call made "
                                 f"{len(tagged)} gathers, the first run "
                                 f"{len(gather_calls)}")
        avg = prof.key_averages()

        dev_us = _dev_us
        # kernels are the CUDA-type entries other than the device-side
        # spans of the launch ranges (m2v_*, gather_class *), which repeat
        # their kernels' time; the CPU-side ops that launched them carry
        # the same device time, so they name the top spenders
        def span(e):
            return getattr(e, "is_user_annotation", False) or e.key.startswith(
                ("m2v_", "gather_class "))

        cuda = [e for e in avg
                if e.device_type == DeviceType.CUDA and not span(e)]
        spans = [e for e in avg
                 if e.device_type == DeviceType.CUDA and span(e)]
        device = sum(dev_us(e) for e in cuda) / 1e3
        ops = [e for e in avg if e.device_type == DeviceType.CPU]
        top = sorted(ops, key=dev_us, reverse=True)[:8]
        # the engine kernels' own entries: [launches, device ms]
        kernels = {}
        for e in cuda:
            k = _engine_kernel(e.key)
            if k is not None:
                c, t = kernels.get(k, (0, 0.0))
                kernels[k] = (c + e.count, t + dev_us(e) / 1e3)
        launched = {k: getattr(mod, attr)
                    for k, (mod, attr) in counters.items()
                    if getattr(mod, attr)}
        ranges = {e.key: e.count for e in ops if e.key.startswith("m2v_")}
        # each census class's launches: [count, device ms of the range's
        # device-side span]
        per_class = {int(e.key.split()[1]): (e.count, dev_us(e) / 1e3)
                     for e in spans if e.key.startswith("gather_class ")}
        lost = {k: n - kernels.get(k, (0, 0.0))[0]
                for k, n in launched.items()
                if kernels.get(k, (0, 0.0))[0] < n}
        if lost:
            print(json.dumps({"profile_lost": name, "lost": lost,
                              "launched": launched, "ranges": ranges}),
                  flush=True)
        os.makedirs(self.args.profile, exist_ok=True)
        stem = "".join(c if c.isalnum() else "_" for c in name)
        with open(os.path.join(self.args.profile, stem + ".txt"), "w") as f:
            f.write(avg.table(sort_by="self_device_time_total", row_limit=-1,
                              max_name_column_width=100))
        return {"wall_ms": wall, "device_ms": device,
                "busy_share": device / wall,
                "kernels": {k: list(v) for k, v in kernels.items()},
                "launched": launched, "ranges": ranges, "lost": lost,
                "gather_classes": per_class,
                "top": [[e.key, e.count, dev_us(e) / 1e3] for e in top]}

    def bound_by(self, name):
        """What sets a kernel's bound: its bytes, or for the probes, when
        their launches take longer, the operations (launches at the empty
        kernel's rate)."""
        if name == "probes" and (self.probe_bound["launches_ms"]
                                 > self.probe_bound["bytes_ms"]):
            return "operations"
        return "bytes"

    def summary(self):
        out = []
        launches = {**self.launches, **self.probe_launches}
        for name, meta in KERNELS.items():
            t = self.timed[name]
            out.append({"name": name, "route": "cuda",
                        "source": meta["source"],
                        "replaces": meta["replaces"],
                        "launches": launches[name],
                        "max_abs_err": self.max_err[name],
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"],
                        "bound_by": self.bound_by(name),
                        "library_ms": t["library_ms"]})
        return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=CARD_SF,
                    help="TPC-H scale factor of the generated store")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None,
                    help="also write every record as JSON to this file")
    ap.add_argument("--old-lib", default=None, metavar="FILE",
                    help="an older engine/kernels/_lib.py: phase 4 also "
                         "times each run with its launch path and the "
                         "checkout's in turns")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="profile one warm call of each query (phase 4) "
                         "and distributed plan (phase 8) with "
                         "torch.profiler; tables go to DIR")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import mplan2vdl_tpu_torch  # noqa: F401  (fails outside the repo)

    t0 = time.perf_counter()
    s = Smoke(args)
    s.records["phase_s"] = {}
    for name, phase in (("card", s.card), ("build", s.build),
                        ("store", s.store), ("kernels", s.kernel_phase),
                        ("queries", s.query_phase), ("probes", s.probe_phase),
                        ("cli", s.cli_phase),
                        ("dist and auto", lambda: s.dist_phase(
                            phases=("dist", "auto"))),
                        ("census", s.census_phase)):
        t = time.perf_counter()
        phase()
        s.records["phase_s"][name] = time.perf_counter() - t
        print(json.dumps({"phase_s": name, "s": s.records["phase_s"][name]}),
              flush=True)
    summary = s.summary()
    s.records["summary"] = summary
    s.records["wall_s"] = time.perf_counter() - t0
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(s.records, f, indent=1)
    print(json.dumps({"wall_s": s.records["wall_s"]}), flush=True)
    print(json.dumps(summary), flush=True)
    # the run uses one card, whatever else the machine shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
