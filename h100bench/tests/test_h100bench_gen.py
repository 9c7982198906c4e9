"""gen.py's tables against the frozen copy of the engine's numpy generator
at SF 0.01: the same tables, columns and dictionaries, row counts, value
ranges and means within sampling noise."""

import numpy as np
import pytest
import torch

from h100bench import gen
from h100bench.tests import frozen_datagen

SF, SEED = 0.01, 20240611


@pytest.fixture(scope="module")
def both():
    return (gen.generate(SF, SEED, "cpu"),
            frozen_datagen.generate(SF, SEED))


def test_same_columns_and_dictionaries(both):
    t, f = both
    assert set(t.cols) == set(f.columns)
    assert set(t.decoders) == set(f.decoders)
    for col, dec in f.decoders.items():
        if col in (("supplier", "s_phone"), ("customer", "c_phone")):
            # the codes drawn: both a subset of the same code space
            assert set(t.decoders[col]) <= set(range(10 * 997, 35 * 997))
            continue
        if col[1].endswith(("_comment", "p_name")):
            assert len(t.decoders[col]) == len(dec), col
            continue
        assert t.decoders[col] == dec, col


def test_row_counts(both):
    t, f = both
    for tab in ("region", "nation", "part", "supplier", "partsupp",
                "customer", "orders"):
        assert t.rows(tab) == len(f.columns[(tab, f"{tab[0]}_comment"
                                             if tab != "partsupp"
                                             else "ps_comment")]), tab
    n, m = t.rows("lineitem"), len(f.columns[("lineitem", "l_orderkey")])
    assert abs(n - m) < 0.02 * m  # 1 to 7 lines an order, mean 4


@pytest.mark.parametrize("tab", ["part", "supplier", "partsupp", "customer",
                                 "orders", "lineitem"])
def test_value_ranges_and_means(both, tab):
    t, f = both
    for (tb, col), ref in f.columns.items():
        if tb != tab:
            continue
        got = t.cols[(tb, col)].numpy().astype(np.int64)
        assert got.dtype == ref.dtype
        lo, hi = int(ref.min()), int(ref.max())
        span = max(hi - lo, 1)
        # uniform draws reach close to both ends of their range (n draws
        # leave a gap of about span / n); sums and products of them have
        # thin tails
        edge = max(8 * span / len(ref) + 1, 0.05 * span)
        assert abs(int(got.min()) - lo) <= edge, col
        assert abs(int(got.max()) - hi) <= edge, col
        # means within six standard errors of the frozen generator's
        tol = 6 * ref.std() / np.sqrt(len(ref)) + 0.01 * span
        assert abs(got.mean() - ref.mean()) <= tol, col


def test_keys_and_consistency():
    t = gen.generate(SF, SEED, "cpu")
    c = lambda tab, n: t.cols[(tab, n)].long()  # noqa: E731
    assert torch.equal(c("orders", "o_orderkey"),
                       torch.arange(1, t.rows("orders") + 1))
    ok = c("lineitem", "l_orderkey")
    assert bool((ok[1:] >= ok[:-1]).all())
    # (l_partkey, l_suppkey) is a partsupp key
    k = c("partsupp", "ps_partkey") * 100000 + c("partsupp", "ps_suppkey")
    lk = c("lineitem", "l_partkey") * 100000 + c("lineitem", "l_suppkey")
    assert bool(torch.isin(lk, k).all())
    # o_totalprice sums its lineitems' net prices
    net = (c("lineitem", "l_extendedprice") * (100 - c("lineitem", "l_discount"))
           * (100 + c("lineitem", "l_tax"))) // 10000
    tot = torch.zeros(t.rows("orders"), dtype=torch.int64).index_add_(
        0, ok - 1, net)
    assert torch.equal(tot, c("orders", "o_totalprice"))
    assert not bool((c("orders", "o_custkey") % 3 == 0).any())


def test_same_seed_same_tables():
    a, b = gen.generate(SF, 7, "cpu"), gen.generate(SF, 7, "cpu")
    assert all(torch.equal(a.cols[k], b.cols[k]) for k in a.cols)
    assert a.decoders == b.decoders
    c = gen.generate(SF, 8, "cpu")
    assert not torch.equal(a.cols[("lineitem", "l_partkey")][:100],
                           c.cols[("lineitem", "l_partkey")][:100])


def test_large_seed():
    t = gen.generate(0.002, 2**31 + 12345, "cpu")
    assert t.rows("orders") == 3000
