"""The port's relational oracle (``oracle/relinterp.py``, numpy only)
against the JAX package's, which pairs join keys with pandas, on the CPU.

* Frame for frame, in order: every census plan (tests/torch_census_cases.py)
  and every in-code plan of tests/torch_plans.py, each built with each
  package's own modules, gives the same column names, dtypes, display types and
  values in the same order, and the same null masks.  The census runs at
  its CPU scale: SF 0.002 for the fuzz families, the stores of the
  original tests for the others.
* ``equi_join_pairs`` against pandas' inner ``merge`` directly, pair for
  pair in order, under hypothesis: one to three key columns, duplicate
  keys on both sides, empty sides, negative keys and keys near the int64
  limits, and pair counts equal to the left row count (where ``merge``
  takes its one-to-one shortcut).
"""

import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import mplan2vdl_tpu
import mplan2vdl_tpu_torch
import torch_census_cases as census
import torch_plans
from mplan2vdl_tpu.engine import datagen as jdatagen
from mplan2vdl_tpu.oracle import relinterp as jrel
from mplan2vdl_tpu_torch.engine import datagen as tdatagen
from mplan2vdl_tpu_torch.oracle import relinterp as trel
from mplan2vdl_tpu_torch.oracle.relinterp import equi_join_pairs

# the census's CPU stores: (sf, seed) per family, as the original tests
STORES = {"fuzz": (0.002, 1), "ordered": (0.002, 1), "null": (0.01, 7),
          "corners": (0.01, 7), "semi_anti": (0.01, 7),
          "distinct": (0.02, 11), "tpch": (0.01, 1)}
# the in-code plans' store (at SF 0.01 Q17's part filter keeps parts), and
# a smaller one for the hot join, which both oracles join before they filter
# (torch_plans.CENSUS_SKIP): n^2 / 5 pairs
PLAN_STORE = (0.01, 1)
PLAN_STORES = {"PLAN_HOT_JOIN": (0.002, 1)}
CODE_PLANS = sorted(k for k in vars(torch_plans)
                    if k.startswith("PLAN_") and isinstance(
                        getattr(torch_plans, k), str))

_stores = {}


def _store_pair(sf, seed):
    if (sf, seed) not in _stores:
        t = tdatagen.generate(sf=sf, seed=seed)
        j = jdatagen.generate(sf=sf, seed=seed)
        _stores[sf, seed] = (t, t.make_catalog(), j, j.make_catalog())
    return _stores[sf, seed]


def _dt(arr):
    dt = getattr(arr, "_dt", None)
    return None if dt is None else (type(dt).__name__, repr(dt))


def _same_frames(got, want):
    assert [nm for nm, _ in got.cols] == [nm for nm, _ in want.cols]
    for (nm, g), (_, w) in zip(got.cols, want.cols):
        assert np.asarray(g).dtype == np.asarray(w).dtype, nm
        assert _dt(g) == _dt(w), nm
        assert np.array_equal(np.asarray(g), np.asarray(w)), nm
    assert list(got.nullmasks) == list(want.nullmasks)
    for k, m in got.nullmasks.items():
        assert np.array_equal(m, want.nullmasks[k]), k


@pytest.mark.parametrize("family,name", census.case_names())
def test_census_frames_equal_jax_oracle(family, name):
    ts, tcfg, js, jcfg = _store_pair(*STORES[family])
    got = trel.run_oracle(ts, census.build(mplan2vdl_tpu_torch, family,
                                           name, ts, tcfg))
    want = jrel.run_oracle(js, census.build(mplan2vdl_tpu, family, name,
                                            js, jcfg))
    assert got.n == want.n
    _same_frames(got, want)


@pytest.mark.parametrize("plan", CODE_PLANS)
def test_code_plan_frames_equal_jax_oracle(plan):
    ts, tcfg, js, jcfg = _store_pair(*PLAN_STORES.get(plan, PLAN_STORE))
    text = getattr(torch_plans, plan)
    got = trel.run_oracle(ts, census.text_mplan(mplan2vdl_tpu_torch, text,
                                                tcfg))
    want = jrel.run_oracle(js, census.text_mplan(mplan2vdl_tpu, text, jcfg))
    assert want.n > 0
    _same_frames(got, want)


def test_census_covers_every_family():
    names = census.case_names()
    assert [f for f, _ in names if f not in census.FAMILIES] == []
    assert {f for f, _ in names} == set(census.FAMILIES)
    assert len(names) == len(set(names)) == (
        40 + 40 + 7 + 5 + 2 + 2 + len(torch_plans.AUTO_PLANS)
        - len(torch_plans.CENSUS_SKIP))
    ts, tcfg = _store_pair(*STORES["fuzz"])[:2]
    for family, name in names:  # every plan builds with the port
        assert census.build(mplan2vdl_tpu_torch, family, name, ts,
                            tcfg) is not None


# ------------------------------------------------ the pairing against pandas
def _merge_pairs(lkeys, rkeys):
    """pandas' inner merge of the key tuples, as the JAX oracle calls it:
    (left rows, right rows)."""
    ldf = pd.DataFrame({f"k{i}": np.asarray(k, np.int64)
                        for i, k in enumerate(lkeys)})
    ldf["__li"] = np.arange(len(lkeys[0]))
    rdf = pd.DataFrame({f"k{i}": np.asarray(k, np.int64)
                        for i, k in enumerate(rkeys)})
    rdf["__ri"] = np.arange(len(rkeys[0]))
    merged = ldf.merge(rdf, on=[f"k{i}" for i in range(len(lkeys))])
    return merged["__li"].to_numpy(), merged["__ri"].to_numpy()


def _check(lkeys, rkeys):
    li, ri = equi_join_pairs(lkeys, rkeys)
    pl, pr = _merge_pairs(lkeys, rkeys)
    assert li.dtype == ri.dtype == np.int64
    assert li.tolist() == pl.tolist() and ri.tolist() == pr.tolist()


I64 = np.iinfo(np.int64)
# a few values, so that keys repeat; the int64 limits among them
POOL = st.sampled_from([I64.min, I64.min + 1, -3, -1, 0, 1, 2, 5,
                        I64.max - 1, I64.max])


@st.composite
def sides(draw, values):
    nk = draw(st.integers(1, 3))
    n = draw(st.integers(0, 14))
    m = draw(st.integers(0, 14))
    lk = [np.array(draw(st.lists(values, min_size=n, max_size=n)), np.int64)
          for _ in range(nk)]
    rk = [np.array(draw(st.lists(values, min_size=m, max_size=m)), np.int64)
          for _ in range(nk)]
    if draw(st.booleans()):  # ascending sides take pandas' monotone path
        lk = [np.sort(k) for k in lk]
        rk = [np.sort(k) for k in rk]
    return lk, rk


@settings(max_examples=400, deadline=None)
@given(sides(POOL))
def test_pairs_equal_merge_on_repeated_keys(kk):
    _check(*kk)


@settings(max_examples=200, deadline=None)
@given(sides(st.integers(I64.min, I64.max)))
def test_pairs_equal_merge_on_any_int64_keys(kk):
    _check(*kk)


@settings(max_examples=200, deadline=None)
@given(sides(st.integers(-2, 2)))
def test_pairs_equal_merge_on_few_keys(kk):
    _check(*kk)


def test_pairs_in_left_row_order():
    """The example of pandas' order: by left row, then by right row."""
    lk = [np.array([4, 3, 2, 1, 1, 0, 0, 0, 0, 4, 3, 4])]
    rk = [np.array([2, 3, 4, 3, 3, 2, 2, 4, 1])]
    li, ri = equi_join_pairs(lk, rk)
    assert list(zip(li.tolist(), ri.tolist()))[:6] == [
        (0, 2), (0, 7), (1, 1), (1, 3), (1, 4), (2, 0)]
    _check(lk, rk)


def test_one_to_one_shortcut_order():
    """Right keys repeat and the pair count equals the left row count, so
    pandas returns its one-to-one shortcut's permutation of the pairs, not
    the left row order; the port's pairing returns the same."""
    lk = [np.array([9, 5, 7, 7])]
    rk = [np.array([7, 5, 5, 8])]
    li, ri = equi_join_pairs(lk, rk)
    pairs = list(zip(li.tolist(), ri.tolist()))
    assert len(pairs) == 4 and pairs != sorted(pairs)
    _check(lk, rk)
    _check(lk + [np.ones(4, np.int64)], rk + [np.ones(4, np.int64)])


def test_empty_sides():
    e = np.zeros(0, np.int64)
    for lk, rk in (([e], [np.array([1, 2])]), ([np.array([1])], [e]),
                   ([e, e], [e, e])):
        li, ri = equi_join_pairs(lk, rk)
        assert li.tolist() == [] and ri.tolist() == []
        _check(lk, rk)
