"""The JAX package's CPU test plans through the port and the JAX engine.

Each plan is built once with each package's own ``mplan`` module, so that
each engine lowers its own tree, and runs through both engines on the CPU;
the rows must be equal as multisets.  The plans:

* the 40 random plans of tests/test_fuzz.py, re-stated with the ``mplan``
  module as a parameter (``torch_census_cases.rand_plan``; the JAX-built
  tree is checked equal to test_fuzz's own), also held against the JAX
  package's relational oracle;
* the seven single-device plans of tests/test_null_semantics.py (outer
  joins with null-aware aggregates, comparisons, ``isnull``, extra ON
  conditions);
* a semi and an anti join with an extra condition, which mark the left rows
  through a scatter of repeated positions; a spy shows the port took its
  repeated-position scatter, and the relational oracle checks the rows.

The plans are built by tests/torch_census_cases.py, whose census
chip_smoke.py's phase 9 runs on the card.  The three plans of tests/test_join_corners.py,
the rest of the census, are held against the JAX engine and the oracle in
tests/test_torch_joins.py.
"""

import random

import numpy as np
import pytest

import test_fuzz
from mplan2vdl_tpu import mplan as jM
from mplan2vdl_tpu import passes as jpasses
from mplan2vdl_tpu import vir as jV
from mplan2vdl_tpu.engine import datagen as jdatagen
from mplan2vdl_tpu.engine import lower as jlower
from mplan2vdl_tpu.mtypes import DDecimal as jDDecimal
from mplan2vdl_tpu.oracle import relinterp
from mplan2vdl_tpu_torch import mplan as tM
from mplan2vdl_tpu_torch import passes as tpasses
from mplan2vdl_tpu_torch import vir as tV
from mplan2vdl_tpu_torch.engine import datagen as tdatagen
from mplan2vdl_tpu_torch.engine import lower as tlower
from mplan2vdl_tpu_torch.mtypes import DDecimal as tDDecimal
from torch_census_cases import (NULL_PLANS, SEMI_ANTI, extra_condition_join,
                                null_plan, rand_plan)

ENGINES = {"port": (tM, tDDecimal), "jax": (jM, jDDecimal)}


# ----------------------------------------------------------------- helpers
def run_both(stores, plans):
    """Each engine's tree (``plans``: engine -> RelExpr) through its own
    engine on the CPU: (port columns, JAX columns), as int64 arrays."""
    ts, tcfg, js, jcfg = stores
    tq = tlower.CompiledQuery(
        tcfg, tpasses.engine_passes(tV.vexps_from_mplan(plans["port"], tcfg)),
        ts, device="cpu")
    jq = jlower.CompiledQuery(
        jcfg, jpasses.engine_passes(jV.vexps_from_mplan(plans["jax"], jcfg)),
        js)
    got, want = tq(), jq()
    assert got.names == want.names
    return ([np.asarray(c, np.int64) for c in got.columns],
            [np.asarray(c, np.int64) for c in want.columns])


def rows(cols):
    return sorted(zip(*[c.tolist() for c in cols])) if cols else []


def oracle_rows(store, plan):
    fr = relinterp.run_oracle(store, plan)
    return rows([np.asarray(a, np.int64) for _, a in fr.cols])


def _stores(sf, seed):
    ts = tdatagen.generate(sf=sf, seed=seed)
    js = jdatagen.generate(sf=sf, seed=seed)
    return ts, ts.make_catalog(), js, js.make_catalog()


@pytest.fixture(scope="module")
def fuzz_stores():
    """test_fuzz's store: SF 0.002, seed 1."""
    return _stores(0.002, 1)


@pytest.fixture(scope="module")
def stores():
    """test_null_semantics' store: SF 0.01, seed 7."""
    return _stores(0.01, 7)


# -------------------------------------------------------------- fuzz plans
@pytest.mark.parametrize("seed", range(40))
def test_fuzz_plan(fuzz_stores, seed):
    plans = {k: rand_plan(M, DD, random.Random(seed))
             for k, (M, DD) in ENGINES.items()}
    assert plans["jax"] == test_fuzz._rand_plan(random.Random(seed))
    got, want = run_both(fuzz_stores, plans)
    assert rows(got) == rows(want)
    assert rows(got) == oracle_rows(fuzz_stores[2], plans["jax"])


# ------------------------------------------------------ null-semantics plans
@pytest.mark.parametrize("which", NULL_PLANS)
def test_null_semantics_plan(stores, which):
    tp = np.asarray(stores[2].columns[("orders", "o_totalprice")])
    plans = {k: null_plan(M, DD, which, tp) for k, (M, DD) in ENGINES.items()}
    got, want = run_both(stores, plans)
    assert got and len(got[0]) > 0
    assert rows(got) == rows(want)


# ------------------------------------ semi and anti joins, extra condition
@pytest.mark.parametrize("variant", SEMI_ANTI)
def test_extra_condition_semi_anti(stores, monkeypatch, variant):
    calls = []

    def spy(p, src, L):
        calls.append((p.shape[0], L, int(p[p < L].unique().numel())))
        return repeat_scatter(p, src, L)

    repeat_scatter = tlower.repeat_scatter
    monkeypatch.setattr(tlower, "repeat_scatter", spy)
    plans = {k: extra_condition_join(M, DD, getattr(M, variant))
             for k, (M, DD) in ENGINES.items()}
    got, want = run_both(stores, plans)
    assert got and len(got[0]) > 0
    assert rows(got) == rows(want)
    assert rows(got) == oracle_rows(stores[2], plans["jax"])
    # the left-row marks: positions repeat (several lineitems of an order)
    assert calls and any(n > distinct for n, _, distinct in calls), calls
