"""Ordered fuzz plans: the port against the JAX engine on the CPU, row for
row in order.

Each plan is one of tests/test_fuzz.py's random plans, built with each
package's own ``mplan``, ordered by every output in random directions, so
that the order is total, and cut by a top N for odd seeds
(``torch_census_cases.ordered_rand_plan``).
"""

import pytest

from test_torch_corpus import ENGINES
from test_torch_ordered import _cols, _equal, _sorted_by
from mplan2vdl_tpu import passes as jpasses
from mplan2vdl_tpu import vir as jV
from mplan2vdl_tpu.engine import datagen as jdatagen
from mplan2vdl_tpu.engine import lower as jlower
from mplan2vdl_tpu_torch import passes as tpasses
from mplan2vdl_tpu_torch import vir as tV
from mplan2vdl_tpu_torch.engine import datagen as tdatagen
from mplan2vdl_tpu_torch.engine import lower as tlower
from torch_census_cases import ordered_rand_plan


@pytest.fixture(scope="module")
def fuzz_stores():
    """test_fuzz's store: SF 0.002, seed 1."""
    ts = tdatagen.generate(sf=0.002, seed=1)
    js = jdatagen.generate(sf=0.002, seed=1)
    return ts, ts.make_catalog(), js, js.make_catalog()


@pytest.mark.parametrize("seed", range(40))
def test_ordered_fuzz_in_order(fuzz_stores, seed):
    ts, tcfg, js, jcfg = fuzz_stores
    plans = {k: ordered_rand_plan(M, DD, seed)
             for k, (M, DD) in ENGINES.items()}
    got = _cols(tlower.CompiledQuery(tcfg, tpasses.engine_passes(
        tV.vexps_from_mplan(plans["port"], tcfg)), ts, device="cpu")())
    want = _cols(jlower.CompiledQuery(jcfg, jpasses.engine_passes(
        jV.vexps_from_mplan(plans["jax"], jcfg)), js)())
    _equal(got, want)
    order = (plans["port"].child if seed % 2 else plans["port"]).order
    assert len(order) == len(got)
    if len(got[0]) > 1:
        assert _sorted_by(got, [(i, d == "desc")
                                for i, (_, d) in enumerate(order)])
