"""The port's plan distributor on the JAX package's distributed plan
fuzz and corner plans, at world size 4.

One world of 4 gloo ranks (``torch_dist_cases.Ranks``) runs
``parallel/auto.distribute`` on every case of
``torch_auto_cases.FUZZ_CASES``, each plan built with the port's own
``mplan``: the 16 random self-join plans and 8 nested group-by plans of
``tests/test_fuzz_dist.py``, its hot-key self-join, the two
count(DISTINCT) plans of ``tests/test_distinct.py`` and the two
``auto.distribute`` plans of ``tests/test_null_semantics.py``.  Each test
builds the same plan with the JAX package's ``mplan`` (checked equal to
the JAX test's own generator where it has one) and runs it through the
JAX ``auto.distribute`` on a mesh of 4 CPU devices: the ``NotDistributable``
decision and text, the ``describe()`` text and the rows (as multisets)
must be JAX's, and the rows the relational oracle's (``relinterp``) where
the plan is an mplan tree.
"""

import random

import numpy as np
import pytest

import torch_auto_cases as A
import torch_dist_cases as C

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = C.Ranks("auto_fuzz", WORLD, str(tmp_path_factory.mktemp("fuzz4")))
    yield r
    r.close()


@pytest.fixture(scope="module")
def jax_side():
    """case -> (vexps' rows or NotDistributable text, describe, oracle
    rows or None, the mplan tree); stores made once each."""
    import jax

    import mplan2vdl_tpu
    from mplan2vdl_tpu.engine import datagen
    from mplan2vdl_tpu.engine.lower import _children
    from mplan2vdl_tpu.oracle import relinterp
    from mplan2vdl_tpu.parallel import auto, dist

    mesh = dist.make_mesh(jax.devices()[:WORLD])
    stores, cache = {}, {}

    def get(case):
        if case in cache:
            return cache[case]
        which = A.store_of(case)
        if which not in stores:
            st = A.make_store(datagen, which)
            stores[which] = (st, st.make_catalog())
        st, cfg = stores[which]
        vexps, m = A.case_vexps(mplan2vdl_tpu, case, st, cfg)
        oracle = None
        if m is not None:
            fr = relinterp.run_oracle(st, m)
            oracle = _rows([a for _, a in fr.cols])
        try:
            dq = auto.distribute(cfg, st, vexps, mesh)
            got = ("rows", _rows([c for _, _, c in dq()]),
                   A.canon_describe(dq, _children))
        except auto.NotDistributable as e:
            got = ("nd", str(e))
        cache[case] = (got, oracle, m)
        return cache[case]

    return get


def _rows(cols):
    return sorted(zip(*[np.asarray(c, np.int64).tolist() for c in cols]))


def _port(res, prefix):
    return _rows([res[f"{prefix}{i}"] for i in range(int(res["ncols"]))])


@pytest.mark.parametrize("case", A.FUZZ_CASES)
def test_distribute_matches_jax(ranks, jax_side, case):
    want, oracle, _ = jax_side(case)
    for res in ranks.case(f"fuzz_{case}"):
        single = _port(res, "s")
        if oracle is not None:
            assert single == oracle, f"{case}: single-device vs oracle"
        if want[0] == "nd":
            assert str(res["nd"]) == want[1]
            continue
        assert str(res["nd"]) == "", f"{case}: JAX distributes it"
        got = _port(res, "c")
        assert got == want[1], f"{case}: port vs JAX distributed rows"
        assert got == single
        if oracle is not None:
            assert got == oracle, f"{case}: distributed vs oracle"
        assert str(res["describe"]) == want[2]


def test_generators_are_the_jax_tests(jax_side):
    """The JAX-built trees are the JAX tests' own plans."""
    import test_fuzz_dist

    for s in range(A.N_JOIN_SEEDS):
        assert jax_side(f"join{s}")[2] == test_fuzz_dist._rand_join_plan(
            random.Random(1000 + s))
    for s in range(A.N_NESTED_SEEDS):
        assert jax_side(f"nested{s}")[2] == \
            test_fuzz_dist._rand_nested_plan(random.Random(5000 + s))


def test_distributed_coverage(ranks):
    """The generator must exercise the distributed join paths: at least
    half of the join seeds distribute, and some through a partitioned
    shuffle join."""
    ok = [c for c in (f"join{s}" for s in range(A.N_JOIN_SEEDS))
          if str(ranks.case(f"fuzz_{c}")[0]["nd"]) == ""]
    assert len(ok) >= A.N_JOIN_SEEDS // 2, ok
    assert any(int(ranks.case(f"fuzz_{c}")[0]["part_joins"]) for c in ok)


def test_hot_key_takes_the_broadcast_path(ranks, jax_side):
    """The hot supplier is detected as heavy and the exchange capacities
    stay near the uniform-keys size on every rank (the JAX test's bound),
    through a partitioned join."""
    (res, *_) = ranks.case("fuzz_hot_key")
    assert int(res["part_joins"]) == 1 and int(res["heavy"]) == 1
    text = str(res["describe"])
    caps = text.split("caps(l/r/pairs/exp)=")[1].split()[0].split("/")
    cap_l, cap_pairs = int(caps[0]), int(caps[2])
    shard_rows = int(text.split(" rows/shard")[0].split(", ")[-1])
    uniform = 2 * -(-shard_rows // WORLD) + 64
    assert cap_l <= 2 * uniform and cap_pairs <= 4 * uniform
    assert jax_side("hot_key")[0][2] == text
