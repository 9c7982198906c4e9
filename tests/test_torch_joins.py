"""The port's general equijoin, Like, DictMap and CrossProduct against the
JAX engine, on the CPU.

Every comparison is exact, as row multisets: within a run of equal join keys
the two engines may order pairs differently.  Covered here:

* the join-corner plans of tests/test_join_corners.py (an anti-join keeping
  the dimension side, a left outer join on an FK pair, a self-join with
  both sides filtered), a semi join and an inner join on a non-FK pair,
  each built with each engine's own ``mplan`` and held against the JAX
  package's relational oracle too;
* the dense-domain and the sort-merge join give the same rows
  (MPLAN2VDL_NO_DENSE_JOIN set and unset), with a spy showing which ran;
* sibling dense joins (one probe key vector, two build sides) share one
  gather launch, over a signed key domain;
* the packed run table at a run of 65,535 equal keys (the int32 sign bit);
* ``Like`` at up to 128 and at more than 128 matching codes, negated too,
  its code table built once per compiled query; ``DictMap`` at up to 64
  and at more than 64 entries;
* ``CrossProduct`` through ``cfg.cross_product``.
"""

import dataclasses
import re

import numpy as np
import pytest

import torch_plans
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
from torch_census_cases import CORNERS, corner

SF = 0.01
SEEDS = (7, 11)


@pytest.fixture(scope="module")
def stores():
    """seed -> (port store, its catalog, JAX store, its catalog)."""
    out = {}
    for seed in SEEDS:
        ts = tdatagen.generate(sf=SF, seed=seed)
        js = jdatagen.generate(sf=SF, seed=seed)
        out[seed] = (ts, ts.make_catalog(), js, js.make_catalog())
    return out


def _rows(cols):
    return sorted(zip(*[np.asarray(c, np.int64).tolist() for c in cols]))


def _both(stores, seed, text, cfg_change=None):
    """The plan text through the port and the JAX engine: (port result,
    JAX result, the port's CompiledQuery)."""
    ts, tcfg, js, jcfg = stores[seed]
    if cfg_change:
        tcfg = dataclasses.replace(tcfg, **cfg_change)
        jcfg = dataclasses.replace(jcfg, **cfg_change)
    tq = tlower.CompiledQuery(tcfg, tlower.plan_to_vexps(text, tcfg), ts,
                              device="cpu")
    got = tq()
    want = jlower.CompiledQuery(jcfg, jlower.plan_to_vexps(text, jcfg),
                                js)()
    assert got.names == want.names
    assert [g.dtype for g in got.columns] == [w.dtype for w in want.columns]
    return got, want, tq


# ------------------------------------------------------------ corner plans
def _run_corner(stores, seed, which):
    ts, tcfg, js, jcfg = stores[seed]
    tplan = corner(tM, tDDecimal, which)
    jplan = corner(jM, jDDecimal, which)
    tq = tlower.CompiledQuery(
        tcfg, tpasses.engine_passes(tV.vexps_from_mplan(tplan, tcfg)), ts,
        device="cpu")
    got = tq()
    want = jlower.CompiledQuery(
        jcfg, jpasses.engine_passes(jV.vexps_from_mplan(jplan, jcfg)), js)()
    oracle = relinterp.run_oracle(js, jplan)
    return got, want, [a for _, a in oracle.cols], tq


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("which", list(CORNERS))
def test_corner_matches_jax_and_oracle(stores, seed, which):
    got, want, oracle, tq = _run_corner(stores, seed, which)
    assert _rows(got.columns) == _rows(want.columns) == _rows(oracle)
    assert len(got.columns[0]) > 0
    assert {j["side"] for j in tq.join_log} == CORNERS[which]
    if which == "left_outer_fk":  # every lineitem row survives
        assert len(got.columns[0]) == stores[seed][0].table_count(
            ("lineitem",))


# ------------------------------------------------------- dense and merge
def _spy_paths(monkeypatch):
    calls = {"dense": 0, "merge": 0}
    orig = tlower.Compiler._dense_join

    def spy(self, *a, **kw):
        out = orig(self, *a, **kw)
        calls["dense" if out is not None else "merge"] += 1
        return out

    monkeypatch.setattr(tlower.Compiler, "_dense_join", spy)
    return calls


DENSE_PLANS = ["q13", "q17", "antijoin_dim_side", "left_outer_fk",
               "self_join_filtered", "semi_nonfk"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("plan", DENSE_PLANS)
def test_dense_matches_merge(stores, monkeypatch, seed, plan):
    """At SF 0.01 every one of these joins is eligible for the dense
    path; with MPLAN2VDL_NO_DENSE_JOIN=1 none takes it, and the rows stay
    the same."""
    def run():
        if plan in CORNERS:
            got, want, _, tq = _run_corner(stores, seed, plan)
        else:
            got, want, tq = _both(stores, seed, getattr(
                torch_plans, f"PLAN_{plan.upper()}"))
        assert _rows(got.columns) == _rows(want.columns)
        return _rows(got.columns), {j["path"] for j in tq.join_log}

    calls = _spy_paths(monkeypatch)
    monkeypatch.delenv("MPLAN2VDL_NO_DENSE_JOIN", raising=False)
    dense_rows, dense_paths = run()
    assert calls["dense"] > 0 and calls["merge"] == 0
    assert dense_paths == {"dense"}
    calls.update(dense=0, merge=0)
    monkeypatch.setenv("MPLAN2VDL_NO_DENSE_JOIN", "1")
    merge_rows, merge_paths = run()
    assert calls["dense"] == 0 and calls["merge"] > 0
    assert merge_paths == {"merge"}
    assert dense_rows == merge_rows


def test_dense_path_needs_ascending_probes_past_small_table(stores,
                                                           monkeypatch):
    """With SMALL_TABLE moved below Q17's key domain, its probe keys (not
    ascending) send the join to the merge path, as the eligibility rule
    says; Q13's customer keys ascend, so its join stays dense."""
    monkeypatch.setattr(tlower, "SMALL_TABLE", 100)
    for plan, path in (("PLAN_Q17", "merge"), ("PLAN_Q13", "dense")):
        got, want, tq = _both(stores, SEEDS[0], getattr(torch_plans, plan))
        assert _rows(got.columns) == _rows(want.columns)
        assert {j["path"] for j in tq.join_log} == {path}


def _sibling_vexps(V, cfg, M):
    """Two inner joins probing the same keys (c_nationkey - 12, a signed
    domain) against supplier's and nation's keys shifted alike; the
    result columns are both joins' left and right row indices."""
    def shifted(col):
        v = V.load_raw(cfg, col)
        return V.complete(V.Binop(binop=M.SUB, left=v,
                                  right=V.const_(12, v)))

    lk = shifted(("customer", "c_nationkey"))
    out = []
    for col in (("supplier", "s_nationkey"), ("nation", "n_nationkey")):
        rk = shifted(col)
        out += [V.complete(V.JoinIndex(lkeys=lk, rkeys=rk, jside=side))
                for side in (V.JLEFT, V.JRIGHT)]
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_sibling_dense_joins_share_one_gather(stores, monkeypatch, seed):
    ts, tcfg, js, jcfg = stores[seed]
    calls = []
    gather_many = tlower.gather_many

    def spy(srcs, pos, valid, small=False):
        calls.append((len(srcs), small, srcs[0].dtype))
        return gather_many(srcs, pos, valid, small=small)

    monkeypatch.setattr(tlower, "gather_many", spy)
    tv = _sibling_vexps(tV, tcfg, tM)
    assert tv[0].vx.lkeys.info.bounds[0] == -12
    tq = tlower.CompiledQuery(tcfg, tv, ts, device="cpu")
    got = tq()
    want = jlower.CompiledQuery(jcfg, _sibling_vexps(jV, jcfg, jM), js)()
    # each join's (left, right) pairs, as multisets
    for a in (0, 2):
        assert _rows(got.columns[a:a + 2]) == _rows(want.columns[a:a + 2])
        assert len(got.columns[a]) > 0
    assert [j["path"] for j in tq.join_log] == ["dense"] * 4
    # the two packed run tables (int32) went through one small gather
    tables = [c for c in calls if c[2] == tlower.torch.int32 and c[1]
              and c[0] == 2]
    assert len(tables) == 1


def test_packed_run_table_sign_bit():
    """A run of DENSE_RIGHT_MAX equal keys packs its length into the int32
    sign bit; the decode (arithmetic shift, low 16 bits) reads it back."""
    torch = tlower.torch
    m = tlower.DENSE_RIGHT_MAX
    r_ok = torch.full((m,), 3, dtype=torch.int32)
    r_ok[:2] = 1  # key 1: rows 0-1; key 3: the rest; key 2: none
    rs_idx, packed = tlower._dense_tab(r_ok, m, klo=1, D=4)
    assert packed[2] < 0
    lo, cnt = packed & 0xFFFF, (packed >> 16) & 0xFFFF
    assert lo.tolist() == [0, m, 2, m] and cnt.tolist() == [2, 0, m - 2, 0]
    r_ok = torch.full((m,), 7, dtype=torch.int32)
    r_ok[-1] = 9  # a sentinel row: dropped from the table
    _, packed = tlower._dense_tab(r_ok, m, klo=7, D=2)
    assert ((packed >> 16) & 0xFFFF).tolist() == [m - 1, 0]
    assert (packed & 0xFFFF).tolist() == [0, m]
    assert torch.equal(rs_idx.long(), torch.arange(m))


# ---------------------------------------------------------- Like, DictMap
def _like_plan(pattern, negated=False):
    return f"""project (
| select (
| | table(sys.part) [ part.p_partkey NOT NULL, part.p_name NOT NULL ] COUNT
| ) [ part.p_name NOT NULL {'! ' if negated else ''}FILTER like (varchar[char({len(pattern)}) "{pattern}"], varchar "") ]
) [ part.p_partkey, part.p_name ]
"""


def _substr_plan(tab, col, length):
    return f"""project (
| group by (
| | project (
| | | table(sys.{tab}) [ {tab}.{col} NOT NULL ] COUNT
| | ) [ sys.substring({tab}.{col} NOT NULL, int "1", int "{length}") as s.code ]
| ) [ s.code ] [ s.code, sys.count() NOT NULL as L1.L1 ]
) [ s.code, L1 as L2.n ]
"""


LIKES = [("%green%", False, "le128"), ("%a%", False, "gt128"),
         ("%a%", True, "gt128")]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pattern,negated,size", LIKES,
                         ids=[f"{p}-{'not-' if n else ''}{s}"
                              for p, n, s in LIKES])
def test_like_matches_jax_and_oracle(stores, seed, pattern, negated, size):
    ts = stores[seed][0]
    dec = ts.decoders[("part", "p_name")]
    rx = re.compile(pattern.strip("%"))
    codes = [c for c, s in dec.items() if rx.search(s)]
    assert (len(codes) <= 128) == (size == "le128")
    got, want, tq = _both(stores, seed, _like_plan(pattern, negated))
    name = ts.columns[("part", "p_name")]
    keep = np.isin(name, codes) != negated
    assert _rows(got.columns) == _rows(want.columns) == _rows(
        [ts.columns[("part", "p_partkey")][keep], name[keep]])
    assert len(tq.lookups) == 1
    tab = next(iter(tq.lookups.values()))
    assert int(tab[1].sum()) == len(codes)
    tq()  # a second call reuses the table
    assert next(iter(tq.lookups.values())) is tab


SUBSTRS = [("customer", "c_mktsegment", 1, "le64"),
           ("customer", "c_phone", 2, "gt64"),
           ("part", "p_name", 3, "gt64")]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("tab,col,length,size", SUBSTRS,
                         ids=[f"{c}-{s}" for _, c, _, s in SUBSTRS])
def test_dictmap_matches_jax_and_oracle(stores, seed, tab, col, length,
                                        size):
    ts = stores[seed][0]
    got, want, tq = _both(stores, seed, _substr_plan(tab, col, length))
    dmap = [tq_v for tq_v in _nodes(tq.vexps) if isinstance(tq_v.vx,
                                                           tV.DictMap)]
    assert len(dmap) == 1
    assert (len(dmap[0].vx.mapping) <= 64) == (size == "le64")
    derived, _ = torch_plans.substr_codes(ts, tab, col, 1, length)
    codes = np.asarray([derived[int(x)] for x in ts.columns[(tab, col)]])
    oracle = torch_plans._group([codes], [(np.ones(len(codes), np.int64),
                                          np.add)])
    assert _rows(got.columns) == _rows(want.columns) == _rows(oracle)


def _nodes(roots):
    seen, out, stack = set(), [], list(roots)
    while stack:
        v = stack.pop()
        if v.skey in seen:
            continue
        seen.add(v.skey)
        out.append(v)
        stack.extend(tlower._children(v.vx))
    return out


# ----------------------------------------------------------- cross product
PLAN_CROSS = """project (
| join (
| | table(sys.nation) [ nation.n_nationkey NOT NULL, nation.n_regionkey NOT NULL ] COUNT,
| | select (
| | | table(sys.region) [ region.r_regionkey NOT NULL, region.r_name NOT NULL ] COUNT
| | ) [ region.r_regionkey NOT NULL < int "3" ]
| ) [ nation.n_regionkey NOT NULL = region.r_regionkey NOT NULL ]
) [ nation.n_nationkey, region.r_name ]
"""


@pytest.mark.parametrize("seed", SEEDS)
def test_cross_product_matches_jax(stores, seed):
    got, want, tq = _both(stores, seed, PLAN_CROSS,
                          cfg_change={"cross_product": True})
    variants = {v.vx.variant for v in _nodes(tq.vexps)
                if isinstance(v.vx, tV.CrossProduct)}
    assert variants == {tV.COUTER, tV.CINNER}
    ts = stores[seed][0]
    nat_reg = ts.columns[("nation", "n_regionkey")]
    keep = nat_reg < 3
    reg_name = ts.columns[("region", "r_name")]
    assert _rows(got.columns) == _rows(want.columns) == _rows(
        [ts.columns[("nation", "n_nationkey")][keep],
         reg_name[nat_reg[keep]]])
