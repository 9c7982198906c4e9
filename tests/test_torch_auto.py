"""The plan analysis of the port's distributor (``parallel/auto.py``)
against the JAX package's, with no ranks.

For every in-code plan (``torch_plans.AUTO_PLANS``) and every fuzz and
corner plan of ``torch_auto_cases.FUZZ_CASES`` (each built with each
package's own ``mplan``), the port's ``_rewrite_distinct_folds``,
``_collect_folds``, ``_plan_part_joins`` and ``_plan_regions`` must give
JAX's results, compared through each node's place in a post-order walk of
the DAG (``torch_auto_cases.canon_map``: interning numbers differ between
the packages), and the port's ``NotDistributable`` decision, with its
text, JAX's, also under each of the two switches (MPLAN2VDL_NO_PART_JOIN,
MPLAN2VDL_NO_SPARSE_JOIN).  The analysis functions themselves are checked to be the same
code as JAX's, docstrings aside.  ``torch_plans.EXPECTED_NOT_DISTRIBUTABLE``
is JAX's verdict at the key widths of the card's scale.
"""

import ast
import dataclasses
import inspect

import pytest
import torch

import mplan2vdl_tpu
import mplan2vdl_tpu_torch
import torch_auto_cases as A
import torch_plans
from mplan2vdl_tpu.engine import datagen as jdatagen
from mplan2vdl_tpu.engine import lower as jlower
from mplan2vdl_tpu.parallel import auto as jauto
from mplan2vdl_tpu_torch.engine import datagen as tdatagen
from mplan2vdl_tpu_torch.engine import lower as tlower
from mplan2vdl_tpu_torch.parallel import auto as tauto
from mplan2vdl_tpu_torch.parallel import dist as tdist

PKGS = {"port": (mplan2vdl_tpu_torch, tdatagen, tlower, tauto),
        "jax": (mplan2vdl_tpu, jdatagen, jlower, jauto)}
CASES = [f"cli_{p}" for p in sorted(torch_plans.AUTO_PLANS)] + A.FUZZ_CASES
# the functions the port keeps line for line
ANALYSIS = ("_collect_folds", "_joins_under", "_contains_right_join",
            "_rowid_chain", "_frame_pos_chain", "_chain_through",
            "_rowid_leaks", "_loads_outside_part", "_plan_part_joins",
            "_plan_regions", "_loads_under", "_rewrite_distinct_folds")


def _body(fn):
    """A function's AST with its docstrings removed."""
    tree = ast.parse(inspect.getsource(fn))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.body \
                and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant) \
                and isinstance(node.body[0].value.value, str):
            node.body = node.body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("name", ANALYSIS)
def test_analysis_is_jax_code(name):
    assert _body(getattr(tauto, name)) == _body(getattr(jauto, name))


def test_join_side_sets_are_jax():
    assert tauto._PART_SIDES == jauto._PART_SIDES
    assert tauto._OUTER_SIDES == jauto._OUTER_SIDES


@pytest.fixture(scope="module")
def stores():
    """(package, store name) -> (store, catalog), made on first use."""
    cache = {}

    def get(pkg, which):
        if (pkg, which) not in cache:
            datagen = PKGS[pkg][1]
            if which in ("cli", "card_keys"):
                st = datagen.generate(sf=A.CLI_SF, seed=A.CLI_SEED)
            else:
                st = A.make_store(datagen, which)
            cfg = st.make_catalog()
            if which == "card_keys":
                A.widen_keys(cfg, torch_plans.CARD_SF)
            cache[pkg, which] = (st, cfg)
        return cache[pkg, which]

    return get


def _vexps(stores, pkg, case):
    package, _, lower, _ = PKGS[pkg]
    if case.startswith(("cli_", "card_keys_")):
        which, plan = (("card_keys", case[10:]) if case.startswith("card")
                       else ("cli", case[4:]))
        st, cfg = stores(pkg, which)
        return st, cfg, lower.plan_to_vexps(torch_plans.AUTO_PLANS[plan], cfg)
    st, cfg = stores(pkg, A.store_of(case))
    return st, cfg, A.case_vexps(package, case, st, cfg)[0]


def _structure(vexps, children):
    """Each node in post order: its kind, its other fields (repr) and its
    children's places."""
    idx = A.canon_map(vexps, children)
    nodes, out = {}, []

    def go(v):
        if v.skey in nodes:
            return
        nodes[v.skey] = v
        for c in children(v.vx):
            go(c)
        vx = v.vx
        kids = {id(c) for c in children(vx)}
        fields = tuple((f.name, repr(getattr(vx, f.name)))
                       for f in dataclasses.fields(vx)
                       if id(getattr(vx, f.name)) not in kids
                       and not isinstance(getattr(vx, f.name), tuple))
        out.append((type(vx).__name__, fields,
                    tuple(idx[c.skey] for c in children(vx)), v.info.count,
                    v.info.bounds))

    for v in vexps:
        go(v)
    return out


def _vals(obj, idx):
    """``obj`` with every Vexp as its place."""
    if hasattr(obj, "skey") and hasattr(obj, "vx"):
        return ("node", idx[obj.skey])
    if isinstance(obj, dict):
        return sorted((k, _vals(v, idx)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return [_vals(x, idx) for x in obj]
    return obj


def _canon_part(pj, idx):
    """``_plan_part_joins``'s four results with skeys as places (the
    joins in their post order)."""
    part_joins, part_pay, part_skip, part_roots = pj
    return ([((idx[a], idx[b]), _vals(spec, idx))
             for (a, b), spec in part_joins.items()],
            sorted((idx[g], (idx[k[0]], idx[k[1]]), i)
                   for g, (k, i) in part_pay.items()),
            sorted(idx[g] for g in part_skip),
            [idx[v.skey] for v in part_roots])


def _canon_regions(regions, idx):
    """``_plan_regions``'s five results with skeys as places."""
    scatters, replicate, fullsrc, extra_full, full_roots = regions
    return ([sorted((idx[k], idx[v.skey]) for k, v in d.items())
             for d in (scatters, replicate, fullsrc)]
            + [list(extra_full), [idx[v.skey] for v in full_roots]])


def _analysis(stores, pkg, case, fact, fact_count):
    """The port's or JAX's analysis of one plan, canonicalized."""
    _, _, lower, auto = PKGS[pkg]
    st, _, vexps = _vexps(stores, pkg, case)
    out = {}
    try:
        vexps = auto._rewrite_distinct_folds(vexps)
    except auto.NotDistributable as e:
        return {"rewrite": str(e)}
    idx = A.canon_map(vexps, lower._children)
    out["rewrite"] = _structure(vexps, lower._children)
    folds = auto._collect_folds(vexps)
    out["folds"] = [idx[f.skey] for f in folds]
    if fact is None:
        return out
    roots = folds or list(vexps)
    pj = auto._plan_part_joins(roots, fact, fact_count, st)
    out["part_joins"] = _canon_part(pj, idx)
    try:
        regions = auto._plan_regions(roots, fact, fact_count,
                                     frozenset(pj[0]), frozenset(pj[2]),
                                     tuple(pj[3]))
        out["regions"] = _canon_regions(regions, idx)
    except auto.NotDistributable as e:
        out["regions"] = str(e)
    return out


def _port_plan(stores, case):
    """The port's AutoDistributed analysis alone (``_plan``, no data
    moved): the object, or the NotDistributable text."""
    st, cfg, vexps = _vexps(stores, "port", case)
    dq = tauto.AutoDistributed.__new__(tauto.AutoDistributed)
    dq.cfg, dq.store, dq.vexps = cfg, st, vexps
    dq.mesh = tdist.Mesh(group=None, rank=0, size=1,
                         device=torch.device("cpu"))
    try:
        dq._plan()
    except tauto.NotDistributable as e:
        return str(e)
    return dq


@pytest.mark.parametrize("case", CASES)
def test_analysis_matches_jax(stores, case):
    plan = _port_plan(stores, case)
    fact = None if isinstance(plan, str) else plan.fact
    count = None if isinstance(plan, str) else plan.fact_count
    got = _analysis(stores, "port", case, fact, count)
    want = _analysis(stores, "jax", case, fact, count)
    assert got == want


def _decisions(stores, case):
    """The port's NotDistributable text (None: it distributes) and what
    JAX's distribute decides on a mesh of one device."""
    import jax

    from mplan2vdl_tpu.parallel import dist

    plan = _port_plan(stores, case)
    st, cfg, vexps = _vexps(stores, "jax", case)
    try:
        jauto.distribute(cfg, st, vexps, dist.make_mesh(jax.devices()[:1]))
        want = None
    except jauto.NotDistributable as e:
        want = str(e)
    except RuntimeError:  # the JAX group stage's Q17 fault comes later
        want = None
    return (plan if isinstance(plan, str) else None), want


@pytest.mark.parametrize("case", CASES)
def test_not_distributable_decision_matches_jax(stores, case):
    """The port decides what JAX's distribute decides on a mesh of one
    device, with the same text."""
    got, want = _decisions(stores, case)
    assert got == want


@pytest.mark.parametrize("plan", sorted(torch_plans.AUTO_PLANS))
def test_expected_not_distributable_is_jax_verdict(stores, plan):
    """torch_plans.EXPECTED_NOT_DISTRIBUTABLE holds JAX's verdict on each
    plan of phase 8 at the key widths of the card's scale (CARD_SF's key
    bounds over the CLI store): the refusal's text for the plans it names,
    and none for the rest; the port decides the same."""
    got, want = _decisions(stores, f"card_keys_{plan}")
    assert got == want == torch_plans.EXPECTED_NOT_DISTRIBUTABLE.get(plan)


def test_card_keys_are_the_generators():
    """widen_keys gives each key column the generator's bounds (checked at
    a small scale, where they can be generated): a primary key's exactly,
    a foreign key's (drawn at random) from above, within 1%."""
    sf = 0.003
    want = tdatagen.generate(sf=sf, seed=A.CLI_SEED).make_catalog()
    got = A.widen_keys(tdatagen.generate(sf=A.CLI_SF, seed=A.CLI_SEED)
                       .make_catalog(), sf)
    for col in A.KEY_COLUMNS:
        (lo, hi), (wlo, whi) = (c.colinfo.lookup(col)[1].bounds
                                for c in (got, want))
        assert lo == wlo == 1 and whi <= hi <= whi * 1.01, col
        if col[1] in ("o_orderkey", "p_partkey", "s_suppkey", "c_custkey"):
            assert hi == whi, col


# the switches of both packages' distributor: the replicated right side for
# every join, and no equijoin inside a sparse group-by
SWITCHES = ("MPLAN2VDL_NO_PART_JOIN", "MPLAN2VDL_NO_SPARSE_JOIN")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("switch", SWITCHES)
def test_switch_decision_matches_jax(stores, monkeypatch, switch, case):
    """With a switch set, the port still decides as JAX, with the same
    text; the sparse-join switch refuses the self-join under a sparse
    group-by."""
    monkeypatch.setenv(switch, "1")
    got, want = _decisions(stores, case)
    assert got == want
    if switch == "MPLAN2VDL_NO_SPARSE_JOIN" and case == "sparse_join":
        assert got == "equijoin in a sparse group-by"
    if switch == "MPLAN2VDL_NO_PART_JOIN" and case == "cli_self_join":
        assert got is None
