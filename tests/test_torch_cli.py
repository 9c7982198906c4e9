"""The port's command line against the JAX package's, on the CPU.

``compile`` (under every flag set, and with ``--dot``), ``explain`` and
``genplans`` print the same bytes as the JAX CLI on every in-code plan
(torch_plans.CLI_PLANS), against metadata files written from a generated
store by ``torch_plans.write_metadata``; the reference UX (no subcommand
means compile, no FILE means stdin) holds through the port's ``main``.
``run --cpu`` prints the JAX ``run --cpu`` CSV (Q3 as a row multiset: the
engines may order the pairs within a run of equal join keys differently),
and ``run --devices 4 --cpu`` (four gloo ranks) the JAX CLI's bytes on a
mesh of four CPU devices.
``CompiledQuery.cost_report`` is checked against the device arguments and
the JAX engine's scan bytes, and ``run --profile`` / ``--roofline`` write
what they promise.  Every comparison is exact."""

import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import torch_plans
from mplan2vdl_tpu import catalog as jcatalog
from mplan2vdl_tpu import cli as jcli
from mplan2vdl_tpu.engine import datagen as jdatagen
from mplan2vdl_tpu.engine import lower as jlower
from mplan2vdl_tpu_torch import cli as tcli
from mplan2vdl_tpu_torch.engine import datagen as tdatagen
from mplan2vdl_tpu_torch.engine import lower as tlower

SF, SEED = 0.01, 7
PLANS = sorted(torch_plans.CLI_PLANS)
META_FILES = ("bounds.csv", "storage.csv", "schema.msqldump",
              "dictionary.csv")
FLAG_SETS = {"default": [], "push": ["-p"], "no_cleanup": ["--no-cleanup"],
             "vlite": ["--vliteformat"], "metadata": ["--metadata"],
             "aggserial": ["--aggserial"],
             "agghierarchical": ["--agghierarchical", "-g", "4"],
             "aggshuffle": ["--aggshuffle"],
             "cross_product": ["--use-cross-product"],
             "no_quirks": ["--no-quirks"], "quirks": ["--quirks"]}
# the inline texts of tests/test_tree_parser.py: a plan the strict grammar
# rejects, and an unknown operator with exotic raw arguments
DOT_TEXTS = {
    "mystery": "mystery op ( table(sys.region) [ r_regionkey ] COUNT ) "
               "[ zz ]",
    "frobnicate": """frobnicate quantum (
  table(sys.lineitem) [ lineitem.l_orderkey NOT NULL HASHCOL ] COUNT
) [ wormhole(%17, "xyz") as L1.zap, [ nested, list ] ]"""}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The metadata files of a generated store and one file per plan."""
    root = tmp_path_factory.mktemp("cli")
    store = tdatagen.generate(sf=SF, seed=SEED)
    torch_plans.write_metadata(store, str(root / "meta"))
    (root / "plans").mkdir()
    for name, text in torch_plans.CLI_PLANS.items():
        (root / "plans" / f"{name}.mplan").write_text(text)
    for name, text in DOT_TEXTS.items():
        (root / f"{name}.txt").write_text(text)
    meta = [str(root / "meta" / f) for f in META_FILES]
    return {"root": root, "store": store, "meta": meta,
            "flags": ["-b", meta[0], "-t", meta[1], "-s", meta[2],
                      "--dictionary", meta[3]]}


def _plan(files, name):
    return str(files["root"] / "plans" / f"{name}.mplan")


def _both(capsys, argv):
    """(stdout, stderr) of the port's main and of the JAX main."""
    out = []
    for main in (tcli.main, jcli.main):
        main(list(argv))
        cap = capsys.readouterr()
        out.append((cap.out, cap.err))
    return out


def test_metadata_reads_back(files):
    """The written files, through the JAX package's ``load_config``, give
    the catalog ``make_catalog`` builds from the same data."""
    got = jcatalog.load_config(*files["meta"])
    want = jdatagen.generate(sf=SF, seed=SEED).make_catalog()
    assert got.tables == want.tables
    assert sorted(got.colinfo.items()) == sorted(want.colinfo.items())
    assert got.dictionary == want.dictionary
    assert got.col_dictionary == want.col_dictionary
    assert got.pkeys == want.pkeys and got.fkrefs == want.fkrefs
    assert len(got.tables) == 8 and len(got.dictionary) > 1000


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
@pytest.mark.parametrize("plan", PLANS)
def test_compile_matches_jax(files, capsys, plan, flags):
    args = list(FLAG_SETS[flags])
    got = tcli.compile_to_text(_plan(files, plan), *files["meta"],
                               extra=args)
    got_err = capsys.readouterr().err
    want = jcli.compile_to_text(_plan(files, plan), *files["meta"],
                                extra=args)
    want_err = capsys.readouterr().err
    assert got == want and got.count("\n") > 10
    # --quirks traces each dictionary lookup on stderr, as the JAX CLI does
    assert got_err == want_err
    if flags == "quirks" and plan in ("q3", "q3_top10"):
        assert ",,BUILDING," in got_err


@pytest.mark.parametrize("plan", PLANS + sorted(DOT_TEXTS))
def test_dot_matches_jax(files, capsys, plan):
    path = (_plan(files, plan) if plan in torch_plans.CLI_PLANS
            else str(files["root"] / f"{plan}.txt"))
    (got, _), (want, _) = _both(capsys, ["compile", path, *files["flags"],
                                         "--dot"])
    assert got == want and got.startswith("digraph plan {")


@pytest.mark.parametrize("flags", [[], ["--no-cleanup"], ["-p"]],
                         ids=["default", "no_cleanup", "push"])
@pytest.mark.parametrize("plan", PLANS)
def test_explain_matches_jax(files, capsys, plan, flags):
    (got, _), (want, _) = _both(capsys, ["explain", _plan(files, plan),
                                         *files["flags"], *flags])
    assert got == want and "-- output 0:" in got
    assert "torch" not in got  # dtypes print as numpy names them


@pytest.mark.parametrize("form", ["meta_dir", "flags"])
def test_genplans_matches_jax(files, capsys, form):
    plans = str(files["root"] / "plans")
    argv = (["genplans", os.path.dirname(files["meta"][0]), plans]
            if form == "meta_dir" else ["genplans", plans, *files["flags"]])
    (got, _), (want, _) = _both(capsys, argv)
    assert got == want
    assert f"SUCCESS/TOTAL: {len(PLANS)}/{len(PLANS)}" in got


def test_no_subcommand_defaults_to_compile(files, capsys):
    argv = [_plan(files, "q6"), *files["flags"]]
    (got, _), (want, _) = _both(capsys, argv)
    tcli.main(["compile", *argv])
    assert got == want == capsys.readouterr().out
    assert ",MaterializeCompact" in got.strip().splitlines()[-1]


def test_no_subcommand_reads_stdin(files, capsys, monkeypatch):
    text = torch_plans.CLI_PLANS["q6"]
    outs = []
    for main in (tcli.main, jcli.main):
        monkeypatch.setattr(sys, "stdin", io.StringIO(text))
        main(list(files["flags"]))
        outs.append(capsys.readouterr().out)
    tcli.main(["compile", _plan(files, "q6"), *files["flags"]])
    assert outs[0] == outs[1] == capsys.readouterr().out


@pytest.mark.parametrize("argv,want", [
    (["q.mplan", "-b", "b"], ["compile", "q.mplan", "-b", "b"]),
    (["-b", "b", "-t", "t"], ["compile", "-", "-b", "b", "-t", "t"]),
    (["run", "q.mplan", "--sf", "1"], ["run", "q.mplan", "--sf", "1"]),
    (["--sf", "run", "explain", "q"], ["--sf", "run", "explain", "q"]),
    (["--help"], ["--help"])])
def test_normalize_argv_matches_jax(argv, want):
    assert tcli._normalize_argv(list(argv)) == want
    assert jcli._normalize_argv(list(argv)) == want


def test_device_free_commands_without_cuda(files, capsys, monkeypatch):
    """compile, explain and genplans touch no device; run without a GPU
    and without --cpu raises before it generates any data."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(tdatagen, "generate",
                        lambda *a, **k: called.append(1))
    for argv in (["compile", _plan(files, "q3")],
                 ["explain", _plan(files, "q3")],
                 ["compile", _plan(files, "q3"), "--dot"]):
        tcli.main(argv + files["flags"])
        assert capsys.readouterr().out
    tcli.main(["genplans", str(files["root"] / "plans"), *files["flags"]])
    assert "SUCCESS/TOTAL" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["run", _plan(files, "q6")])
    assert called == []


# ------------------------------------------------------------ run --devices
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the sum of the ten largest prices: a top N inside the aggregate stage,
# which neither package distributes
PLAN_TOP10_SUM = """project (
| group by (
| | top N (
| | | project (
| | | | table(sys.lineitem) [ lineitem.l_extendedprice NOT NULL ] COUNT
| | | ) [ lineitem.l_extendedprice ] [ lineitem.l_extendedprice ]
| | ) [ wrd "10" ]
| ) [  ] [ sys.sum no nil (lineitem.l_extendedprice NOT NULL) as L1.L1 ]
) [ L1 as L2.top_price ]
"""
# run --devices 4 --cpu: (plan, extra flags)
DIST_RUNS = {
    "q6": ("q6", []),
    "q6_explain_decode": ("q6", ["--explain-dist", "--decode"]),
    "q3": ("q3", []),
    "q3_explain_decode": ("q3", ["--explain-dist", "--decode"]),
    "q13": ("q13", []),
    "q13_explain_decode": ("q13", ["--explain-dist", "--decode"]),
    "sparse_groupby": ("sparse_groupby", []),
    "sparse_groupby_explain_decode": ("sparse_groupby",
                                      ["--explain-dist", "--decode"]),
    "top10_sum_not_distributable": ("top10_sum", ["--explain-dist"])}


def _cli(package, argv):
    """``python -m package ARGV`` in a fresh process from the repo's root:
    (exit code, stdout, its stderr's ``# `` lines)."""
    import subprocess

    e = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-m", package, *argv], cwd=REPO,
                       env=e, capture_output=True, text=True, timeout=600)
    return (p.returncode, p.stdout,
            [ln for ln in p.stderr.splitlines() if ln.startswith("# ")])


@pytest.mark.parametrize("run", sorted(DIST_RUNS))
def test_run_devices_cpu_matches_jax(files, run):
    """``run --devices 4 --cpu``: four gloo ranks print the JAX CLI's
    bytes on its mesh of four CPU devices, stdout and the ``# `` lines of
    stderr (``--explain-dist``'s plan, the not-distributable notice).
    Both run in fresh processes, so the skeys in a partitioned join's
    line are the same numbers."""
    plan, extra = DIST_RUNS[run]
    path = files["root"] / "top10_sum.mplan"  # beside the plan directory
    if plan == "top10_sum":
        path.write_text(PLAN_TOP10_SUM)
    else:
        path = _plan(files, plan)
    argv = ["run", str(path), "--sf", "0.01", "--seed", "3", "--cpu",
            "--devices", "4", *extra]
    got = _cli("mplan2vdl_tpu_torch", argv)
    want = _cli("mplan2vdl_tpu", argv)
    assert got == want
    assert got[0] == 0 and got[1].count("\n") >= 2
    if plan == "top10_sum":
        assert got[2] == ["# not distributable (ordered aggregate stage); "
                          "running single-chip"]
    elif "--explain-dist" in extra:
        assert got[2][0].startswith("# fact table: ")


def test_run_devices_one_is_single_device(files, capsys):
    """``--devices 1`` (and 0, the default) run one device, as in JAX."""
    argv = ["run", _plan(files, "q3"), "--sf", "0.005", "--seed", "3",
            "--cpu"]
    tcli.main(argv)
    plain = capsys.readouterr()
    tcli.main(argv + ["--devices", "1", "--explain-dist"])
    assert capsys.readouterr() == plain


def test_run_devices_without_cards_fails(files, capfd, monkeypatch):
    """``--devices 2`` without ``--cpu`` needs two cards: with fewer it
    exits nonzero, naming ``--cpu``, before it generates any data, and
    prints no rows; there is no quiet fallback to the CPU."""
    import torch

    called = []
    monkeypatch.setattr(tdatagen, "generate",
                        lambda *a, **k: called.append(1))
    for count in (0, 1):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        with pytest.raises(SystemExit) as e:
            tcli.main(["run", _plan(files, "q6"), "--devices", "2"])
        assert str(e.value) == (f"--devices 2: only {count} device(s) "
                                "available (use --cpu for 2 gloo ranks)")
    assert called == [] and capfd.readouterr().out == ""


# ------------------------------------------------------------------- run
RUNS = {"q6": [], "q1": [], "q1_decode": ["--decode"],
        "q1_legacy": ["--legacy-fk-names"], "q3": [],
        "q3_decode": ["--decode", "--use-cross-product"],
        "q3_legacy": ["--legacy-fk-names"], "q16": [],
        "q16_decode": ["--decode", "--use-cross-product"]}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_run_cpu_matches_jax(files, capsys, monkeypatch, run):
    monkeypatch.setenv("MPLAN2VDL_SIZE_CACHE", "0")
    plan = run.split("_")[0]
    argv = ["run", _plan(files, plan), "--sf", "0.005", "--seed", "3",
            "--cpu", *RUNS[run]]
    (got, _), (want, _) = _both(capsys, argv)
    assert got.count("\n") > 1
    if plan == "q3":
        g, w = got.splitlines(), want.splitlines()
        assert g[0] == w[0] and sorted(g[1:]) == sorted(w[1:])
    else:
        assert got == want  # Q16 in its ORDER BY order


# ----------------------------------------------------------- cost_report
@pytest.fixture(scope="module")
def q5():
    ts = tdatagen.generate(sf=SF, seed=SEED)
    tcfg = ts.make_catalog()
    return tlower.compile_plan_text(torch_plans.PLAN_Q5, tcfg, ts,
                                    device="cpu")


def test_cost_report_scan_bytes_match_jax(q5):
    """scan_bytes is one read of the device arguments, and equals the JAX
    engine's on the same plan and data: every loaded column has the same
    dtype in both engines."""
    js = jdatagen.generate(sf=SF, seed=SEED)
    jcfg = js.make_catalog()
    jq = jlower.CompiledQuery(jcfg, jlower.plan_to_vexps(
        torch_plans.PLAN_Q5, jcfg), js)
    rep = q5.cost_report()
    args = q5.device_args()
    assert rep["scan_bytes"] == sum(a.numel() * a.element_size()
                                    for a in args) > 0
    jargs = jq.device_args()
    assert [n for n in q5.loads] == [n for n in jq.loads]
    differ = [(n, str(a.dtype), str(b.dtype))
              for n, a, b in zip(q5.loads, args, jargs)
              if str(a.dtype).replace("torch.", "") != str(b.dtype)]
    assert differ == []
    assert rep["scan_bytes"] == jq.cost_report()["scan_bytes"]


def test_cost_report_accounting(q5):
    rep = q5.cost_report(per_op=True)
    per = rep["per_op"]
    assert rep["flops"] is None
    assert sum(per["by_kind"].values()) == rep["bytes_accessed"] \
        == per["total_bytes"]
    assert list(per["by_kind"].values()) == sorted(per["by_kind"].values(),
                                                   reverse=True)
    assert rep["amplification"] == rep["bytes_accessed"] / rep["scan_bytes"]
    assert rep["amplification"] >= 1
    top = [b for _, b, _ in per["top_nodes"]]
    assert top == sorted(top, reverse=True) and len(top) == 12
    assert "Load" not in per["by_kind"] and "Shuffle Gather" in per["by_kind"]
    assert not {"roofline_floor_s", "traffic_time_s"} & set(rep)
    floor = q5.cost_report(hbm_gbps=2000.0)
    assert floor["roofline_floor_s"] == rep["scan_bytes"] / 2e12
    assert floor["traffic_time_s"] == rep["bytes_accessed"] / 2e12
    assert "per_op" not in floor


def test_normal_call_records_nothing(q5, monkeypatch):
    before = q5()
    q5.cost_report()

    def refuse(self, v):
        raise AssertionError("a normal call charged a node")

    monkeypatch.setattr(tlower.TracedCompiler, "eval", refuse)
    after = q5()
    assert [n for n in before.names] == [n for n in after.names]
    for a, b in zip(before.columns, after.columns, strict=True):
        np.testing.assert_array_equal(a, b)


def test_run_roofline_and_profile(files, capsys, tmp_path):
    prof = tmp_path / "prof"
    argv = ["run", _plan(files, "q5"), "--sf", "0.005", "--seed", "3",
            "--cpu"]
    tcli.main(argv)
    plain = capsys.readouterr()
    tcli.main(argv + ["--roofline", "--profile", str(prof)])
    cap = capsys.readouterr()
    assert cap.out == plain.out and plain.err == ""
    err = cap.err.splitlines()
    assert err[0] == f"# profiler trace written to {prof}"
    keys = [ln[2:].split(":")[0] for ln in err[1:5]]
    assert keys == ["scan_bytes", "bytes_accessed", "flops", "amplification"]
    assert "# top nodes:" in err and not any("floor" in ln for ln in err)
    trace = json.loads((prof / "trace.json").read_text())
    assert any(e.get("name", "").startswith("aten::")
               for e in trace["traceEvents"])
    assert "Self CPU" in (prof / "ops.txt").read_text()
    tcli.main(argv + ["--roofline", "--hbm-gbps", "3350"])
    floor = capsys.readouterr().err
    assert "# roofline_floor_s: " in floor and "# traffic_time_s: " in floor


def test_launch_is_a_profiler_range_named_after_its_entry(monkeypatch):
    """Each kernel launch goes through ``_lib.call``: under the profiler a
    range named after the C entry point (what a trace of ``run
    --profile`` shows on the card), outside it the bare call."""
    from torch.profiler import ProfilerActivity, profile

    from mplan2vdl_tpu_torch.engine.kernels import _lib

    calls = []

    class FakeLib:
        def m2v_gather(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_lib, "_lib", FakeLib())
    assert _lib.call("m2v_gather", 1, 2) == 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert _lib.call("m2v_gather", 3) == 0
    assert calls == [(1, 2), (3,)]
    names = [e.key for e in prof.key_averages()]
    assert names.count("m2v_gather") == 1
