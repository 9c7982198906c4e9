"""Each cell's mix through the harness's own path on the CPU at a tiny
scale; the same path with the timed calls broken underneath must come out
not correct, as must the float32 control; a run without a CUDA device
prints no result."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from h100bench import cells, check, control, gen, run

SF = 0.02  # Q17 needs a Brand#23 MED BOX part (one in 1,000)
CELLS = [w["name"] for w in cells.manifest()["workloads"]]
# the configuration and mix that no cell uses yet, proven on the card but
# with a latency that follows the host's speed (PERF.md), run as cells here
KEPT = [{"name": "tpch_sf1.scan_agg", "config": "tpch_sf1",
         "traffic": "scan_agg", "chips": 1, "why": "kept"},
        {"name": "tpch_sf10.joins", "config": "tpch_sf10",
         "traffic": "joins", "chips": 1, "why": "kept"}]
BENCH = dict(cells.manifest())
BENCH["workloads"] = BENCH["workloads"] + KEPT
ALL = CELLS + [w["name"] for w in KEPT]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", ALL)
def test_cell_runs_on_cpu(name, trace):
    res, numbers, parts = run.run_cell(name, 2**31 + 977, 0.3, trace,
                                       device="cpu", sf=SF, bench=BENCH)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    cell = cells.cell(name, BENCH)
    assert set(numbers) == {f"{q}.rows_off" for q in cell.queries}
    assert all(v["results"] >= 1 for v in numbers.values())
    want = {m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)}
    # the CPU has no device trace and no device memory
    assert set(res["metrics"]) <= want
    if trace:  # the CPU has no device events: the counts and host time
        assert {m for m in want if m.startswith(("host_syncs",
                                                 "engine_host_ms"))} == set(
            res["metrics"])
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert want - {"peak_gb"} == set(res["metrics"])
    for k in ("tables_s", "store_s", "catalog_s", "compile_s", "upload_s",
              "warmup_s", "check_s"):
        assert parts[k] >= 0


def _alter(cols):
    """One value of the last column changed where the answer is made."""
    cols = [np.array(c) for c in cols]
    if len(cols[-1]):
        cols[-1][len(cols[-1]) // 2] += 1
    return cols


def _halve(cols):
    """Half of the answer's rows left out."""
    return [np.array(c)[: len(c) // 2] for c in cols]


class _Stale:
    """Each call answers with the result of the call before it (a state
    that is not brought up to date)."""

    def __init__(self):
        self.prev = None

    def __call__(self, res):
        prev, self.prev = self.prev, res
        return prev if prev is not None else res


@pytest.mark.parametrize("fault", ["alter", "halve", "stale"])
@pytest.mark.parametrize("name", ALL)
def test_broken_answers_are_not_correct(name, fault, monkeypatch):
    from mplan2vdl_tpu_torch.engine import lower

    call = lower.CompiledQuery.__call__
    stale = _Stale()

    def broken(self):
        res = call(self)
        if fault == "stale":
            return stale(res)
        res.columns = (_alter if fault == "alter" else _halve)(res.columns)
        return res

    monkeypatch.setattr(lower.CompiledQuery, "__call__", broken)
    res, numbers, _ = run.run_cell(name, 31337, 0.2, False, device="cpu",
                                   sf=SF, bench=BENCH)
    assert not res["correct"]
    assert any(v["value"] > v["limit"] for v in res["checks"].values())


@pytest.mark.parametrize("name", ALL)
def test_float32_control_is_not_correct(name):
    for seed in (11, 12, 13):
        rec = control.control_run(name, seed, torch.device("cpu"), sf=SF * 2,
                                  bench=BENCH)
        assert not rec["correct"], rec


def test_forbidden_modules(monkeypatch):
    assert run.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "mplan2vdl_tpu.engine", object())
    monkeypatch.setitem(sys.modules, "mplan2vdl_tpu_torch_like", object())
    found = run.forbidden_modules()
    assert "mplan2vdl_tpu" in found and "mplan2vdl_tpu_torch_like" not in found


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, f"{cells.HERE}/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=cells.ROOT)
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_reference_rebuilds_the_same_tables():
    a = gen.generate(SF, 99, "cpu")
    cell = cells.cell(CELLS[0])
    got = {q: [c.clone() for c in cell.reference(q).reference(a, torch.int64)]
           for q in cell.queries}
    b = gen.generate(SF, 99, "cpu")
    for q in cell.queries:
        want = check.canonical(cell.reference(q).reference(b, torch.int64))
        assert check.rows_off(got[q], want) == 0


@pytest.mark.card
def test_cell_on_card(card):
    """A short run of the first cell on the card (run it there with
    ``python -m pytest h100bench/tests -m card``)."""
    res, numbers, _ = run.run_cell(CELLS[0], 5, 2.0, False, device=card)
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["metrics"]["peak_gb"]["value"] > 0
