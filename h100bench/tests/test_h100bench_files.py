"""BENCHMARK.json against the contract's shape, and every configuration,
mix, query, reference and metric it names found by name as a file."""

import json
import os
import re

import pytest

from h100bench import cells

BENCH = cells.manifest()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}\Z")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(cells.ROOT, p))
    assert len(BENCH["command"]) <= 32 and all(map(_line, BENCH["command"]))
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(cells.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(cells.ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads():
    names = set()
    pairs = set()
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["name"] not in names and w["config"] in configs
        assert (w["config"], w["traffic"]) not in pairs
        names.add(w["name"])
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4) and _line(w["why"])
        cell = cells.cell(w["name"])
        assert cell.chips == w["chips"] == cell.config["chips"]
        for q in cell.queries:
            assert cell.plan(q).strip()
            ref = cell.reference(q)
            assert callable(ref.reference) and ref.COLUMNS
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


def test_metrics():
    seen = set()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                           "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(cells.reader(m["name"]))
    for w in BENCH["workloads"]:
        cell = cells.cell(w["name"])
        assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("sub", ["configs", "mixes", "queries", "reference",
                                 "metrics"])
def test_file_names(sub):
    for f in os.listdir(os.path.join(cells.HERE, sub)):
        if f.startswith(("_", ".")):
            continue
        assert NAME.match(f), f
