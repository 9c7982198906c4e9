"""The port's dbgen ``.tbl`` ingest (``engine/tblingest.py``, a copy of the
JAX package's) against the JAX package's, on the CPU.

``to_tbl`` writes the same bytes from the same generated data, ``from_tbl``
reads them back into the same columns and dictionaries, and ``run --tbl
--cpu`` prints the JAX ``run --tbl --cpu`` CSV.  Against the generated
store the ingested one holds the same values, and ``run --tbl`` gives the
generated store's rows (decoded: the ingest's dictionaries are in sorted
string order, the generator's are not), which is the check
``chip_smoke.py`` makes on the card."""

import os

import numpy as np
import pytest

import torch_plans
from mplan2vdl_tpu import cli as jcli
from mplan2vdl_tpu.engine import datagen as jdatagen
from mplan2vdl_tpu.engine import tblingest as jtbl
from mplan2vdl_tpu_torch import cli as tcli
from mplan2vdl_tpu_torch.engine import datagen as tdatagen
from mplan2vdl_tpu_torch.engine import tblingest as ttbl

SF, SEED = 0.005, 21


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """.tbl directories written by the port and by the JAX package, from
    the same generated data, and the plans as files."""
    root = tmp_path_factory.mktemp("tbl")
    ttbl.to_tbl(tdatagen.generate(sf=SF, seed=SEED), str(root / "port"))
    jtbl.to_tbl(jdatagen.generate(sf=SF, seed=SEED), str(root / "jax"))
    for name, text in torch_plans.CLI_PLANS.items():
        (root / f"{name}.mplan").write_text(text)
    return root


def test_to_tbl_bytes_match_jax(dirs):
    names = sorted(os.listdir(dirs / "jax"))
    assert names == sorted(os.listdir(dirs / "port"))
    assert len(names) == 8
    for name in names:
        got = (dirs / "port" / name).read_bytes()
        assert got == (dirs / "jax" / name).read_bytes(), name
        assert got.count(b"\n") > 0


def test_from_tbl_matches_jax(dirs):
    got = ttbl.from_tbl(str(dirs / "port"))
    want = jtbl.from_tbl(str(dirs / "port"))
    assert list(got.columns) == list(want.columns)
    for key in got.columns:
        assert got.columns[key].dtype == want.columns[key].dtype, key
        np.testing.assert_array_equal(got.columns[key], want.columns[key])
    assert got.decoders == want.decoders


def test_roundtrip_holds_the_generated_values(dirs):
    store = tdatagen.generate(sf=SF, seed=SEED)
    ingested = ttbl.from_tbl(str(dirs / "port"))
    assert set(store.columns) == set(ingested.columns)
    for key, a in store.columns.items():
        b = ingested.columns[key]
        if key in store.decoders:
            da, db = store.decoders[key], ingested.decoders[key]
            assert [da[int(v)] for v in a] == [db[int(v)] for v in b], key
        else:
            np.testing.assert_array_equal(np.asarray(a, np.int64),
                                          np.asarray(b, np.int64))


def test_extra_field_is_dropped_silently(tmp_path):
    """The known fault the copy keeps: a row with an extra field passes
    the field-count check when another row has the schema's width."""
    schema = [t for t in tdatagen.tpch_schema() if t.name == ("region",)]
    (tmp_path / "region.tbl").write_text("0|AFRICA|c0|\n1|ASIA|c1|extra|\n")
    store = ttbl.from_tbl(str(tmp_path), schema=schema,
                          build_indexes=False)
    assert store.columns[("region", "r_regionkey")].tolist() == [0, 1]
    with pytest.raises(ValueError, match="fields per row"):
        (tmp_path / "region.tbl").write_text("0|AFRICA|c0|x|\n")
        ttbl.from_tbl(str(tmp_path), schema=schema, build_indexes=False)


@pytest.mark.parametrize("plan,decode", [("q1", False), ("q6", False),
                                         ("q16", True), ("q16", False)])
def test_run_tbl_cpu_matches_jax(dirs, capsys, monkeypatch, plan, decode):
    monkeypatch.setenv("MPLAN2VDL_SIZE_CACHE", "0")
    argv = ["run", str(dirs / f"{plan}.mplan"), "--tbl", str(dirs / "port"),
            "--cpu"] + (["--decode"] if decode else [])
    tcli.main(argv)
    got = capsys.readouterr().out
    jcli.main(argv)
    assert got == capsys.readouterr().out and got.count("\n") > 1


@pytest.mark.parametrize("plan", ["q1", "q16"])
def test_run_tbl_matches_generated_store(dirs, capsys, plan):
    """The chip's --tbl check at a small scale: the decoded rows of the
    ingested store are the generated store's; Q16's follow its ORDER BY
    over the strings, since the ingest's codes ascend with them."""
    path = str(dirs / f"{plan}.mplan")
    tcli.main(["run", path, "--tbl", str(dirs / "port"), "--cpu",
               "--decode"])
    head, rows = torch_plans.csv_rows(capsys.readouterr().out)
    tcli.main(["run", path, "--sf", str(SF), "--seed", str(SEED), "--cpu",
               "--decode"])
    want_head, want = torch_plans.csv_rows(capsys.readouterr().out)
    assert head == want_head and len(rows) > 3
    assert sorted(rows) == sorted(want)
    if plan == "q16":
        assert torch_plans.q16_sql_order(rows)
        assert not torch_plans.q16_sql_order(want)
