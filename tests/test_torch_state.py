"""The store carries across: the port loads what the JAX package saved,
and both generators give the same store for a seed."""

import numpy as np
import pytest

from mplan2vdl_tpu.engine import datagen as jdatagen
from mplan2vdl_tpu_torch.engine import datagen as tdatagen
from mplan2vdl_tpu_torch.engine.columnstore import ColumnStore


def _assert_same_store(got, want):
    assert list(got.columns) == list(want.columns)
    for name, w in want.columns.items():
        g = got.columns[name]
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=str(name))
    assert got.decoders == want.decoders


def test_load_of_jax_saved_store(tmp_path):
    want = jdatagen.generate(sf=0.005, seed=3)
    want.save(str(tmp_path / "store"))
    got = ColumnStore.load(str(tmp_path / "store"))
    _assert_same_store(got, want)
    # the two packages' dataclasses are distinct types: compare their reprs
    gi, wi = got.make_catalog().colinfo, want.make_catalog().colinfo
    assert repr(sorted(gi._m.items())) == repr(sorted(wi._m.items()))


@pytest.mark.parametrize("seed", [0, 5])
def test_generate_matches_jax(seed):
    got = tdatagen.generate(sf=0.01, seed=seed)
    want = jdatagen.generate(sf=0.01, seed=seed)
    _assert_same_store(got, want)
    assert repr(got.tables) == repr(want.tables)
