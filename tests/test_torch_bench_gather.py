"""The gather bench's shapes and byte counts on the CPU: ``chip_smoke.py``
phase 3 times the engine's gathers at ``bench_gather.shapes`` and takes
their ``bound_ms`` from ``byte_count`` and the sector note from
``sector_count``."""

import numpy as np
import pytest
import torch

from mplan2vdl_tpu_torch.engine import datagen
from mplan2vdl_tpu_torch.engine.kernels import sorted_gather as sg
from mplan2vdl_tpu_torch.oracle.tpch import day
from mplan2vdl_tpu_torch.tools import bench_gather


@pytest.fixture(scope="module")
def cols():
    st = datagen.generate(sf=0.002, seed=1)
    return {c: torch.from_numpy(st.columns[("lineitem", c)].copy())
            for c in bench_gather.COLUMNS}


# (k, source dtypes, order of the positions) of each shape
SHAPES = {"a": (["int32"], "ascending"),
          "b": (["int32"] * 4, "ascending"),
          "c": (["int64", "int64", "int32"], "identity"),
          "d": (["int32"], "permutation"),
          "e": (["int64"] * 8, "ascending"),
          "f": (["int64"], "permutation")}


@pytest.mark.parametrize("tag", sorted(SHAPES))
def test_shapes_are_the_engines(cols, tag):
    """Each shape has the sources, positions and count its note names, and
    the wrapper's CPU path gathers it like the plain indexing."""
    sh = {s.tag: s for s in bench_gather.shapes(cols, seed=1)}[tag]
    srcs, pos, valid = sh.build()
    dtypes, order = SHAPES[tag]
    n = cols["l_shipdate"].shape[0]
    assert [str(s.dtype)[6:] for s in srcs] == dtypes
    assert all(s.shape[0] == n for s in srcs) and pos.dtype == torch.int32
    assert valid == pos.shape[0]
    p = pos.long()
    if order == "ascending":
        ship = cols["l_shipdate"][p]
        assert 0 < pos.shape[0] < n and bool((p[1:] > p[:-1]).all())
        assert bool(((ship >= day(1994, 1, 1))
                     & (ship < day(1995, 1, 1))).all())
    elif order == "identity":
        assert torch.equal(p, torch.arange(n))
    else:
        assert torch.equal(p.sort().values, torch.arange(n))
    got = sg.gather_many(srcs, pos, valid)
    for g, s in zip(got, srcs):
        assert torch.equal(g, s[p])


def test_byte_and_sector_counts():
    """Bytes: positions, selected elements and outputs once.  Sectors: each
    source read in 32-byte sectors, one per run of rows in one sector."""
    src4 = torch.arange(64, dtype=torch.int32)
    src8 = torch.arange(64, dtype=torch.int64)
    ident = torch.arange(64, dtype=torch.int32)
    assert bench_gather.byte_count([src4, src8], ident) == 64 * (4 + 8 + 16)
    # consecutive positions read every sector once: the byte count
    assert bench_gather.sector_count([src4, src8], ident, 64) == \
        bench_gather.byte_count([src4, src8], ident)
    # every 8th int32 row: one sector a row (8 int32 elements a sector)
    every8 = torch.arange(0, 64, 8, dtype=torch.int32)
    assert bench_gather.sector_count([src4], every8, 8) == 8 * (4 + 32 + 4)
    # a row past valid repeats the last valid position: no new sector
    assert bench_gather.sector_count([src4], every8, 4) == \
        8 * 4 + 4 * 32 + 8 * 4
    # a permutation of an int64 source: a sector for each run of
    # consecutive rows in one sector (4 int64 elements a sector)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(64)
                            .astype(np.int32))
    sec = perm.long() * 8 // 32
    runs = 1 + int((sec[1:] != sec[:-1]).sum())
    assert bench_gather.sector_count([src8], perm, 64) == \
        64 * 4 + runs * 32 + 64 * 8
    assert bench_gather.bound_ms(3.35e9) == pytest.approx(1.0)


def test_blocks_per_sm_where_the_library_reports_it():
    """A library without ``m2v_gather_blocks_per_sm`` (an older source)
    reports nothing; one with it is asked for the launch's K4 and K8."""
    class Old:
        def m2v_gather_max_sources(self):
            return 8

    class Fn:
        def __call__(self, k4, k8, pos_esize):
            return (k4, k8, pos_esize)

    class New(Old):
        m2v_gather_blocks_per_sm = Fn()

    srcs = [torch.zeros(4, dtype=d) for d in
            [torch.int32, torch.int64, torch.int64] + [torch.int32] * 7]
    pos = torch.zeros(3, dtype=torch.int64)
    assert bench_gather.blocks_per_sm(Old(), srcs, pos) is None
    # the first launch takes 8 sources: 6 int32 and 2 int64
    assert bench_gather.blocks_per_sm(New(), srcs, pos) == (6, 2, 8)
