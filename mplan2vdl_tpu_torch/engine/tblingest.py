"""Ingest official TPC-H dbgen ``.tbl`` files into a ColumnStore.

The reference compiled against real MonetDB database snapshots (its
README.md:68-73); this framework's synthetic store is "dbgen-lite"
(engine/datagen.py).  This loader closes the realism gap for users who
HAVE dbgen output: ``<table>.tbl`` files ('|'-delimited, one trailing '|'
per row) load straight into the framework's integer encodings —

  * INTEGER     -> int64
  * DECIMAL(p,s)-> value * 10^s as int64 (scaled-decimal storage,
                   Types.hs:66-70)
  * DATE        -> days since 0000-01-01 proleptic Gregorian
                   (Mplan.hs:50-57 encoding, = toordinal() + 365)
  * CHAR/VARCHAR-> per-column dictionary codes (sorted string order)

FK join-index columns and the catalog derive mechanically afterwards,
exactly as for generated stores.  The loader is tested by round-trip
against the synthetic store written out as .tbl text
(tests/test_torch_tbl.py).  A row with more fields than the schema loses
the extra ones silently when another row has the schema's width (the
check counts the fields of the shortest row), as in the JAX package's
module this one copies.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import numpy as np

from ..fe.schema_parser import Table
from .columnstore import ColumnStore

# toordinal() is days since 0001-01-01 (=1); the framework's day counts
# are since 0000-01-01, which the proleptic calendar puts 366 days
# earlier (year 0 is a leap year) — hence the +365 on 1-based ordinals.
_ORDINAL_OFFSET = 365


def _encode_date(vals: List[str]) -> np.ndarray:
    out = np.empty(len(vals), dtype=np.int64)
    cache = {}
    for i, s in enumerate(vals):
        v = cache.get(s)
        if v is None:
            v = datetime.date.fromisoformat(s).toordinal() + _ORDINAL_OFFSET
            cache[s] = v
        out[i] = v
    return out


def _encode_decimal(vals: List[str], scale: int) -> np.ndarray:
    out = np.empty(len(vals), dtype=np.int64)
    for i, s in enumerate(vals):
        s = s.strip()
        neg = s.startswith("-")
        if neg:
            s = s[1:]
        if "." in s:
            whole, frac = s.split(".", 1)
        else:
            whole, frac = s, ""
        frac = (frac + "0" * scale)[:scale]
        v = int(whole or "0") * 10 ** scale + int(frac or "0")
        out[i] = -v if neg else v
    return out


def from_tbl(directory: str, schema: Optional[List[Table]] = None,
             build_indexes: bool = True) -> ColumnStore:
    """Load every ``<table>.tbl`` under ``directory`` (missing tables are
    simply absent from the store)."""
    if schema is None:
        from .datagen import tpch_schema

        schema = tpch_schema()
    store = ColumnStore(tables=schema)
    for t in schema:
        tab = t.name[0]
        path = os.path.join(directory, f"{tab}.tbl")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            rows = [ln.rstrip("\n").rstrip("|").split("|")
                    for ln in f if ln.strip()]
        ncols = len(t.columns)
        cols = list(zip(*rows)) if rows else [[] for _ in range(ncols)]
        if rows and len(cols) != ncols:
            raise ValueError(
                f"{path}: {len(cols)} fields per row, schema has {ncols}")
        for (cname, ts), vals in zip(t.columns, cols):
            col = cname[-1]
            kind = ts.tname.upper()
            vals = list(vals)
            if kind in ("INTEGER", "INT", "BIGINT", "SMALLINT", "TINYINT"):
                store.add(tab, col, np.asarray([int(v) for v in vals],
                                               dtype=np.int64))
            elif kind == "DECIMAL":
                scale = ts.tparams[1] if len(ts.tparams) > 1 else 0
                store.add(tab, col, _encode_decimal(vals, scale))
            elif kind == "DATE":
                store.add(tab, col, _encode_date(vals))
            elif kind in ("CHAR", "VARCHAR"):
                store.add_strings(tab, col, np.asarray(vals, dtype=object))
            else:
                raise ValueError(f"{tab}.{col}: unsupported type {kind}")
    if build_indexes:
        store.build_fk_indexes()
    return store


def to_tbl(store: ColumnStore, directory: str) -> None:
    """Write a store back out as dbgen-format .tbl files (decoded values:
    ISO dates, scaled decimals with their fraction, dictionary strings).
    Used by the round-trip test; also handy for exporting synthetic data
    to other engines."""
    from ..mtypes import resolve_type_spec

    os.makedirs(directory, exist_ok=True)
    for t in store.tables:
        tab = t.name[0]
        first = (tab, t.columns[0][0][-1])
        if first not in store.columns:
            continue
        n = len(store.columns[first])
        fields = []
        for cname, ts in t.columns:
            col = cname[-1]
            data = store.columns[(tab, col)]
            kind = ts.tname.upper()
            if kind == "DECIMAL":
                scale = ts.tparams[1] if len(ts.tparams) > 1 else 0
                if scale:
                    d = 10 ** scale
                    fields.append([f"{int(v) // d}.{int(v) % d:0{scale}d}"
                                   if v >= 0 else
                                   f"-{-int(v) // d}.{-int(v) % d:0{scale}d}"
                                   for v in data])
                else:
                    fields.append([str(int(v)) for v in data])
            elif kind == "DATE":
                fields.append([datetime.date.fromordinal(
                    int(v) - _ORDINAL_OFFSET).isoformat() for v in data])
            elif kind in ("CHAR", "VARCHAR"):
                dec = store.decoders[(tab, col)]
                fields.append([dec[int(v)] for v in data])
            else:
                fields.append([str(int(v)) for v in data])
        with open(os.path.join(directory, f"{tab}.tbl"), "w") as f:
            for i in range(n):
                f.write("|".join(fl[i] for fl in fields) + "|\n")
