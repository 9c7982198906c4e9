"""Columnar table storage + catalog generation from data.

Every column is a flat integer array (the framework's storage model mirrors
the reference's "everything becomes an integer" discipline, Types.hs:66-70):
  * numerics: raw ints / scaled-decimal ints
  * dates:    days since 0000-01-01
  * strings:  per-column dictionary codes

A store also materializes, per foreign key, the join-index column
``<fact>.<fk_constraint>`` mapping each fact row to the *row position* of the
referenced dimension row (the reference's ``%fk -> %TID%`` columns, which
MonetDB maintains and mplan2vdl loads via Load, Vlite.hs:1250-1258).

``make_catalog`` computes the bounds/count/trailing-zeros metadata the
compiler needs directly from the data, replacing the reference's four CSV
sidecar files (README.md:68-73).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..catalog import ColInfo, Config, make_config
from ..fe.schema_parser import FKey, PKey, Table
from ..mtypes import TypeSpec
from ..names import Name, concat_name


@dataclass
class ColumnStore:
    tables: List[Table]  # schema
    columns: Dict[Name, np.ndarray] = field(default_factory=dict)
    # per string column: code -> string (ordered); inverse of the dictionary
    decoders: Dict[Name, Dict[int, str]] = field(default_factory=dict)

    def table_count(self, tab: Name) -> int:
        t = next(t for t in self.tables if t.name == tab)
        first = concat_name(tab, t.columns[0][0])
        return len(self.columns[first])

    def is_sorted(self, name: Name) -> bool:
        """True when the stored column is physically non-decreasing —
        checked once per column per process (one numpy pass) and cached.
        FK join-index columns of order-major tables (lineitem -> orders)
        are sorted in practice, which lets the engine route their gathers
        through the streaming sorted-gather kernel instead of XLA's
        serialized dynamic gather."""
        cache = getattr(self, "_sorted_cache", None)
        if cache is None:
            cache = self._sorted_cache = {}
        hit = cache.get(name)
        if hit is None:
            arr = self.columns.get(name)
            hit = bool(arr is not None and len(arr) > 1
                       and np.all(arr[1:] >= arr[:-1])) or \
                bool(arr is not None and len(arr) <= 1)
            cache[name] = hit
        return hit

    def _invalidate_sorted(self, name) -> None:
        """A replaced column must not keep a stale is_sorted() verdict —
        an unsorted column routed through the sorted-gather/monotone-
        scatter kernels would yield silent wrong results."""
        cache = getattr(self, "_sorted_cache", None)
        if cache is not None:
            cache.pop(name, None)

    def add(self, tab: str, col: str, data: np.ndarray) -> None:
        self.columns[(tab, col)] = _narrow(np.ascontiguousarray(data))
        self._invalidate_sorted((tab, col))

    def add_strings(self, tab: str, col: str, values: "np.ndarray") -> None:
        """Dictionary-encode a string column; codes are assigned in sorted
        string order (any order is legal: plans compare codes only for
        equality / LIKE membership)."""
        uniq, codes = np.unique(np.asarray(values, dtype=object), return_inverse=True)
        self.columns[(tab, col)] = _narrow(codes.astype(np.int64))
        self.decoders[(tab, col)] = {i: s for i, s in enumerate(uniq.tolist())}
        self._invalidate_sorted((tab, col))

    def add_categorical(self, tab: str, col: str, codes: np.ndarray,
                        decoder: Dict[int, str]) -> None:
        """A string column given directly as dictionary codes + decoder
        (avoids materializing per-row Python strings at large scale)."""
        self.columns[(tab, col)] = _narrow(
            np.ascontiguousarray(codes, dtype=np.int64))
        self.decoders[(tab, col)] = dict(decoder)
        self._invalidate_sorted((tab, col))

    def build_fk_indexes(self) -> None:
        """Materialize the per-FK join-index columns (fact row -> dim row)."""
        for t in self.tables:
            for fk in t.fkeys:
                dim = next(d for d in self.tables if d.name == fk.references)
                # composite keys: encode as tuples via searchsorted on a
                # structured ordering; all TPC-H dim keys are 1-2 ints.
                fact_keys = [self.columns[concat_name(t.name, c)]
                             for c, _ in fk.colmap]
                dim_keys = [self.columns[concat_name(fk.references, c)]
                            for _, c in fk.colmap]
                if len(fact_keys) == 1:
                    fkey, dkey = fact_keys[0], dim_keys[0]
                else:
                    # pack pairs into one int64 (dim key values are modest)
                    shift = int(max(k.max() for k in (fact_keys[1],
                                                      dim_keys[1]))).bit_length() + 1
                    fkey = (fact_keys[0].astype(np.int64) << shift) | fact_keys[1]
                    dkey = (dim_keys[0].astype(np.int64) << shift) | dim_keys[1]
                from . import nativeio

                idx = nativeio.fk_index(fkey, dkey)
                name = concat_name(t.name, fk.constraint)
                self.columns[name] = _narrow(idx)
                self._invalidate_sorted(name)

    def save(self, directory: str) -> None:
        """Persist as raw binary columns + manifest (native IO when built)."""
        from . import nativeio

        nativeio.save_store(self, directory)

    @classmethod
    def load(cls, directory: str, tables=None) -> "ColumnStore":
        from . import nativeio

        return nativeio.load_store(directory, tables)

    # ---------------------------------------------------------------- catalog
    def make_catalog(self, **flags) -> Config:
        """Build a Config whose bounds/storage/dictionary reflect this data."""
        bounds: List[Tuple[str, str, int, int, int, int]] = []
        storage: List[tuple] = []
        dictrows: List[Tuple[str, str, str, int]] = []

        declared: Dict[Name, TypeSpec] = {}
        for t in self.tables:
            for cn, ts in t.columns:
                declared[concat_name(t.name, cn)] = ts

        from . import nativeio

        for name, data in self.columns.items():
            tab, col = name
            mn, mx, tz, n = nativeio.column_stats(data)
            bounds.append((tab, col, mn, mx, n, tz))
            ts = declared.get(name)
            if ts is None:
                typ = "oid"  # join-index pseudo column
            else:
                typ = ts.tname.lower()
            width = 8
            storage.append(("sys", tab, col, typ, "", n, width, width * n,
                            0, 0, 0, "false"))
        # pkey-constraint pseudo-columns: virtual row ids (MonetDB's pkey oid
        # column equals the row TID).  No data is stored — the engine and
        # oracle synthesize an iota — but the bounds must describe row ids.
        for t in self.tables:
            tab = t.name[0]
            pk = t.pkey.constraint[0]
            n = self.table_count(t.name)
            bounds.append((tab, pk, 0, max(n - 1, 0), n, 0))
            storage.append(("sys", tab, pk, "oid", "", n, 8, 8 * n, 0, 0, 0,
                            "false"))

        for name, dec in self.decoders.items():
            tab, col = name
            for code, s in dec.items():
                dictrows.append((tab, col, s, code))
        return make_config(bounds, storage, self.tables, dictrows, **flags)


def _narrow(data: np.ndarray) -> np.ndarray:
    """Store integer columns at the narrowest standard width their values
    allow — the catalog's exact bounds make int32 storage safe, halving HBM
    traffic for most TPC-H columns."""
    if data.dtype == np.int64 and len(data):
        lo, hi = int(data.min()), int(data.max())
        if -(2**31) <= lo and hi < 2**31:
            return data.astype(np.int32)
    return data


def _trailing_zeros(data: np.ndarray) -> int:
    if len(data) == 0:
        return 0
    g = int(np.bitwise_or.reduce(np.abs(data).astype(np.int64)))
    if g == 0:
        return 0
    return (g & -g).bit_length() - 1
