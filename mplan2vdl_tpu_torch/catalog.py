"""The compile-time catalog: column bounds/widths/counts, keys, dictionary.

Semantics of reference src/Config.hs.  Four inputs:
  * bounds csv:  (table, col, min, max, count, trailing_zeros)   (Config.hs:57)
  * storage csv: ``select * from storage`` 12-tuples             (Config.hs:60-72)
  * schema:      msqldump DDL (tables, pkeys, fkeys)
  * dictionary:  (table, col, string, code) string encodings     (Config.hs:75-79)

The catalog statically knows every column's value bounds, row count and
trailing-zero count; the whole framework leans on this to compile
dynamic-cardinality relational ops into static-shape XLA programs.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from .fe.schema_parser import FKey, PKey, Table
from .mtypes import (DType, MType, SType, TypeSpec, dtype_of_mtype,
                     resolve_type_spec, stype_of_mtype, within_bounds)
from .names import Name, NameTable, concat_name, name_str

# aggregation strategies (Config.hs:221)
AGG_SERIAL = "serial"
AGG_HIERARCHICAL = "hierarchical"
AGG_SHUFFLE = "shuffle"

FORMAT_VDL = "vdl"
FORMAT_VLITE = "vlite"


@dataclass(frozen=True)
class ColInfo:
    """Static metadata carried by every column and IR vector (Config.hs:114-120)."""

    bounds: Tuple[int, int]
    trailing_zeros: int  # largest power of two known to divide all values
    count: int
    stype: SType
    dtype: DType

    def check(self) -> "ColInfo":
        l, u = self.bounds
        assert l <= u, f"bad bounds {self.bounds}"
        assert self.count >= 0
        assert self.trailing_zeros >= 0
        return self


# which-side marker of an FK instance (Config.hs:194)
FACT_DIM = "fact_dim"
DIM_FACT = "dim_fact"


@dataclass(frozen=True)
class FKInstance:
    """One usable direction of a foreign-key constraint (Config.hs:198)."""

    cols: Tuple[Tuple[Name, Name], ...]  # canonically sorted (fact, dim) pairs
    fkjoinorder: str  # FACT_DIM or DIM_FACT
    fact: Name
    dim: Name
    idxname: Name  # the stored join-index column (fact table row -> dim row id)


@dataclass
class Config:
    # flags (MainFuns.hs:34-75)
    cross_product: bool = False
    format: str = FORMAT_VDL
    sparsity_threshold: float = 1.0
    show_metadata: bool = False
    gboffset: int = 0
    agg_strategy: str = AGG_SERIAL
    grainsize_log: int = 0
    # True on the VDL-conformance path (CLI compile/genplans): applies the
    # reference's aggregation-strategy rewrites (2-level grain folds,
    # contention shuffles, the hardcoded >32000 sparse-domain shuffle —
    # Vlite.hs:1076-1098,1173-1194).  The TPU engine keeps this False: its
    # sparse group-by path sorts anyway, so contention shuffles would only
    # add gather traffic.
    conformance_agg: bool = False
    # Reproduce the reference's dictionary-lookup trace side-channel
    # (Mplan.hs:44 prints ",,<string>,<code>" to stderr on every char-
    # literal resolution, a debugging quirk of the Haskell `trace`).
    # Off by default; `--quirks` turns the full quirk set on.
    quirk_trace_dict: bool = False
    # catalog
    dictionary: Dict[str, int] = field(default_factory=dict)  # string -> code (global; last wins, Config.hs:83-86)
    col_dictionary: Dict[Name, Dict[str, int]] = field(default_factory=dict)  # per-column, for LIKE
    colinfo: NameTable = field(default_factory=NameTable)
    fkrefs: Dict[Tuple[Tuple[Name, Name], ...], FKInstance] = field(default_factory=dict)
    pkeys: Dict[Tuple[Name, ...], Name] = field(default_factory=dict)
    table_pkeys: Dict[Name, Name] = field(default_factory=dict)
    partial_fks: Dict[Tuple[Name, Name], Tuple[str, Tuple[Tuple[Name, Name], ...]]] = field(default_factory=dict)
    partial_pks: Dict[Name, Tuple[Name, ...]] = field(default_factory=dict)
    # positional FK constraint aliases: MonetDB auto-names FK constraints
    # "<tab>_fk<N>" by declaration order, so plans generated against such a
    # database reference e.g. lineitem.%lineitem_fk1 even when the metadata
    # snapshot names the join index lineitem_orders
    fk_aliases: Dict[Name, Name] = field(default_factory=dict)
    tables: List[Table] = field(default_factory=list)

    def canonical(self, name: Name) -> Name:
        return self.fk_aliases.get(name, name)

    # ------------------------------------------------------------- query api
    def is_pkey(self, cols: Tuple[Name, ...]) -> Optional[Name]:
        """Config.hs:241-243."""
        return self.pkeys.get(tuple(sorted(cols)))

    def lookup_pkey(self, tab: Name) -> Name:
        """Config.hs:245-250."""
        n = self.table_pkeys.get(tab)
        if n is None:
            raise KeyError(f"no pkey info for table {name_str(tab)}")
        return n

    def is_fk_ref(self, cols: Tuple[Tuple[Name, Name], ...]) -> Optional[FKInstance]:
        """Config.hs:254-256."""
        return self.fkrefs.get(tuple(sorted(cols)))

    def is_partial_fk(self, pair: Tuple[Name, Name]):
        return self.partial_fks.get(pair)

    def is_partial_pk(self, col: Name):
        return self.partial_pks.get(col)

    def col(self, n: Name) -> Tuple[Name, ColInfo]:
        return self.colinfo.lookup(n)


# --------------------------------------------------------------- csv readers
def read_bounds_csv(path: str) -> List[Tuple[str, str, int, int, int, int]]:
    out = []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if not row:
                continue
            tab, col, mn, mx, cnt, tz = row
            out.append((tab, col, int(mn), int(mx), int(cnt), int(tz)))
    return out


def read_storage_csv(path: str) -> List[tuple]:
    out = []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if not row:
                continue
            (schema, tab, col, typ, loc, cnt, w, colsize, heap, hashes,
             imprints, sorted_) = row
            out.append((schema, tab, col, typ, loc, int(cnt), int(w),
                        int(colsize), int(heap), int(hashes), int(imprints),
                        sorted_))
    return out


def read_dictionary_csv(path: str) -> List[Tuple[str, str, str, int]]:
    out = []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if not row:
                continue
            tab, col, s, code = row
            out.append((tab, col, s, int(code)))
    return out


# --------------------------------------------------------------- construction
def _table_constraint_cols(t: Table) -> List[Name]:
    """Names of the constraint pseudo-columns of a table (Config.hs:179-188)."""
    names = [concat_name(t.name, t.pkey.constraint)]
    names += [concat_name(t.name, fk.constraint) for fk in t.fkeys]
    return names


def _make_fk_entries(t: Table) -> List[FKInstance]:
    """Per FK: 4 instances — implicit col pairs and explicit idx->%TID%, both
    directions (Config.hs:200-218)."""
    out = []
    for fk in t.fkeys:
        local = [concat_name(t.name, c) for c, _ in fk.colmap]
        remote = [concat_name(fk.references, c) for _, c in fk.colmap]
        joinidx = concat_name(t.name, fk.constraint)
        tidname = concat_name(fk.references, ("%TID%",))
        implicit = tuple(sorted(zip(local, remote)))
        implicit_back = tuple(sorted(zip(remote, local)))
        explicit = ((joinidx, tidname),)
        explicit_back = ((tidname, joinidx),)
        out += [
            FKInstance(implicit, FACT_DIM, t.name, fk.references, joinidx),
            FKInstance(implicit_back, DIM_FACT, t.name, fk.references, joinidx),
            FKInstance(explicit, FACT_DIM, t.name, fk.references, joinidx),
            FKInstance(explicit_back, DIM_FACT, t.name, fk.references, joinidx),
        ]
    return out


def make_config(
    bounds: List[Tuple[str, str, int, int, int, int]],
    storage: List[tuple],
    tables: List[Table],
    dictlist: List[Tuple[str, str, str, int]],
    **flags,
) -> Config:
    """Assemble the catalog (Config.hs:149-170)."""
    cfg = Config(**flags)
    cfg.tables = tables

    # global dictionary: keyed by string only; later rows win (Config.hs:83-86)
    for tab, col, s, code in dictlist:
        cfg.dictionary[s] = code
        cfg.col_dictionary.setdefault((tab, col), {})[s] = code

    # typespecs from the schema
    tspecs: Dict[Name, TypeSpec] = {}
    for t in tables:
        for cn, ts in t.columns:
            tspecs[concat_name(t.name, cn)] = ts

    # storage -> surface/storage type per column (Config.hs:89-105)
    storagemap: Dict[Name, MType] = {}
    for (schema, tab, col, typ, loc, cnt, w, colsize, heap, *_rest) in storage:
        name = (tab, col)
        if typ != "oid":
            ts = tspecs.get(name)
            if ts is None:
                continue
        else:
            ts = TypeSpec("oid")
        mt = resolve_type_spec(ts)
        storagemap[name] = mt

    # constraint pseudo-columns also get a '%'-prefixed alias (Config.hs:137-147)
    constraints = set()
    for t in tables:
        constraints.update(_table_constraint_cols(t))

    for tab, col, mn, mx, cnt, tz in bounds:
        name = (tab, col)
        mt = storagemap.get(name)
        if mt is None:
            raise KeyError(f"no storage record for bounds row {name_str(name)}")
        info = ColInfo(bounds=(mn, mx), trailing_zeros=tz, count=cnt,
                       stype=stype_of_mtype(mt), dtype=dtype_of_mtype(mt, name))
        cfg.colinfo.insert(name, info)
        if name in constraints:
            cfg.colinfo.insert((tab, "%" + col), info)

    # FK machinery (Config.hs:158-168)
    allrefs = []
    for t in tables:
        allrefs += _make_fk_entries(t)
    for inst in allrefs:
        cfg.fkrefs[inst.cols] = inst
        for pair in inst.cols:
            # straighten to (fact, dim) order per direction (Config.hs:159-162)
            if inst.fkjoinorder == FACT_DIM:
                straight = inst.cols
            else:
                straight = tuple(sorted((b, a) for a, b in inst.cols))
            cfg.partial_fks[pair] = (inst.fkjoinorder, straight)

    # positional FK-constraint aliases (<tab>_fk<N> by declaration order).
    # Never shadow a REAL constraint name: schemas that already use fkN
    # names may declare them out of numbering order (aliasing would
    # cross-map them), so alias only names that do not exist.
    for t in tables:
        existing = {concat_name(t.name, fk.constraint)[1] for fk in t.fkeys}
        for i, fk in enumerate(t.fkeys, 1):
            canon = concat_name(t.name, fk.constraint)
            alias = f"{t.name[0]}_fk{i}"
            if canon[1] != alias and alias not in existing:
                cfg.fk_aliases[(t.name[0], alias)] = canon
                cfg.fk_aliases[(t.name[0], "%" + alias)] = \
                    (canon[0], "%" + canon[1])

    # primary keys (Config.hs:164-166,190-192)
    for t in tables:
        pkcols = tuple(sorted(concat_name(t.name, c) for c in t.pkey.cols))
        pkconstraint = concat_name(t.name, t.pkey.constraint)
        cfg.pkeys[pkcols] = pkconstraint
        cfg.table_pkeys[t.name] = pkconstraint
        for c in pkcols:
            cfg.partial_pks[c] = pkcols

    return cfg


def load_config(
    bounds_path: str,
    storage_path: str,
    schema_path: str,
    dict_path: str,
    **flags,
) -> Config:
    from .fe import schema_parser

    return make_config(
        read_bounds_csv(bounds_path),
        read_storage_csv(storage_path),
        schema_parser.from_file(schema_path),
        read_dictionary_csv(dict_path),
        **flags,
    )
