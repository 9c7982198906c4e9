"""The system under test, reached through its public entry points: the
generated tables go into a ``ColumnStore`` (``add`` / ``add_categorical``,
``build_fk_indexes``), the store gives a catalog (``make_catalog``), and
each query of the mix becomes a prepared ``CompiledQuery``
(``lower.compile_plan_text``) whose ``__call__`` brings its rows to the
host, as ``cli run`` does."""

from __future__ import annotations

import time
from typing import Dict


def store_from(host, decoders):
    """A ``ColumnStore`` holding the host columns ``host``."""
    from mplan2vdl_tpu_torch.engine.columnstore import ColumnStore
    from mplan2vdl_tpu_torch.engine.datagen import tpch_schema

    store = ColumnStore(tables=tpch_schema())
    for (tab, col), data in host.items():
        dec = decoders.get((tab, col))
        if dec is None:
            store.add(tab, col, data)
        else:
            store.add_categorical(tab, col, data, dec)
    store.build_fk_indexes()
    return store


def prepare(tables, cell, device, times: Dict[str, float]):
    """(store, {query: CompiledQuery}) with every column the mix reads
    on ``device``; ``times`` gets each step's seconds."""
    from mplan2vdl_tpu_torch.engine import lower

    t = time.perf_counter()
    host = {k: v.cpu().numpy() for k, v in tables.cols.items()}
    times["to_host_s"] = time.perf_counter() - t
    t = time.perf_counter()
    store = store_from(host, tables.decoders)
    times["store_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cfg = store.make_catalog()
    times["catalog_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cqs = {q: lower.compile_plan_text(cell.plan(q), cfg, store, device=device)
           for q in cell.queries}
    times["compile_s"] = time.perf_counter() - t
    return store, cqs
