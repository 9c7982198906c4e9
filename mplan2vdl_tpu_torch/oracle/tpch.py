"""Numpy oracle implementations of the TPC-H "noorder" queries.

Arithmetic contract mirrored from the engine (and the reference compiler):
  * decimals are scaled int64 (scale tracked per expression)
  * division truncates toward zero (C semantics, like the Voodoo backend)
  * dates are day counts since 0000-01-01
  * strings are dictionary codes; equality and LIKE operate on codes
  * group-by outputs are ordered by ascending composite key, but tests
    compare row *sets*, so oracles return unsorted rows
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Tuple

import numpy as np

from ..engine.columnstore import ColumnStore
from ..engine.lower import like_to_regex


def tdiv(a, b):
    """Truncating integer division (C semantics)."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    q = np.abs(a) // np.abs(b)
    return np.where((a >= 0) == (b >= 0), q, -q)


def day(y, m, d):
    return datetime.date(y, m, d).toordinal() + 365


def code_of(store: ColumnStore, tab: str, col: str, s: str) -> int:
    dec = store.decoders[(tab, col)]
    for c, v in dec.items():
        if v == s:
            return c
    raise KeyError(f"{s!r} not in {tab}.{col} dictionary")


def like_codes(store: ColumnStore, tab: str, col: str,
               pattern: str) -> np.ndarray:
    rx = like_to_regex(pattern)
    dec = store.decoders[(tab, col)]
    return np.array(sorted(c for c, s in dec.items() if rx.match(s)),
                    dtype=np.int64)


def isin(vals: np.ndarray, codes: np.ndarray) -> np.ndarray:
    return np.isin(vals, codes)


def C(store: ColumnStore, tab: str, col: str) -> np.ndarray:
    return store.columns[(tab, col)]


def groupby_sum(keys: List[np.ndarray], vals: List[np.ndarray]):
    """Group rows by the key tuple; return (key columns, summed columns)."""
    packed = np.stack(keys, axis=1) if keys else np.zeros((len(vals[0]), 0))
    uniq, inv = np.unique(packed, axis=0, return_inverse=True)
    outs = []
    for v in vals:
        acc = np.zeros(len(uniq), dtype=np.int64)
        np.add.at(acc, inv, v.astype(np.int64))
        outs.append(acc)
    return [uniq[:, i] for i in range(uniq.shape[1])], outs, inv, uniq


# ------------------------------------------------------------------- queries
def q1(store: ColumnStore):
    ship = C(store, "lineitem", "l_shipdate")
    m = ship <= day(1998, 12, 1) - 90
    rf = C(store, "lineitem", "l_returnflag")[m]
    ls = C(store, "lineitem", "l_linestatus")[m]
    qty = C(store, "lineitem", "l_quantity")[m].astype(np.int64)
    ep = C(store, "lineitem", "l_extendedprice")[m].astype(np.int64)
    disc = C(store, "lineitem", "l_discount")[m].astype(np.int64)
    tax = C(store, "lineitem", "l_tax")[m].astype(np.int64)
    disc_price = ep * (100 - disc)  # scale 4
    charge = disc_price * (100 + tax)  # scale 6
    keys, (s_qty, s_ep, s_dp, s_ch, s_disc, cnt), inv, _ = groupby_sum(
        [rf, ls], [qty, ep, disc_price, charge, disc, np.ones_like(qty)])
    return {
        "l_returnflag": keys[0], "l_linestatus": keys[1],
        "sum_qty": s_qty, "sum_base_price": s_ep, "sum_disc_price": s_dp,
        "sum_charge": s_ch, "avg_qty": tdiv(s_qty, cnt),
        "avg_price": tdiv(s_ep, cnt), "avg_disc": tdiv(s_disc, cnt),
        "count_order": cnt,
    }


def q6(store: ColumnStore):
    ship = C(store, "lineitem", "l_shipdate")
    disc = C(store, "lineitem", "l_discount").astype(np.int64)
    qty = C(store, "lineitem", "l_quantity").astype(np.int64)
    ep = C(store, "lineitem", "l_extendedprice").astype(np.int64)
    m = ((ship >= day(1994, 1, 1)) & (ship < day(1995, 1, 1))
         & (disc >= 5) & (disc <= 7) & (qty < 2400))
    return {"revenue": np.array([np.sum(ep[m] * disc[m])])}


ORACLES = {"01": q1, "06": q6}
