"""Plain torch relational helpers for the references.

Joins go through primary keys with a sort and ``searchsorted``, group-bys
through ``torch.unique`` of packed keys; nothing here imports the engine.
Every aggregate is computed in ``acc``: ``torch.int64`` gives the exact
answer, and a lower precision (``torch.float32``) is the control, whose
answers must come out wrong.  Results are int64 columns in the plan's
order, rows in any order.
"""

from __future__ import annotations

import datetime
import re
from typing import List, Sequence, Tuple

import torch

EXACT = torch.int64


def day(y: int, m: int, d: int) -> int:
    """Days since 0000-01-01 (proleptic Gregorian)."""
    return datetime.date(y, m, d).toordinal() + 365


def num(x: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """``x`` as a number to compute with in ``acc``."""
    return x.to(acc)


def out(x: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """An answer column as int64 (a float control rounds to nearest)."""
    return x.to(EXACT) if not acc.is_floating_point else (
        x.round().to(EXACT))


def tdiv(a: torch.Tensor, b: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """``a / b`` truncated toward zero, the engine's integer division."""
    if acc.is_floating_point:
        return torch.trunc(a / b)
    return torch.div(a, b, rounding_mode="trunc")


def codes(t, col: Tuple[str, str], pattern: str) -> torch.Tensor:
    """Codes of ``col``'s strings matching a SQL LIKE ``pattern``."""
    rx = re.compile("".join(".*" if ch == "%" else "." if ch == "_"
                            else re.escape(ch) for ch in pattern) + r"\Z",
                    re.S)
    dev = next(iter(t.cols.values())).device
    return torch.tensor([c for c, s in t.decoders[col].items()
                         if rx.match(s)], dtype=torch.int64, device=dev)


def pk_lookup(keys: torch.Tensor, probe: torch.Tensor):
    """Row of ``keys`` (a primary key) holding each ``probe`` value, and
    whether there is one."""
    keys, probe = keys.to(torch.int64), probe.to(torch.int64)
    if keys.numel() == 0:
        z = torch.zeros_like(probe)
        return z, z.bool()
    sk, order = torch.sort(keys, stable=True)
    i = torch.searchsorted(sk, probe).clamp_(max=sk.numel() - 1)
    return order[i], sk[i] == probe


def _pack(keys: Sequence[torch.Tensor]):
    """One int64 key that orders like the key tuple, and how to undo it."""
    packed = torch.zeros_like(keys[0], dtype=torch.int64)
    parts, bits = [], 0
    for k in keys:
        k = k.to(torch.int64)
        lo = int(k.min()) if k.numel() else 0
        w = (int(k.max()) - lo).bit_length() if k.numel() else 0
        bits += w
        if bits > 62:
            raise ValueError("group key wider than 62 bits")
        packed = (packed << w) | (k - lo)
        parts.append((lo, w))
    return packed, parts


def _unpack(packed: torch.Tensor, parts) -> List[torch.Tensor]:
    cols = []
    for lo, w in reversed(parts):
        cols.append((packed & ((1 << w) - 1)) + lo)
        packed = packed >> w
    return cols[::-1]


def group(keys: Sequence[torch.Tensor], aggs, acc: torch.dtype
          ) -> List[torch.Tensor]:
    """Rows grouped by the key tuple: the distinct keys (int64), then one
    column per ``(values, op)`` of ``aggs`` (op: ``sum``, ``min``, ``max``
    or ``count``, values None for a count), each computed and left in
    ``acc`` (``out`` makes it an answer column)."""
    packed, parts = _pack(keys)
    uniq, inv = torch.unique(packed, sorted=True, return_inverse=True)
    g = uniq.numel()
    cols = _unpack(uniq, parts)
    for vals, op in aggs:
        cols.append(reduce(vals, inv, g, op, acc))
    return cols


def reduce(vals, inv: torch.Tensor, g: int, op: str, acc: torch.dtype
           ) -> torch.Tensor:
    """Per-group ``op`` of ``vals`` (group of each row in ``inv``)."""
    if op == "count":
        vals = torch.ones_like(inv)
    vals = num(vals, acc)
    res = torch.zeros(g, dtype=acc, device=inv.device)
    if op in ("sum", "count"):
        return res.index_add_(0, inv, vals)
    return res.scatter_reduce_(0, inv, vals,
                               {"min": "amin", "max": "amax"}[op],
                               include_self=False)


def total(vals: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """The sum of ``vals`` as a one-row column."""
    return out(num(vals, acc).sum().reshape(1), acc)


def year(days: torch.Tensor) -> torch.Tensor:
    """Calendar year of day counts since 0000-01-01, through a table over
    the range the column holds."""
    lo, hi = int(days.min()), int(days.max())
    table = torch.tensor(
        [datetime.date.fromordinal(d - 365).year for d in range(lo, hi + 1)],
        dtype=torch.int64, device=days.device)
    return table[days.to(torch.int64) - lo]
