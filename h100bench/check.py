"""The comparison that decides ``correct``: the rows a query returned
against its plain reference, as multisets of int64 rows.

``rows_off`` is 0 exactly when the two row sets are equal; otherwise it
counts the rows that differ (after sorting both) plus the difference in
row counts.  Its limit is 0: every answer is exact.  ``control`` puts the
reference computed in float32 in the program's place, which must fail.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

LIMIT = 0  # rows off: the configurations guarantee exact answers


def canonical(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """The rows of ``cols`` as an int64 [rows, columns] tensor, sorted."""
    rows = torch.stack([c.to(torch.int64).reshape(-1) for c in cols], 1)
    for j in range(rows.shape[1] - 1, -1, -1):
        order = torch.sort(rows[:, j], stable=True).indices
        rows = rows[order]
    return rows


def rows_off(got: Sequence[torch.Tensor], want: torch.Tensor) -> int:
    """Rows of ``got`` (columns) that differ from the sorted ``want``."""
    if len(got) != want.shape[1] or len({c.numel() for c in got}) > 1:
        return max(want.shape[0], max((c.numel() for c in got), default=0))
    g = canonical(got)
    n = min(g.shape[0], want.shape[0])
    return (abs(g.shape[0] - want.shape[0])
            + int((g[:n] != want[:n]).any(1).sum()))


def host_columns(result, device) -> List[torch.Tensor]:
    """A ``QueryResult``'s columns on ``device`` as int64."""
    return [torch.from_numpy(np.ascontiguousarray(c, dtype=np.int64))
            .to(device) for c in result.columns]


def compare(kept: Dict[str, list], tables, cell, acc=torch.int64
            ) -> Dict[str, dict]:
    """For each query, the worst ``rows_off`` over its kept results
    against the reference computed in ``acc``, with its limit."""
    dev = next(iter(tables.cols.values())).device
    out = {}
    for q in cell.queries:
        want = canonical(cell.reference(q).reference(tables, acc))
        results = kept.get(q, [])
        worst = max((rows_off(host_columns(r, dev), want) for r in results),
                    default=want.shape[0] or 1)
        out[f"{q}.rows_off"] = {"value": worst, "limit": LIMIT,
                                "results": len(results)}
        del want
    return out


def control(tables, cell, acc=torch.float32) -> Dict[str, dict]:
    """The reference in ``acc`` in the program's place: its rows against
    the exact reference's, by the same comparison."""
    out = {}
    for q in cell.queries:
        ref = cell.reference(q)
        want = canonical(ref.reference(tables, torch.int64))
        out[f"{q}.rows_off"] = {"value": rows_off(ref.reference(tables, acc),
                                                  want), "limit": LIMIT}
        del want
    return out


def passed(numbers: Dict[str, dict]) -> bool:
    return all(v["value"] <= v["limit"] and v.get("results", 1) > 0
               for v in numbers.values())
