"""Vectorized searchsorted.

The JAX package ranked large query sets with a tagged co-sort because
binary search serialized on its device; on the GPU ``torch.searchsorted``
runs one thread per query, so the port keeps only the entry points the
engine calls: ``searchsorted_fast`` and ``lo_hi`` (which replaces
``merge_lo_hi`` and its tagged co-sort in the equijoin)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def searchsorted_fast(table: torch.Tensor, queries: torch.Tensor,
                      side: str = "left", key_hi: Optional[int] = None):
    """= ``searchsorted(table, queries, side)`` for a sorted integer
    ``table``.  ``key_hi`` bounded the JAX co-sort's key packing;
    ``torch.searchsorted`` has no packing, so it is accepted and unused."""
    del key_hi
    return torch.searchsorted(table.to(torch.int64),
                              queries.to(torch.int64), side=side)


def lo_hi(table: torch.Tensor, queries: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First and one-past-last position of each query's run of equal keys
    in the sorted ``table`` (same dtype as ``queries``), as int64."""
    return (torch.searchsorted(table, queries),
            torch.searchsorted(table, queries, right=True))
