"""Vectorized searchsorted.

The JAX package ranked large query sets with a tagged co-sort because
binary search serialized on its device; on the GPU ``torch.searchsorted``
runs one thread per query, so the port keeps only the dispatch entry point
the engine calls (``searchsorted_fast``)."""

from __future__ import annotations

import torch


def searchsorted_fast(table: torch.Tensor, queries: torch.Tensor,
                      side: str = "left"):
    """= ``searchsorted(table, queries, side)`` for a sorted integer
    ``table``."""
    return torch.searchsorted(table.to(torch.int64),
                              queries.to(torch.int64), side=side)
