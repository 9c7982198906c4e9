"""Segmented reductions over small dense group-id domains, as torch ops.

For a domain of at most ``SMALL_DOMAIN`` ids the engine reduces once per
group id under a mask, as the JAX module does: on the GPU each masked
reduction is one tree reduction over the input with no atomics, so a
single-group sum (Q6) never funnels every row into one address.  Larger
domains take the engine's sort-based path (``engine/lower.py``)."""

from __future__ import annotations

import torch

SMALL_DOMAIN = 64


def _ident(op: str, dtype):
    if op == "sum":
        return 0
    # true dtype extremes: a group whose values legitimately equal the
    # dtype minimum must still max-reduce to that value (empty groups are
    # dropped later by occupancy compaction, so the identity never leaks)
    info = torch.iinfo(dtype)
    return info.min if op == "max" else info.max


def _reduce(op: str, x: torch.Tensor) -> torch.Tensor:
    if op == "sum":
        return x.sum(dtype=x.dtype)
    if op == "max":
        return x.max() if x.numel() else x.new_full((), torch.iinfo(x.dtype).min)
    return x.min() if x.numel() else x.new_full((), torch.iinfo(x.dtype).max)


def masked_group_reduce(data, ids_ok, domain: int, op: str):
    """[domain] vector of per-group reductions; rows whose ``ids_ok`` is
    outside [0, domain) are ignored.  Requires domain <= SMALL_DOMAIN."""
    if domain > SMALL_DOMAIN:
        raise ValueError(f"domain {domain} > SMALL_DOMAIN")
    ident = _ident(op, data.dtype)
    outs = [_reduce(op, torch.where(ids_ok == g, data,
                                    data.new_full((), ident)))
            for g in range(domain)]
    return torch.stack(outs)


def group_counts(ids_ok, domain: int):
    """[domain] vector of per-group row counts (int64)."""
    if domain > SMALL_DOMAIN:
        raise ValueError(f"domain {domain} > SMALL_DOMAIN")
    return torch.stack([(ids_ok == g).sum() for g in range(domain)])


def one_group_reduce(data, ok, key: int, domain: int, op: str):
    """``masked_group_reduce`` where every row that ``ok`` keeps (every row
    when ``ok`` is None) has the id ``key``: one reduction, and the
    identity at every other id."""
    x = data if ok is None else torch.where(ok, data, _ident(op, data.dtype))
    out = data.new_full((domain,), _ident(op, data.dtype))
    out[key] = _reduce(op, x)
    return out


def one_group_counts(ok, key: int, domain: int, n: int, device):
    """``group_counts`` of the same rows, ``n`` of them."""
    out = torch.zeros(domain, dtype=torch.int64, device=device)
    out[key] = n if ok is None else ok.sum()
    return out


def masked_group_reduce_with_counts(data, ids_ok, domain: int, op: str):
    """Per-group (reduction, row count)."""
    return (masked_group_reduce(data, ids_ok, domain, op),
            group_counts(ids_ok, domain))
