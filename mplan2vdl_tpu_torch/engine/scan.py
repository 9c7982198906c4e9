"""1-D prefix sums as torch ops.

The JAX package hand-rolled a log-sweep here because XLA's reduce-window
lowering was slow on its device; ``torch.cumsum`` is a single scan kernel
on the GPU, so both entry points are thin wrappers that keep the JAX
module's contracts (inclusive sums along axis 0, int64 flag counts)."""

from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along axis 0, in ``x``'s own dtype
    (wraparound semantics included)."""
    if x.shape[0] <= 1:
        return x
    return torch.cumsum(x, dim=0, dtype=x.dtype)


def cumsum_flags(flags: torch.Tensor) -> torch.Tensor:
    """Prefix sum of a 0/1 flag vector, returned as int64.  Accumulates in
    int32 when the total provably fits (n <= INT32_MAX)."""
    if flags.shape[0] <= INT32_MAX:
        return cumsum(flags.to(torch.int32)).to(torch.int64)
    return cumsum(flags.to(torch.int64))
