"""Digit rank of an LSD radix pass, per 8192-element block.

``radix_rank(x, nbits)[i]`` is the number of ``j`` in ``i``'s 8192-element
block with ``j <= i`` and the same ``nbits``-bit digit (``x & (2^nbits -
1)``): the inclusive, 1-based rank that places each element inside its
(block, bucket).  It is the data movement a multi-digit radix sort pays per
pass, which the radix probe (``tools/probe_radix.py``) weighs against a
stable sort.

On CUDA tensors ``radix_rank`` launches the hand-written kernel in
``csrc/radix_rank.cu`` (each warp ranks its own ``WARP_KEYS`` keys of a
block with ballots and a warp-private running count per digit, then the
warps' counts are scanned into offsets: two block barriers in all); on CPU
tensors it runs ``radix_rank_plain``, a one-hot cumulative sum per block.  Replaces the Pallas kernel ``rank_kernel`` of
``mplan2vdl_tpu/tools/probe_radix.py``, whose lower-triangular matmul scans
answered Mosaic's missing cumsum.
"""

from __future__ import annotations

import torch

from . import _lib

BLOCK = 8192
# keys of a block that one warp of csrc/radix_rank.cu ranks (its kWarpKeys)
WARP_KEYS = 1024
# elements of the plain version's one-hot per batch of blocks
PLAIN_BUDGET = 1 << 26

# kernel launches made by radix_rank (callers reset it)
launches = 0


def _check(x: torch.Tensor, nbits: int) -> None:
    if x.dim() != 1 or x.dtype != torch.int32:
        raise TypeError(f"keys must be 1-D int32, got {x.dtype} "
                        f"{tuple(x.shape)}")
    if x.shape[0] % BLOCK:
        raise ValueError(f"{x.shape[0]} keys: not a multiple of {BLOCK}")
    if not 1 <= nbits <= 8:
        raise ValueError(f"nbits {nbits} outside [1, 8]")


def radix_rank_plain(x: torch.Tensor, nbits: int) -> torch.Tensor:
    """Plain PyTorch version: per block, the one-hot of each digit, its
    int32 cumulative sum along the block, read back at each element's own
    digit (in batches of blocks, so the one-hot stays within
    ``PLAIN_BUDGET`` elements)."""
    _check(x, nbits)
    r = 1 << nbits
    d = (x & (r - 1)).view(-1, BLOCK).to(torch.int64)
    out = torch.empty_like(x).view(-1, BLOCK)
    buckets = torch.arange(r, device=x.device)
    step = max(1, PLAIN_BUDGET // (BLOCK * r))
    for lo in range(0, d.shape[0], step):
        db = d[lo:lo + step].unsqueeze(-1)
        cs = torch.cumsum((db == buckets).to(torch.int32), dim=1,
                          dtype=torch.int32)
        out[lo:lo + step] = cs.gather(2, db).squeeze(-1)
    return out.view(-1)


def radix_rank(x: torch.Tensor, nbits: int) -> torch.Tensor:
    """int32[n] ranks of int32[n] keys, n a multiple of 8192."""
    global launches
    _check(x, nbits)
    if x.device.type == "cpu":
        return radix_rank_plain(x, nbits)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    rc = _lib.call("m2v_radix_rank", x.data_ptr(), out.data_ptr(),
                   x.shape[0], nbits, _lib.stream(x))
    _lib.check(rc, "radix_rank")
    launches += 1
    return out


def radix_rank_checksum(y: torch.Tensor) -> torch.Tensor:
    """The radix probe's return value: ``sum(y[:, 0]) + y[0, -1]`` of the
    (n / 128, 128) view, as int64."""
    v = y.view(-1, 128)
    return v[:, 0].to(torch.int64).sum() + v[0, -1].to(torch.int64)
