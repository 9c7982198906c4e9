"""Monotone scatter: ``out[pos[i]] = src[i]`` into a zeroed buffer.

The engine's scatters all write through unique, ascending positions: FK-join
mask deduction scatters ones or positions through an ascending unique
dimension mask, and the relational Scatter receives compaction outputs.  On
CUDA tensors the wrapper launches the hand-written kernel in
``csrc/scatter.cu`` (one launch: blocks own spans of ``TILE``-slot output
tiles, stage each tile in shared memory from the run of source rows that
lands in it, walked in ``CHUNK``-row chunks, and store every slot once); on
CPU tensors it runs the plain version.  Replaces
``mplan2vdl_tpu/engine/kernels/scatter.py:monotone_scatter`` with the same
contract; the TPU kernel's two-window log-shift spread has no counterpart.
"""

from __future__ import annotations

import torch

from ... import tracing
from . import _lib

_DTYPES = (torch.int32, torch.int64)

# output slots one block of csrc/scatter.cu stages at a time (its kTile),
# and rows its walk loads per step (its kChunk)
TILE = 4096
CHUNK = 1024

# kernel launches made by monotone_scatter (callers reset it)
launches = 0


def monotone_scatter_plain(pos: torch.Tensor, src: torch.Tensor,
                           L: int) -> torch.Tensor:
    """Plain PyTorch version: ``torch.zeros(L).index_put_`` over the rows
    whose position lies in ``[0, L)``."""
    out = torch.zeros(L, dtype=src.dtype, device=src.device)
    ok = (pos >= 0) & (pos < L)
    out.index_put_((pos[ok].long(),), src[ok])
    return out


@tracing.kernel
def monotone_scatter(pos: torch.Tensor, src: torch.Tensor,
                     L: int) -> torch.Tensor:
    """``out[pos[i]] = src[i]`` over ``L`` slots, 0 where no row writes.
    ``pos`` must be unique (strictly ascending over the valid prefix, as
    the engine gives it); rows whose position is outside ``[0, L)`` are
    dropped, which is how callers mark invalid rows.  ``src`` is int32 or
    int64 and sets the output dtype; ``pos`` is int32 or int64."""
    global launches
    if pos.dim() != 1 or src.dim() != 1 or pos.shape[0] != src.shape[0]:
        raise ValueError(f"pos {tuple(pos.shape)} and src {tuple(src.shape)} "
                         "must be 1-D of one length")
    if pos.dtype not in _DTYPES or src.dtype not in _DTYPES:
        raise TypeError(f"pos {pos.dtype} / src {src.dtype} not int32/int64")
    if pos.device != src.device:
        raise ValueError("positions and source on different devices")
    L = int(L)
    if L < 0:
        raise ValueError(f"L={L} < 0")
    if pos.device.type == "cpu":
        return monotone_scatter_plain(pos, src, L)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    out = torch.empty(L, dtype=src.dtype, device=src.device)
    if L == 0:
        return out
    pos, src = pos.contiguous(), src.contiguous()
    lib = _lib.lib()
    if lib.m2v_scatter_tile() != TILE:
        raise RuntimeError("scatter.cu's tile differs from scatter.TILE")
    _lib.check(_lib.call(
        "m2v_scatter", pos.data_ptr(), pos.element_size(), src.data_ptr(),
        src.element_size(), out.data_ptr(), pos.shape[0], L,
        _lib.stream(pos)), "scatter")
    launches += 1
    return out
