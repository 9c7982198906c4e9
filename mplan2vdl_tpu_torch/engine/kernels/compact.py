"""Stream compaction: positions of a mask's true rows, in order.

``FoldSelect`` compacts a boolean mask into ascending positions, and the
dense folds compact their group occupancy the same way
(``lower._sel_positions``).  On a CUDA tensor the wrapper launches the
hand-written kernel in ``csrc/compact.cu`` (one launch, a single-pass scan
by decoupled look-back; see the note there); on a CPU tensor it runs the
plain version.  Replaces
``mplan2vdl_tpu/engine/kernels/compact.py:compact_positions`` with the same
contract.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ... import tracing
from . import _lib

INT32_MAX = 2**31 - 1

# rows per tile of the kernel (csrc/compact.cu kTile)
TILE = 32768
# zero-tail slots per extra block, and the most extra blocks one call takes
TAIL_SLOTS = 1 << 16
MAX_TAIL_BLOCKS = 264
# status words carry a 30-bit epoch; 0 marks a word never written
EPOCH_LIMIT = 1 << 30
# status words allocated at least, so that small masks share one buffer
MIN_STATUS = 1024

# kernel launches made by compact_positions (callers reset it to count a run)
launches = 0


def compact_positions_plain(mask: torch.Tensor,
                            n_out: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: ``torch.nonzero`` padded with zeros to
    ``n_out`` (default ``len(mask)``) and trimmed to it, as int32."""
    n = mask.shape[0]
    n_out = n if n_out is None else n_out
    pos = torch.nonzero(mask.reshape(-1)).reshape(-1)[:n_out]
    out = torch.zeros(n_out, dtype=torch.int32, device=mask.device)
    out[:pos.shape[0]] = pos.to(torch.int32)
    return out


def tiles(n: int) -> int:
    """Tiles (look-back status words) of a mask of ``n`` rows."""
    return -(-n // TILE)


def tail_blocks(n_out: int) -> int:
    """Blocks launched beyond the tiles to write the zero tail of an output
    of ``n_out`` slots (none when there are no slots)."""
    return min(-(-n_out // TAIL_SLOTS), MAX_TAIL_BLOCKS)


class Lookback:
    """Host bookkeeping of one stream's look-back scratch: an int64 buffer
    of ``words`` = 1 + status words, ``[0]`` the kernel's ticket counter.

    The kernel never resets the counter, so ``issued`` tracks the tickets
    that earlier calls drew; each call gets a new ``epoch`` so that status
    words of earlier calls read as unpublished.  ``plan`` returns, per
    call, the word count of a fresh zeroed buffer when one is needed (first
    use, more tiles than it holds, the epoch about to wrap) or None."""

    def __init__(self) -> None:
        self.words = 0
        self.issued = 0
        self.epoch = 0

    def plan(self, n_tiles: int, blocks: int) -> Tuple[Optional[int], int,
                                                       int]:
        """(fresh words or None, ticket base, epoch) for a call of
        ``n_tiles`` tiles launched as ``blocks`` blocks."""
        fresh = None
        if n_tiles > self.words - 1 or self.epoch + 1 >= EPOCH_LIMIT:
            fresh = 1 + max(n_tiles, 2 * (self.words - 1), MIN_STATUS)
            self.words, self.issued, self.epoch = fresh, 0, 0
        self.epoch += 1
        base = self.issued
        self.issued += blocks
        return fresh, base, self.epoch

    def forget(self) -> None:
        """After a refused launch: the next call starts from fresh scratch."""
        self.words = 0


# (device index, stream handle) -> (Lookback, its device buffer)
_scratch: Dict[Tuple[int, int], Tuple[Lookback, Optional[torch.Tensor]]] = {}


@tracing.kernel
def compact_positions(mask: torch.Tensor,
                      n_out: Optional[int] = None) -> torch.Tensor:
    """int32 positions of ``mask``'s true rows, ascending; entries past the
    true count are zero.  ``mask`` is a 1-D ``torch.bool`` tensor; ``n_out``
    (default ``len(mask)``, at most that) trims the output length."""
    if mask.dim() != 1:
        raise ValueError(f"mask must be 1-D, got shape {tuple(mask.shape)}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be torch.bool, got {mask.dtype}")
    n = mask.shape[0]
    n_out = n if n_out is None else int(n_out)
    if not 0 <= n_out <= n:
        raise ValueError(f"n_out={n_out} outside [0, {n}]")
    if n > INT32_MAX:
        raise ValueError(f"mask of {n} rows: int32 positions overflow")
    if mask.device.type == "cpu":
        return compact_positions_plain(mask, n_out)
    if mask.device.type != "cuda":
        raise ValueError(f"unsupported device {mask.device}")
    if not mask.is_contiguous() or mask.data_ptr() % 16:
        mask = mask.clone(memory_format=torch.contiguous_format)
    global launches
    lib = _lib.lib()
    if lib.m2v_compact_tile() != TILE:
        raise RuntimeError("compact.cu's tile differs from compact.TILE")
    out = torch.empty(n_out, dtype=torch.int32, device=mask.device)
    stream = _lib.stream(mask)
    key = (mask.device.index or 0, stream)
    state, buf = _scratch.get(key, (Lookback(), None))
    nt, tail = tiles(n), tail_blocks(n_out)
    fresh, base, epoch = state.plan(nt, nt + tail)
    if fresh is not None:
        buf = torch.zeros(fresh, dtype=torch.int64, device=mask.device)
    _scratch[key] = (state, buf)
    rc = _lib.call("m2v_compact", mask.data_ptr(), n, buf.data_ptr(), base,
                   epoch, out.data_ptr(), n_out, tail, stream)
    if rc != 0:
        state.forget()
    _lib.check(rc, "compact")
    launches += 1
    return out
