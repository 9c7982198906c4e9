"""Stream compaction: positions of a mask's true rows, in order.

``FoldSelect`` compacts a boolean mask into ascending positions, and the
dense folds compact their group occupancy the same way
(``lower._sel_positions``).  On a CUDA tensor the wrapper launches the
hand-written kernel in ``csrc/compact.cu`` (count, scan, write; see the
note there); on a CPU tensor it runs the plain version.  Replaces
``mplan2vdl_tpu/engine/kernels/compact.py:compact_positions`` with the same
contract.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _lib

INT32_MAX = 2**31 - 1

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
    tile = lib.m2v_compact_tile()
    nb = -(-n // tile)
    out = torch.empty(n_out, dtype=torch.int32, device=mask.device)
    counts = torch.empty(max(nb, 1), dtype=torch.int32, device=mask.device)
    offsets = torch.empty(nb + 1, dtype=torch.int32, device=mask.device)
    _lib.check(lib.m2v_compact(mask.data_ptr(), n, counts.data_ptr(),
                               offsets.data_ptr(), out.data_ptr(), n_out,
                               _lib.stream(mask)), "compact")
    launches += 1
    return out
