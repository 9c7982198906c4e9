"""Device selection for the port (replaces ``jaxcfg.py``).

Every entry point takes an explicit ``device``; the default is ``cuda``.
Without a CUDA device the call raises unless the caller asked for the CPU
(``device="cpu"``) — the engine never carries on on the CPU unasked.
Integers are native int64 (no x64 switch), and there is no compile cache:
the engine runs eagerly.
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device=None) -> torch.device:
    """The torch device for ``device`` (None means ``cuda``); raises when
    CUDA is asked for and absent."""
    dev = torch.device(DEFAULT if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: mplan2vdl_tpu_torch runs on the GPU; pass "
            "device='cpu' (CLI: --cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
