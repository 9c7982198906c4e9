"""Gather for one source or many: through monotone positions, or from a
small table through positions in any order.

Every Select compacts to ascending positions and then gathers each surviving
column through them; joins expand through consecutive positions and sparse
folds gather through sort permutations.  On CUDA tensors ``gather_many``
launches the hand-written kernel in ``csrc/gather.cu`` (one launch for up to
its capacity of sources sharing the positions, int32 and int64 mixed); on
CPU tensors it runs the plain version.  Replaces
``mplan2vdl_tpu/engine/kernels/sorted_gather.py:sorted_gather`` and
``gather_many(small=False)`` with the same contract.  The TPU kernel's
span-fit windows (``W_OPTIONS``, ``resolve_fit``) have no counterpart: on
the GPU a warp's 32 consecutive rows coalesce by themselves.  On an H100 the
kernel is right for any order of positions and its speed follows the
order: consecutive positions run at 0.9 of the byte bound, ascending ones
at 15.9% density at 0.4–0.5 of it (about 0.7 of the bytes counted in
32-byte sectors), and a permutation of a 60M-row source at 0.1–0.2 (random sector
reads).

FK-value gathers into dimension tables of at most ``SMALL_TABLE`` rows take
``gather_many(small=True)`` / ``small_table_gather``: the kernel in
``csrc/small_gather.cu`` keeps the tables in shared memory when they fit its
budget and reads them through the read-only cache otherwise.  Replaces
``small_table_gather`` and ``gather_many(small=True)``.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch

from ... import tracing
from . import _lib

_DTYPES = (torch.int32, torch.int64)

# max rows of a table that gather_many(small=True) takes (the JAX
# package's VMEM-resident limit, kept as the routing threshold)
SMALL_TABLE = 65536

# kernel launches made by sorted_gather / gather_many(small=False) and by
# small_table_gather / gather_many(small=True) (callers reset them)
launches = 0
small_launches = 0

Valid = Union[int, torch.Tensor]


def prep_pos(src_len: int, pos: torch.Tensor, valid: Valid) -> torch.Tensor:
    """The kernel's position preprocessing (``_prep_pos``): repeat the last
    VALID position over the tail and clip into the source range (int64)."""
    m = pos.shape[0]
    idx = torch.arange(m, device=pos.device)
    v = torch.as_tensor(valid, dtype=torch.int64, device=pos.device)
    last = pos[torch.clamp(v - 1, 0, m - 1)]
    posm = torch.where(idx < v, pos, last).to(torch.int64)
    return torch.clamp(posm, 0, src_len - 1)


def gather_many_plain(srcs: Sequence[torch.Tensor], pos: torch.Tensor,
                      valid: Valid) -> List[torch.Tensor]:
    """Plain PyTorch version: ``src[p]`` for each source."""
    n = srcs[0].shape[0]
    if pos.shape[0] == 0 or n == 0:
        return [torch.zeros(pos.shape[0], dtype=s.dtype, device=s.device)
                for s in srcs]
    p = prep_pos(n, pos, valid)
    return [s[p] for s in srcs]


def _check(srcs, pos, valid):
    if not srcs:
        raise ValueError("gather of no sources")
    n = srcs[0].shape[0]
    for s in srcs:
        if s.dim() != 1 or s.shape[0] != n:
            raise ValueError("sources must be 1-D and share a length")
        if s.dtype not in _DTYPES:
            raise TypeError(f"source dtype {s.dtype} not int32/int64")
        if s.device != pos.device:
            raise ValueError("sources and positions on different devices")
    if pos.dim() != 1 or pos.dtype not in _DTYPES:
        raise TypeError(f"positions must be 1-D int32/int64, got "
                        f"{pos.dtype} {tuple(pos.shape)}")
    if isinstance(valid, torch.Tensor) and (
            valid.numel() != 1 or valid.device != pos.device):
        raise ValueError("valid must be an int or a one-element tensor on "
                         "the positions' device")


def small_gather_plain(srcs: Sequence[torch.Tensor],
                       pos: torch.Tensor) -> List[torch.Tensor]:
    """Plain PyTorch version of the small-table gather:
    ``src[clamp(pos, 0, n - 1)]`` for each source."""
    n = srcs[0].shape[0]
    if pos.shape[0] == 0 or n == 0:
        return [torch.zeros(pos.shape[0], dtype=s.dtype, device=s.device)
                for s in srcs]
    p = torch.clamp(pos.to(torch.int64), 0, n - 1)
    return [s[p] for s in srcs]


def _small_gather(srcs: List[torch.Tensor],
                  pos: torch.Tensor) -> List[torch.Tensor]:
    global small_launches
    m, n = pos.shape[0], srcs[0].shape[0]
    if n > SMALL_TABLE:
        raise ValueError(f"small-table gather of {n} rows > {SMALL_TABLE}")
    if pos.device.type == "cpu":
        return small_gather_plain(srcs, pos)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    outs = [torch.empty(m, dtype=s.dtype, device=s.device) for s in srcs]
    if m == 0:
        return outs
    if n == 0:
        return [o.zero_() for o in outs]
    srcs = [s.contiguous() for s in srcs]
    pos = pos.contiguous()
    lib = _lib.lib()
    cap = lib.m2v_small_gather_max_sources()
    for lo in range(0, len(srcs), cap):
        part, part_out = srcs[lo:lo + cap], outs[lo:lo + cap]
        rc = _lib.call(
            "m2v_small_gather", _lib.ptrs(part), _lib.ptrs(part_out),
            _lib.ints([s.element_size() for s in part]), len(part),
            pos.data_ptr(), pos.element_size(), m, n, _lib.stream(pos))
        _lib.check(rc, "small_gather")
        small_launches += 1
    return outs


@tracing.kernel
def gather_many(srcs: Sequence[torch.Tensor], pos: torch.Tensor,
                valid: Valid, small: bool = False) -> List[torch.Tensor]:
    """``[s[p] for s in srcs]``; sources share a length and may mix int32
    and int64.  By default ``p`` = ``prep_pos(pos, valid)``, positions in
    any order (fastest when consecutive, slowest as a permutation: see the
    module note).
    ``small=True`` is the small-table gather: at most ``SMALL_TABLE``
    source rows, positions in any order, ``p = clamp(pos, 0, n - 1)`` with
    no tail repeat (``valid`` is not read)."""
    global launches
    srcs = list(srcs)
    _check(srcs, pos, valid)
    if small:
        return _small_gather(srcs, pos)
    if pos.device.type == "cpu":
        return gather_many_plain(srcs, pos, valid)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    m, n = pos.shape[0], srcs[0].shape[0]
    outs = [torch.empty(m, dtype=s.dtype, device=s.device) for s in srcs]
    if m == 0:
        return outs
    if n == 0:
        return [o.zero_() for o in outs]
    srcs = [s.contiguous() for s in srcs]
    pos = pos.contiguous()
    if isinstance(valid, torch.Tensor):
        vdev = valid.reshape(()).to(torch.int64).contiguous()
        vhost, vptr = 0, vdev.data_ptr()
    else:
        vdev, vhost, vptr = None, int(valid), None
    lib = _lib.lib()
    cap = lib.m2v_gather_max_sources()
    for lo in range(0, len(srcs), cap):
        part, part_out = srcs[lo:lo + cap], outs[lo:lo + cap]
        rc = _lib.call(
            "m2v_gather", _lib.ptrs(part), _lib.ptrs(part_out),
            _lib.ints([s.element_size() for s in part]), len(part),
            pos.data_ptr(), pos.element_size(), m, n, vhost, vptr,
            _lib.stream(pos))
        _lib.check(rc, "gather")
        launches += 1
    return outs


def sorted_gather(src: torch.Tensor, pos: torch.Tensor,
                  valid: Valid) -> torch.Tensor:
    """``src[pos]`` for monotone ``pos`` (rows past ``valid`` repeat the
    last valid position; positions clip into the source) — the k = 1 call
    of ``gather_many``."""
    return gather_many([src], pos, valid)[0]


def small_table_gather(src: torch.Tensor, pos: torch.Tensor,
                       valid: Valid) -> torch.Tensor:
    """``src[clamp(pos)]`` for a table of at most ``SMALL_TABLE`` rows,
    positions in any order — the k = 1 call of ``gather_many(small=True)``."""
    return gather_many([src], pos, valid, small=True)[0]
