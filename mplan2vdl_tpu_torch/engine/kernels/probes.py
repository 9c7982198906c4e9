"""Kernel-pattern probes: the small patterns of the TPU kernel probe, as
kernels of this card, one launch a probe.

``tools/probe_kernels.py`` runs the twelve probes of
``mplan2vdl_tpu/tools/probe_mosaic.py`` through the wrappers below.  On
CUDA tensors each wrapper launches its kernel in ``csrc/probes.cu``; on CPU
tensors it runs the plain version beside it (``PLAIN`` holds the plain
versions under the wrappers' names, so a probe written against one runs
against the other).  ``mma_contract`` goes through the tensor-core
contraction of ``csrc/multiagg_mxu.cu`` (``csrc/mma_u8.cuh``), with the
values split into 8-bit limbs as that kernel splits them, so that a
fragment-layout slip shows in a small probe.  Replaces
``mplan2vdl_tpu/tools/probe_mosaic.py:run_probe``.

The probes are launch-bound, so a wrapper checks only what its kernel
cannot take (dtype, sizes, device), allocates its output uninitialised
(``_empty``: every kernel writes all of it) and launches through
``_lib.call``.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional

import torch

from . import _lib

# kernel launches made by the wrappers below (callers reset it)
launches = 0

# rhs modes of the contractions: rhs[b][j][k]; the same rhs read through
# its explicit transpose (probe 9: the kernel stages it in shared memory as
# [k][j]); the one-hot (keys[b][k] == j); one mask (keys[b][k] == key) for
# every column j
RHS_ROWS, RHS_ROWS_T, RHS_ONEHOT, RHS_KEY = 0, 1, 2, 3
MAX_COLS = 32  # columns n of a contraction
# csrc/probes.cu's shapes, which the CPU tests' models of its kernels use:
# fma_kernel's threads a block and its staged transpose's floats;
# mma_kernel's 128-thread groups a block and rows a step (mma_u8.cuh)
FMA_THREADS, STAGE_WORDS = 256, 256 * (MAX_COLS + 1)
MMA_GROUPS, MMA_STEP_ROWS = 4, 512
# the depth bounds of mma_contract: byte x byte products (RHS_ROWS), and
# 0/1 rhs bytes, so that no warp's int32 cell passes 2^31
MMA_ROWS_DEPTH, MMA_MASK_DEPTH = 1 << 15, (1 << 23) - 1


def _int32(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32, got {t.dtype}")


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); raises for any other device."""
    if t.is_cuda:
        return True
    if t.is_cpu:
        return False
    raise ValueError(f"unsupported device {t.device}")


# a template of each (shape, dtype, device) of a probe output:
# torch.empty_like of it allocates in about half the host time of
# torch.empty with keyword arguments (the probes are launch-bound)
_templates: Dict[tuple, torch.Tensor] = {}


def _empty(shape: tuple, dtype: torch.dtype, ref: torch.Tensor):
    """An uninitialised tensor of ``shape`` and ``dtype`` on ``ref``'s
    device."""
    key = (shape, dtype, ref.get_device())
    t = _templates.get(key)
    if t is None:
        t = _templates[key] = torch.empty(shape, dtype=dtype,
                                          device=ref.device)
    return torch.empty_like(t)


def _launched(rc: int, what: str) -> None:
    global launches
    if rc:
        _lib.check(rc, what)
    launches += 1


# ------------------------------------------------------------- transpose
def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    return x.t().contiguous()


def transpose(x: torch.Tensor) -> torch.Tensor:
    """int32[r, c] -> int32[c, r]."""
    _int32(x)
    if x.dim() != 2:
        raise ValueError("transpose of a 2-D tensor")
    if not _on_card(x):
        return transpose_plain(x)
    x = x.contiguous()
    rows, cols = x.shape
    out = _empty((cols, rows), torch.int32, x)
    _launched(_lib.call("m2v_probe_transpose", x.data_ptr(), rows, cols,
                        out.data_ptr(), _lib.stream(x)), "probe transpose")
    return out


# ----------------------------------------------------------- rows copy
def rows_copy_plain(x, src_cols, row0, row_step, out_rows, out_cols):
    flat = x.reshape(-1)
    r = torch.arange(out_rows, device=x.device)[:, None]
    c = torch.arange(out_cols, device=x.device)[None, :]
    return flat[(row0 + r * row_step) * src_cols + c]


def rows_copy(x: torch.Tensor, src_cols: int, row0: int, row_step: int,
              out_rows: int, out_cols: int) -> torch.Tensor:
    """``out[r][c] = flat(x)[(row0 + r * row_step) * src_cols + c]``: a
    reshape (identity on the flat index) or a strided row slice."""
    _int32(x)
    last = (row0 + (out_rows - 1) * row_step) * src_cols + out_cols - 1
    if min(row0, row_step, out_rows - 1, out_cols - 1) < 0 or \
            last >= x.numel():
        raise ValueError("rows_copy reads outside its source")
    if not _on_card(x):
        return rows_copy_plain(x, src_cols, row0, row_step, out_rows,
                               out_cols)
    x = x.contiguous()
    out = _empty((out_rows, out_cols), torch.int32, x)
    _launched(_lib.call("m2v_probe_rows_copy", x.data_ptr(), src_cols, row0,
                        row_step, out_rows, out_cols, out.data_ptr(),
                        _lib.stream(x)), "probe rows_copy")
    return out


# -------------------------------------------------------- contractions
def _rhs_matrix(rhs, mode, batch, n, k, key):
    """The rhs as [batch, n, k] int64."""
    if mode == RHS_ROWS:
        return rhs.reshape(batch, n, k).to(torch.int64)
    if mode == RHS_ROWS_T:  # the explicit transpose, read column-wise
        t = rhs.reshape(batch, n, k).transpose(1, 2).contiguous()
        return t.transpose(1, 2).to(torch.int64)
    keys = rhs.reshape(batch, 1, k)
    want = (torch.arange(n, device=rhs.device).view(1, n, 1)
            if mode == RHS_ONEHOT else key)
    return (keys == want).to(torch.int64).expand(batch, n, k)


def _dot(a, b):
    """[batch, m, k] x [batch, n, k] -> [batch, m, n] in int64 (integer
    matmul has no CUDA kernel in torch, so multiply and sum)."""
    return (a.unsqueeze(2) * b.unsqueeze(1)).sum(-1)


def _contract_args(a, rhs, m, n, k, mode, batch) -> bool:
    """Checks a contraction's operands (``batch`` items, None for one
    item with no batch axis); True when they lie on the card."""
    if a.dtype != torch.int32 or rhs.dtype != torch.int32:
        raise TypeError(f"expected int32, got {a.dtype} and {rhs.dtype}")
    nb = 1 if batch is None else batch
    if nb < 1:
        raise ValueError(f"batch of {batch} items")
    if a.numel() != nb * m * k:
        raise ValueError(f"lhs of {a.numel()} elements, not {batch}x{m}x{k}")
    if mode == RHS_ROWS or mode == RHS_ROWS_T:
        want = nb * n * k
    elif mode == RHS_ONEHOT or mode == RHS_KEY:
        want = nb * k
    else:
        raise ValueError(f"rhs mode {mode}")
    if rhs.numel() != want:
        raise ValueError(f"rhs of {rhs.numel()} elements for mode {mode}")
    if n < 1 or n > MAX_COLS:
        raise ValueError(f"{n} columns: a contraction has 1..{MAX_COLS}")
    if a.get_device() != rhs.get_device():
        raise ValueError("lhs and rhs on different devices")
    return _on_card(a)


def _out_shape(batch, m, n):
    return (m, n) if batch is None else (batch, m, n)


def fma_contract_plain(a, rhs, m, n, k, mode, key=0, batch=None):
    nb = 1 if batch is None else batch
    b = _rhs_matrix(rhs, mode, nb, n, k, key)
    return _dot(a.reshape(nb, m, k).to(torch.int64), b).to(
        torch.float32).reshape(_out_shape(batch, m, n))


def fma_contract(a: torch.Tensor, rhs: torch.Tensor, m: int, n: int, k: int,
                 mode: int, key: int = 0,
                 batch: Optional[int] = None) -> torch.Tensor:
    """float32[batch, m, n] (float32[m, n] when ``batch`` is None): ``sum_k
    a[b][i][k] * rhs element`` in float FMA (exact while every partial sum
    is an integer below 2^24)."""
    if not _contract_args(a, rhs, m, n, k, mode, batch):
        return fma_contract_plain(a, rhs, m, n, k, mode, key, batch)
    a, rhs = a.contiguous(), rhs.contiguous()
    out = _empty(_out_shape(batch, m, n), torch.float32, a)
    _launched(_lib.call("m2v_probe_fma", a.data_ptr(), rhs.data_ptr(),
                        batch or 1, m, n, k, mode, key, out.data_ptr(),
                        _lib.stream(a)),
              "probe fma")
    return out


def mma_contract_plain(a, nlimb, rhs, m, n, k, mode, key=0, batch=None):
    """The same sum over u8 limb planes of ``a``, recombined."""
    nb = 1 if batch is None else batch
    b = _rhs_matrix(rhs, mode, nb, n, k, key)
    a = a.reshape(nb, m, k).to(torch.int64)
    out = torch.zeros((nb, m, n), dtype=torch.int64, device=a.device)
    for limb in range(nlimb):
        plane = (a >> (8 * limb)) & 0xFF
        out += _dot(plane, b & 0xFF) << (8 * limb)
    return out.reshape(_out_shape(batch, m, n))


def mma_contract(a: torch.Tensor, nlimb: int, rhs: torch.Tensor, m: int,
                 n: int, k: int, mode: int, key: int = 0,
                 batch: Optional[int] = None) -> torch.Tensor:
    """int64[batch, m, n] (int64[m, n] when ``batch`` is None): the
    ``fma_contract`` sum on the tensor cores, through multiagg_mxu's
    contraction: ``a`` (non-negative, below 2^(8 * nlimb)) split into
    ``nlimb`` byte planes, the rhs as bytes
    (modes RHS_ROWS with entries 0..255 and depth k <= MMA_ROWS_DEPTH;
    RHS_ONEHOT and RHS_KEY with k <= MMA_MASK_DEPTH).  The kernel writes
    every output: no zero fill."""
    on_card = _contract_args(a, rhs, m, n, k, mode, batch)
    if mode == RHS_ROWS_T:
        raise ValueError("mma_contract takes the rhs row-wise")
    if not (1 <= nlimb <= 4 and m * nlimb <= 32
            and k <= (MMA_ROWS_DEPTH if mode == RHS_ROWS
                      else MMA_MASK_DEPTH)):
        raise ValueError(f"mma_contract of {m}x{nlimb} planes, {n} columns, "
                         f"depth {k}: outside one block's tile")
    if not on_card:
        return mma_contract_plain(a, nlimb, rhs, m, n, k, mode, key, batch)
    a, rhs = a.contiguous(), rhs.contiguous()
    out = _empty(_out_shape(batch, m, n), torch.int64, a)
    _launched(_lib.call("m2v_probe_mma", a.data_ptr(), nlimb, rhs.data_ptr(),
                        batch or 1, m, n, k, mode, key, out.data_ptr(),
                        _lib.stream(a)), "probe mma")
    return out


# ------------------------------------------------------------------ take
def take_plain(table, idx, blocks=1):
    p = torch.clamp(idx.to(torch.int64), 0, table.numel() - 1)
    return table.reshape(-1)[p]


def take(table: torch.Tensor, idx: torch.Tensor,
         blocks: int = 1) -> torch.Tensor:
    """``flat(table)[clip(idx)]`` in idx's shape; ``blocks`` blocks each
    hold the whole table in shared memory (8 for the broadcast rows of
    take_along_axis, 1 for a flat take)."""
    _int32(table, idx)
    if not 1 <= table.numel() <= 8192 or idx.numel() < 1:
        raise ValueError("take of a table of 1..8192 entries")
    if table.get_device() != idx.get_device():
        raise ValueError("table and idx on different devices")
    if not _on_card(idx):
        return take_plain(table, idx, blocks)
    table, idx = table.contiguous(), idx.contiguous()
    out = torch.empty_like(idx)
    _launched(_lib.call("m2v_probe_take", table.data_ptr(), table.numel(),
                        idx.data_ptr(), idx.numel(), blocks, out.data_ptr(),
                        _lib.stream(idx)), "probe take")
    return out


# ------------------------------------------------------------------ noop
def noop(device) -> None:
    """One launch of an empty kernel on ``device``'s current stream,
    through the probes' launch path: the fixed cost each probe launch pays
    (a CUDA device only)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"noop launches on a CUDA device, not {device}")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    _launched(_lib.call("m2v_probe_noop", _lib.device_stream(index)),
              "probe noop")


PLAIN = SimpleNamespace(transpose=transpose_plain, rows_copy=rows_copy_plain,
                        fma_contract=fma_contract_plain,
                        mma_contract=mma_contract_plain, take=take_plain)
