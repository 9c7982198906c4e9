"""Kernel-pattern probes: the small patterns of the TPU kernel probe, as
kernels of this card.

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
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from . import _lib

# kernel launches made by the wrappers below (callers reset it)
launches = 0

# rhs modes of the contractions: rhs[b][j][k], rhs[b][k][j], the one-hot
# (keys[b][k] == j), and one mask (keys[b][k] == key) for every column j
RHS_ROWS, RHS_COLS, RHS_ONEHOT, RHS_KEY = 0, 1, 2, 3


def _need(t: torch.Tensor) -> torch.Tensor:
    if t.dtype != torch.int32:
        raise TypeError(f"expected int32, got {t.dtype}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.contiguous()


def _launched(rc: int, what: str) -> None:
    global launches
    _lib.check(rc, what)
    launches += 1


# ------------------------------------------------------------- transpose
def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    return x.t().contiguous()


def transpose(x: torch.Tensor) -> torch.Tensor:
    """int32[r, c] -> int32[c, r]."""
    x = _need(x)
    if x.dim() != 2:
        raise ValueError("transpose of a 2-D tensor")
    if x.device.type == "cpu":
        return transpose_plain(x)
    out = torch.empty((x.shape[1], x.shape[0]), dtype=x.dtype,
                      device=x.device)
    _launched(_lib.lib().m2v_probe_transpose(
        x.data_ptr(), x.shape[0], x.shape[1], out.data_ptr(),
        _lib.stream(x)), "probe transpose")
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
    x = _need(x)
    last = (row0 + (out_rows - 1) * row_step) * src_cols + out_cols - 1
    if min(row0, row_step, out_rows - 1, out_cols - 1) < 0 or \
            last >= x.numel():
        raise ValueError("rows_copy reads outside its source")
    if x.device.type == "cpu":
        return rows_copy_plain(x, src_cols, row0, row_step, out_rows,
                               out_cols)
    out = torch.empty((out_rows, out_cols), dtype=x.dtype, device=x.device)
    _launched(_lib.lib().m2v_probe_rows_copy(
        x.data_ptr(), src_cols, row0, row_step, out_rows, out_cols,
        out.data_ptr(), _lib.stream(x)), "probe rows_copy")
    return out


# -------------------------------------------------------- contractions
def _rhs_matrix(rhs, mode, batch, n, k, key):
    """The rhs as [batch, n, k] int64."""
    if mode == RHS_ROWS:
        return rhs.reshape(batch, n, k).to(torch.int64)
    if mode == RHS_COLS:
        return rhs.reshape(batch, k, n).transpose(1, 2).to(torch.int64)
    keys = rhs.reshape(batch, 1, k)
    want = (torch.arange(n, device=rhs.device).view(1, n, 1)
            if mode == RHS_ONEHOT else key)
    return (keys == want).to(torch.int64).expand(batch, n, k)


def _dot(a, b):
    """[batch, m, k] x [batch, n, k] -> [batch, m, n] in int64 (integer
    matmul has no CUDA kernel in torch, so multiply and sum)."""
    return (a.unsqueeze(2) * b.unsqueeze(1)).sum(-1)


def _contract_args(a, rhs, m, n, k, mode, batch):
    a, rhs = _need(a), _need(rhs)
    if a.numel() != batch * m * k:
        raise ValueError(f"lhs of {a.numel()} elements, not {batch}x{m}x{k}")
    want = batch * n * k if mode in (RHS_ROWS, RHS_COLS) else batch * k
    if mode not in (RHS_ROWS, RHS_COLS, RHS_ONEHOT, RHS_KEY) or \
            rhs.numel() != want:
        raise ValueError(f"rhs of {rhs.numel()} elements for mode {mode}")
    if a.device != rhs.device:
        raise ValueError("lhs and rhs on different devices")
    return a, rhs


def fma_contract_plain(a, rhs, m, n, k, mode, key=0, batch=1):
    b = _rhs_matrix(rhs, mode, batch, n, k, key)
    return _dot(a.reshape(batch, m, k).to(torch.int64), b).to(torch.float32)


def fma_contract(a: torch.Tensor, rhs: torch.Tensor, m: int, n: int, k: int,
                 mode: int, key: int = 0, batch: int = 1) -> torch.Tensor:
    """float32[batch, m, n]: ``sum_k a[b][i][k] * rhs element`` in float FMA
    (exact while every partial sum is an integer below 2^24)."""
    a, rhs = _contract_args(a, rhs, m, n, k, mode, batch)
    if a.device.type == "cpu":
        return fma_contract_plain(a, rhs, m, n, k, mode, key, batch)
    out = torch.empty((batch, m, n), dtype=torch.float32, device=a.device)
    _launched(_lib.lib().m2v_probe_fma(
        a.data_ptr(), rhs.data_ptr(), batch, m, n, k, mode, key,
        out.data_ptr(), _lib.stream(a)), "probe fma")
    return out


def mma_contract_plain(a, nlimb, rhs, m, n, k, mode, key=0, batch=1):
    """The same sum over u8 limb planes of ``a``, recombined."""
    b = _rhs_matrix(rhs, mode, batch, n, k, key)
    a = a.reshape(batch, m, k).to(torch.int64)
    out = torch.zeros((batch, m, n), dtype=torch.int64, device=a.device)
    for limb in range(nlimb):
        plane = (a >> (8 * limb)) & 0xFF
        out += _dot(plane, b & 0xFF) << (8 * limb)
    return out


def mma_contract(a: torch.Tensor, nlimb: int, rhs: torch.Tensor, m: int,
                 n: int, k: int, mode: int, key: int = 0,
                 batch: int = 1) -> torch.Tensor:
    """int64[batch, m, n]: the ``fma_contract`` sum on the tensor cores,
    through multiagg_mxu's contraction: ``a`` (non-negative, below
    2^(8 * nlimb)) split into ``nlimb`` byte planes, the rhs as bytes
    (modes RHS_ROWS with entries 0..255, RHS_ONEHOT, RHS_KEY)."""
    a, rhs = _contract_args(a, rhs, m, n, k, mode, batch)
    if mode == RHS_COLS:
        raise ValueError("mma_contract takes the rhs row-wise")
    if not (1 <= nlimb <= 4 and m * nlimb <= 32 and n <= 32 and k < 1 << 23):
        raise ValueError(f"mma_contract of {m}x{nlimb} planes, {n} columns, "
                         f"depth {k}: outside one block's tile")
    if a.device.type == "cpu":
        return mma_contract_plain(a, nlimb, rhs, m, n, k, mode, key, batch)
    out = torch.zeros((batch, m, n), dtype=torch.int64, device=a.device)
    _launched(_lib.lib().m2v_probe_mma(
        a.data_ptr(), nlimb, rhs.data_ptr(), batch, m, n, k, mode, key,
        out.data_ptr(), _lib.stream(a)), "probe mma")
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
    table, idx = _need(table), _need(idx)
    if table.numel() > 8192 or table.numel() < 1 or idx.numel() < 1:
        raise ValueError("take of a table of 1..8192 entries")
    if table.device != idx.device:
        raise ValueError("table and idx on different devices")
    if idx.device.type == "cpu":
        return take_plain(table, idx, blocks)
    out = torch.empty_like(idx)
    _launched(_lib.lib().m2v_probe_take(
        table.data_ptr(), table.numel(), idx.data_ptr(), idx.numel(), blocks,
        out.data_ptr(), _lib.stream(idx)), "probe take")
    return out


# ------------------------------------------------------------------ noop
def noop(device: torch.device) -> None:
    """One launch of an empty kernel on ``device``'s current stream: the
    fixed cost that each probe launch pays (a CUDA device only)."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"noop launches on a CUDA device, not {device}")
    _launched(_lib.lib().m2v_probe_noop(
        torch.cuda.current_stream(device).cuda_stream), "probe noop")


PLAIN = SimpleNamespace(transpose=transpose_plain, rows_copy=rows_copy_plain,
                        fma_contract=fma_contract_plain,
                        mma_contract=mma_contract_plain, take=take_plain)
