"""ctypes bindings for the native column-store runtime (native/colstore.cpp).

Provides mmap'd zero-copy column loading, parallel column statistics, and
parallel FK-index building.  Every entry point has a numpy fallback so the
framework works without the compiled library; ``available()`` reports which
path is active.  The library is built on demand with ``make -C native``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
from typing import Dict, Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO, "native", "libcolstore.so")
_NTHREADS = min(os.cpu_count() or 1, 16)


class _ColStats(ctypes.Structure):
    _fields_ = [("min", ctypes.c_int64), ("max", ctypes.c_int64),
                ("or_reduction", ctypes.c_int64), ("count", ctypes.c_int64)]


_lib = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    src = os.path.join(_REPO, "native", "colstore.cpp")
    stale = (not os.path.exists(_LIB_PATH)
             or (os.path.exists(src)
                 and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)))
    if stale:
        try:
            subprocess.run(["make", "-C", os.path.join(_REPO, "native")],
                           check=True, capture_output=True, timeout=120)
        except Exception:
            if not os.path.exists(_LIB_PATH):
                return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.cs_write.restype = ctypes.c_int
    lib.cs_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                             ctypes.c_int64]
    lib.cs_mmap.restype = ctypes.c_void_p
    lib.cs_mmap.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.cs_stats.restype = ctypes.c_int
    lib.cs_stats.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                             ctypes.c_int, ctypes.POINTER(_ColStats)]
    lib.cs_fk_index.restype = ctypes.c_int64
    lib.cs_fk_index.argtypes = [ctypes.POINTER(ctypes.c_int64),
                                ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int64),
                                ctypes.POINTER(ctypes.c_int64),
                                ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int64),
                                ctypes.c_int]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def column_stats(arr: np.ndarray) -> Tuple[int, int, int, int]:
    """(min, max, trailing_zeros, count) via the parallel native scanner
    (numpy fallback)."""
    lib = _load()
    n = len(arr)
    if n == 0:
        return 0, 0, 0, 0
    if lib is not None and arr.dtype in (np.int32, np.int64):
        arr = np.ascontiguousarray(arr)
        st = _ColStats()
        rc = lib.cs_stats(arr.ctypes.data_as(ctypes.c_void_p), n,
                          arr.dtype.itemsize, _NTHREADS, ctypes.byref(st))
        if rc == 0:
            orred = st.or_reduction
            tz = ((orred & -orred).bit_length() - 1) if orred else 0
            return int(st.min), int(st.max), tz, n
    mn = int(arr.min())
    mx = int(arr.max())
    g = int(np.bitwise_or.reduce(np.abs(arr).astype(np.int64)))
    tz = ((g & -g).bit_length() - 1) if g else 0
    return mn, mx, tz, n


def fk_index(fact_keys: np.ndarray, dim_keys: np.ndarray) -> np.ndarray:
    """Row position in the dim table for each fact key (parallel binary
    search in native code; numpy fallback).  Raises on dangling keys."""
    order = np.argsort(dim_keys, kind="stable")
    srt = np.ascontiguousarray(dim_keys[order].astype(np.int64))
    pos = np.ascontiguousarray(order.astype(np.int64))
    fk = np.ascontiguousarray(fact_keys.astype(np.int64))
    lib = _load()
    if lib is not None:
        out = np.empty(len(fk), dtype=np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        dangling = lib.cs_fk_index(
            fk.ctypes.data_as(i64p), len(fk), srt.ctypes.data_as(i64p),
            pos.ctypes.data_as(i64p), len(srt), out.ctypes.data_as(i64p),
            _NTHREADS)
        if dangling:
            raise ValueError(f"{dangling} dangling foreign keys")
        return out
    idx = np.searchsorted(srt, fk)
    idx = np.clip(idx, 0, len(srt) - 1)
    if not np.array_equal(srt[idx], fk):
        raise ValueError("dangling foreign keys")
    return pos[idx]


# ------------------------------------------------------------ store on disk
def save_store(store, directory: str) -> None:
    """Persist a ColumnStore as raw binary columns + a JSON manifest."""
    os.makedirs(directory, exist_ok=True)
    lib = _load()
    manifest = {"columns": {}, "decoders": {}}
    for (tab, col), arr in store.columns.items():
        fname = f"{tab}.{col}.bin"
        path = os.path.join(directory, fname)
        arr = np.ascontiguousarray(arr)
        # atomic per-file write (tmp + rename): a concurrent or killed
        # saver must never leave a truncated column visible under the
        # final name (r5: a 0-byte region.r_regionkey.bin from exactly
        # that race broke every region query at SF0.25)
        tmp = path + f".tmp.{os.getpid()}"
        if lib is not None:
            rc = lib.cs_write(tmp.encode(), arr.ctypes.data_as(
                ctypes.c_void_p), arr.nbytes)
            if rc != 0:
                raise IOError(f"native write failed for {tmp}")
        else:
            arr.tofile(tmp)
        os.replace(tmp, path)
        manifest["columns"][f"{tab}.{col}"] = {
            "file": fname, "dtype": str(arr.dtype), "n": len(arr)}
    for (tab, col), dec in store.decoders.items():
        manifest["decoders"][f"{tab}.{col}"] = {str(k): v
                                                for k, v in dec.items()}
    mtmp = os.path.join(directory, f"manifest.json.tmp.{os.getpid()}")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(directory, "manifest.json"))


def load_store(directory: str, tables=None):
    """Load a persisted store; columns are mmap'd zero-copy when the native
    library is present."""
    from .columnstore import ColumnStore
    from .datagen import tpch_schema

    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    store = ColumnStore(tables=tables if tables is not None else tpch_schema())
    lib = _load()
    for key, info in manifest["columns"].items():
        tab, col = key.split(".", 1)
        path = os.path.join(directory, info["file"])
        dtype = np.dtype(info["dtype"])
        if lib is not None:
            size = ctypes.c_int64()
            ptr = lib.cs_mmap(path.encode(), ctypes.byref(size))
            if ptr:
                buf = (ctypes.c_char * size.value).from_address(ptr)
                arr = np.frombuffer(buf, dtype=dtype, count=info["n"])
            else:
                arr = np.fromfile(path, dtype=dtype)
        else:
            arr = np.fromfile(path, dtype=dtype)
        if len(arr) != info["n"]:
            raise IOError(
                f"store cache corrupt: {path} holds {len(arr)} values, "
                f"manifest says {info['n']} — delete {directory} and "
                "regenerate")
        store.columns[(tab, col)] = arr
    for key, dec in manifest["decoders"].items():
        tab, col = key.split(".", 1)
        store.decoders[(tab, col)] = {int(k): v for k, v in dec.items()}
    return store
