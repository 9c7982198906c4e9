"""Builds and loads the CUDA kernel library.

The kernels are CUDA C++ with a plain C interface (``csrc/*.cu``), compiled
by ``nvcc`` for Hopper (``sm_90a``) into
``<repo>/build/mplan2vdl_tpu_torch/libkernels.so`` and bound with ctypes —
no PyTorch headers, so a build takes seconds.  The library is built at
first use, and again when a source is newer than it; each source compiles
in its own ``nvcc`` process, all started together.  Nothing here runs at
import time: the CPU tests import every module on a machine with no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from ... import tracing

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
SOURCES = ("compact.cu", "exprfold.cu", "gather.cu", "multiagg.cu",
           "multiagg_mxu.cu", "probes.cu", "radix_rank.cu", "scatter.cu",
           "small_gather.cu")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
BUILD_DIR = os.path.join(_REPO, "build", "mplan2vdl_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libkernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# the C entry points of _SIGNATURES, resolved once when the library loads
_entries: Dict[str, Callable[..., int]] = {}
# the cheapest public read of a device's current stream (a torch.Stream,
# made in C++; torch.cuda.current_stream builds a Python object, ~2.5x
# the host time)
_current_stream = torch.accelerator.current_stream
# filled by build(): seconds taken and each source's ptxas report
build_info: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_ulonglong
_SIGNATURES = {
    "m2v_compact": ([_P, _L, _P, _U, _L, _P, _L, _I, _P], _I),
    "m2v_compact_tile": ([], _I),
    "m2v_expr_fold": ([_P, _P, _I, _L, _P, _P, _I, _I, _I, _P, _P], _I),
    "m2v_gather": ([_P, _P, _P, _I, _P, _I, _L, _L, _L, _P, _P], _I),
    "m2v_group_ids": ([_P, _P, _I, _L, _P, _P, _I, _L, _L, _P, _P], _I),
    "m2v_gather_blocks_per_sm": ([_I, _I, _I], _I),
    "m2v_gather_max_sources": ([], _I),
    "m2v_multiagg": ([_P, _I, _P, _L, _P, _I, _I, _I, _I, _P, _P], _I),
    "m2v_multiagg_mxu": ([_P, _I, _P, _L, _P, _I, _I, _P, _I, _I, _P, _P],
                         _I),
    "m2v_multiagg_mxu_fast": ([_P, _I, _P, _L, _P, _I, _P, _I, _I, _I, _I,
                               _I, _P, _P], _I),
    "m2v_probe_fma": ([_P, _P, _I, _I, _I, _I, _I, _I, _P, _P], _I),
    "m2v_probe_noop": ([_P], _I),
    "m2v_probe_mma": ([_P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P], _I),
    "m2v_probe_rows_copy": ([_P, _I, _I, _I, _I, _I, _P, _P], _I),
    "m2v_probe_take": ([_P, _I, _P, _L, _I, _P, _P], _I),
    "m2v_probe_transpose": ([_P, _I, _I, _P, _P], _I),
    "m2v_radix_rank": ([_P, _P, _L, _I, _P], _I),
    "m2v_scatter": ([_P, _I, _P, _I, _P, _L, _L, _P], _I),
    "m2v_scatter_tile": ([], _I),
    "m2v_small_gather": ([_P, _P, _P, _I, _P, _I, _L, _L, _P], _I),
    "m2v_small_gather_max_sources": ([], _I),
    "m2v_small_gather_smem_budget": ([], _I),
    "m2v_error_string": ([_I], ctypes.c_char_p),
}


def nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, else PATH, else torch's guess."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(os.path.join(CSRC, f)) > built
               for f in os.listdir(CSRC))


def build() -> float:
    """Compiles every source (one ``nvcc`` each, in parallel) and links the
    library; returns the seconds taken.  Raises with the compiler's output
    when a source does not build."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    exe = nvcc()
    procs: List[tuple] = []
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR, src[:-3] + ".o")
        cmd = [exe, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
               os.path.join(CSRC, src), "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors, ptxas = [], {}
    for src, obj, p in procs:
        out, _ = p.communicate()
        ptxas[src] = out
        if p.returncode != 0:
            errors.append(f"--- {src} (rc {p.returncode})\n{out}")
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    tmp = f"{LIB_PATH}.tmp.{os.getpid()}"
    link = subprocess.run([exe, *NVCC_FLAGS, "-shared", "-o", tmp,
                           *(obj for _, obj, _ in procs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"CUDA kernel link failed:\n{link.stdout}")
    os.replace(tmp, LIB_PATH)
    secs = time.perf_counter() - t0
    build_info.update(seconds=secs, ptxas=ptxas)
    return secs


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale.  Once
    it is loaded, no lock is taken."""
    handle = _lib
    return handle if handle is not None else _load()


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            handle = ctypes.CDLL(LIB_PATH)
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = res
                _entries[name] = fn
            _lib = handle
        return _lib


def call(name: str, *args) -> int:
    """Calls the C entry point ``name`` (a kernel launch) and returns its
    error code.  While torch.profiler records (``tracing.recording``), the
    call is a range named ``name``, so a trace names each launch beside its
    kernel."""
    fn = _entries.get(name) or getattr(lib(), name)
    if not tracing.recording():
        return fn(*args)
    with torch.profiler.record_function(name):
        return fn(*args)


def check(rc: int, what: str) -> None:
    """Raises when a C entry returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib().m2v_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream of ``t``'s device."""
    return _current_stream(t.get_device()).native_handle


def device_stream(index: int) -> int:
    """The handle of the current CUDA stream of device ``index``."""
    return _current_stream(index).native_handle


def ptrs(values) -> ctypes.Array:
    """A host array of ``void*`` (device pointers of tensors, or ints)."""
    arr = (ctypes.c_void_p * max(len(values), 1))()
    for i, v in enumerate(values):
        arr[i] = v.data_ptr() if isinstance(v, torch.Tensor) else v
    return arr


def ints(values) -> ctypes.Array:
    arr = (ctypes.c_int * max(len(values), 1))()
    for i, v in enumerate(values):
        arr[i] = int(v)
    return arr
