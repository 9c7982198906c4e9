"""The components of a multi-digit LSD radix pass against a stable sort, at
engine shapes.

    python -m mplan2vdl_tpu_torch.tools.probe_radix [--sizes 1572864,6291456,25165824] [--iters 30] [--cpu]

A radix pass is (a) a digit histogram per block, (b) each element's rank
within its (block, bucket), the unavoidable data movement, and (c) applying
the resulting permutation.  For random 24-bit int32 keys at each size this
times ``torch.sort(stable=True)`` returning values and indices (the
baseline), per-block 16-bucket counts in plain torch, the rank kernel
(``engine/kernels/radix_rank.py``) with 4-bit and 8-bit digits, and the
gather kernel (``gather.cu``) through a random permutation; then it prints
the per-pass cost, ``ceil(24 / bits)`` passes of rank + histogram + apply,
against the sort.  The cases, sizes, keys (``np.random.default_rng(0)``)
and printed lines are those of ``mplan2vdl_tpu/tools/probe_radix.py``.
Times are CUDA-event means over ``--iters`` calls after two warm-up calls
(host clock on the CPU).  Without a GPU the command refuses unless
``--cpu`` asks for the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import device as D
from ..engine.kernels.radix_rank import BLOCK, radix_rank
from ..engine.kernels.sorted_gather import sorted_gather

DEFAULT_SIZES = (1572864, 6291456, 25165824)
SORT = "torch_sort2_i32"
HIST = "hist16_torch_per_block"
RANKS = ((4, "rank16_cuda(4bit)"), (8, "rank256_cuda(8bit)"))
APPLY = "apply_perm_gather_cuda"


def timeit(fn, dev: torch.device, iters: int) -> float:
    """Seconds per call: CUDA events on the GPU, the host clock on the
    CPU, after two warm-up calls."""
    for _ in range(2):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def hist16(keys: torch.Tensor) -> torch.Tensor:
    """Per-block counts of the 16 low-digit buckets, [n / BLOCK, 16]."""
    block = torch.arange(keys.shape[0], device=keys.device) // BLOCK
    flat = block * 16 + (keys & 15).to(torch.int64)
    return torch.bincount(flat, minlength=keys.shape[0] // BLOCK * 16
                          ).view(-1, 16)


def run(sizes: Sequence[int], iters: int = 30,
        dev=None) -> List[Tuple[int, str, float]]:
    """Times every case at every size on ``dev``; prints the per-element
    lines and the decision table and returns (n, case, ns per element)."""
    dev = D.resolve(dev)
    rng = np.random.default_rng(0)
    rows = []
    for n in sizes:
        if n % BLOCK:
            raise ValueError(f"size {n} is not a multiple of {BLOCK}")
        keys = torch.from_numpy(
            rng.integers(0, 1 << 24, n, dtype=np.int32)).to(dev)
        perm = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
        cases = {SORT: lambda: torch.sort(keys, stable=True),
                 HIST: lambda: hist16(keys)}
        for bits, name in RANKS:
            cases[name] = lambda bits=bits: radix_rank(keys, bits)
        cases[APPLY] = lambda: sorted_gather(keys, perm, n)
        for name, fn in cases.items():
            t = timeit(fn, dev, iters)
            nspel = t / n * 1e9
            rows.append((n, name, nspel))
            print(f"n={n:>9} {name:32s} {t * 1e6:10.1f} us  "
                  f"{nspel:7.3f} ns/el", flush=True)
        del keys, perm

    print("\nper-pass = rank + hist + apply; passes = ceil(24/digit_bits)")
    for n in sizes:
        r = {name: v for (m, name, v) in rows if m == n}
        base = r[SORT]
        for bits, rk in RANKS:
            passes = -(-24 // bits)
            per = r[rk] + r[HIST] + r[APPLY]
            print(f"n={n:>9} {bits}-bit: {passes} passes x {per:.2f} = "
                  f"{passes * per:.2f} ns/el vs torch.sort {base:.2f} ns/el "
                  f"-> {'RADIX WINS' if passes * per < base else 'refuted'}",
                  flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default=",".join(map(str, DEFAULT_SIZES)))
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU (the default is "
                         "the kernels on the GPU)")
    args = ap.parse_args(argv)
    dev = D.resolve("cpu" if args.cpu else None)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={name}", flush=True)
    run([int(s) for s in args.sizes.split(",")], args.iters, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
