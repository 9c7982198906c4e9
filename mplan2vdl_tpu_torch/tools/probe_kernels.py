"""The kernel-pattern probes: twelve small patterns, each run through its
kernel on the card and checked against numpy.

    python -m mplan2vdl_tpu_torch.tools.probe_kernels [--cpu]

The same probes, inputs (drawn from ``np.random.default_rng(0)`` in the same
order) and numpy answers as ``mplan2vdl_tpu/tools/probe_mosaic.py``, which
asked what the TPU compiler lowers.  Here each pattern runs as the GPU
writes it (``engine/kernels/probes.py``): a shared-memory tile transpose,
index-remapping copies for the reshapes and the strided slice, FMA
contractions, and a shared-memory table for the two wide takes.  The
group-contraction probes (5, 7 and 8) also run a second variant through the
tensor-core contraction of ``multiagg_mxu.cu``.  Every probe prints OK or
WRONG RESULT; the command exits nonzero if any probe was wrong.  Without a
GPU it refuses unless ``--cpu`` asks for the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass
from typing import Callable, List, Sequence

import numpy as np
import torch

from .. import device as D
from ..engine.kernels import probes as P

S, C = 16, 128


@dataclass
class Probe:
    name: str
    run: Callable[[object], torch.Tensor]  # the kernels' namespace -> result
    want: np.ndarray
    inputs: Sequence[torch.Tensor]

    def nbytes(self, got: torch.Tensor) -> int:
        """Each input read once and the result written once."""
        return (sum(t.numel() * t.element_size() for t in self.inputs)
                + got.numel() * got.element_size())


def make_probes(dev) -> List[Probe]:
    """The twelve probes (and the tensor-core variants of 5, 7 and 8) on
    ``dev``, in the original's order."""
    rng = np.random.default_rng(0)
    f32 = np.float32

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    x_np = rng.integers(0, 1000, (S, C)).astype(np.int32)
    x = t(x_np)
    out = [
        # 1. 2D tile transpose
        Probe("transpose_16x128", lambda ops: ops.transpose(x), x_np.T, [x]),
        # 2. reshape (S, 128) -> (1, S*128)
        Probe("reshape_to_1xSC",
              lambda ops: ops.rows_copy(x, S * C, 0, 1, 1, S * C),
              x_np.reshape(1, S * C), [x]),
        # 3. reshape (S, 128) -> (S*128, 1)
        Probe("reshape_to_SCx1",
              lambda ops: ops.rows_copy(x, 1, 0, 1, S * C, 1),
              x_np.reshape(S * C, 1), [x]),
    ]

    # 4. contraction over two dimensions ((1, 2), (1, 2))
    R, G = 8, 4
    v_np = rng.integers(0, 100, (R, S, C)).astype(np.int32)
    m_np = rng.integers(0, 2, (G, S, C)).astype(np.int32)
    v, m = t(v_np), t(m_np)
    want4 = np.einsum("rsc,gsc->rg", v_np.astype(f32), m_np.astype(f32))
    out.append(Probe(
        "dot_general_2d_contract",
        lambda ops: ops.fma_contract(v, m, R, G, S * C, P.RHS_ROWS),
        want4, [v, m]))

    # 5. one-hot of the group id contracted along each row
    gid_np = rng.integers(0, G, (S, C)).astype(np.int32)
    vals_np = rng.integers(0, 1000, (S, C)).astype(np.int32)
    gid, vals = t(gid_np), t(vals_np)
    want5 = np.stack([(vals_np * (gid_np == g)).sum(axis=1)
                      for g in range(G)], axis=1).astype(f32)
    out += [
        Probe("masked_lane_dot",
              lambda ops: ops.fma_contract(vals, gid, 1, G, C, P.RHS_ONEHOT,
                                           batch=S).reshape(S, G),
              want5, [vals, gid]),
        Probe("masked_lane_dot [mma u8]",
              lambda ops: ops.mma_contract(vals, 2, gid, 1, G, C,
                                           P.RHS_ONEHOT,
                                           batch=S).reshape(S, G),
              want5, [vals, gid]),
    ]

    # 6. strided row slice x[1::S] of a tall tile
    R2 = 4
    tall_np = rng.integers(0, 1000, (R2 * S, C)).astype(np.int32)
    tall = t(tall_np)
    out.append(Probe("strided_sublane_slice",
                     lambda ops: ops.rows_copy(tall, C, 1, S, R2, C),
                     tall_np[1::S, :], [tall]))

    # 7. one-hot group contraction over the whole tile
    want7 = np.stack([(vals_np * (gid_np == g)).sum() * np.ones(S)
                      for g in range(G)], axis=1).astype(f32)
    out += [
        Probe("stack_plus_dot_general",
              lambda ops: ops.fma_contract(vals, gid, 1, G, S * C,
                                           P.RHS_ONEHOT).expand(S, G),
              want7, [vals, gid]),
        Probe("stack_plus_dot_general [mma u8]",
              lambda ops: ops.mma_contract(vals, 2, gid, 1, G, S * C,
                                           P.RHS_ONEHOT).expand(S, G),
              want7, [vals, gid]),
    ]

    # 8. A x B^T contracting the long dimension
    R3 = 8
    flatv_np = rng.integers(0, 1 << 12, (R3, S * C)).astype(np.int32)
    flatm_np = rng.integers(0, 2, (G, S * C)).astype(np.int32)
    flatv, flatm = t(flatv_np), t(flatm_np)
    want8 = flatv_np.astype(f32) @ flatm_np.astype(f32).T
    out += [
        Probe("dot_abT_contract_lanes",
              lambda ops: ops.fma_contract(flatv, flatm, R3, G, S * C,
                                           P.RHS_ROWS),
              want8, [flatv, flatm]),
        Probe("dot_abT_contract_lanes [mma u8]",
              lambda ops: ops.mma_contract(flatv, 2, flatm, R3, G, S * C,
                                           P.RHS_ROWS),
              want8, [flatv, flatm]),
    ]

    # 9. wide transpose [G, S*C] -> [S*C, G], then a plain matmul: one
    #    launch that stages the transpose in shared memory
    out.append(Probe(
        "matmul_with_rhs_T",
        lambda ops: ops.fma_contract(flatv, flatm, R3, G, S * C,
                                     P.RHS_ROWS_T),
        want8, [flatv, flatm]))

    # 10. (R, S, 128) rows flattened to (R, S*128), contracted against the
    #     mask gid == 1 in every column
    vals3_np = rng.integers(0, 1 << 12, (R3, S, C)).astype(np.int32)
    vals3 = t(vals3_np)
    want10 = np.einsum("rsc,sc->r", vals3_np.astype(np.float64),
                       (gid_np == 1).astype(np.float64))
    want10 = np.repeat(want10[:, None], G, axis=1).astype(f32)
    out.append(Probe(
        "reshape_stack_dot",
        lambda ops: ops.fma_contract(vals3, gid, R3, G, S * C, P.RHS_KEY,
                                     key=1),
        want10, [vals3, gid]))

    # 11./12. take from a 1024-wide source: each of 8 rows from its own
    #         broadcast copy of the table, then from one flat table
    src_np = rng.integers(0, 1 << 20, (8, 128)).astype(np.int32)
    idx_np = rng.integers(0, 1024, (8, 128)).astype(np.int32)
    src, idx = t(src_np), t(idx_np)
    want11 = src_np.reshape(-1)[idx_np]
    out += [
        Probe("take_along_axis_wide1024",
              lambda ops: ops.take(src, idx, blocks=8), want11, [src, idx]),
        Probe("take_flat_vector",
              lambda ops: ops.take(src, idx, blocks=1), want11, [src, idx]),
    ]
    return out


def check(probe: Probe, ops=P) -> bool:
    """Runs one probe through ``ops`` (the kernels, or ``probes.PLAIN``)
    and compares with its numpy answer as the original does."""
    got = probe.run(ops).cpu().numpy()
    return (got.shape == probe.want.shape
            and bool(np.allclose(got.astype(probe.want.dtype), probe.want)))


def run(dev) -> List[tuple]:
    """Checks every probe on ``dev``; prints and returns (name, ok)."""
    rows = []
    for p in make_probes(dev):
        ok = check(p)
        print(f"{p.name}: {'OK' if ok else 'WRONG RESULT'}", flush=True)
        rows.append((p.name, ok))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU (the default is "
                         "the kernels on the GPU)")
    args = ap.parse_args(argv)
    dev = D.resolve("cpu" if args.cpu else None)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={name}", flush=True)
    rows = run(dev)
    bad = [name for name, ok in rows if not ok]
    print(f"{len(rows) - len(bad)} of {len(rows)} probes OK", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
