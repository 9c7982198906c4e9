"""mplan2vdl_tpu_torch — the query engine of ``mplan2vdl_tpu`` in PyTorch,
with hand-written CUDA kernels for an NVIDIA Hopper GPU.

The frontend (parser, catalog, typed plan, vector IR, passes) is a copy of
the JAX package's JAX-free modules; the engine evaluates the vector-IR DAG
eagerly with torch ops, and the hot ops that the JAX package wrote as
Pallas kernels (compaction, monotone gather, fused group-aggregate) are
CUDA C++ kernels under ``engine/kernels/csrc``.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``;
without a CUDA device they raise instead of running on the CPU.
"""

__version__ = "0.1.0"
