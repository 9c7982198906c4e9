"""Execution engine: a query's vector-IR DAG evaluated eagerly with torch
ops over columns resident on one device; compaction, monotone gathers and
the fused group-aggregate run as hand-written CUDA kernels on the GPU."""
