"""Hot-op kernels: CUDA C++ sources in ``csrc/`` (built by ``_lib``), each
with a plain PyTorch version beside its wrapper for CPU tensors."""
