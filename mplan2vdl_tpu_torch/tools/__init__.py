"""Measurement and probe entry points of the port (``python -m
mplan2vdl_tpu_torch.tools.<name>``): ``probe_radix`` (the radix-pass
components against a stable sort) and ``probe_kernels`` (the kernel-pattern
probes)."""
