"""The benchmark of mplan2vdl_tpu_torch on one H100 (see README.md)."""
