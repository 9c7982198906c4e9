"""``python -m mplan2vdl_tpu_torch``."""

from .cli import main

main()
