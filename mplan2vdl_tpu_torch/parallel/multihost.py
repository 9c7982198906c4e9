"""Joining a multi-process run, and the mesh over its process group.

The port is SPMD over a ``torch.distributed`` process group: one process
per rank, each holding its rank's rows on its own device.  NCCL carries the
collectives between GPUs and gloo between CPU processes; the backend follows
the device (``device.resolve``: ``cuda`` unless the caller asks for the
CPU).  ``torchrun`` sets the variables ``initialize`` reads:

    torchrun --nproc-per-node 4 my_query.py      # calls multihost.initialize()

NCCL puts no two ranks of one communicator on one GPU, so a machine with one
card runs world size 1 over NCCL; several ranks on one machine need as many
cards, or ``device="cpu"`` (gloo).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as tdist

from .. import device as _device
from . import dist

# a rank that waits longer than this on a collective fails instead of
# hanging (a rank that branched alone never reaches its peers' collective)
TIMEOUT_S = 60


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None) -> None:
    """Join a multi-process run (no-op when single-process and no
    coordinator is given, as in the JAX package).

    ``coordinator`` is ``host:port`` or an ``init_method`` URL
    (``tcp://host:port``, ``file:///path``); it defaults to torchrun's
    ``MASTER_ADDR``:``MASTER_PORT``.  ``num_processes`` and ``process_id``
    default to ``WORLD_SIZE`` and ``RANK``; on CUDA the rank's card is
    ``LOCAL_RANK``.  A process group that fails to start raises."""
    if coordinator is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 and coordinator is None:
        return
    if coordinator is None:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "(host:port, or MASTER_ADDR and MASTER_PORT)")
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    dev = _device.resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              if dev.index is None else dev.index)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    tdist.init_process_group(
        backend=dist.backend_for(dev), init_method=url,
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))


def data_mesh(device=None) -> "dist.Mesh":
    """The mesh over every rank of the default process group: the
    row-sharding axis of ``dist``, ``shuffle_agg`` and ``shuffle_join``."""
    return dist.make_mesh(device=device)
