"""Distribution layer: SPMD over a ``torch.distributed`` process group,
one process per rank (NCCL between GPUs, gloo between CPU processes).

``multihost`` joins a run (torchrun's variables) and builds the mesh;
``dist`` holds the mesh, the collectives, ``ShardedTable``, ``DistQuery``
and ``shuffle_by_key``; ``shuffle_agg`` the sparse group-by and
``shuffle_join`` the shuffle equijoin; ``auto`` the plan distributor
(``distribute``), which runs a compiled plan's aggregate stage over the
ranks on these primitives (``run --devices N``)."""
