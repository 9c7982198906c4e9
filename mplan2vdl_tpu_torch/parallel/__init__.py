"""Distribution layer: SPMD over a ``torch.distributed`` process group,
one process per rank (NCCL between GPUs, gloo between CPU processes).

``multihost`` joins a run (torchrun's variables) and builds the mesh;
``dist`` holds the mesh, the collectives, ``ShardedTable``, ``DistQuery``
and ``shuffle_by_key``; ``shuffle_agg`` the sparse group-by and
``shuffle_join`` the shuffle equijoin.  ``auto`` holds only the fold walker
that ``engine/fuse.py`` imports; the plan distributor is not ported yet."""
