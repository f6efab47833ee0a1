"""Fused bucketed collectives.

Port of ``mpi4torch_tpu/fuse`` on the rank-thread runtime.  A per-leaf
collective pattern (one Allreduce per tree leaf) pays one rendezvous per
leaf; the fused forms flatten the tree into a few dtype-homogeneous
flat **buckets** (~``bucket_bytes`` each, layout cached per tree
structure) and run one collective per bucket.

Entry points::

    comm.Allreduce_tree(grads, MPI_SUM, mean=True)   # facade sugar

    from mpi4torch_tpu_torch import fuse
    fuse.fused_allreduce_tree(comm, tree, MPI_SUM, compression="q8")
    fuse.fused_reduce_scatter_tree(comm, grads, mean=True)   # ZeRO grads
    fuse.fused_allgather_tree(comm, shards, template)        # ZeRO params

    with config.fusion_scope(1 << 20):   # 1 MiB buckets for a block
        ...
    with config.fusion_scope(0):         # opt out: per-leaf ops
        ...

Everything stays differentiable: the backward of a fused collective is
itself fused bucketed communication, and ``compression=`` quantizes
fused buckets with the facade's per-tensor rules.
"""

from __future__ import annotations

from .bucketing import (BucketLayout, LeafSlot, ShardLayout, ShardSlot,
                        bucket_layout, flatten_buckets,
                        flatten_shard_buckets, shard_layout,
                        unflatten_buckets, unflatten_shard_rows)
from .collectives import (FUSE_TAG_BASE, fused_allgather_tree,
                          fused_allreduce_tree, fused_reduce_scatter_tree)

__all__ = [
    "BucketLayout",
    "LeafSlot",
    "ShardLayout",
    "ShardSlot",
    "bucket_layout",
    "flatten_buckets",
    "flatten_shard_buckets",
    "shard_layout",
    "unflatten_buckets",
    "unflatten_shard_rows",
    "fused_allreduce_tree",
    "fused_reduce_scatter_tree",
    "fused_allgather_tree",
    "FUSE_TAG_BASE",
]
