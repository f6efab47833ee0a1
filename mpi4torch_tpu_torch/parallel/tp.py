"""Tensor-parallel sharding helpers.

Port of ``shard_axis`` and ``shard_heads`` from
``mpi4torch_tpu/parallel/tp.py``: this rank's equal, rank-major shard of
a replicated tensor, and the whole-head variant the serving layer cuts
its q/k/v and output-projection shards with.
"""

from __future__ import annotations


def shard_axis(comm, x, axis: int):
    """This rank's equal shard of ``x`` along ``axis`` (rank-major order).
    ``x`` must be replicated (every rank passes the same full tensor).
    The shard is a view of ``x``."""
    size = comm.size
    n = x.shape[axis]
    if n % size != 0:
        raise ValueError(
            f"axis {axis} length {n} not divisible by world size {size}")
    local = n // size
    return x.narrow(axis, comm.rank * local, local)


def shard_heads(comm, w, n_heads: int, axis: int = 1):
    """This rank's whole-head shard of a head-structured projection:
    ``w``'s ``axis`` holds ``n_heads`` contiguous equal head blocks, and
    the shard keeps ``n_heads / size`` whole heads, so per-head attention
    never crosses ranks."""
    size = comm.size
    n = w.shape[axis]
    if n_heads <= 0 or n % n_heads != 0:
        raise ValueError(
            f"axis {axis} length {n} is not a whole number of "
            f"{n_heads} head blocks")
    if n_heads % size != 0:
        raise ValueError(
            f"n_heads ({n_heads}) not divisible by world size ({size}) "
            "— tensor-parallel attention shards whole heads only")
    return shard_axis(comm, w, axis)
