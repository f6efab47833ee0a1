"""Data parallelism: the reference's canonical strategy.

Port of ``mpi4torch_tpu/parallel/dp.py``.  The reference demonstrates DP
as a user pattern (examples/simple_linear_regression.py): average the
replicated parameters with an Allreduce whose adjoint turns per-rank
loss gradients into their global mean, then Allreduce the local loss.
These helpers package that recipe for parameter trees and loss
functions.
"""

from __future__ import annotations

from ..constants import MPI_SUM, divide
from ..utils.tree import value_and_grad


def all_average_tree(comm, tree, bucket_bytes=None, overlap=None):
    """Allreduce-average every leaf of a parameter tree.

    The DP lock-step primitive: forward is the identity on replicated
    values; the adjoint Allreduce makes downstream gradients the mean over
    ranks (reference: doc/examples.rst:46-65).  Every rank ends with the
    same bits.

    Rides the fused bucketed path (:mod:`mpi4torch_tpu_torch.fuse`) by
    default: one Allreduce per ~``bucket_bytes`` dtype-homogeneous
    bucket instead of one per leaf, and the ``/ comm.size`` mean applied
    once per bucket.  On the exact wire this is bit-identical to the
    per-leaf form; opt out with ``bucket_bytes=0`` or
    ``config.fusion_scope(0)``.  ``overlap`` (None → the
    :func:`~mpi4torch_tpu_torch.config.overlap_scope` / process default)
    truthy runs the nonblocking Isend/Irecv pipeline, with the same
    bits."""
    return comm.Allreduce_tree(tree, MPI_SUM, bucket_bytes=bucket_bytes,
                               mean=True, overlap=overlap)


def dp_loss(comm, local_loss_fn, params, batch):
    """Global DP loss = mean over ranks of ``local_loss_fn`` on the rank's
    batch shard, with the parameter-averaging Allreduce that keeps per-rank
    optimizer replicas arithmetically identical."""
    params = all_average_tree(comm, params)
    return divide(comm.Allreduce(local_loss_fn(params, batch), MPI_SUM),
                  comm.size)


def dp_value_and_grad(comm, local_loss_fn):
    """The data-parallel counterpart of ``jax.value_and_grad``.

    Returns ``f(params, batch) -> (global_loss, mean_grads)``, the
    gradient from :func:`torch.autograd.grad`; every rank receives
    identical gradients, so any optimizer stays in lock-step."""
    def vg(params, batch):
        return value_and_grad(
            lambda p: dp_loss(comm, local_loss_fn, p, batch), params)
    return vg
