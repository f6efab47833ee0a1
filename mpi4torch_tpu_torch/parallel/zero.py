"""ZeRO-1 and ZeRO-3: optimizer states (and, for stage 3, the parameters
themselves) sharded over the data-parallel ranks.

Port of ``mpi4torch_tpu/parallel/zero.py``.  Plain DP replicates
parameters, gradients and optimizer state on every rank; ZeRO stage 1
keeps each rank's optimizer state for only ``1/size`` of the
parameters:

1. per-rank local gradients are ``Reduce_scatter``'d — each rank
   receives the global gradient of its own shard;
2. the optimizer update runs on the shard (element-wise optimizers —
   :func:`~mpi4torch_tpu_torch.utils.optim.sgd`,
   :func:`~mpi4torch_tpu_torch.utils.optim.adam` — give the replicated
   update's bits, so trajectories match plain DP exactly);
3. the updated shards are ``Allgather``'d back into full replicated
   parameters.

Stage 3 also keeps the parameters as ``1/size`` flat shards between
steps; the forward gathers them on use, and the backward of that
Allgather reduce-scatters the gradients.  The optimizer is an
``(init, update)`` pair with optax's calling convention
(``utils/optim.py``).

Leaves are flattened and zero-padded to a multiple of ``size``; the pad
slots carry zero gradients, so their shard state stays zero and the
unpad after the allgather is exact.  Every collective is the
differentiable facade's, fused into dtype-homogeneous buckets
(:mod:`mpi4torch_tpu_torch.fuse`).
"""

from __future__ import annotations

import torch

from ..constants import MPI_SUM
from ..utils.tree import tree_leaves, tree_map, value_and_grad


def _shard_len(n: int, size: int) -> int:
    return -(-n // size)  # ceil: padded flat length per rank


def _my_shard(comm, p):
    """This rank's segment of ``p`` flattened and zero-padded to a
    multiple of the world size, as a tensor of its own."""
    flat = p.reshape(-1)
    per = _shard_len(flat.shape[0], comm.size)
    start = comm.rank * per
    seg = flat[start:start + per]
    if seg.shape[0] < per:
        seg = torch.cat([seg, seg.new_zeros(per - seg.shape[0])])
    return seg.clone()


def shard_global_norm(comm, shards):
    """Global L2 norm of a gradient whose leaves are distributed as this
    rank's ZeRO shards.  Shards of one tensor are disjoint segments
    across ranks, so the global norm is ``sqrt(Allreduce(sum of local
    squares))``, not the norm of the local shards.  Use it for
    global-norm clipping through ``zero_step``'s ``grad_transform`` (a
    shard-local clip would scale each rank by its own factor); scale by
    ``max_norm / maximum(norm, max_norm)``, safe at ``norm == 0``.  Zero
    padding adds nothing to the sum of squares."""
    local_sq = sum(torch.sum(torch.square(s)) for s in tree_leaves(shards))
    # compression=False: feeds the clipping decision — keep exact.
    return torch.sqrt(comm.Allreduce(local_sq, MPI_SUM, compression=False))


def zero_init(comm, opt, params):
    """Optimizer state for this rank's parameter shards: ``opt.init`` on
    the sharded-and-padded view — ``1/size`` of the replicated state."""
    return opt.init(zero3_shard_params(comm, params))


def zero_step(comm, opt, params, local_grads, opt_state,
              grad_transform=None, overlap=None, mean=True):
    """One ZeRO-1 update; returns ``(new_params, new_opt_state)``.

    ``local_grads`` are this rank's un-reduced loss gradients (their sum
    over ranks is the global gradient); the reduction happens here, in
    the fused reduce-scatter, with the ``/ size`` rank-mean applied once
    per bucket (``mean=False`` keeps the rank sum).  The updated
    parameters return fully replicated.

    ``grad_transform(g_shards) -> g_shards`` runs after the
    reduce-scatter, on the sharded global gradients — the hook for
    global-norm clipping with :func:`shard_global_norm`.

    ``overlap`` (None → the :func:`~mpi4torch_tpu_torch.config.
    overlap_scope` / process default) truthy runs both wire legs through
    the split-phase scheduler (:mod:`mpi4torch_tpu_torch.overlap`): the
    gradient reduce-scatters in a windowed start/wait pipeline, the
    updated-shard all-gathers as the double-buffered prefetch.  Same
    bits as the blocking step."""
    from ..fuse import fused_reduce_scatter_tree

    g_shards = fused_reduce_scatter_tree(comm, local_grads, MPI_SUM,
                                         mean=mean, overlap=overlap)
    if grad_transform is not None:
        g_shards = grad_transform(g_shards)
    p_shards = zero3_shard_params(comm, params)
    updates, new_state = opt.update(g_shards, opt_state, p_shards)
    p_shards = tree_map(torch.add, p_shards, updates)
    return zero3_params(comm, p_shards, params, overlap=overlap), new_state


def zero3_shard_params(comm, params):
    """Partition full parameters into this rank's flat shards (the
    persistent between-step representation of stage 3).  Returns the
    shard tree; keep ``params`` (or a tree of meta tensors of its shapes
    and dtypes) as the shape template."""
    return tree_map(lambda p: _my_shard(comm, p), params)


def zero3_params(comm, p_shards, template, overlap=None):
    """Differentiable gather: full parameters from this rank's shards,
    one fused ``Allgather`` per bucket.  Under ``torch.autograd.grad``
    the adjoint reduce-scatters the parameter cotangents back to shards,
    summing over ranks on the way, so the gradient of a rank-local loss
    with respect to the shards is the global-sum gradient shard.  Always
    exact.  ``overlap`` truthy takes the double-buffered prefetch
    (:func:`~mpi4torch_tpu_torch.overlap.prefetch_allgather_tree`), with
    the same bits."""
    from ..fuse import fused_allgather_tree
    return fused_allgather_tree(comm, p_shards, template, overlap=overlap)


def zero3_init(comm, opt, params):
    """Shards and the optimizer state over them: ``(p_shards,
    opt_state)``."""
    p_shards = zero3_shard_params(comm, params)
    return p_shards, opt.init(p_shards)


def zero3_to_tp(comm, p_shards, template, tp_specs, strategy=None,
                dtype=None):
    """ZeRO-shard → TP-shard handoff: not ported yet (raises)."""
    raise NotImplementedError(
        "zero3_to_tp: the handoff needs the tensor-parallel layers and the "
        "reshard planner (ROADMAP.md, Queue 1 items 3 and 6)")


def zero3_step(comm, opt, p_shards, template, local_loss_fn, opt_state,
               grad_transform=None):
    """One ZeRO-3 update; returns ``(loss, new_p_shards,
    new_opt_state)``.

    ``local_loss_fn(full_params)`` is this rank's un-reduced local loss;
    the reduction happens in the Allgather's adjoint
    (``torch.autograd.grad`` through :func:`zero3_params`).  The summed
    gradient is divided by ``size`` (the plain-DP rank mean), then
    ``opt`` runs on the shards.  ``grad_transform`` hooks the sharded
    global-mean gradients, as in :func:`zero_step`."""
    size = comm.size
    loss, g_shards = value_and_grad(
        lambda shards: local_loss_fn(zero3_params(comm, shards, template)),
        p_shards)
    g_shards = tree_map(lambda g: g / size, g_shards)
    if grad_transform is not None:
        g_shards = grad_transform(g_shards)
    updates, new_state = opt.update(g_shards, opt_state, p_shards)
    new_shards = tree_map(torch.add, p_shards, updates)
    return loss, new_shards, new_state
