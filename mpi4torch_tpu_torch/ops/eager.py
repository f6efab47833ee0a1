"""Differentiable collectives on the rank-thread runtime.

Port of ``mpi4torch_tpu/ops/eager.py`` as far as serving and
data-parallel training need it: the
Allreduce, whose backward is itself the Allreduce of the gradient
(``MPI_SUM`` only; other ops raise in backward, like the mpi4torch
reference's unimplemented node).  The reduction is the ascending-rank
fold of :func:`~mpi4torch_tpu_torch.constants.reduce_ordered`, so every
rank gets the same bits on every run.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..runtime import CommError, RankContext

# Element count above which Allreduce folds once (rank 0) and shares the
# result instead of every rank thread folding the same list again.  The
# share costs one more rendezvous.
_FOLD_ONCE_MIN = 65536


def _shape_sig(x):
    return (tuple(x.shape), str(x.dtype))


def _allreduce_value(ctx: RankContext, x, op: int):
    world, rank = ctx.world, ctx.rank
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"Allreduce takes a torch.Tensor, got {type(x)}")
    if world.device is not None and x.device != world.device:
        raise CommError(
            f"Allreduce payload is on {x.device} but this rank world runs "
            f"on {world.device}")
    sig = _shape_sig(x)
    vals = world.exchange(rank, ("Allreduce", op, "ring", sig), x)
    if x.numel() >= _FOLD_ONCE_MIN and C.fold_applicable(op, x.dtype):
        # Every rank would compute the identical ascending-rank fold;
        # above the threshold rank 0 folds once and a second rendezvous
        # shares the result.  The gate is dtype-aware, so an op invalid
        # for the dtype stays on the every-rank path and raises on every
        # rank alike.
        red = C.reduce_ordered(op, vals) if rank == 0 else None
        red = world.exchange(rank, ("Allreduce.fold", op, "ring", sig),
                             red)[0]
        # One tensor object for every rank would let one rank's in-place
        # edit reach the others (in MPI they are distinct buffers in
        # distinct processes), and autograd must give each rank's output
        # its own node: ranks other than 0 take a private copy.
        return red if rank == 0 else red.clone()
    return C.reduce_ordered(op, vals)


class _Allreduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, rctx, op):
        fctx.rctx, fctx.op = rctx, op
        return _allreduce_value(rctx, x, op)

    @staticmethod
    def backward(fctx, g):
        if fctx.op != C.MPI_SUM:
            raise RuntimeError(
                f"Backward pass for Allreduce with {C.op_name(fctx.op)} is "
                "not implemented — only MPI_SUM is differentiable")
        return _allreduce_value(fctx.rctx, g.contiguous(), C.MPI_SUM), \
            None, None


def allreduce(ctx: RankContext, x, op: int):
    """Differentiable Allreduce over ``ctx``'s world.  The backward is the
    Allreduce of the gradient, so every rank's backward must run (it is a
    collective).  Rank threads of :func:`~mpi4torch_tpu_torch.run_ranks`
    run their backward passes on their own thread, CPU or CUDA, so each
    blocking backward collective waits only on its own rank; a rank that
    never arrives still ends as a ``DeadlockError`` at the world
    timeout."""
    return _Allreduce.apply(x, ctx, op)
