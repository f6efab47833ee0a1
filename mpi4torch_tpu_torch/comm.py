"""User-facing communicator facade.

Port of ``mpi4torch_tpu/comm.py`` as far as serving and data-parallel
training need it: :class:`MPI_Communicator` with ``rank``, ``size``,
``Allreduce`` and ``Allreduce_tree``, and the :data:`COMM_WORLD`
singleton.  Inside :func:`run_ranks` each rank
thread sees its own concrete rank; outside, ``COMM_WORLD`` is a size-1
world, like an MPI binary run without ``mpirun``.

Only the exact wire exists here: ``compression=None``/``False`` and
``algorithm=None``/``"ring"``.  Every other value raises
``NotImplementedError`` naming the ROADMAP.md item that brings it.
"""

from __future__ import annotations

import torch

from . import constants as C
from .ops import eager as _eager
from .runtime import CommError, effective_rank_context
from .utils.tree import tree_map


def _check_plan(compression, algorithm) -> None:
    if compression not in (None, False):
        raise NotImplementedError(
            f"compression={compression!r}: compressed collectives are not "
            "ported yet (ROADMAP.md, Queue 1 item 3, with kernel K1)")
    if algorithm not in (None, "ring"):
        raise NotImplementedError(
            f"algorithm={algorithm!r}: only the ascending-rank ring fold "
            "is ported; the other schedules come with the compiled "
            "backend (ROADMAP.md, Queue 1 items 2 and 6)")


class MPI_Communicator:
    """Communicator wrapper: the rank-thread world of the calling
    thread."""

    @property
    def rank(self) -> int:
        """Rank of the calling thread within this communicator."""
        return effective_rank_context().rank

    @property
    def size(self) -> int:
        """Number of ranks in the communicator."""
        return effective_rank_context().world.size

    @property
    def device(self):
        """The device of this communicator's rank world (``None`` for the
        default size-1 world, which takes tensors on any device)."""
        return effective_rank_context().world.device

    def Allreduce(self, tensor, op: int, compression=None, algorithm=None):
        """Element-wise combine across all ranks, result on every rank,
        folded in ascending rank order.  Only ``MPI_SUM`` is
        differentiable; other ops raise in backward."""
        _check_plan(compression, algorithm)
        with torch.profiler.record_function("mpi4torch.Allreduce"):
            return _eager.allreduce(effective_rank_context(), tensor, op)

    def Allreduce_tree(self, tree, op: int, compression=None,
                       bucket_bytes=None, mean: bool = False, overlap=None,
                       algorithm=None):
        """Allreduce every leaf of a parameter tree (nested dictionaries,
        lists and tuples of tensors); ``mean=True`` divides each reduced
        leaf by :attr:`size` (``MPI_SUM`` only).  Differentiable like
        :meth:`Allreduce`.

        This is the per-leaf form: one Allreduce per leaf, in traversal
        order.  The JAX package fuses leaves into flat buckets, and its
        eager fused form is bit-identical to this one (the same
        ascending-rank fold, element by element, then the same division),
        so ``bucket_bytes`` is validated and otherwise changes nothing
        here.  The bucketed fusion and ``overlap`` come with ROADMAP.md
        Queue 1 item 4."""
        _check_plan(compression, algorithm)
        if overlap:
            raise NotImplementedError(
                f"overlap={overlap!r}: the split-phase overlap pipeline "
                "is not ported yet (ROADMAP.md, Queue 1 item 4); use None "
                "or False")
        if mean and op != C.MPI_SUM:
            raise CommError(
                f"mean=True is the rank-mean of an MPI_SUM reduction; got "
                f"{C.op_name(op)}")
        if bucket_bytes is not None and bucket_bytes is not False \
                and int(bucket_bytes) < 0:
            raise ValueError(f"bucket_bytes must be >= 0, got "
                             f"{int(bucket_bytes)}")
        size = self.size
        with torch.profiler.record_function("mpi4torch.Allreduce_tree"):
            out = tree_map(lambda t: self.Allreduce(t, op), tree)
            if mean:
                out = tree_map(lambda t: t / size, out)
        return out


COMM_WORLD = MPI_Communicator()
"""World communicator: the current rank thread's world inside
:func:`run_ranks`, a size-1 world otherwise."""
