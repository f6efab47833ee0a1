"""User-facing communicator facade.

Port of ``mpi4torch_tpu/comm.py`` as far as serving, data-parallel
training and the compressed gradient Allreduce need it:
:class:`MPI_Communicator` with ``rank``, ``size``, ``Allreduce`` and
``Allreduce_tree``, and the :data:`COMM_WORLD` singleton.  Inside
:func:`run_ranks` each rank thread sees its own concrete rank; outside,
``COMM_WORLD`` is a size-1 world, like an MPI binary run without
``mpirun``.

``Allreduce`` resolves its codec and algorithm with the JAX package's
rules: ``compression=None`` defers to the compression scope or process
default, and ``algorithm=None`` to the selector.  An explicit argument
that cannot serve the call raises; a scope default degrades to the
exact wire (for integer tensors, non-sum ops, and an explicit algorithm
the codec does not ride).  The block-q8 codecs run on
``ring``, ``bidir`` and ``torus``; the exact wire on ``ring``.  What is
not ported raises ``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

import torch

from . import config as _cfg
from . import constants as C
from .compress import codec_applicable, codec_rides_algorithm, get_codec
from .compress import eager as _ceager
from .ops import eager as _eager
from .runtime import CommError, effective_rank_context
from .tune import resolve_request
from .utils.tree import tree_map


def _resolve_compression(compression):
    """The codec of a ``compression=`` argument, or None.  ``None`` defers
    to the scope/process default; ``False``/``"none"`` force the exact
    wire even inside a compression scope."""
    if compression is None:
        compression = _cfg.default_compression()
    return get_codec(compression)


def _reconcile_codec_algorithm(codec, algo, codec_explicit: bool):
    """Resolve a codec and an explicit algorithm that do not compose: an
    explicit codec raises; a scope-provided one yields to the exact
    wire."""
    if codec is None or algo is None or codec_rides_algorithm(codec, algo):
        return codec, algo
    if codec_explicit:
        raise ValueError(
            f"compression={codec.name!r} composes with the "
            f"{'/'.join(codec.algorithms)} wire algorithm(s) "
            f"only; algorithm={algo!r} cannot carry this codec — drop "
            "one of the two")
    return None, algo


def _codec_for(tensor, codec, explicit):
    """Floating tensors only: a scope default degrades an integer or bool
    payload to the exact wire; an explicit ``compression=`` on one
    raises."""
    if codec is None:
        return None
    if not codec_applicable(codec, tensor.dtype):
        if explicit:
            raise ValueError(
                f"compression={codec.name!r} requires a floating tensor; "
                f"got dtype {tensor.dtype} (integer/bool payloads would be "
                "truncated, not approximated)")
        return None
    return codec


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

    def _allreduce_plan(self, tensor, op: int, compression, algorithm):
        """``(codec, algorithm)`` of an Allreduce call, after the
        scope/explicit degrade-or-raise rules."""
        if not isinstance(tensor, torch.Tensor):
            raise TypeError(f"Allreduce takes a torch.Tensor, got "
                            f"{type(tensor)}")
        codec = _codec_for(tensor, _resolve_compression(compression),
                           explicit=compression is not None)
        if codec is not None and op != C.MPI_SUM and compression is None:
            # A non-sum reduction inside a compression scope never asked
            # for compression; an explicit one raises in the collective.
            codec = None
        # There is no algorithm scope in this package yet: only an
        # explicit argument names an algorithm, and None is the selector.
        algo = resolve_request(algorithm, nranks=self.size)
        return _reconcile_codec_algorithm(
            codec, algo, codec_explicit=compression is not None)

    def Allreduce(self, tensor, op: int, compression=None, algorithm=None):
        """Element-wise combine across all ranks, result on every rank.
        Only ``MPI_SUM`` is differentiable; other ops raise in backward.

        ``compression`` picks a codec (``"q8"``, ``"q8_ef"``,
        ``"q8_ef_hop"``, a Codec object, or ``False`` to override a
        compression scope); a compressed Allreduce is ``MPI_SUM`` only and
        its backward is itself compressed.  ``algorithm`` picks the wire
        schedule (``"ring"``, and for the block-q8 codecs ``"bidir"`` and
        ``"torus"``; ``False``/``"auto"``/None for the selector).  The
        exact wire folds in ascending rank order."""
        codec, algo = self._allreduce_plan(tensor, op, compression,
                                           algorithm)
        ctx = effective_rank_context()
        if codec is None:
            if algo not in (None, "ring"):
                raise NotImplementedError(
                    f"algorithm={algo!r}: the exact wire runs only the "
                    "ascending-rank ring fold; the other schedules come "
                    "with the compiled backend (ROADMAP.md, Queue 1 items "
                    "2 and 6)")
            with torch.profiler.record_function("mpi4torch.Allreduce"):
                return _eager.allreduce(ctx, tensor, op)
        with torch.profiler.record_function(
                f"mpi4torch.Allreduce.{codec.name}"):
            return _ceager.allreduce(ctx, tensor, op, codec,
                                     algorithm=algo)

    def Allreduce_tree(self, tree, op: int, compression=None,
                       bucket_bytes=None, mean: bool = False, overlap=None,
                       algorithm=None):
        """Allreduce every leaf of a parameter tree (nested dictionaries,
        lists and tuples of tensors); ``mean=True`` divides each reduced
        leaf by :attr:`size` (``MPI_SUM`` only).  Differentiable like
        :meth:`Allreduce`, whose ``compression`` and ``algorithm`` rules
        apply per leaf.

        This is the per-leaf form: one Allreduce per leaf, in traversal
        order.  The JAX package fuses leaves into flat buckets.  On the
        exact wire its eager fused form is bit-identical to this one (the
        same ascending-rank fold, element by element, then the same
        division), so ``bucket_bytes`` is validated and otherwise changes
        nothing.  A compressed bucket quantizes other blocks than a
        compressed leaf, so with a codec only ``bucket_bytes=0`` (the JAX
        package's per-leaf path) is served.  Bucketed fusion and
        ``overlap`` come with ROADMAP.md Queue 1 item 4."""
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
        if _resolve_compression(compression) is not None \
                and bucket_bytes not in (0, False):
            raise NotImplementedError(
                f"Allreduce_tree with compression and bucket_bytes="
                f"{bucket_bytes!r}: compressed buckets are not ported yet "
                "(ROADMAP.md, Queue 1 item 4); pass bucket_bytes=0 for one "
                "compressed Allreduce per leaf")
        size = self.size
        with torch.profiler.record_function("mpi4torch.Allreduce_tree"):
            out = tree_map(lambda t: self.Allreduce(
                t, op, compression=compression, algorithm=algorithm), tree)
            if mean:
                out = tree_map(lambda t: t / size, out)
        return out


COMM_WORLD = MPI_Communicator()
"""World communicator: the current rank thread's world inside
:func:`run_ranks`, a size-1 world otherwise."""
