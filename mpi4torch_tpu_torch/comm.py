"""User-facing communicator facade.

Port of ``mpi4torch_tpu/comm.py`` on the rank-thread runtime:
:class:`MPI_Communicator` with the mpi4torch op table (``Allreduce``,
``Bcast_``, ``Reduce_``, ``Gather``, ``Allgather``, ``Reduce_scatter``,
``Scatter``, ``Alltoall``, ``Isend``/``Irecv``/``Wait``/``Send``/
``Recv``), ``check_health`` and ``Allreduce_tree``; :class:`WaitHandle`,
:func:`JoinDummies` and :func:`JoinDummiesHandle`; and the
:data:`COMM_WORLD` singleton.  Inside :func:`run_ranks` each rank thread
sees its own concrete rank; outside, ``COMM_WORLD`` is a size-1 world,
like an MPI binary run without ``mpirun``.  Every op is differentiable,
its backward the adjoint communication (``ops/eager.py``), and runs
under ``torch.profiler.record_function("mpi4torch.<Name>")``.

``Allreduce`` resolves its codec and algorithm with the JAX package's
rules: ``compression=None`` defers to the compression scope or process
default, and ``algorithm=None`` to the selector.  An explicit argument
that cannot serve the call raises; a scope default degrades to the
exact wire (for integer tensors, non-sum ops, and an explicit algorithm
the codec does not ride).  The block-q8 codecs run on ``ring``,
``bidir`` and ``torus``; the exact wire on ``ring``, ``rhd``, ``tree``,
``hier``, ``bidir`` and ``torus``.  What is not ported raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

import functools
import numbers
from typing import List, Sequence

import torch

from . import config as _cfg
from . import constants as C
from .compress import codec_applicable, codec_rides_algorithm, get_codec
from .compress import eager as _ceager
from .ops import eager as _eager
from .runtime import CommError, HealthReport, effective_rank_context
from .tune import resolve_request
from .utils.tree import tree_map


class WaitHandle:
    """The handle a non-blocking call returns: the raw 3-tensor handle
    ``[descriptor, buffer, loopthrough]`` of the mpi4torch reference."""

    def __init__(self, raw_handle: List):
        self._handle = list(raw_handle)

    @property
    def dummy(self):
        """A dummy variable for the second argument of
        :func:`JoinDummies` / :func:`JoinDummiesHandle`."""
        return self._handle[0]


def JoinDummies(loopthrough, dummies: Sequence):
    """Join dummy dependencies into the autograd graph: forward returns
    ``loopthrough`` itself (with no dummies, the very same object);
    backward gives each dummy a zero gradient, which keeps the
    communication that produced it ordered in the backward pass.  The
    result cannot be modified in place (copy it first)."""
    return _eager.join_dummies(loopthrough, dummies)


def JoinDummiesHandle(handle: WaitHandle, dummies: Sequence) -> WaitHandle:
    """:func:`JoinDummies` for a :class:`WaitHandle`: the dummies join the
    descriptor slot only."""
    raw = handle._handle
    return WaitHandle([JoinDummies(raw[0], dummies), raw[1], raw[2]])


def _named_op(method):
    """Run a facade op under ``record_function("mpi4torch.<Name>")``
    (the trailing in-place underscore stripped), so profiler traces carry
    one span per op."""
    span = "mpi4torch." + method.__name__.rstrip("_")

    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        with torch.profiler.record_function(span):
            return method(self, *args, **kwargs)

    return wrapped


def _not_packed(numelem, what: str) -> None:
    raise NotImplementedError(
        f"{what} with a per-rank numelem={numelem!r}: the packed and "
        "ragged collectives are not ported yet (ROADMAP.md, Queue 1 item "
        "1)")


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
        schedule (``"ring"``, ``"rhd"``, ``"tree"``, ``"hier"``,
        ``"bidir"``, ``"torus"``; the block-q8 codecs ride ``ring``,
        ``bidir`` and ``torus``; ``False``/``"auto"``/None for the
        selector).  On the rank threads a schedule is a reduction
        association: the exact wire folds in that schedule's (ascending
        rank for ``ring`` and ``bidir``), and the backward uses the same
        one.  The profiler span carries the codec and a non-ring
        algorithm (``mpi4torch.Allreduce.q8.bidir``)."""
        codec, algo = self._allreduce_plan(tensor, op, compression,
                                           algorithm)
        ctx = effective_rank_context()
        span = "mpi4torch.Allreduce" + (f".{codec.name}" if codec else "") \
            + (f".{algo}" if algo not in (None, "ring") else "")
        with torch.profiler.record_function(span):
            if codec is None:
                return _eager.allreduce(ctx, tensor, op, algorithm=algo)
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
        ``overlap`` come with ROADMAP.md Queue 1 item 2."""
        if overlap:
            raise NotImplementedError(
                f"overlap={overlap!r}: the split-phase overlap pipeline "
                "is not ported yet (ROADMAP.md, Queue 1 item 2); use None "
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
                "(ROADMAP.md, Queue 1 item 2); pass bucket_bytes=0 for one "
                "compressed Allreduce per leaf")
        size = self.size
        with torch.profiler.record_function("mpi4torch.Allreduce_tree"):
            out = tree_map(lambda t: self.Allreduce(
                t, op, compression=compression, algorithm=algorithm), tree)
            if mean:
                out = tree_map(lambda t: t / size, out)
        return out

    # ------------------------------------------------------------ health

    def check_health(self, timeout=None) -> HealthReport:
        """Timeout-bounded attributed barrier probe: every live rank calls
        it; the report says whether all ranks answered within ``timeout``
        (default: the world's deadlock timeout) and, when not, which ranks
        arrived and which are missing.  A failed probe returns its report
        and leaves the collective rendezvous untouched, and a later probe
        starts fresh."""
        ctx = effective_rank_context()
        return ctx.world.health_check(ctx.rank, timeout)

    # ------------------------------------------------------- collectives

    @_named_op
    def Bcast_(self, tensor, root: int, algorithm=None):
        """Broadcast ``root``'s tensor; every rank gets its own copy.
        ``algorithm`` (``"ring"``, ``"tree"``) shapes the adjoint, a
        ``Reduce_`` to ``root`` in that association."""
        algo = resolve_request(algorithm, collective="bcast",
                               nranks=self.size)
        return _eager.bcast_(effective_rank_context(), tensor, root,
                             algorithm=algo)

    @_named_op
    def Reduce_(self, tensor, op: int, root: int, algorithm=None):
        """Reduce to ``root``; non-root results are zeros and the input
        is consumed (a later communication op on it raises
        :class:`~mpi4torch_tpu_torch.runtime.InPlaceReuseError`).
        ``algorithm``: ``"tree"`` folds in the binomial-tree association
        relative to the root, ``"ring"``/None in ascending rank order.
        Only ``MPI_SUM`` is differentiable; the adjoint is a ``Bcast_``."""
        algo = resolve_request(algorithm, collective="reduce",
                               nranks=self.size)
        return _eager.reduce_(effective_rank_context(), tensor, op, root,
                              algorithm=algo)

    @_named_op
    def Gather(self, tensor, gatheraxis: int, root: int, numelem=None):
        """Concatenate per-rank tensors along ``gatheraxis`` on ``root``
        (per-rank axis lengths may differ; non-root ranks get zeros of
        the gathered shape).  A per-rank ``numelem`` (the packed path)
        is not ported yet and raises."""
        if numelem is not None:
            _not_packed(numelem, "Gather")
        return _eager.gather(effective_rank_context(), tensor, gatheraxis,
                             root)

    @_named_op
    def Allgather(self, tensor, gatheraxis: int, numelem=None,
                  compression=None):
        """Gather with the result on every rank; the adjoint is the
        ordered reduce-scatter.  A compressed Allgather is not ported
        yet: an explicit ``compression=`` raises, and so does a scope or
        process codec on a floating tensor (the JAX package would
        compress there, so the exact wire would be another answer).
        A per-rank ``numelem`` (the packed path) raises too."""
        if numelem is not None:
            _not_packed(numelem, "Allgather")
        codec = _codec_for(tensor, _resolve_compression(compression),
                           explicit=compression is not None)
        if codec is not None:
            raise NotImplementedError(
                f"Allgather with compression {codec.name!r}: the "
                "compressed Allgather is not ported yet (ROADMAP.md, Queue "
                "1 item 3); pass compression=False for the exact wire")
        return _eager.allgather(effective_rank_context(), tensor, gatheraxis)

    @_named_op
    def Reduce_scatter(self, tensor, op: int, scatteraxis: int):
        """Element-wise reduce across ranks, scattered in equal
        ``scatteraxis`` segments (rank r keeps segment r).  Only
        ``MPI_SUM`` is differentiable; the adjoint is an allgather."""
        return _eager.reduce_scatter(effective_rank_context(), tensor, op,
                                     scatteraxis)

    @_named_op
    def Scatter(self, tensor, scatteraxis: int, numelem, root: int):
        """Split ``root``'s tensor along ``scatteraxis``; this rank keeps
        ``numelem`` entries (the counts must sum to the root's axis
        length).  Non-root input shapes are ignored.  A per-rank tuple
        ``numelem`` (the packed path) raises."""
        if not isinstance(numelem, numbers.Integral):
            _not_packed(numelem, "Scatter")
        return _eager.scatter(effective_rank_context(), tensor, scatteraxis,
                              numelem, root)

    @_named_op
    def Alltoall(self, tensor, gatheraxis: int, scatteraxis: int, numelem,
                 current_numelem=None):
        """Gather along ``gatheraxis`` and redistribute along
        ``scatteraxis``, keeping ``numelem`` entries here.  A per-rank
        tuple ``numelem`` (the packed path) raises."""
        if not isinstance(numelem, numbers.Integral):
            _not_packed(numelem, "Alltoall")
        if current_numelem is not None:
            raise ValueError(
                "current_numelem only applies to per-rank tuple numelem")
        return _eager.alltoall(effective_rank_context(), tensor, gatheraxis,
                               scatteraxis, numelem)

    def Allreduce_start(self, tensor, op: int, compression=None,
                        algorithm=None):
        """Split-phase Allreduce: not ported yet (raises)."""
        _not_split_phase("Allreduce_start")

    def Reduce_scatter_start(self, tensor, op: int, scatteraxis: int):
        """Split-phase Reduce_scatter: not ported yet (raises)."""
        _not_split_phase("Reduce_scatter_start")

    def Allgather_start(self, tensor, gatheraxis: int):
        """Split-phase Allgather: not ported yet (raises)."""
        _not_split_phase("Allgather_start")

    # --------------------------------------------------------------- p2p

    @_named_op
    def Isend(self, tensor, dest: int, tag: int) -> WaitHandle:
        """Nonblocking (buffered) send to ``dest`` (an int, or a per-rank
        table) on ``tag``."""
        return WaitHandle(_eager.isend(effective_rank_context(), tensor,
                                       dest, tag))

    @_named_op
    def Irecv(self, tensor, source: int, tag: int) -> WaitHandle:
        """Nonblocking receive into ``tensor``'s shape and dtype."""
        return WaitHandle(_eager.irecv(effective_rank_context(), tensor,
                                       source, tag))

    @_named_op
    def Wait(self, waithandle: WaitHandle):
        """Complete a nonblocking request, exactly once: the send's
        loop-through tensor, or the received message."""
        return _eager.wait(effective_rank_context(), waithandle._handle)

    @_named_op
    def Send(self, tensor, dest: int, tag: int):
        """Blocking send = Isend + Wait."""
        ctx = effective_rank_context()
        return _eager.wait(ctx, _eager.isend(ctx, tensor, dest, tag))

    @_named_op
    def Recv(self, tensor, source: int, tag: int):
        """Blocking receive = Irecv + Wait."""
        ctx = effective_rank_context()
        return _eager.wait(ctx, _eager.irecv(ctx, tensor, source, tag))


def _not_split_phase(what: str) -> None:
    raise NotImplementedError(
        f"{what}: the split-phase collectives come with the overlap "
        "pipeline (ROADMAP.md, Queue 1 item 2)")


def comm_from_mesh(mesh, axis_name):
    """A communicator over a device-mesh axis: not ported yet (raises)."""
    raise NotImplementedError(
        "comm_from_mesh: mesh communicators come with the compiled/device "
        "backend (ROADMAP.md, Queue 1 item 6)")


def comm_from_mpi4py(comm):
    """A communicator from an mpi4py one: not ported yet (raises)."""
    raise NotImplementedError(
        "comm_from_mpi4py: multi-process worlds come with the "
        "compiled/device backend (ROADMAP.md, Queue 1 item 6)")


COMM_WORLD = MPI_Communicator()
"""World communicator: the current rank thread's world inside
:func:`run_ranks`, a size-1 world otherwise."""
