"""User-facing communicator facade.

Port of ``mpi4torch_tpu/comm.py`` on the rank-thread runtime:
:class:`MPI_Communicator` with the mpi4torch op table (``Allreduce``,
``Bcast_``, ``Reduce_``, ``Gather``, ``Allgather``, ``Reduce_scatter``,
``Scatter``, ``Alltoall``, ``Isend``/``Irecv``/``Wait``/``Send``/
``Recv``), the per-rank ``numelem`` of the packed collectives
(``ops/packed.py``), the split-phase ``Allreduce_start``/
``Reduce_scatter_start``/``Allgather_start`` (``overlap/``),
``check_health`` and the fused ``Allreduce_tree`` (``fuse/``);
:class:`WaitHandle`, :func:`JoinDummies` and :func:`JoinDummiesHandle`;
and the :data:`COMM_WORLD` singleton.  Inside :func:`run_ranks` each rank thread
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
from .runtime import HealthReport, effective_rank_context
from .tune import resolve_request


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

    def _with_raw(self, raw_handle: List) -> "WaitHandle":
        """A handle of the same kind over ``raw_handle``."""
        return WaitHandle(raw_handle)


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
    return handle._with_raw([JoinDummies(raw[0], dummies), raw[1], raw[2]])


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
        """Fused bucketed Allreduce over a parameter tree (nested
        dictionaries, lists and tuples of tensors;
        :mod:`mpi4torch_tpu_torch.fuse`): the leaves are flattened into
        dtype-homogeneous flat buckets of ~``bucket_bytes`` (layout
        cached per tree structure) and each bucket rides one
        :meth:`Allreduce`.  On the exact wire this is bit-identical to an
        Allreduce per leaf (the same fold, element by element).
        Differentiable: the backward is itself fused.

        ``bucket_bytes=None`` uses the :func:`config.fusion_scope` /
        process default (4 MiB); ``0`` gives one Allreduce per leaf.
        ``mean=True`` divides each reduced bucket by :attr:`size` once
        (``MPI_SUM`` only).  ``compression`` and ``algorithm`` follow the
        :meth:`Allreduce` contract, applied per bucket; a compressed
        bucket quantizes other blocks than a compressed leaf, so it
        matches the JAX package's fused form.  ``overlap`` (None: the
        :func:`config.overlap_scope` / process default) truthy runs the
        nonblocking Isend/Irecv pipeline, exact ``MPI_SUM`` on the ring
        association only."""
        from .fuse import fused_allreduce_tree

        with torch.profiler.record_function("mpi4torch.Allreduce_tree"):
            return fused_allreduce_tree(
                self, tree, op, compression=compression,
                bucket_bytes=bucket_bytes, mean=mean, overlap=overlap,
                algorithm=algorithm)

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
        the gathered shape).

        ``numelem``, a per-rank tuple, takes the packed path
        (``ops/packed.py``): the axis is capacity-padded, rank ``r``'s
        first ``numelem[r]`` entries are valid, and the result comes back
        packed to ``sum(numelem)``.  An int ``numelem`` is the uniform
        prefix ``(numelem,) * size``."""
        if numelem is not None:
            from .ops.packed import packed_gather
            if isinstance(numelem, numbers.Integral):
                numelem = (int(numelem),) * self.size   # uniform prefix
            return packed_gather(self, tensor, gatheraxis, numelem, root)
        return _eager.gather(effective_rank_context(), tensor, gatheraxis,
                             root)

    @_named_op
    def Allgather(self, tensor, gatheraxis: int, numelem=None,
                  compression=None):
        """Gather with the result on every rank; the adjoint is the
        ordered reduce-scatter.  A per-rank tuple ``numelem``: see
        :meth:`Gather`; the packed path is always exact (an explicit
        codec raises there, a scope codec does not apply).  A compressed
        Allgather is not ported yet: an explicit ``compression=`` raises,
        and so does a scope or process codec on a floating tensor (the
        JAX package would compress there, so the exact wire would be
        another answer)."""
        if numelem is not None:
            if compression is not None and \
                    get_codec(compression) is not None:
                raise ValueError(
                    "Allgather: compression= is not supported together "
                    "with the packed numelem= path")
            from .ops.packed import packed_allgather
            if isinstance(numelem, numbers.Integral):
                numelem = (int(numelem),) * self.size   # uniform prefix
            return packed_allgather(self, tensor, gatheraxis, numelem)
        codec = _codec_for(tensor, _resolve_compression(compression),
                           explicit=compression is not None)
        if codec is not None:
            raise NotImplementedError(
                f"Allgather with compression {codec.name!r}: the "
                "compressed Allgather is not ported yet (ROADMAP.md, Queue "
                "1 item 1); pass compression=False for the exact wire")
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
        ``numelem`` takes the packed path (``ops/packed.py``): the axis
        must be the packed ``sum(numelem)``, and the result is
        capacity-padded to ``max(numelem)`` with invalid slots zeroed."""
        if not isinstance(numelem, numbers.Integral):
            from .ops.packed import packed_scatter
            return packed_scatter(self, tensor, scatteraxis, numelem, root)
        return _eager.scatter(effective_rank_context(), tensor, scatteraxis,
                              numelem, root)

    @_named_op
    def Alltoall(self, tensor, gatheraxis: int, scatteraxis: int, numelem,
                 current_numelem=None):
        """Gather along ``gatheraxis`` and redistribute along
        ``scatteraxis``, keeping ``numelem`` entries here.  A per-rank
        tuple ``numelem`` takes the packed path (``ops/packed.py``):
        gather axis capacity-padded in, packed out; scatter axis packed
        in, capacity-padded and masked out.  For ``gatheraxis ==
        scatteraxis`` (the interval-overlap redistribution) also pass
        ``current_numelem``, the present partition."""
        if not isinstance(numelem, numbers.Integral):
            from .ops.packed import packed_alltoall
            return packed_alltoall(self, tensor, gatheraxis, scatteraxis,
                                   numelem, current_numelem)
        if current_numelem is not None:
            raise ValueError(
                "current_numelem only applies to per-rank tuple numelem")
        return _eager.alltoall(effective_rank_context(), tensor, gatheraxis,
                               scatteraxis, numelem)

    # ------------------------------------------ split-phase collectives

    def Allreduce_start(self, tensor, op: int, compression=None,
                        algorithm=None) -> WaitHandle:
        """Split-phase Allreduce, phase 1 (:mod:`mpi4torch_tpu_torch.
        overlap`): returns a handle with the :class:`WaitHandle` API
        (``.dummy``; :func:`JoinDummiesHandle` composes) that
        :meth:`Wait` completes exactly once, with the same bits as the
        blocking :meth:`Allreduce`.  On the rank threads the collective
        runs here and the Wait is its completion point.  Split-phase
        transfers are exact: an explicit ``compression=`` raises, a
        scope or process codec degrades to the exact wire.  The span
        carries the resolved algorithm
        (``mpi4torch.Allreduce_start.rhd``)."""
        from .overlap import allreduce_start
        return allreduce_start(self, tensor, op, compression=compression,
                               algorithm=algorithm)

    def Reduce_scatter_start(self, tensor, op: int,
                             scatteraxis: int) -> WaitHandle:
        """Split-phase :meth:`Reduce_scatter` (the ZeRO gradient-bucket
        form).  See :meth:`Allreduce_start`."""
        from .overlap import reduce_scatter_start
        with torch.profiler.record_function(
                "mpi4torch.Reduce_scatter_start"):
            return reduce_scatter_start(self, tensor, op, scatteraxis)

    def Allgather_start(self, tensor, gatheraxis: int) -> WaitHandle:
        """Split-phase :meth:`Allgather` (the ZeRO-3 parameter-prefetch
        form).  See :meth:`Allreduce_start`."""
        from .overlap import allgather_start
        with torch.profiler.record_function("mpi4torch.Allgather_start"):
            return allgather_start(self, tensor, gatheraxis)

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
        loop-through tensor, the received message, or a split-phase
        collective's result (``*_start``)."""
        if getattr(waithandle, "_split_state", None) is not None:
            from .overlap import complete_generic
            return complete_generic(waithandle)
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


def comm_from_mesh(mesh, axis_name):
    """A communicator over a device-mesh axis: not ported yet (raises)."""
    raise NotImplementedError(
        "comm_from_mesh: mesh communicators come with the compiled/device "
        "backend (ROADMAP.md, Queue 1 item 4)")


def comm_from_mpi4py(comm):
    """A communicator from an mpi4py one: not ported yet (raises)."""
    raise NotImplementedError(
        "comm_from_mpi4py: multi-process worlds come with the "
        "compiled/device backend (ROADMAP.md, Queue 1 item 4)")


COMM_WORLD = MPI_Communicator()
"""World communicator: the current rank thread's world inside
:func:`run_ranks`, a size-1 world otherwise."""
