"""User-facing communicator facade.

Port of ``mpi4torch_tpu/comm.py`` on the rank-thread runtime:
:class:`MPI_Communicator` with the mpi4torch op table (``Allreduce``,
``Bcast_``, ``Reduce_``, ``Gather``, ``Allgather``, ``Reduce_scatter``,
``Scatter``, ``Alltoall``, ``Isend``/``Irecv``/``Wait``/``Send``/
``Recv``), the per-rank ``numelem`` of the packed collectives
(``ops/packed.py``), the split-phase ``Allreduce_start``/
``Reduce_scatter_start``/``Allgather_start`` (``overlap/``),
``check_health``, the fused ``Allreduce_tree`` (``fuse/``) and the
planned redistribution ``Reshard`` (``reshard/``);
:class:`WaitHandle`, :func:`JoinDummies` and :func:`JoinDummiesHandle`;
the :data:`COMM_WORLD` singleton; and mpi4torch's
``deactivate_cuda_aware_mpi_support``, a no-op here.  Inside
:func:`run_ranks` each rank thread sees its own concrete rank; outside,
``COMM_WORLD`` is a size-1 world, like an MPI binary run without
``mpirun``.  Every op is differentiable, its backward the adjoint
communication (``ops/eager.py``), and runs under
``torch.profiler.record_function("mpi4torch.<Name>")``.

Inside :func:`~mpi4torch_tpu_torch.ops.spmd.run_spmd` (Mode A)
``COMM_WORLD`` and the mesh communicators of :func:`comm_from_mesh`
route every op to :class:`~mpi4torch_tpu_torch.ops.spmd.SpmdBackend`:
``rank`` is then symbolic and ``size`` static.  Under Mode A a codec
(explicit or from the compression scope) runs the compressed SPMD
collectives of ``compress/spmd.py``, and ``Reshard`` the SPMD reshard
executor; a tier-stack mesh communicator has no compressed pipeline (an
explicit codec raises, a scope codec degrades to the exact wire).

``Allreduce`` resolves its codec and algorithm with the JAX package's
rules: ``compression=None`` defers to the compression scope or process
default, and ``algorithm=None`` to the algorithm scope or process
default, then to the selector (``tune.select_auto``).  An explicit
argument that cannot serve the call raises; a scope default degrades (a
codec to the exact wire for integer tensors, non-sum ops and an explicit
algorithm the codec does not ride; an algorithm to auto selection, or to
``ring`` under a codec that does not ride it).  The block-q8 codecs run
on ``ring``, ``bidir`` and ``torus``; the exact wire on ``ring``,
``rhd``, ``tree``, ``hier``, ``bidir``, ``torus`` and synthesized
schedules (``"synth:<digest>"``, installed by ``csched.synth``).  What is
not ported raises ``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

import functools
import math
import numbers
from typing import List, Sequence

import torch

from . import config as _cfg
from . import constants as C
from .compress import codec_applicable, codec_rides_algorithm, get_codec
from .compress import eager as _ceager
from .ops import eager as _eager
from .runtime import CommError, HealthReport, effective_rank_context
from .tune import codec_algorithms, resolve_request
from .tune import get_algorithm as _get_algorithm


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


def _resolve_algorithm(algorithm, nranks, collective="allreduce"):
    """A facade ``algorithm=`` argument as a concrete name, or None for
    the selector: ``None`` defers to the scope/process default
    (:func:`config.default_algorithm`); ``False``/``"auto"`` ask for the
    selector even inside an ``algorithm_scope``.  An explicit request
    that cannot serve the call raises; a default degrades to auto
    (``tune.resolve_request``)."""
    explicit = algorithm is not None
    requested = algorithm if explicit else _cfg.default_algorithm()
    return resolve_request(requested, collective=collective,
                           nranks=nranks, explicit=explicit)


def _reconcile_codec_algorithm(codec, algo, codec_explicit: bool,
                               algo_explicit: bool):
    """Resolve a codec and an algorithm that do not compose
    (``compress.codec_rides_algorithm``): both explicit raises; otherwise
    the scope-provided half yields (an explicit algorithm takes the exact
    wire; a codec takes ``ring``)."""
    if codec is None or algo is None or codec_rides_algorithm(codec, algo):
        return codec, algo
    if codec_explicit and algo_explicit:
        raise ValueError(
            f"compression={codec.name!r} composes with the "
            f"{'/'.join(codec_algorithms(codec))} wire algorithm(s) "
            f"only; algorithm={algo!r} cannot carry this codec — drop "
            "one of the two")
    if algo_explicit:
        return None, algo
    return codec, "ring"


def _mesh_algorithm(algorithm):
    """The algorithm of a call on a tier-stack mesh communicator, which
    keys its tiers off the mesh axes: the name is validated only (the
    backend enforces what it can lower: explicit raises, a default
    yields to its native schedule)."""
    requested = (algorithm if algorithm not in (None, False, "auto")
                 else None if algorithm is not None
                 else _cfg.default_algorithm())
    return (None if requested in (None, "auto")
            else _get_algorithm(requested).name)


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
    """Communicator wrapper.  ``COMM_WORLD`` resolves to the Mode A axis
    of the calling rank thread inside ``run_spmd``, else to its rank
    world; a mesh communicator (:func:`comm_from_mesh`) carries its own
    resolver."""

    def __init__(self, backend_resolver=None):
        self._resolver = backend_resolver

    def __reduce__(self):
        """Pickling, world-only: the round trip restores the
        :data:`COMM_WORLD` singleton, which resolves its world in the
        loading context (so a rank body shipped to a transport worker
        still talks to its world).  A mesh-derived communicator refuses,
        as in the JAX package."""
        if self._resolver is None:
            return (_restore_comm_world, ())
        import pickle
        raise pickle.PicklingError(
            "Unsupported communicator for serialization: only COMM_WORLD "
            "can be pickled (mesh-derived communicators hold live device "
            "references; rebuild them with comm_from_mesh after loading)")

    def __copy__(self):
        # A communicator denotes a process group, not data: copying a
        # structure that holds one hands back the same handle.
        return self

    def __deepcopy__(self, memo):
        return self

    def _spmd(self):
        """The Mode A backend this communicator resolves to on the calling
        thread, or None (the rank-thread eager runtime)."""
        if self._resolver is not None:
            return self._resolver()
        from .ops import spmd as _spmd
        ctx = _spmd.current_spmd_context()
        return None if ctx is None else _spmd.SpmdBackend(ctx)

    @property
    def rank(self) -> int:
        """Rank of the calling thread within this communicator: an int on
        the rank threads, a symbolic
        :class:`~mpi4torch_tpu_torch.ops.spmd.RankExpr` under Mode A."""
        b = self._spmd()
        return effective_rank_context().rank if b is None else b.rank

    @property
    def size(self) -> int:
        """Number of ranks in the communicator (static under Mode A)."""
        if self._resolver is not None:
            axes = getattr(self, "_spmd_axis", None)
            if axes is not None:
                return axes[1]
            hier = getattr(self, "_hier_axes", None)
            if hier is not None:
                return math.prod(hier[1])
        b = self._spmd()
        return effective_rank_context().world.size if b is None else b.size

    @property
    def device(self):
        """The device of this communicator's rank world (``None`` for the
        default size-1 world, which takes tensors on any device)."""
        b = self._spmd()
        return effective_rank_context().world.device if b is None \
            else b.device

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
        if algorithm is False:
            algorithm = "auto"
        algo_explicit = algorithm not in (None, "auto")
        if getattr(self._spmd(), "owns_algorithm_resolution", False):
            algo = _mesh_algorithm(algorithm)
        else:
            algo = _resolve_algorithm(algorithm, self.size)
        codec, algo = _reconcile_codec_algorithm(
            codec, algo, codec_explicit=compression is not None,
            algo_explicit=algo_explicit)
        if codec is not None and not getattr(self._spmd(),
                                             "supports_compression", True):
            # The tier-stack mesh communicators have no compressed
            # pipeline: an explicit codec raises, a scope default
            # degrades to the exact wire.
            if compression is not None:
                raise ValueError(
                    f"compression={codec.name!r} is not supported on "
                    "this communicator (the mesh-axis tier-stack "
                    "backend has no compressed pipeline); use a "
                    "single-axis comm_from_mesh communicator")
            codec = None
        return codec, algo

    def Allreduce(self, tensor, op: int, compression=None, algorithm=None):
        """Element-wise combine across all ranks, result on every rank.
        Only ``MPI_SUM`` is differentiable; other ops raise in backward.

        ``compression`` picks a codec (``"q8"``, ``"q8_ef"``,
        ``"q8_ef_hop"``, ``"bf16"``, ``"bf16r"``, a Codec object, or
        ``False`` to override a compression scope); a compressed Allreduce
        is ``MPI_SUM`` only and its backward is itself compressed.
        ``algorithm`` picks the wire schedule (``"ring"``, ``"rhd"``,
        ``"tree"``, ``"hier"``, ``"bidir"``, ``"torus"``; the block-q8
        codecs ride ``ring``, ``bidir`` and ``torus``, the bf16 codecs
        ``ring``; ``False``/``"auto"``/None for the selector).  On the
        rank threads a schedule is a reduction association: the exact
        wire folds in that schedule's (ascending rank for ``ring`` and
        ``bidir``), and the backward uses the same one.  The profiler span carries the codec and a non-ring
        algorithm (``mpi4torch.Allreduce.q8.bidir``)."""
        codec, algo = self._allreduce_plan(tensor, op, compression,
                                           algorithm)
        span = "mpi4torch.Allreduce" + (f".{codec.name}" if codec else "") \
            + (f".{algo}" if algo not in (None, "ring") else "")
        b = self._spmd()
        explicit = algorithm not in (None, False, "auto")
        if b is not None:
            with torch.profiler.record_function(span):
                if codec is None:
                    return b.allreduce(tensor, op, algorithm=algo,
                                       algorithm_explicit=explicit)
                return b.allreduce_compressed(
                    tensor, op, codec, algorithm=algo,
                    algorithm_explicit=explicit)
        ctx = effective_rank_context()
        with torch.profiler.record_function(span):
            if codec is None:
                return _eager.allreduce(ctx, tensor, op, algorithm=algo,
                                        algorithm_explicit=explicit)
            return _ceager.allreduce(ctx, tensor, op, codec,
                                     algorithm=algo,
                                     algorithm_explicit=explicit)

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

    def Reshard(self, tree, from_spec, to_spec, strategy=None,
                compression=None):
        """Redistribute a tree of shards from one sharding layout to
        another (:mod:`mpi4torch_tpu_torch.reshard`): each leaf moves from
        its ``from_spec`` :class:`~mpi4torch_tpu_torch.reshard.Layout` to
        its ``to_spec`` Layout through a planned program of collectives
        whose peak live bytes stay ``O(shard + chunk)``, never those of
        gathering everything.  ``from_spec``/``to_spec`` are one Layout
        (broadcast over the tree) or a matching tree of Layouts (e.g. from
        :func:`~mpi4torch_tpu_torch.reshard.match_partition_rules`).

        Differentiable: the backward redistributes the cotangents
        ``to_spec`` -> ``from_spec`` by the reverse plan; a replication
        adjoint sums them in ascending group order.  The bits equal the
        JAX package's (every step but that sum moves data).

        ``strategy`` pins a planner strategy
        (:data:`mpi4torch_tpu_torch.reshard.STRATEGIES`; ``None``: the
        :func:`config.default_reshard_strategy`, else the preference
        order).  ``compression`` (explicit only: a state migration never
        inherits the gradient codec scope) rides the full-world gather hop
        of the ``gather`` strategy.  Under Mode A (``run_spmd``) the SPMD
        executor runs the same plan, bitwise the rank-thread replay."""
        from .reshard import reshard_tree

        with torch.profiler.record_function("mpi4torch.Reshard"):
            return reshard_tree(self, tree, from_spec, to_spec,
                                strategy=strategy, compression=compression)

    # ------------------------------------------------------------ health

    def check_health(self, timeout=None) -> HealthReport:
        """Timeout-bounded attributed barrier probe: every live rank calls
        it; the report says whether all ranks answered within ``timeout``
        (default: the world's deadlock timeout) and, when not, which ranks
        arrived and which are missing.  A failed probe returns its report
        and leaves the collective rendezvous untouched, and a later probe
        starts fresh.  Host-level by nature: under Mode A it raises
        :class:`~mpi4torch_tpu_torch.runtime.CommError`, as in the JAX
        package."""
        if self._spmd() is not None:
            raise CommError(
                "check_health is a host-level liveness probe: call it on "
                "the eager thread world (run_ranks) or outside SPMD "
                "regions — a compiled SPMD program cannot host-probe "
                "mid-schedule")
        ctx = effective_rank_context()
        return ctx.world.health_check(ctx.rank, timeout)

    # ------------------------------------------------------- collectives

    @_named_op
    def Bcast_(self, tensor, root: int, algorithm=None):
        """Broadcast ``root``'s tensor; every rank gets its own copy.
        ``algorithm`` (``"ring"``, ``"tree"``) shapes the adjoint, a
        ``Reduce_`` to ``root`` in that association."""
        algo = _resolve_algorithm(algorithm, self.size, collective="bcast")
        b = self._spmd()
        if b is not None:
            return b.bcast_(tensor, root, algorithm=algo)
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
        algo = _resolve_algorithm(algorithm, self.size,
                                  collective="reduce")
        b = self._spmd()
        if b is not None:
            return b.reduce_(tensor, op, root, algorithm=algo)
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
        b = self._spmd()
        if b is not None:
            return b.gather(tensor, gatheraxis, root)
        return _eager.gather(effective_rank_context(), tensor, gatheraxis,
                             root)

    def Allgather(self, tensor, gatheraxis: int, numelem=None,
                  compression=None):
        """Gather with the result on every rank; the adjoint is the
        ordered reduce-scatter.  A per-rank tuple ``numelem``: see
        :meth:`Gather`; the packed path is always exact (an explicit
        codec raises there, a scope codec does not apply).

        ``compression`` picks a wire codec as for :meth:`Allreduce`
        (``None`` defers to the compression scope, which applies to
        floating tensors only): the shard travels encoded, every rank
        decodes every shard, and the adjoint is a compressed
        reduce-scatter.  The profiler span carries the codec
        (``mpi4torch.Allgather.bf16``)."""
        if numelem is not None:
            if compression is not None and \
                    get_codec(compression) is not None:
                raise ValueError(
                    "Allgather: compression= is not supported together "
                    "with the packed numelem= path")
            with torch.profiler.record_function("mpi4torch.Allgather"):
                from .ops.packed import packed_allgather
                if isinstance(numelem, numbers.Integral):
                    numelem = (int(numelem),) * self.size  # uniform prefix
                return packed_allgather(self, tensor, gatheraxis, numelem)
        codec = _codec_for(tensor, _resolve_compression(compression),
                           explicit=compression is not None)
        span = "mpi4torch.Allgather" + (f".{codec.name}" if codec else "")
        b = self._spmd()
        if b is not None:
            with torch.profiler.record_function(span):
                if codec is None:
                    return b.allgather(tensor, gatheraxis)
                return b.allgather_compressed(tensor, gatheraxis, codec)
        ctx = effective_rank_context()
        with torch.profiler.record_function(span):
            if codec is None:
                return _eager.allgather(ctx, tensor, gatheraxis)
            return _ceager.allgather(ctx, tensor, gatheraxis, codec)

    @_named_op
    def Reduce_scatter(self, tensor, op: int, scatteraxis: int):
        """Element-wise reduce across ranks, scattered in equal
        ``scatteraxis`` segments (rank r keeps segment r).  Only
        ``MPI_SUM`` is differentiable; the adjoint is an allgather."""
        b = self._spmd()
        if b is not None:
            return b.reduce_scatter(tensor, op, scatteraxis)
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
        b = self._spmd()
        if b is not None:
            return b.scatter(tensor, scatteraxis, int(numelem), root)
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
        b = self._spmd()
        if b is not None:
            return b.alltoall(tensor, gatheraxis, scatteraxis, int(numelem))
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
        table) on ``tag``; under Mode A a static permutation of the
        symbolic rank."""
        b = self._spmd()
        if b is not None:
            return WaitHandle(b.isend(tensor, dest, tag))
        return WaitHandle(_eager.isend(effective_rank_context(), tensor,
                                       dest, tag))

    @_named_op
    def Irecv(self, tensor, source: int, tag: int) -> WaitHandle:
        """Nonblocking receive into ``tensor``'s shape and dtype."""
        b = self._spmd()
        if b is not None:
            return WaitHandle(b.irecv(tensor, source, tag))
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
        b = self._spmd()
        if b is not None:
            return b.wait(waithandle._handle)
        return _eager.wait(effective_rank_context(), waithandle._handle)

    @_named_op
    def Send(self, tensor, dest: int, tag: int):
        """Blocking send = Isend + Wait."""
        b = self._spmd()
        if b is not None:
            return b.wait(b.isend(tensor, dest, tag))
        ctx = effective_rank_context()
        return _eager.wait(ctx, _eager.isend(ctx, tensor, dest, tag))

    @_named_op
    def Recv(self, tensor, source: int, tag: int):
        """Blocking receive = Irecv + Wait."""
        b = self._spmd()
        if b is not None:
            return b.wait(b.irecv(tensor, source, tag))
        ctx = effective_rank_context()
        return _eager.wait(ctx, _eager.irecv(ctx, tensor, source, tag))


def comm_from_mesh(mesh, axis_name):
    """A communicator over a mesh axis (or, for a tuple of axis names, the
    tier stack over them), used inside ``run_spmd(fn, mesh=mesh)``; see
    :func:`mpi4torch_tpu_torch.ops.spmd.comm_from_mesh`."""
    from .ops.spmd import comm_from_mesh as _from_mesh
    return _from_mesh(mesh, axis_name)


class _ProcessWorldBackend:
    """Top-level backend of an mpi4py-derived communicator under an MPI
    launch of more than one process: rank/size report the MPI layout;
    collective ops require an SPMD region (each OS process runs its own
    ranks; only ``run_spmd`` over the global world spans them)."""

    def __init__(self, rank: int, size: int):
        self.rank = rank
        self.size = size

    def __getattr__(self, name):
        raise CommError(
            "this mpi4py-derived communicator spans OS processes; run its "
            "collectives inside run_spmd (the SPMD program over the global "
            "world), not at the top level of one process")


def comm_from_mpi4py(comm, device=None) -> MPI_Communicator:
    """Convert an mpi4py communicator (mpi4torch's ``comm_from_mpi4py``;
    there via the Fortran handle, here via the ``torch.distributed``
    rendezvous).

    Under an MPI launch (``mpirun -np N python prog.py`` with mpi4py),
    this bootstraps the multi-process runtime *from the MPI world*: rank
    0 picks a free ``host:port`` and broadcasts it over the mpi4py
    communicator, every rank joins via
    :func:`~mpi4torch_tpu_torch.init_distributed`, and the returned
    communicator reports the MPI rank/size at the top level while its
    collectives run over the global world inside ``run_spmd`` regions.
    The host is ``MPI4TORCH_TPU_COORDINATOR_HOST`` when set (the JAX
    package's variable), else this host's routable address.  With a
    single MPI process the default world already matches, so the
    returned communicator is immediately usable.  ``device`` is the
    rendezvous's (``init_distributed``'s: CUDA unless the caller passes
    ``"cpu"``).  Raises ``RuntimeError`` when mpi4py is absent and
    :class:`CommError` when the established process layout disagrees
    with the MPI world."""
    try:
        from mpi4py import MPI as _MPI  # noqa: F401
    except ModuleNotFoundError:
        raise RuntimeError("mpi4py is not available!")

    from . import distributed as _dist

    rank, size = comm.Get_rank(), comm.Get_size()
    if size == 1:
        info = _dist.distributed_info()
        if info is not None and info.process_count > 1:
            # COMM_SELF (or another size-1 subcommunicator) inside a
            # multi-process launch: the default world spans ALL
            # processes, so returning it would silently widen rank-local
            # collectives across the launch.
            raise CommError(
                "a size-1 mpi4py communicator inside a "
                f"{info.process_count}-process launch is a "
                "subcommunicator; only world-spanning communicators map "
                "onto the global world — split the mesh with "
                "comm_from_mesh for subgroup collectives")
        # One process: the contextual world (size-1 eager, or whatever
        # world a surrounding run_spmd region provides) is already the
        # MPI world; ops work immediately.
        return MPI_Communicator()

    if not _dist.is_distributed():
        if rank == 0:
            addr = f"{_routable_ip()}:{_free_port()}"
        else:
            addr = None
        addr = comm.bcast(addr, root=0)
        _dist.init_distributed(coordinator_address=addr,
                               num_processes=size, process_id=rank,
                               device=device)
    info = _dist.distributed_info()
    if info.process_count != size:
        raise CommError(
            f"mpi4py world has {size} processes but the runtime was "
            f"initialized with {info.process_count}; launch both with the "
            "same layout")
    if info.process_id != rank:
        raise CommError(
            f"mpi4py rank {rank} does not match the process_id "
            f"{info.process_id}; a rank-reordered communicator would "
            "silently misattribute SPMD ranks — pass the communicator "
            "whose ordering matches the launch (usually MPI.COMM_WORLD)")
    backend = _ProcessWorldBackend(rank, size)

    def resolver():
        from .ops import spmd as _spmd
        ctx = _spmd.current_spmd_context()
        return backend if ctx is None else _spmd.SpmdBackend(ctx)

    return MPI_Communicator(resolver)


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _routable_ip() -> str:
    """Best-effort address other hosts can reach for the rendezvous.

    ``MPI4TORCH_TPU_COORDINATOR_HOST`` overrides.  The UDP-connect trick
    learns the egress interface without sending a packet;
    ``gethostbyname(hostname)`` often maps to 127.0.0.1 in containers,
    which would hang a multi-host rendezvous, so it is the last resort
    (fine for single-host launches)."""
    import os
    import socket

    override = os.environ.get("MPI4TORCH_TPU_COORDINATOR_HOST")
    if override:
        return override
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("8.8.8.8", 80))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        pass
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def deactivate_cuda_aware_mpi_support() -> None:
    """A documented no-op kept so that mpi4torch scripts run unmodified.
    In mpi4torch it stops MPI from reading CUDA buffers directly and
    stages them through host memory instead.  Here collectives never go
    through MPI: rank threads of one world hand each other device tensors
    on the card's shared stream, so there is no CUDA-aware transport to
    turn off."""


def _restore_comm_world():
    """Unpickle target: the :data:`COMM_WORLD` singleton."""
    return COMM_WORLD


COMM_WORLD = MPI_Communicator()
"""World communicator: the current rank thread's world inside
:func:`run_ranks`, a size-1 world otherwise."""
