"""The port's lowering: a Mode A program recorded as it runs once.

The JAX package lowers a ``run_spmd`` program with
``jax.jit(call).lower(*args)`` and its analyzer reads the StableHLO text.
The port runs eagerly, but every Mode A collective already goes through
one chokepoint, ``World.exchange``: each ``lax.ppermute`` of the JAX
schedules is one exchange, each native collective (``psum``,
``all_gather``, ``psum_scatter``, ``all_to_all``) one exchange.  So
:func:`lower` runs the call once on its world with a recorder attached
and returns the same typed records the JAX parser reads off the text:

* one :class:`~.parse.CollectiveOp` per exchange, with JAX's kind name,
  ``source_target_pairs`` (a permute) or ``replica_groups`` in the mesh's
  row-major global rank ids, JAX's ``AxBxf32`` operand and result types,
  a channel (its ordinal) and the span path it ran under;
* one :class:`~.parse.OpEvent` per aten op, seen by a
  ``TorchDispatchMode`` on each rank thread, per hand-written kernel
  launch (a ``custom_call`` named after its kernel, hooked where
  ``ops._kernels`` counts launches) and per collective, plus a
  ``named_scope`` marker where a ``record_function`` span opens.  Events
  carry value ids and result bytes for the liveness scan.

The span path is the stack of ``torch.profiler.record_function`` spans
open on the rank thread (the facade's ``mpi4torch.<Op>`` spans, the
bucket spans of ``utils.profiling``, the adjoints' ``...Backward``
spans), joined with ``/`` as JAX joins its ``named_scope`` path.

The program is SPMD: it is the lowest recorded rank's stream, whose ops
alone are recorded, and every other rank's collective sequence is
checked to equal it.  (The aten streams may differ: a rank-dependent
Python branch of the port is a masked select in JAX's single program.)

Loops: the recorder sees executed exchanges, so a ``lax.scan`` body that
JAX's text holds once (the ordered ring fold, the bidir chains past
``config.chain_unroll_max``) appears here once per trip.  Where JAX's
program has no loop the two op sequences are equal op for op.

Recording runs the call for real once and discards its outputs; it
changes no state of the caller's beyond what that call changes, and two
lowerings of the same call give equal programs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import config as _config
from ..runtime import CommError
from .parse import CollectiveOp, OpEvent, ParsedProgram

__all__ = ["LoweredProgram", "lower", "element_type", "tensor_type"]

_ELEMENT_TYPES = {
    torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16",
    torch.float16: "f16", torch.int64: "i64", torch.int32: "i32",
    torch.int16: "i16", torch.int8: "i8", torch.uint8: "ui8",
    torch.bool: "i1", torch.complex64: "c64", torch.complex128: "c128",
}
_BY_NAME = {str(dt): et for dt, et in _ELEMENT_TYPES.items()}

# The Mode A exchange kinds (ops/spmd.py ``_xchg``) as JAX names them.
_KINDS = {"ppermute": "collective_permute", "psum": "all_reduce",
          "all_gather": "all_gather", "all_gather_tiled": "all_gather",
          "psum_scatter": "reduce_scatter", "all_to_all": "all_to_all"}


def element_type(dtype) -> str:
    """JAX's element-type name of a torch dtype (or of its ``str``)."""
    et = _ELEMENT_TYPES.get(dtype) or _BY_NAME.get(str(dtype))
    if et is None:
        raise ValueError(f"no element type for {dtype!r}")
    return et


def tensor_type(shape, dtype) -> str:
    """JAX's ``AxBxf32`` type description of a shape and dtype."""
    return "x".join([str(int(d)) for d in shape] + [element_type(dtype)])


@dataclass(frozen=True)
class LoweredProgram:
    """One recorded run of a Mode A program: the lowest recorded rank's
    event stream and collectives (the SPMD program), its world's mesh,
    the values it read before defining them (``arguments``: value id and
    bytes), the event index at which each run of the world began
    (``regions``: the forward at 0, a gradient taken from outside
    after it), and ``kernel_events``, the ``custom_call`` events of every
    recorded rank summed by kernel (what ``_kernels.launch_counts``
    counts for the same run)."""
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    arguments: Tuple[Tuple[int, int], ...] = field(repr=False)
    events: Tuple[OpEvent, ...] = field(repr=False)
    collectives: Tuple[CollectiveOp, ...] = field(repr=False)
    regions: Tuple[int, ...] = (0,)
    kernel_events: Tuple[Tuple[str, int], ...] = ()

    @property
    def num_partitions(self) -> int:
        return math.prod(self.mesh_shape)

    def region(self, i: int) -> ParsedProgram:
        """The parse of run ``i`` alone (``region(0)``: the forward of a
        value-and-gradient recording, the program a forward lowering
        records)."""
        lo = self.regions[i]
        hi = self.regions[i + 1] if i + 1 < len(self.regions) \
            else len(self.events)
        return ParsedProgram(
            num_partitions=self.num_partitions, events=self.events[lo:hi],
            collectives=tuple(op for op in self.collectives
                              if lo <= op.line < hi),
            arguments=self.arguments, program=self)

    def kernels(self) -> Dict[str, int]:
        """``custom_call`` events of every recorded rank, by kernel."""
        return dict(self.kernel_events)


# ---------------------------------------------------------------------------
# One rank thread's stream
# ---------------------------------------------------------------------------


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of an op's arguments or results (nested lists, tuples
    and dicts), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out: List[torch.Tensor] = []
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            out.append(node)
        elif isinstance(node, (list, tuple)):
            stack.extend(reversed(node))
        elif isinstance(node, dict):
            stack.extend(reversed(list(node.values())))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor) -> int:
    """Address of ``t``'s storage (0 for an empty one)."""
    return t.untyped_storage().data_ptr()


class _Stream:
    """The program one rank thread runs: events, collectives, span stack
    and value ids (keyed by the tensor's ``id`` beside a weak reference
    that tells a reused ``id`` apart, so recording keeps nothing
    alive)."""

    def __init__(self, recorder: "_Recorder", rank: int, full: bool):
        self.recorder = recorder
        self.rank = rank
        # Only the program's rank records its ops; every other rank
        # records its collectives (checked against the program's) and
        # counts its kernel launches.
        self.full = full
        self.events: List[OpEvent] = []
        self.collectives: List[CollectiveOp] = []
        self.arguments: List[Tuple[int, int]] = []
        self.spans: List[str] = []            # open record_function spans
        self.regions: List[int] = []          # event index of each run
        self.quiet = 0
        self.kernels: Counter = Counter()
        self._vids: Dict[int, tuple] = {}    # id(tensor) -> (ref, vid)
        self._next = 0

    # ------------------------------------------------------------ values

    def _new(self) -> int:
        self._next += 1
        return self._next

    def _get(self, t: torch.Tensor) -> Optional[int]:
        got = self._vids.get(id(t))
        if got is not None and got[0]() is t:
            return got[1]
        return None

    def _set(self, t: torch.Tensor, vid: int) -> None:
        self._vids[id(t)] = (weakref.ref(t), vid)

    def use(self, t: torch.Tensor) -> int:
        """The value id of an operand; a tensor made before recording
        (an input, a parameter; a view made there is its base's value)
        becomes an argument, live from the start."""
        vid = self._get(t)
        if vid is None:
            base = t._base if t._is_view() else None
            vid = self._get(base) if base is not None else None
            if vid is None:
                vid = self._new()
                self.arguments.append(
                    (vid, _nbytes(t if base is None else base)))
                if base is not None:
                    self._set(base, vid)
            self._set(t, vid)
        return vid

    def operands(self, tree) -> Tuple[List[int], List[torch.Tensor]]:
        """Value ids of the tensors in ``tree`` (each once), and the
        tensors."""
        tensors = _tensors(tree)
        vids: List[int] = []
        for t in tensors:
            vid = self.use(t)
            if vid not in vids:
                vids.append(vid)
        return vids, tensors

    def define(self, outs, operands: List[int],
               inputs: List[torch.Tensor]):
        """``(value id, bytes)`` of the new values among ``outs``.  An
        output that shares an input's storage (a view, an in-place op's
        result, a kernel's preallocated output) is that input's value: it
        joins ``operands`` instead.  (Below autograd, where the dispatch
        mode sits, a view's ``_base`` is not set yet, so aliasing is read
        off the storage.)"""
        results = []
        storages = None
        for t in _tensors(outs):
            vid = self._get(t)
            if vid is None:
                if storages is None:
                    storages = {}
                    for i in inputs:
                        ptr = _storage(i)
                        if ptr:
                            storages.setdefault(ptr, self._get(i))
                vid = storages.get(_storage(t))
                if vid is not None:
                    self._set(t, vid)
            if vid is not None:
                if vid not in operands:
                    operands.append(vid)
                continue
            vid = self._new()
            self._set(t, vid)
            results.append((vid, _nbytes(t)))
        return tuple(results)

    def scope(self) -> str:
        return "/".join(self.spans)

    def _event(self, kind, operands, results=(), target=None) -> OpEvent:
        ev = OpEvent(line=len(self.events), kind=kind, scope=self.scope(),
                     operands=tuple(operands), results=results,
                     target=target)
        self.events.append(ev)
        return ev

    # -------------------------------------------------------------- hooks

    def aten(self, func, args, kwargs, out) -> None:
        operands, inputs = self.operands((args, kwargs))
        results = self.define(out, operands, inputs)
        self._event(func.overloadpacket.__name__, operands, results)

    def enter_span(self, name: str) -> None:
        # A marker event, so that a span with no op of its own (a Wait
        # that returns a result its start computed) still shows where it
        # opened.
        self.spans.append(str(name))
        self._event("named_scope", ())

    def exit_span(self) -> None:
        # Spans are ``with`` blocks, so they close in LIFO order on one
        # thread (the handle the exit op receives is a fresh wrapper of
        # the enter's, so it cannot be matched by identity).
        if self.spans:
            self.spans.pop()

    def kernel(self, name: str, ins, outs) -> None:
        """One hand-written kernel launch (``ops._kernels._launch``)."""
        self.kernels[name] += 1
        if self.full:
            operands, _ = self.operands((tuple(ins), tuple(outs)))
            self._event("custom_call", operands, target=name)

    def exchange(self, run, rank, signature, payload, read, checks):
        """One ``World.exchange`` of this rank: run it (the aten ops of
        its read are the collective's, not the program's), then record
        the collective."""
        op = self.recorder.decode(signature)
        self.quiet += 1
        try:
            out = run(rank, signature, payload, read, checks)
        finally:
            self.quiet -= 1
        if not self.full:
            if op is not None:
                self.collectives.append(op)
            return out
        operands, inputs = self.operands(payload)
        results = self.define(out, operands, inputs)
        # Not a Mode A wire collective (a rendezvous of another kind): an
        # event, but no wire op.
        ev = self._event(op.kind if op else "rendezvous", operands, results)
        if op is not None:
            self.collectives.append(dataclasses.replace(
                op, line=ev.line, scope=ev.scope,
                channel=len(self.collectives) + 1))
        return out


def _rf_ops():
    ops = torch.ops.profiler
    return (ops._record_function_enter_new.default,
            ops._record_function_exit._RecordFunction)


class _OpRecorder(TorchDispatchMode):
    """Every aten op of one rank thread into its stream, and the
    ``record_function`` spans onto its span stack."""

    def __init__(self, stream: _Stream):
        super().__init__()
        self.stream = stream
        self.enter_op, self.exit_op = _rf_ops()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        s = self.stream
        if func is self.enter_op:
            s.enter_span(args[0])
            return func(*args, **kwargs)
        if func is self.exit_op:
            s.exit_span()
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if not s.quiet:
            s.aten(func, args, kwargs, out)
        return out


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------


class _Recorder:
    """Streams of the rank threads of one ``run_spmd`` world (the
    forward and, when the call takes a gradient from outside, the
    backward of the same world)."""

    def __init__(self):
        self.world = None
        self.names: Tuple[str, ...] = ()
        self.shape: Tuple[int, ...] = ()
        self.streams: Dict[int, _Stream] = {}
        self._lock = threading.Lock()
        self._groups: Dict[object, Tuple[Tuple[int, ...], ...]] = {}

    @contextlib.contextmanager
    def rank_stream(self, run, rank: int):
        """Record rank ``rank`` of ``run`` (an ``ops.spmd._SpmdRun``) on
        this thread for the duration of the block."""
        with self._lock:
            if self.world is None:
                self.world = run.world
                self.names, self.shape = tuple(run.names), tuple(run.shape)
            elif run.world is not self.world:
                raise CommError(
                    "lower: the call ran more than one run_spmd world; "
                    "lower one run_spmd call (and its gradient) at a time")
            stream = self.streams.get(rank)
            if stream is None:
                stream = self.streams[rank] = _Stream(
                    self, rank, rank == run.world.local_ranks[0])
        stream.regions.append(len(stream.events))
        prev = _config.program_stream()
        _config.set_program_stream(stream)
        try:
            with (_OpRecorder(stream) if stream.full
                  else contextlib.nullcontext()):
                yield stream
        finally:
            _config.set_program_stream(prev)

    def axis_groups(self, axis) -> Tuple[Tuple[int, ...], ...]:
        """Every rank group of mesh axis (or axes) ``axis``, in global
        rank ids, sorted."""
        got = self._groups.get(axis)
        if got is None:
            from ..ops.spmd import _Region

            n = math.prod(self.shape)
            got = tuple(sorted({
                _Region(None, r, self.names, self.shape, None)
                .new_ctx(axis).group for r in range(n)}))
            with self._lock:
                self._groups[axis] = got
        return got

    def decode(self, signature) -> Optional[CollectiveOp]:
        """The collective record of a Mode A exchange signature
        (``("spmd.<kind>", axis, *extra, (shape, dtype))``), its event
        index, scope and channel left for the stream to fill; None for
        another signature."""
        tag = signature[0] if signature else None
        if not (isinstance(tag, str) and tag.startswith("spmd.")):
            return None
        what = tag[len("spmd."):]
        kind = _KINDS.get(what)
        if kind is None:
            return None
        axis, extra = signature[1], signature[2:-1]
        shape, dtype = signature[-1]
        axis_groups = self.axis_groups(
            tuple(axis) if isinstance(axis, list) else axis)
        operand = (tensor_type(shape, dtype),)
        if what == "ppermute":
            return CollectiveOp(
                kind=kind, line=-1, scope="", operand_types=operand,
                result_types=operand, source_target_pairs=tuple(
                    (grp[s], grp[d]) for grp in axis_groups
                    for s, d in extra[0]))
        subgroups = extra[-1]
        groups = tuple(tuple(grp[i] for i in sub) for grp in axis_groups
                       for sub in subgroups) if subgroups else axis_groups
        g = len(groups[0])
        res = list(shape)
        if what == "all_gather":
            res = [g] + res
        elif what == "all_gather_tiled":
            res[extra[0]] *= g
        elif what == "psum_scatter":
            res[extra[1]] //= g
        elif what == "all_to_all":
            res[extra[0]] //= g
            res[extra[1]] *= g
        return CollectiveOp(
            kind=kind, line=-1, scope="", operand_types=operand,
            result_types=(tensor_type(res, dtype),), replica_groups=groups,
            group_shape=(len(groups), g))

    def program(self) -> LoweredProgram:
        if not self.streams:
            raise CommError(
                "lower: the call ran no run_spmd region on the rank "
                "threads, so there is no program to record")
        ranks = tuple(sorted(self.streams))
        main = self.streams[ranks[0]]

        def wire(stream):
            return [(op.kind, op.operand_types, op.result_types,
                     op.replica_groups, op.source_target_pairs)
                    for op in stream.collectives]

        want = wire(main)
        for r in ranks[1:]:
            if wire(self.streams[r]) != want:
                raise CommError(
                    f"lower: rank {r} ran another collective sequence "
                    f"than rank {ranks[0]}; an SPMD program is one "
                    "sequence on every rank")
        kernels: Counter = Counter()
        for s in self.streams.values():
            kernels.update(s.kernels)
        return LoweredProgram(
            mesh_shape=self.shape, axis_names=self.names, rank=ranks[0],
            arguments=tuple(main.arguments),
            events=tuple(main.events),
            collectives=tuple(main.collectives),
            regions=tuple(main.regions),
            kernel_events=tuple(sorted(kernels.items())))


_LOWERING = threading.Lock()


def lower(call, *args, **kwargs) -> LoweredProgram:
    """Record the program ``call(*args, **kwargs)`` runs: ``call`` is a
    ``run_spmd(...)`` function (the counterpart of
    ``jax.jit(call).lower(*args)``), or any function that runs one
    ``run_spmd`` call and, optionally, takes its gradient from outside
    (the value-and-gradient program).  The call runs once, on its world's
    device; its outputs are dropped.  Unlike ``jit(...).lower`` it
    executes: its kernels launch and count in ``launch_counts``.  Its
    exchanges go straight to the wire, so no comm tracer records them
    (an attached controller's estimator sees no phantom step) and no
    fault plan fires on them.  One lowering records at a time."""
    if not _LOWERING.acquire(blocking=False):
        raise CommError("lower: another lowering is recording; lowerings "
                        "do not nest or run concurrently")
    try:
        rec = _Recorder()
        _config.set_program_recorder(rec)
        try:
            call(*args, **kwargs)
        finally:
            _config.set_program_recorder(None)
        return rec.program()
    finally:
        _LOWERING.release()
