"""One reader of recorded programs for every census in the port.

Port of ``mpi4torch_tpu/analyze/parse.py``.  The JAX package parses the
StableHLO text of a lowering; the port has no compiler, so its lowering
is a recorded run (:func:`~mpi4torch_tpu_torch.analyze.lower`, module
:mod:`.record`) that already holds typed records.  :func:`parse_program`
turns that :class:`~.record.LoweredProgram` into the
:class:`ParsedProgram` every pass reads:

* typed :class:`CollectiveOp` records of every wire op, in JAX's terms:
  kind (``collective_permute``, ``all_reduce``, ``all_gather``,
  ``reduce_scatter``, ``all_to_all``), ``replica_groups`` with their
  declared shape or ``source_target_pairs`` in the mesh's row-major
  global rank ids, a channel, operand and result types in JAX's
  ``AxBxf32`` form, payload bytes, and the span path the op ran under
  (``mpi4torch.Allreduce.q8.bidir``,
  ``mpi4torch.Allreduce_tree/mpi4torch.Allreduce_tree.bucket0of3.start``,
  ...);
* an :class:`OpEvent` stream of every op of one rank's program in
  order: the aten ops, each hand-written kernel launch (a
  ``custom_call`` named after its kernel), each collective, and a
  ``named_scope`` marker where a span opens.  An event's ``line`` is its
  index in the stream; its operands and results are value ids, the
  substrate of the liveness scan;
* ``num_partitions``, the world's rank count, and ``arguments``, the
  values the program read before defining them (the liveness scan's
  function arguments: a recorded program is one function, the rank
  body).

The type grammar (:func:`tensor_bytes`, :func:`dtype_bytes`) and the
bucket-span grammar (:func:`bucket_of`) are the JAX package's.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

__all__ = [
    "COLLECTIVE_KINDS",
    "WIRE_OPS",
    "CollectiveOp",
    "OpEvent",
    "ParsedProgram",
    "bucket_of",
    "dtype_bytes",
    "parse_program",
    "tensor_bytes",
]

# The op kinds that put bytes on the wire (or rendezvous ranks), named
# as the JAX package's StableHLO names them.
COLLECTIVE_KINDS = ("all_reduce", "all_gather", "reduce_scatter",
                    "all_to_all", "collective_permute")
WIRE_OPS = frozenset(COLLECTIVE_KINDS)

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2,
    "i64": 8, "ui64": 8, "i32": 4, "ui32": 4,
    "i16": 2, "ui16": 2, "i8": 1, "ui8": 1, "i1": 1,
    "c64": 8, "c128": 16,
}

_BUCKET = re.compile(
    r"mpi4torch\.(?P<op>[A-Za-z_]+)\.bucket(?P<i>\d+)of(?P<n>\d+)"
    r"(?P<rest>(?:\.\w+)*)")
_LABEL = re.compile(r"mpi4torch\.[A-Za-z_0-9.]+")


def dtype_bytes(element_type: str) -> Optional[int]:
    """Bytes per element of an element type (``f32`` -> 4), or None for
    an unknown type that carries no priceable buffer."""
    return _DTYPE_BYTES.get(element_type)


def tensor_bytes(desc: str) -> int:
    """Bytes of a tensor type description (``8x128xf32``).  Unknown
    element types and dynamic dims carry 0 (a zero-sized dim is a
    legitimate 0, which :func:`dtype_bytes` tells apart)."""
    parts = desc.replace(" ", "").split("x")
    n = _DTYPE_BYTES.get(parts[-1])
    if n is None:
        return 0
    for d in parts[:-1]:
        if not d.isdigit():
            return 0
        n *= int(d)
    return n


def bucket_of(scope: str):
    """``(op, bucket, total, phase)`` of the outermost
    ``mpi4torch.<Op>.bucket<i>of<n>[...]`` span in a span path, or None
    (the ``utils.profiling.bucket_scope`` grammar)."""
    m = _BUCKET.search(scope)
    if m is None:
        return None
    rest = m.group("rest").split(".")
    phase = ("start" if "start" in rest
             else "wait" if "wait" in rest else None)
    return (m.group("op"), int(m.group("i")), int(m.group("n")), phase)


@dataclass(frozen=True)
class OpEvent:
    """One op of a recorded program, in program order.  ``operands`` are
    the value ids it reads (an in-place op's target among them),
    ``results`` the ``(value id, bytes)`` of the values it defines; a
    view defines nothing (it is its base's value).  ``target`` names
    the kernel of a ``custom_call``."""
    line: int          # index in the rank's event stream
    kind: str          # "add", "mm", "custom_call", "all_reduce", ...
    scope: str         # span path ("a/b/c"), or ""
    operands: Tuple[int, ...] = ()
    results: Tuple[Tuple[int, int], ...] = ()
    target: Optional[str] = None

    @property
    def bucket(self):
        return bucket_of(self.scope)


@dataclass(frozen=True)
class CollectiveOp:
    """A typed record of one wire collective of a recorded program."""
    kind: str                                    # COLLECTIVE_KINDS entry
    line: int                                    # its event's index
    scope: str                                   # span path or ""
    operand_types: Tuple[str, ...]               # "AxBxf32" descs
    result_types: Tuple[str, ...]
    replica_groups: Optional[Tuple[Tuple[int, ...], ...]] = None
    group_shape: Optional[Tuple[int, int]] = None   # declared RxC
    source_target_pairs: Optional[Tuple[Tuple[int, int], ...]] = None
    channel: Optional[int] = None

    @property
    def dtype(self) -> Optional[str]:
        """Element type of the payload (first operand)."""
        if not self.operand_types:
            return None
        return self.operand_types[0].replace(" ", "").split("x")[-1]

    @property
    def payload_bytes(self) -> int:
        """Bytes of the first operand — what one rank contributes."""
        return tensor_bytes(self.operand_types[0]) \
            if self.operand_types else 0

    @property
    def group_size(self) -> Optional[int]:
        """Participants per replica group (the declared column count)."""
        return self.group_shape[1] if self.group_shape else None

    @property
    def label(self) -> Optional[str]:
        """The outermost ``mpi4torch.*`` span of the scope path, or
        None."""
        m = _LABEL.search(self.scope)
        return m.group(0) if m else None

    @property
    def bucket(self):
        return bucket_of(self.scope)


@dataclass
class ParsedProgram:
    """The shared parse every analysis pass consumes: one rank's
    recorded program (``program``, the :class:`~.record.LoweredProgram`
    it came from, or None for a hand-built program)."""
    num_partitions: Optional[int]
    events: Tuple[OpEvent, ...] = field(repr=False)
    collectives: Tuple[CollectiveOp, ...]
    arguments: Tuple[Tuple[int, int], ...] = field(default=(),
                                                   repr=False)
    program: object = field(default=None, repr=False, compare=False)

    def census(self) -> Dict[str, int]:
        """Collective kind -> occurrence count, every kind present."""
        out = {k: 0 for k in COLLECTIVE_KINDS}
        for op in self.collectives:
            out[op.kind] += 1
        return out

    def ops(self, kind: Optional[str] = None,
            dtype: Optional[str] = None) -> Tuple[CollectiveOp, ...]:
        """Collective records filtered by kind and/or payload dtype."""
        got = self.collectives
        if kind is not None:
            got = tuple(op for op in got if op.kind == kind)
        if dtype is not None:
            got = tuple(op for op in got if op.dtype == dtype)
        return got

    def scopes(self) -> Tuple[str, ...]:
        """Every distinct non-empty scope path, in first-seen order."""
        seen: Dict[str, None] = {}
        for ev in self.events:
            if ev.scope:
                seen.setdefault(ev.scope)
        return tuple(seen)

    def kernel_events(self) -> Dict[str, int]:
        """``custom_call`` events of this rank's program by kernel."""
        out: Dict[str, int] = {}
        for ev in self.events:
            if ev.kind == "custom_call":
                out[ev.target] = out.get(ev.target, 0) + 1
        return out


def parse_program(program) -> ParsedProgram:
    """The :class:`ParsedProgram` of a recorded program
    (:class:`~.record.LoweredProgram`, from
    :func:`~mpi4torch_tpu_torch.analyze.lower` or
    ``Engine.lower_step``); a :class:`ParsedProgram` passes through."""
    if isinstance(program, ParsedProgram):
        return program
    from .record import LoweredProgram

    if not isinstance(program, LoweredProgram):
        raise TypeError(
            "parse_program reads a recorded program (analyze.lower(...) "
            "or Engine.lower_step()); the port lowers to no StableHLO "
            f"text, got {type(program).__name__}")
    return ParsedProgram(
        num_partitions=program.num_partitions, events=program.events,
        collectives=program.collectives, arguments=program.arguments,
        program=program)
