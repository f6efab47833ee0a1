"""Chokepoint comm tracing: the runtime half of the observability layer.

Port of ``mpi4torch_tpu/obs/trace.py`` for the rank-thread runtime.  A
:class:`CommTracer` installed with :func:`trace` (a ``with`` block) or
``config.set_comm_tracer`` (process-wide) observes every operation at
the two chokepoints all subsystems go through, ``World.exchange`` and
the p2p mailboxes (runtime.py), so fused buckets, compressed wires,
overlap pipelines and serving traffic are traced with no hook of their
own.  With no tracer installed a chokepoint pays one attribute read.

The tracer never reads the device: an event's bytes come from tensor
shapes and its times from the host clock, so tracing adds no device
sync and no copy.  The times are host times.

The tracer also holds the flight recorder: a bounded ring of recent
events per rank, snapshotted into a rank-attributed postmortem when a
chokepoint raises ``RankFailedError``, ``DeadlockError``,
``IntegrityError`` or ``SlowRankError`` (see :mod:`.flight`).

On the process transport each worker traces its own rank and ships its
events back; :meth:`CommTracer.absorb` merges them into the parent's
tracer under the transport's world.

Mode A (``run_spmd``) has the JAX package's step-event hook too:
:func:`spmd_collective_event`, with ``mode_a=True``, records one event a
collective entry (``where``, payload bytes); its exchanges are traced at
the chokepoint like every other rendezvous.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Dict, List, Optional

from .. import config as _config
from .events import CommEvent, annotate_signature, payload_nbytes

__all__ = [
    "CommTracer",
    "trace",
    "current_tracer",
    "spmd_collective_event",
    "push_label",
    "current_label",
]

# Errors that snapshot a postmortem, resolved on first use (runtime and
# resilience import this package).
_FAILURE_TYPES = None


def _failure_types():
    global _FAILURE_TYPES
    if _FAILURE_TYPES is None:
        from ..elastic.membership import ConsensusError
        from ..resilience.health import SlowRankError
        from ..runtime import DeadlockError, IntegrityError, RankFailedError

        # A failed membership consensus (a failed resize) gets its
        # postmortem through the same reaper entry point as every other
        # attributed failure.
        _FAILURE_TYPES = (RankFailedError, DeadlockError, IntegrityError,
                          ConsensusError, SlowRankError)
    return _FAILURE_TYPES


# ------------------------------------------------------- label context

# Thread-local label stack the bucket and step scopes push
# (utils/profiling.py), so that chokepoint events carry the bucket or
# serving-step label.  Pushed only while a tracer is installed.
_labels = threading.local()


def push_label(label: str):
    """Context manager pushing ``label`` onto this thread's label stack
    (it does nothing when no tracer is installed)."""
    return _LabelCtx(label)


class _LabelCtx:
    __slots__ = ("label", "_pushed")

    def __init__(self, label: str):
        self.label = label
        self._pushed = False

    def __enter__(self):
        if _config.comm_tracer() is not None:
            stack = getattr(_labels, "stack", None)
            if stack is None:
                stack = _labels.stack = []
            stack.append(self.label)
            self._pushed = True
        return self

    def __exit__(self, *exc):
        if self._pushed:
            _labels.stack.pop()
        return False


def current_label() -> Optional[str]:
    """Innermost label pushed on this thread, or None."""
    stack = getattr(_labels, "stack", None)
    return stack[-1] if stack else None


class _Meter:
    """Measurement state of one operation, handed through the
    chokepoint: the runtime's retry loops add to ``retries`` and its
    barriers to ``wait_s``; :meth:`CommTracer.commit` takes the
    duration."""

    __slots__ = ("tracer", "world_ord", "world_size", "rank", "channel",
                 "signature", "payload_bytes", "peer", "tag", "t0",
                 "retries", "bucket", "wait_s")

    def __init__(self, tracer, world_ord, world_size, rank, channel,
                 signature, payload_bytes, peer, tag):
        self.tracer = tracer
        self.world_ord = world_ord
        self.world_size = world_size
        self.rank = rank
        self.channel = channel
        self.signature = signature
        self.payload_bytes = payload_bytes
        self.peer = peer
        self.tag = tag
        self.bucket = current_label()
        self.retries = 0
        self.wait_s = 0.0
        self.t0 = time.perf_counter()

    def add_retries(self, n: int) -> None:
        self.retries += n

    def add_wait(self, seconds: float) -> None:
        """Time blocked on peers at a rendezvous barrier (both barriers
        of an exchange add in)."""
        self.wait_s += seconds


class CommTracer:
    """Thread-safe collector of :class:`CommEvent` records.

    * ``events``: the program-order list, bounded by ``max_events``
      (the oldest go first; ``dropped`` counts them).
    * a ring of the last ``ring`` events per ``(world, rank)``: the
      flight recorder's tails (:meth:`tails`).
    * ``postmortems``: rank-attributed failure snapshots, the first
      failure per world; later observers of the same tear add to its
      ``observers`` count.
    """

    def __init__(self, ring: int = 64, max_events: int = 200_000,
                 mode_a: bool = False):
        # Whether spmd_collective_event records Mode A step events.
        self.mode_a = bool(mode_a)
        self.ring = int(ring)
        self.max_events = int(max_events)
        self.events: collections.deque = collections.deque(
            maxlen=self.max_events)
        self.dropped = 0
        self.postmortems: List[dict] = []
        self._rings: Dict[tuple, collections.deque] = {}
        # id(world) -> (weak reference, ordinal); the reference tells a
        # new world that reuses a dead one's id from the old world.
        self._worlds: Dict[int, tuple] = {}
        self._failed_worlds: Dict[int, int] = {}   # ordinal -> pm index
        self._world_ctr = itertools.count()
        self._seq = itertools.count()
        self._lock = threading.Lock()

    # ----------------------------------------------------------- plumbing

    def _world_ord(self, world) -> int:
        wid = id(world)
        with self._lock:
            got = self._worlds.get(wid)
            if got is None or got[0]() is not world:
                got = self._worlds[wid] = (weakref.ref(world),
                                           next(self._world_ctr))
            return got[1]

    def begin(self, world, rank: int, channel: str, signature,
              payload=None, peer: Optional[int] = None,
              tag: Optional[int] = None) -> _Meter:
        return _Meter(self, self._world_ord(world), world.size, rank,
                      channel, signature,
                      payload_nbytes(payload) if payload is not None
                      else 0, peer, tag)

    def commit(self, meter: _Meter, result_payload=None,
               error: Optional[BaseException] = None) -> None:
        """Finalize one operation into an event.  ``result_payload`` (a
        p2p receive's message) adds the received bytes; ``error`` sets
        the status and, for the attributed failures, snapshots a
        postmortem."""
        dur = time.perf_counter() - meter.t0
        if result_payload is not None:
            meter.payload_bytes += payload_nbytes(result_payload)
        ann = annotate_signature(meter.signature)
        ev = CommEvent(
            seq=next(self._seq), rank=meter.rank, world=meter.world_ord,
            world_size=meter.world_size, channel=meter.channel,
            op=ann["op"], signature=(meter.signature if isinstance(
                meter.signature, tuple) else (meter.signature,)),
            payload_bytes=meter.payload_bytes, duration_s=dur,
            wait_s=meter.wait_s, t_start=meter.t0, retries=meter.retries,
            status="ok" if error is None else type(error).__name__,
            family=ann.get("family"), bookkeeping=ann["bookkeeping"],
            unmodeled=ann.get("unmodeled", False),
            algorithm=ann.get("algorithm"), codec=ann.get("codec"),
            bucket=meter.bucket, group_size=ann.get("group_size"),
            shape=ann.get("shape"), dtype=ann.get("dtype"),
            peer=meter.peer, tag=meter.tag)
        self._append(ev)
        if error is not None and isinstance(error, _failure_types()):
            self._note_failure(ev, error)

    def record_spmd(self, label: str, nbytes: int) -> None:
        """Target of :func:`spmd_collective_event`: one step-level Mode A
        event a collective entry and rank, with the JAX package's fields
        (rank and world -1, channel ``"spmd"``)."""
        ev = CommEvent(
            seq=next(self._seq), rank=-1, world=-1, world_size=0,
            channel="spmd", op=label, signature=(label,),
            payload_bytes=int(nbytes), t_start=time.perf_counter())
        self._append(ev)

    def _append(self, ev: CommEvent) -> None:
        with self._lock:
            if len(self.events) == self.max_events:
                self.dropped += 1   # the deque's maxlen drops the oldest
            self.events.append(ev)
            key = (ev.world, ev.rank)
            ring = self._rings.get(key)
            if ring is None:
                ring = self._rings[key] = collections.deque(
                    maxlen=self.ring)
            ring.append(ev)
        from . import metrics as _metrics
        _metrics.inc("obs_events_total",
                     help="CommEvents recorded by the comm tracer")

    def _note_failure(self, ev: CommEvent, error: BaseException) -> None:
        from .flight import build_postmortem
        with self._lock:
            idx = self._failed_worlds.get(ev.world)
            if idx is not None:
                # A later observer of a tear already snapshotted: refresh
                # its own tail (it has just committed its view of the
                # torn collective) and count it.
                pm = self.postmortems[idx]
                pm["observers"] += 1
                pm["observer_ranks"] = sorted(set(
                    pm["observer_ranks"] + [ev.rank]))
                ring = self._rings.get((ev.world, ev.rank))
                if ring:
                    pm["tails"][ev.rank] = [e.to_dict() for e in ring]
                return
            pm = build_postmortem(self, ev, error)
            self._failed_worlds[ev.world] = len(self.postmortems)
            self.postmortems.append(pm)
        from . import metrics as _metrics
        _metrics.inc("obs_postmortems_total",
                     help="flight-recorder postmortems captured")

    def note_rank_failure(self, world, rank: int,
                          error: BaseException) -> None:
        """Postmortem entry point for failures raised away from the
        chokepoints (``run_ranks`` routes every rank failure here).  Only
        the attributed failures snapshot; one already captured at a
        chokepoint gains an observer."""
        if not isinstance(error, _failure_types()):
            return
        ev = CommEvent(
            seq=next(self._seq), rank=rank,
            world=self._world_ord(world), world_size=world.size,
            channel="exchange", op=f"({type(error).__name__})",
            status=type(error).__name__)
        self._note_failure(ev, error)

    def note_gray_failure(self, world_ord: int, world_size: int,
                          rank: int, error: BaseException) -> None:
        """Postmortem entry point for an escalated gray failure
        (``resilience.health``): the detector runs between phases,
        outside any rank body, and names the traced world by the ordinal
        its events carry."""
        if not isinstance(error, _failure_types()):
            return
        ev = CommEvent(
            seq=next(self._seq), rank=rank, world=world_ord,
            world_size=world_size, channel="exchange",
            op=f"({type(error).__name__})",
            status=type(error).__name__)
        self._note_failure(ev, error)

    def absorb(self, world, shards: List[Optional[dict]]) -> None:
        """Merge process-backend worker dumps into this tracer: the
        parent's half of the transport's tracing contract.

        ``shards[rank]`` is the worker's shipped dump (``{"events",
        "postmortems", "dropped"}``) or None.  The events are merged in
        the order of their start times (``time.perf_counter`` is the
        host's monotonic clock, shared by processes) and re-sequenced in
        that order under this tracer's ordinal for ``world`` (the
        transport's switchboard); the postmortems merge as concurrent
        observers of one tear do (the first snapshot stays, later ones
        add their observers and their own ranks' tails)."""
        ord_ = self._world_ord(world)
        merged: List[CommEvent] = []
        for sh in shards:
            if not sh:
                continue
            with self._lock:
                self.dropped += int(sh.get("dropped") or 0)
            merged.extend(sh.get("events") or ())
        merged.sort(key=lambda ev: ev.t_start)
        for ev in merged:
            self._append(dataclasses.replace(ev, seq=next(self._seq),
                                             world=ord_))
        for sh in shards:
            for pm in (sh or {}).get("postmortems") or ():
                self._absorb_postmortem(ord_, pm)

    def _absorb_postmortem(self, ord_: int, pm: dict) -> None:
        with self._lock:
            idx = self._failed_worlds.get(ord_)
            if idx is None:
                pm = dict(pm, world=ord_, tails=dict(pm.get("tails") or {}))
                self._failed_worlds[ord_] = len(self.postmortems)
                self.postmortems.append(pm)
                return
            dst = self.postmortems[idx]
            dst["observers"] += pm.get("observers", 1)
            dst["observer_ranks"] = sorted(
                set(dst["observer_ranks"])
                | set(pm.get("observer_ranks") or ()))
            dst["tails"].update(pm.get("tails") or {})
            if not dst.get("failed_ranks") and pm.get("failed_ranks"):
                dst["failed_ranks"] = pm["failed_ranks"]

    # -------------------------------------------------------------- reads

    def events_for(self, rank: Optional[int] = None,
                   channel: Optional[str] = None) -> List[CommEvent]:
        with self._lock:
            evs = list(self.events)
        if rank is not None:
            evs = [e for e in evs if e.rank == rank]
        if channel is not None:
            evs = [e for e in evs if e.channel == channel]
        return evs

    def tails(self) -> Dict[tuple, List[CommEvent]]:
        """The flight recorder's ring per (world, rank), newest last."""
        with self._lock:
            return {k: list(r) for k, r in self._rings.items()}

    def last_postmortem(self) -> Optional[dict]:
        with self._lock:
            return self.postmortems[-1] if self.postmortems else None

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self.dropped = 0
            self._rings.clear()
            self.postmortems.clear()
            self._failed_worlds.clear()


def current_tracer() -> Optional[CommTracer]:
    """The installed tracer, or None."""
    return _config.comm_tracer()


@contextmanager
def trace(ring: int = 64, max_events: int = 200_000,
          mode_a: bool = False, tracer: Optional[CommTracer] = None):
    """Install a :class:`CommTracer` for the block and yield it::

        with mpi.obs.trace() as t:
            mpi.run_ranks(step, 2)
        t.events_for(rank=0)

    Process-wide, like the fault plan: events come from ``run_ranks``'
    rank threads, which a thread-local scope opened outside them would
    miss.  ``mode_a=True`` also records the Mode A step events of
    :func:`spmd_collective_event`.  The previous tracer is restored on
    exit."""
    t = tracer if tracer is not None else CommTracer(
        ring=ring, max_events=max_events, mode_a=mode_a)
    prev = _config.comm_tracer()
    _config.set_comm_tracer(t)
    try:
        yield t
    finally:
        _config.set_comm_tracer(prev)


def spmd_collective_event(x, where: str):
    """Mode A step-event hook, called on a collective entry's input.
    With no tracer installed, or ``mode_a=False`` (the default), returns
    ``x`` untouched: no op, no sync.  With ``mode_a=True`` it records one
    step-level event for this rank's entry, carrying the payload bytes
    (from the shape; nothing is read from the device)."""
    tracer = _config.comm_tracer()
    if tracer is None or not tracer.mode_a:
        return x
    tracer.record_spmd(where, x.numel() * x.element_size())
    return x
