"""Rank-thread eager runtime: the ``mpirun -np N`` analogue.

Port of the thread backend of ``mpi4torch_tpu/runtime.py``: N Python
threads, each running the per-rank function with a concrete integer rank,
where every collective is a rendezvous of all threads with a signature
check.  It is stricter than MPI: ranks that disagree on the collective
raise :class:`CollectiveMismatchError` on every rank, and a rank that
never arrives raises :class:`DeadlockError` naming who arrived and who
did not.

Besides the collective rendezvous a world carries point-to-point
mailboxes (buffered sends, blocking receives with the deadlock timeout),
the request table of the non-blocking ops with its wait-handle guards, the
per-rank in-place reuse guard of ``Reduce_``, and a resettable health
probe.

Every collective goes through :meth:`World.exchange` and every message
through :meth:`World.p2p_send` / :meth:`World.p2p_recv`.  These two
chokepoints carry what the observability and fault-tolerance packages
hook: the comm tracer (``config.comm_tracer``, ``obs``), the fault plan
(``config.fault_plan``, ``resilience``), retries with capped exponential
backoff (``config.comm_retries`` / ``comm_backoff``) and the integrity
checks an exchange is given (``checks=``).  With none of them on, each
costs one attribute read per call.

Payloads are torch tensors.  Rank threads of one world share one device;
on a CUDA device they all issue on the same stream, which is what makes
handing one thread's tensor to another safe without events.

Below each chokepoint sits its wire (``_exchange_wire``,
``_p2p_send_wire``, ``_on_wire_drop``, ``_p2p_recv_wire``,
``_health_wire``): the only methods a transport replaces.  The process
transport (``transport/``) runs each rank in a worker process whose wire
goes through the parent.
"""

from __future__ import annotations

import inspect
import queue
import threading
import time
from dataclasses import dataclass
from typing import (Any, Callable, Dict, FrozenSet, List, Optional,
                    Sequence, Tuple)

import torch

from . import config as _cfg


class CommError(RuntimeError):
    """Base class for communication-runtime errors."""


class CollectiveMismatchError(CommError):
    """Ranks disagree on which collective (or which parameters) they are
    executing.  MPI would deadlock or corrupt buffers; this raises on
    every rank."""


class DeadlockError(CommError):
    """A rendezvous timed out: the analogue of an MPI hang.  ``arrived``
    is the frozenset of ranks that reached the collective and ``missing``
    the frozenset that never did."""

    def __init__(self, message: str, arrived=None, missing=None):
        super().__init__(message)
        self.arrived: Optional[FrozenSet[int]] = (
            None if arrived is None else frozenset(arrived))
        self.missing: Optional[FrozenSet[int]] = (
            None if missing is None else frozenset(missing))


class RankFailedError(CommError):
    """A rank is known to have died; ``ranks`` names the failed rank(s).
    Surviving ranks raise it too, so every participant of the torn
    collective learns who failed."""

    def __init__(self, message: str, ranks=()):
        super().__init__(message)
        self.ranks: FrozenSet[int] = frozenset(ranks)


class IntegrityError(CommError):
    """A payload failed an integrity guard: a non-finite contribution
    under ``config.comm_finite_guard="raise"``, or a compressed-wire
    checksum mismatch under ``config.comm_wire_checksum``.  ``ranks``
    names the rank(s) whose contribution was corrupt."""

    def __init__(self, message: str, ranks=()):
        super().__init__(message)
        self.ranks: FrozenSet[int] = frozenset(ranks)


class InPlaceReuseError(CommError):
    """A tensor consumed by an in-place collective (``Reduce_``) was
    passed to a later communication op on the same rank."""


class BifurcationError(CommError):
    """A wait handle was waited on twice, or its parts were spliced
    between handles."""


# Request kinds of the non-blocking point-to-point ops.
REQ_ISEND = 1
REQ_IRECV = 2

# What a fault plan's p2p hook returns to swallow a message
# (``resilience`` ``drop_p2p``): the payload waits in the world's dropped
# stash, and a receive that retries gets it redelivered.
_P2P_DROPPED = object()

# Ceiling of one backoff pause: retries extend a wait, they must not turn
# a real deadlock into an unbounded hang.
_BACKOFF_CAP_S = 30.0


def _backoff_pause(attempt: int, backoff: float, base: float) -> float:
    """Length of retry ``attempt``'s patience window: capped exponential
    on ``backoff``, or the base timeout again when backoff is 0.  One
    rule for the rendezvous barrier and the p2p receive."""
    if backoff > 0:
        return min(backoff * (2 ** (attempt - 1)), _BACKOFF_CAP_S)
    return base


@dataclass
class _PendingRequest:
    req_id: int
    kind: int                 # REQ_ISEND / REQ_IRECV
    rank: int                 # owning rank
    peer: int                 # dest (isend) or source (irecv)
    tag: int
    shape: Tuple[int, ...]
    dtype: Any
    fingerprint: int


@dataclass(frozen=True)
class HealthReport:
    """Result of :meth:`World.health_check` (``comm.check_health()``): a
    timeout-bounded attributed barrier probe.  ``ok`` says whether every
    rank answered within the bound, ``arrived``/``missing`` name who did
    and who did not, ``probe_duration_s`` is this caller's wall time in
    the probe, and ``arrival_s`` maps each arrived rank to its arrival
    time after the round's first arrival (a slow rank shows a large
    offset; a dead one is missing).  :meth:`slow_ranks` applies a
    threshold."""
    ok: bool
    size: int
    arrived: FrozenSet[int]
    missing: FrozenSet[int]
    probe_duration_s: float = 0.0
    arrival_s: Optional[Dict[int, float]] = None

    def __bool__(self) -> bool:
        return self.ok

    def slow_ranks(self, threshold_s: float) -> FrozenSet[int]:
        """Arrived ranks whose arrival latency (behind the round's first
        arrival) is at least ``threshold_s``: slow but alive, the gray
        counterpart of ``missing``."""
        if not self.arrival_s:
            return frozenset()
        return frozenset(r for r, dt in self.arrival_s.items()
                         if dt >= threshold_s)


def _fnv1a(parts) -> int:
    """31-bit FNV-1a hash of a request's description: the fingerprint a
    wait-handle descriptor carries and :meth:`World.complete_request`
    checks again."""
    h = 0x811C9DC5
    for ch in "|".join(str(p) for p in parts).encode():
        h ^= ch
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h & 0x7FFFFFFF


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another device (the tests pass ``"cpu"``).  Without CUDA and without
    an explicit request this raises — nothing moves to the CPU because no
    GPU was found."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _BarrierTimeout(Exception):
    """Internal: this thread's barrier wait expired."""

    def __init__(self, arrived: FrozenSet[int], arrive_t=None):
        super().__init__("barrier timeout")
        self.arrived = arrived
        self.arrive_t = dict(arrive_t or {})


class _BarrierBroken(Exception):
    """Internal: another thread broke the barrier (a peer's timeout, or
    ``abort()`` after a rank failure)."""

    def __init__(self, arrived: Optional[FrozenSet[int]] = None,
                 arrive_t=None):
        super().__init__("barrier broken")
        self.arrived = arrived
        self.arrive_t = dict(arrive_t or {})


class _AttributedBarrier:
    """Generation-counted rendezvous barrier that knows who has arrived.

    ``threading.Barrier`` only answers whether everyone arrived in time;
    attribution needs the arrival set of the generation that timed out.
    A timeout breaks the barrier for every waiter, permanently (the world
    is torn), and ``abort()`` breaks it at once.

    ``resettable=True`` (the health probe's barrier) relaxes the
    permanence: once every waiter of a broken round has left, the next
    arrival starts a fresh round, so a failed probe does not fail every
    later probe after the slow rank recovers."""

    def __init__(self, size: int, resettable: bool = False):
        self.size = size
        self.resettable = resettable
        self._cond = threading.Condition()
        self._gen = 0
        self._count = 0
        self._arrived: set = set()
        # Arrival times of the current round, kept for the completed
        # round in _last_arrivals and for a broken one in
        # timeout_arrive_t.
        self._arrive_t: Dict[int, float] = {}
        self._last_arrivals: Dict[int, float] = {}
        self._broken = False
        # Arrival snapshot of the generation that broke: lets the other
        # waiters of that generation attribute the failure too.
        self.timeout_arrived: Optional[FrozenSet[int]] = None
        self.timeout_arrive_t: Dict[int, float] = {}

    def wait(self, rank: int, timeout: float, retries: int = 0,
             backoff: float = 0.0,
             collect_arrivals: Optional[list] = None) -> int:
        """Arrive and wait for the generation to fill; returns the number
        of retry extensions this waiter used (0: the base timeout was
        enough).  Raises :class:`_BarrierTimeout` when the patience (the
        timeout and ``retries`` windows of capped exponential
        ``backoff``) runs out and :class:`_BarrierBroken` when another
        waiter broke the barrier.  ``collect_arrivals`` (a list) receives
        the completed round's arrival times, appended under the lock."""
        with self._cond:
            if self._broken:
                if not self.resettable:
                    raise _BarrierBroken(self.timeout_arrived,
                                         self.timeout_arrive_t)
                # Let the broken round's waiters leave, then start fresh.
                drain_deadline = time.monotonic() + timeout
                while self._broken and self._count > 0:
                    remaining = drain_deadline - time.monotonic()
                    if remaining <= 0:
                        raise _BarrierBroken(self.timeout_arrived,
                                             self.timeout_arrive_t)
                    self._cond.wait(remaining)
                if self._broken:
                    self._broken = False
                    self.timeout_arrived = None
                    self.timeout_arrive_t = {}
                    self._gen += 1
            gen = self._gen
            self._arrived.add(rank)
            self._arrive_t[rank] = time.monotonic()
            self._count += 1
            if self._count == self.size:
                self._last_arrivals = dict(self._arrive_t)
                self._count = 0
                self._arrived = set()
                self._arrive_t = {}
                self._gen += 1
                self._cond.notify_all()
                if collect_arrivals is not None:
                    collect_arrivals.append(dict(self._last_arrivals))
                return 0
            attempt = 0
            deadline = time.monotonic() + timeout
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    if attempt < retries:
                        # One more patience window: a slow rank that
                        # arrives inside it completes the round for all.
                        attempt += 1
                        deadline = time.monotonic() + _backoff_pause(
                            attempt, backoff, timeout)
                        continue
                    arrived = frozenset(self._arrived)
                    self.timeout_arrived = arrived
                    self.timeout_arrive_t = dict(self._arrive_t)
                    self._broken = True
                    self._leave(rank)
                    self._cond.notify_all()
                    raise _BarrierTimeout(arrived, self.timeout_arrive_t)
                self._cond.wait(remaining)
                if self._gen != gen:
                    if collect_arrivals is not None:
                        collect_arrivals.append(dict(self._last_arrivals))
                    return attempt
                if self._broken:
                    self._leave(rank)
                    raise _BarrierBroken(self.timeout_arrived,
                                         self.timeout_arrive_t)

    def _leave(self, rank: int) -> None:
        """Leave a broken round (the caller holds the lock); the last one
        out wakes an arrival waiting to start a fresh round."""
        self._count -= 1
        self._arrived.discard(rank)
        self._arrive_t.pop(rank, None)
        if self._count == 0:
            self._cond.notify_all()

    def abort(self) -> None:
        with self._cond:
            if self.timeout_arrived is None:
                self.timeout_arrived = frozenset(self._arrived)
                self.timeout_arrive_t = dict(self._arrive_t)
            self._broken = True
            self._cond.notify_all()


class World:
    """A set of ``size`` rank threads with rendezvous-based collectives.

    All collectives funnel through :meth:`exchange`: a barrier, an
    all-to-all of per-rank payloads, and a signature agreement check.
    Point-to-point messages go through per-``(src, dst, tag)`` FIFO
    mailboxes (:meth:`p2p_send`, :meth:`p2p_recv`).  ``device``
    (optional) is the device every payload must live on.

    ``retry_events`` counts the retry extensions used by waits that then
    completed, per waiter: one slow rank on an N-rank world can add up to
    ``(N - 1) x retries``."""

    def __init__(self, size: int, timeout: Optional[float] = None,
                 device: Optional[torch.device] = None):
        if size < 1:
            raise ValueError("World size must be >= 1")
        self.size = size
        # Ranks of this world whose threads run in this process (a
        # transport's or a distributed world runs fewer than ``size``).
        self.local_ranks = range(size)
        self.timeout = _cfg.world_timeout() if timeout is None \
            else float(timeout)
        self.device = device
        self._barrier = _AttributedBarrier(size)
        self._health = _AttributedBarrier(size, resettable=True)
        self._slots: List[Any] = [None] * size
        self._sigs: List[Any] = [None] * size
        # Each rank's verdicts on its own deposited payload, one per check
        # of the exchange (see exchange's ``checks``).
        self._verdicts: List[Any] = [()] * size
        self._mailboxes: Dict[Tuple[int, int, int], queue.Queue] = {}
        self._mb_lock = threading.Lock()
        self._req_lock = threading.Lock()
        self._req_counter = 0
        self._pending: Dict[int, _PendingRequest] = {}
        # (rank, id(x)) -> x: the per-rank in-place reuse guard; the
        # strong reference pins the id while it is tracked.
        self._consumed: Dict[Tuple[int, int], Any] = {}
        self._failed = threading.Event()
        self._first_error: Optional[BaseException] = None
        self._err_lock = threading.Lock()
        self._dead: dict = {}
        # Messages a fault plan dropped off the p2p wire, redelivered to
        # a receive that retries (the analogue of a NACK retransmission).
        self._dropped: Dict[Tuple[int, int, int], List[Any]] = {}
        self.retry_events = 0

    # ---------------------------------------------------------------- errors

    def fail(self, exc: BaseException) -> None:
        """Mark the world failed and wake everyone blocked on a barrier."""
        with self._err_lock:
            if self._first_error is None:
                self._first_error = exc
        self._failed.set()
        self._barrier.abort()
        self._health.abort()

    def mark_dead(self, rank: int, exc: BaseException) -> None:
        """Record ``rank`` as permanently failed and tear the world down,
        so blocked peers raise a rank-attributed :class:`RankFailedError`
        instead of waiting out their deadlock timeout."""
        with self._err_lock:
            self._dead[rank] = exc
        self.fail(exc)

    def _rank_failed_error(self, verb: str) -> RankFailedError:
        dead = sorted(self._dead)
        return RankFailedError(
            f"collective {verb}: rank(s) {dead} failed (preempted or "
            "crashed)", ranks=dead)

    def _check_failed(self) -> None:
        if self._failed.is_set():
            if self._dead:
                raise self._rank_failed_error("cannot start") \
                    from next(iter(self._dead.values()))
            raise CommError(
                "communication world already failed on another rank"
            ) from self._first_error

    # ----------------------------------------------------------- collectives

    def exchange(self, rank: int, signature: Tuple, payload: Any,
                 read: Optional[Callable[[List[Any]], Any]] = None,
                 checks: Sequence = ()) -> Any:
        """All ranks deposit ``(signature, payload)``; returns every
        payload in rank order, or ``read(payloads)`` when ``read`` is
        given.  A signature mismatch raises on every rank.

        ``read`` runs before any rank leaves the rendezvous, so whatever
        it takes from other ranks' payloads (a copy, a fold, a
        concatenation) is taken (on the CPU) or queued on the shared
        stream (on the card) before their owners can go on and modify
        them in place.

        ``checks`` are integrity checks (``resilience.guards``): each
        rank runs ``check.ok(payload)`` once on its own payload as
        deposited, after fault injection, and between the barriers every
        rank sees every rank's verdict, so a failure is reported by
        ``check.report(bad_ranks)`` on every rank alike.

        This is the collective chokepoint: with a comm tracer installed
        it records a ``CommEvent``, and a fault plan may delay, kill or
        corrupt this rank's contribution here."""
        tracer = _cfg.comm_tracer()
        if tracer is None:
            return self._exchange(rank, signature, payload, read, checks,
                                  None)
        meter = tracer.begin(self, rank, "exchange", signature, payload)
        try:
            out = self._exchange(rank, signature, payload, read, checks,
                                 meter)
        except BaseException as e:  # noqa: BLE001 — recorded, re-raised
            tracer.commit(meter, error=e)
            raise
        tracer.commit(meter)
        return out

    def _exchange(self, rank: int, signature: Tuple, payload: Any, read,
                  checks, meter) -> Any:
        self._check_failed()
        plan = _cfg.fault_plan()
        if plan is not None:
            payload = plan.on_exchange(self, rank, signature, payload)
        return self._exchange_wire(rank, signature, payload, read, checks,
                                   meter)

    def _exchange_wire(self, rank: int, signature: Tuple, payload: Any,
                       read=None, checks=(), meter=None) -> Any:
        """The rendezvous's wire: everything below the chokepoint's tracer
        and fault hook.  A transport (``mpi4torch_tpu_torch.transport``)
        replaces only this method and its siblings
        (:meth:`_p2p_send_wire`, :meth:`_on_wire_drop`,
        :meth:`_p2p_recv_wire`, :meth:`_health_wire`), so tracing, fault
        injection and retry accounting are the same code on every
        backend."""
        self._sigs[rank] = signature
        self._slots[rank] = payload
        self._verdicts[rank] = tuple(c.ok(payload) for c in checks)
        self._wait_barrier(rank, meter)
        try:
            self._check_sig_agreement(self._sigs)
            for i, check in enumerate(checks):
                bad = [r for r, v in enumerate(self._verdicts) if not v[i]]
                if bad:
                    check.report(bad)
            out = list(self._slots)
            if read is not None:
                out = read(out)
        finally:
            # All readers are done before the slots are reused, and
            # before any owner may modify its payload.
            self._wait_barrier(rank, meter)
        return out

    @staticmethod
    def _check_sig_agreement(sigs) -> None:
        sig0 = sigs[0]
        if any(s != sig0 for s in sigs):
            # Everyone observes the same mismatch, so everyone raises.
            raise CollectiveMismatchError(
                "ranks disagree on the collective being executed: "
                + "; ".join(f"rank {i}: {s}" for i, s in enumerate(sigs)))

    def _count_retries(self, used: int, meter) -> None:
        """Retry bookkeeping of the barrier and the p2p receive: the
        world counter, the ``comm_retry_events_total`` metric and the
        traced operation.  Runs only when a retry rescued a wait."""
        with self._err_lock:
            self.retry_events += used
        if meter is not None:
            meter.add_retries(used)
        from .obs import metrics as _metrics
        _metrics.inc("comm_retry_events_total", used,
                     help="retry extensions consumed by rendezvous/p2p "
                          "waits that eventually completed")

    def _wait_barrier(self, rank: int, meter=None) -> None:
        t0 = time.perf_counter() if meter is not None else 0.0
        try:
            used = self._barrier.wait(rank, self.timeout,
                                      retries=_cfg.comm_retries(),
                                      backoff=_cfg.comm_backoff())
        except _BarrierTimeout as t:
            if self._dead:
                raise self._rank_failed_error("cannot complete") \
                    from next(iter(self._dead.values()))
            raise self._deadlock_error(t.arrived) from None
        except _BarrierBroken as b:
            if self._dead:
                raise self._rank_failed_error("aborted") \
                    from next(iter(self._dead.values()))
            if self._first_error is not None:
                raise CommError(
                    "collective aborted because another rank failed"
                ) from self._first_error
            raise self._deadlock_error(b.arrived) from None
        if meter is not None:
            # Time blocked on peers; the event's duration minus this is
            # the rank's own local latency, the gray-failure signal.
            meter.add_wait(time.perf_counter() - t0)
        if used:
            self._count_retries(used, meter)

    def _deadlock_error(self, arrived: Optional[FrozenSet[int]]
                        ) -> DeadlockError:
        arrived = frozenset() if arrived is None else arrived
        missing = frozenset(range(self.size)) - arrived
        return DeadlockError(
            f"collective rendezvous timed out after {self.timeout}s — a "
            "rank did not reach the matching collective (every rank must "
            "execute the same communication sequence).  Ranks "
            f"{sorted(arrived)} arrived; ranks {sorted(missing)} did not",
            arrived=arrived, missing=missing)

    # ----------------------------------------------------------- health

    def health_check(self, rank: int,
                     timeout: Optional[float] = None) -> HealthReport:
        """Timeout-bounded attributed barrier probe: ``ok`` iff every rank
        answered within ``timeout`` (default: the world timeout).  It runs
        on its own resettable barrier, so a failed probe reports who
        arrived and who is missing without tearing the collective
        rendezvous, and once its round has drained the next probe starts
        fresh: a recovered rank reads ``ok`` again.  Every live rank must
        call it, like any barrier."""
        timeout = self.timeout if timeout is None else float(timeout)
        everyone = frozenset(range(self.size))
        t0 = time.monotonic()
        ok, arrived, arrive_t = self._health_wire(rank, timeout)
        from .obs import metrics as _metrics
        _metrics.inc(
            f'comm_health_probes_total{{result="{"ok" if ok else "failed"}"}}',
            help="health_check barrier probes by outcome")
        arrival_s: Dict[int, float] = {}
        if arrive_t:
            first = min(arrive_t.values())
            arrival_s = {r: t - first for r, t in arrive_t.items()
                         if r in arrived}
        return HealthReport(ok, self.size, frozenset(arrived),
                            everyone - frozenset(arrived),
                            probe_duration_s=time.monotonic() - t0,
                            arrival_s=arrival_s)

    def _health_wire(self, rank: int, timeout: float):
        """The health probe's wire (a transport seam, like
        :meth:`_exchange_wire`): ``(ok, arrived, arrive_t)`` of one round
        of the resettable barrier."""
        arrivals: List[Dict[int, float]] = []
        try:
            self._health.wait(rank, timeout, collect_arrivals=arrivals)
        except (_BarrierTimeout, _BarrierBroken) as e:
            arrived = frozenset() if e.arrived is None else e.arrived
            return False, arrived, e.arrive_t
        return (True, frozenset(range(self.size)),
                arrivals[0] if arrivals else {})

    # -------------------------------------------------------------- p2p

    def _mailbox(self, src: int, dst: int, tag: int) -> queue.Queue:
        key = (src, dst, tag)
        with self._mb_lock:
            q = self._mailboxes.get(key)
            if q is None:
                q = queue.Queue()
                self._mailboxes[key] = q
            return q

    def p2p_send(self, src: int, dst: int, tag: int, payload: Any) -> None:
        """Buffered send: never blocks.  Messages of one ``(src, dst,
        tag)`` arrive in the order they were sent.  The p2p send
        chokepoint: traced like :meth:`exchange`, and a fault plan may
        delay, kill, corrupt or drop the message here."""
        tracer = _cfg.comm_tracer()
        if tracer is None:
            return self._p2p_send(src, dst, tag, payload)
        meter = tracer.begin(self, src, "p2p_send", ("p2p_send", tag),
                             payload, peer=dst, tag=tag)
        try:
            self._p2p_send(src, dst, tag, payload)
        except BaseException as e:  # noqa: BLE001 — recorded, re-raised
            tracer.commit(meter, error=e)
            raise
        tracer.commit(meter)

    def _p2p_send(self, src: int, dst: int, tag: int, payload: Any) -> None:
        self._check_failed()
        if not (0 <= dst < self.size):
            raise CommError(f"invalid destination rank {dst} (size "
                            f"{self.size})")
        plan = _cfg.fault_plan()
        if plan is not None:
            payload = plan.on_p2p_send(self, src, dst, tag, payload)
            if payload is _P2P_DROPPED:
                # The plan stashed the payload in this world's _dropped;
                # a transport moves it to where its receives redeliver.
                self._on_wire_drop(src, dst, tag)
                return
        self._p2p_send_wire(src, dst, tag, payload)

    def _p2p_send_wire(self, src: int, dst: int, tag: int,
                       payload: Any) -> None:
        """The p2p send's wire (a transport seam, like
        :meth:`_exchange_wire`)."""
        self._mailbox(src, dst, tag).put(payload)

    def _on_wire_drop(self, src: int, dst: int, tag: int) -> None:
        """Called after a fault plan dropped a message.  On rank threads
        the payload already waits in ``_dropped``, where a retrying
        receive redelivers it from."""

    def p2p_recv(self, src: int, dst: int, tag: int) -> Any:
        """Blocking receive with the deadlock timeout.  A dead ``src``
        raises a :class:`RankFailedError` naming it; no message within
        the world timeout raises :class:`DeadlockError`.  With
        ``config.comm_retries`` set, an empty wait retries with capped
        exponential backoff, first asking for redelivery of a message a
        fault plan dropped.  The p2p receive chokepoint: traced like
        :meth:`exchange`, with the received bytes."""
        tracer = _cfg.comm_tracer()
        if tracer is None:
            return self._p2p_recv(src, dst, tag, None)
        meter = tracer.begin(self, dst, "p2p_recv", ("p2p_recv", tag),
                             None, peer=src, tag=tag)
        try:
            out = self._p2p_recv(src, dst, tag, meter)
        except BaseException as e:  # noqa: BLE001 — recorded, re-raised
            tracer.commit(meter, error=e)
            raise
        tracer.commit(meter, result_payload=out)
        return out

    def _p2p_recv(self, src: int, dst: int, tag: int, meter) -> Any:
        if not (0 <= src < self.size):
            raise CommError(f"invalid source rank {src} (size {self.size})")
        return self._p2p_recv_wire(src, dst, tag, meter)

    def _p2p_recv_wire(self, src: int, dst: int, tag: int, meter) -> Any:
        """The p2p receive's wire (a transport seam, like
        :meth:`_exchange_wire`): the blocking wait, the retry windows and
        the redelivery of a dropped message."""
        q = self._mailbox(src, dst, tag)
        retries = _cfg.comm_retries()
        backoff = _cfg.comm_backoff()
        attempt = 0
        deadline = time.monotonic() + self.timeout
        while True:
            # The sender-specific check comes first: it says which peer
            # this receive was waiting on.
            if src in self._dead:
                raise RankFailedError(
                    f"receive (src={src}, dst={dst}, tag={tag}) cannot "
                    f"complete: rank {src} failed", ranks=(src,)
                ) from self._dead[src]
            self._check_failed()
            try:
                return q.get(timeout=0.05)
            except queue.Empty:
                if time.monotonic() > deadline:
                    if attempt < retries:
                        attempt += 1
                        if self._redeliver_dropped(src, dst, tag):
                            self._count_retries(1, meter)
                        deadline = time.monotonic() + _backoff_pause(
                            attempt, backoff, self.timeout)
                        continue
                    with self._mb_lock:
                        dropped = bool(self._dropped.get((src, dst, tag)))
                    raise DeadlockError(
                        f"receive (src={src}, dst={dst}, tag={tag}) timed "
                        f"out after {self.timeout}s — the matching send was "
                        "never posted" + (
                            " (a fault-injected drop consumed the message "
                            "and config.comm_retries is exhausted or unset)"
                            if dropped else "")) from None

    def _redeliver_dropped(self, src: int, dst: int, tag: int) -> bool:
        """Move one dropped message back onto its mailbox."""
        with self._mb_lock:
            stash = self._dropped.get((src, dst, tag))
            if not stash:
                return False
            payload = stash.pop(0)
        self._mailbox(src, dst, tag).put(payload)
        return True

    # --------------------------------------------------------- requests

    def new_request(self, kind: int, rank: int, peer: int, tag: int,
                    shape: Tuple[int, ...], dtype: Any) -> _PendingRequest:
        """Post a non-blocking request and return it with its id and
        fingerprint."""
        with self._req_lock:
            self._req_counter += 1
            rid = self._req_counter
        fp = _fnv1a((rid, kind, peer, tag, tuple(shape), str(dtype)))
        req = _PendingRequest(rid, kind, rank, peer, tag, tuple(shape),
                              dtype, fp)
        with self._req_lock:
            self._pending[rid] = req
        return req

    def complete_request(self, req_id: int, shape: Tuple[int, ...],
                         dtype: Any) -> _PendingRequest:
        """Pop a pending request; an unknown or already completed one, or
        a handle whose buffer does not match the posted request, raises
        :class:`BifurcationError`."""
        with self._req_lock:
            req = self._pending.pop(req_id, None)
        if req is None:
            raise BifurcationError(
                f"Detected bifurcation in Wait handle usage: request "
                f"{req_id} is unknown or was already waited on (a WaitHandle "
                "must be waited on exactly once, and its parts must not be "
                "swapped between handles)")
        if tuple(shape) != req.shape or dtype != req.dtype:
            with self._req_lock:
                self._pending[req_id] = req
            raise BifurcationError(
                "Detected bifurcation in Wait handle usage: the buffer in the "
                f"handle (shape {tuple(shape)}, dtype {dtype}) does not match "
                f"the posted request (shape {req.shape}, dtype {req.dtype})")
        return req

    # ------------------------------------------------ in-place reuse guard

    # Bound on the guard table: the oldest entries go first (dropping one
    # only weakens detection for that old tensor).
    _CONSUMED_CAP = 4096

    def mark_consumed(self, rank: int, x: Any) -> None:
        """Record ``x`` as consumed by an in-place collective on
        ``rank``: later communication ops on that rank reject it.  Keyed
        per rank, since rank threads share one process."""
        with self._req_lock:
            self._consumed[(rank, id(x))] = x
            while len(self._consumed) > self._CONSUMED_CAP:
                self._consumed.pop(next(iter(self._consumed)))

    def check_not_consumed(self, rank: int, *tensors: Any) -> None:
        for t in tensors:
            if (rank, id(t)) in self._consumed:
                raise InPlaceReuseError(
                    "Reuse of variables passed to in-place MPI kernels is "
                    "not supported: this tensor was consumed by Reduce_ — "
                    "use its return value instead")


@dataclass
class RankContext:
    """Binds the current thread to (world, rank)."""
    world: World
    rank: int


_tls = threading.local()


def current_rank_context() -> Optional[RankContext]:
    return getattr(_tls, "ctx", None)


class _bind_rank:
    def __init__(self, ctx: RankContext):
        self.ctx = ctx

    def __enter__(self):
        self.prev = getattr(_tls, "ctx", None)
        _tls.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        _tls.ctx = self.prev
        return False


# A default single-rank world, so that user scripts work without any
# launcher, like an MPI program run without mpirun (world size 1).
_default_world = World(1)
_default_ctx = RankContext(_default_world, 0)


def effective_rank_context() -> RankContext:
    ctx = current_rank_context()
    return ctx if ctx is not None else _default_ctx


def _fn_nparams(fn: Callable) -> int:
    """Required positional parameters of ``fn``: decides ``fn()`` versus
    ``fn(rank)``."""
    try:
        return len([
            p for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            and p.default is p.empty
        ])
    except (TypeError, ValueError):
        return 0


def _raise_primary(errors: List[Optional[BaseException]],
                   first_error: Optional[BaseException]) -> None:
    """Re-raise the root-cause per-rank error with the other ranks'
    failures attached as a note."""
    failed = [(r, e) for r, e in enumerate(errors) if e is not None]
    if not failed:
        return
    primary = first_error
    if primary is None or primary not in errors:
        primary = failed[0][1]
    secondary = [(r, e) for r, e in failed if e is not primary]
    if secondary:
        primary.add_note(
            "other rank failures: "
            + "; ".join(f"rank {r}: {type(e).__name__}: {e}"
                        for r, e in secondary))
    raise primary


def run_rank_threads(world: World, body: Callable[[int], None]) -> None:
    """Run ``body(rank)`` on one thread per rank of ``world`` that runs in
    this process (``world.local_ranks``) and join them.  A rank that raises fails the world (so its peers' rendezvous
    end) and tells the comm tracer; after every thread has ended the
    root-cause error is re-raised, the others attached as a note."""
    errors: List[Optional[BaseException]] = [None] * world.size

    def worker(rank: int):
        try:
            body(rank)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[rank] = e
            tracer = _cfg.comm_tracer()
            if tracer is not None:
                # The flight recorder also sees failures raised away
                # from the chokepoints (a guard after a rendezvous).
                tracer.note_rank_failure(world, rank, e)
            world.fail(e)

    threads = [threading.Thread(target=worker, args=(r,), name=f"rank{r}")
               for r in world.local_ranks]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    _raise_primary(errors, world._first_error)


def run_ranks(fn: Callable, nranks: int, timeout: Optional[float] = None,
              return_results: bool = True, backend: Optional[str] = None,
              device=None) -> List[Any]:
    """Run ``fn`` on ``nranks`` ranks — the ``mpirun -np N`` analogue.

    ``fn`` is called as ``fn()`` or ``fn(rank)``.  Inside it,
    ``COMM_WORLD`` resolves to this world with a concrete integer rank.
    ``device`` is the world's device (CUDA unless the caller passes
    ``"cpu"``; see :func:`resolve_device`): every rank makes it its
    current device, and collective payloads must live on it.
    ``timeout`` is the deadlock-detection wall clock (``None``: the
    ``MPI4TORCH_TPU_WORLD_TIMEOUT`` environment variable, else 60 s).

    ``backend`` picks the transport (``mpi4torch_tpu_torch.transport``):
    ``"thread"``, N rank threads in this process, or ``"process"``, N
    pooled worker processes, each with its own interpreter, CUDA context
    and stream, whose rendezvous runs through this process.  ``None``
    defers to ``config.comm_transport()`` (the ``MPI4TORCH_TPU_TRANSPORT``
    environment variable, else ``"thread"``).  Results are bitwise the
    same on both.

    Every backward pass inside ``fn`` runs on its rank's thread (CUDA
    included), so differentiating through collectives works on one card.
    The first per-rank exception is re-raised after every rank has
    ended, with the other ranks' failures attached as a note."""
    name = backend if backend is not None else _cfg.comm_transport()
    if name != "thread":
        from .transport import get_transport

        return get_transport(name).run_ranks(
            fn, nranks, timeout=timeout, return_results=return_results,
            device=device)
    dev = resolve_device(device)
    world = World(nranks, timeout=timeout, device=dev)
    results: List[Any] = [None] * nranks
    nparams = _fn_nparams(fn)

    def body(rank: int):
        # Backward passes run on this rank's own thread.  By default
        # autograd runs a CUDA backward on one worker thread per device,
        # where the ranks' blocking backward collectives would queue
        # behind each other and deadlock; the flag is thread-local, so
        # nothing outside the rank threads changes.
        with _bind_rank(RankContext(world, rank)), \
                torch.autograd.set_multithreading_enabled(False):
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            results[rank] = fn(rank) if nparams >= 1 else fn()

    run_rank_threads(world, body)
    return results if return_results else []
