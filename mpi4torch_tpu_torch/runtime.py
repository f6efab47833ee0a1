"""Rank-thread eager runtime: the ``mpirun -np N`` analogue.

Port of the thread backend of ``mpi4torch_tpu/runtime.py``: N Python
threads, each running the per-rank function with a concrete integer rank,
where every collective is a rendezvous of all threads with a signature
check.  It is stricter than MPI: ranks that disagree on the collective
raise :class:`CollectiveMismatchError` on every rank, and a rank that
never arrives raises :class:`DeadlockError` naming who arrived and who
did not.

Payloads are torch tensors.  Rank threads of one world share one device;
on a CUDA device they all issue on the same stream, which is what makes
handing one thread's tensor to another safe without events.
"""

from __future__ import annotations

import inspect
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, FrozenSet, List, Optional, Tuple

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

    def __init__(self, arrived: FrozenSet[int]):
        super().__init__("barrier timeout")
        self.arrived = arrived


class _BarrierBroken(Exception):
    """Internal: another thread broke the barrier (a peer's timeout, or
    ``abort()`` after a rank failure)."""

    def __init__(self, arrived: Optional[FrozenSet[int]] = None):
        super().__init__("barrier broken")
        self.arrived = arrived


class _AttributedBarrier:
    """Generation-counted rendezvous barrier that knows who has arrived.

    ``threading.Barrier`` only answers whether everyone arrived in time;
    attribution needs the arrival set of the generation that timed out.
    A timeout breaks the barrier for every waiter, permanently (the world
    is torn), and ``abort()`` breaks it at once."""

    def __init__(self, size: int):
        self.size = size
        self._cond = threading.Condition()
        self._gen = 0
        self._count = 0
        self._arrived: set = set()
        self._broken = False
        # Arrival snapshot of the generation that broke: lets the other
        # waiters of that generation attribute the failure too.
        self.timeout_arrived: Optional[FrozenSet[int]] = None

    def wait(self, rank: int, timeout: float) -> None:
        with self._cond:
            if self._broken:
                raise _BarrierBroken(self.timeout_arrived)
            gen = self._gen
            self._arrived.add(rank)
            self._count += 1
            if self._count == self.size:
                self._count = 0
                self._arrived = set()
                self._gen += 1
                self._cond.notify_all()
                return
            deadline = time.monotonic() + timeout
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    arrived = frozenset(self._arrived)
                    self.timeout_arrived = arrived
                    self._broken = True
                    self._cond.notify_all()
                    raise _BarrierTimeout(arrived)
                self._cond.wait(remaining)
                if self._gen != gen:
                    return
                if self._broken:
                    raise _BarrierBroken(self.timeout_arrived)

    def abort(self) -> None:
        with self._cond:
            if self.timeout_arrived is None:
                self.timeout_arrived = frozenset(self._arrived)
            self._broken = True
            self._cond.notify_all()


class World:
    """A set of ``size`` rank threads with rendezvous-based collectives.

    All collectives funnel through :meth:`exchange`: a barrier, an
    all-to-all of per-rank payloads, and a signature agreement check.
    ``device`` (optional) is the device every payload must live on."""

    def __init__(self, size: int, timeout: Optional[float] = None,
                 device: Optional[torch.device] = None):
        if size < 1:
            raise ValueError("World size must be >= 1")
        self.size = size
        self.timeout = _cfg.world_timeout() if timeout is None \
            else float(timeout)
        self.device = device
        self._barrier = _AttributedBarrier(size)
        self._slots: List[Any] = [None] * size
        self._sigs: List[Any] = [None] * size
        self._failed = threading.Event()
        self._first_error: Optional[BaseException] = None
        self._err_lock = threading.Lock()
        self._dead: dict = {}

    # ---------------------------------------------------------------- errors

    def fail(self, exc: BaseException) -> None:
        """Mark the world failed and wake everyone blocked on a barrier."""
        with self._err_lock:
            if self._first_error is None:
                self._first_error = exc
        self._failed.set()
        self._barrier.abort()

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

    def exchange(self, rank: int, signature: Tuple, payload: Any
                 ) -> List[Any]:
        """All ranks deposit ``(signature, payload)``; returns every
        payload in rank order.  A signature mismatch raises on every
        rank."""
        self._check_failed()
        return self._exchange_wire(rank, signature, payload)

    def _exchange_wire(self, rank: int, signature: Tuple,
                       payload: Any) -> List[Any]:
        self._sigs[rank] = signature
        self._slots[rank] = payload
        self._wait_barrier(rank)
        self._check_sig_agreement(self._sigs)
        out = list(self._slots)
        # All readers are done before the slots are reused.
        self._wait_barrier(rank)
        return out

    @staticmethod
    def _check_sig_agreement(sigs) -> None:
        sig0 = sigs[0]
        if any(s != sig0 for s in sigs):
            # Everyone observes the same mismatch, so everyone raises.
            raise CollectiveMismatchError(
                "ranks disagree on the collective being executed: "
                + "; ".join(f"rank {i}: {s}" for i, s in enumerate(sigs)))

    def _wait_barrier(self, rank: int) -> None:
        try:
            self._barrier.wait(rank, self.timeout)
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


def run_ranks(fn: Callable, nranks: int, timeout: Optional[float] = None,
              return_results: bool = True, backend: Optional[str] = None,
              device=None) -> List[Any]:
    """Run ``fn`` on ``nranks`` rank threads — the ``mpirun -np N``
    analogue.

    ``fn`` is called as ``fn()`` or ``fn(rank)``.  Inside it,
    ``COMM_WORLD`` resolves to this world with a concrete integer rank.
    ``device`` is the world's device (CUDA unless the caller passes
    ``"cpu"``; see :func:`resolve_device`): every rank thread makes it
    its current device, and collective payloads must live on it.
    ``timeout`` is the deadlock-detection wall clock (``None``: the
    ``MPI4TORCH_TPU_WORLD_TIMEOUT`` environment variable, else 60 s).
    Every backward pass inside ``fn`` runs on its rank's thread (CUDA
    included), so differentiating through collectives works on one card.
    The first per-rank exception is re-raised after every thread has
    been joined, with the other ranks' failures attached as a note."""
    if backend not in (None, "thread"):
        raise NotImplementedError(
            f"backend={backend!r}: only rank threads exist in this package; "
            "the multi-process transport is not ported yet (ROADMAP.md, "
            "Queue 1 item 2)")
    dev = resolve_device(device)
    world = World(nranks, timeout=timeout, device=dev)
    results: List[Any] = [None] * nranks
    errors: List[Optional[BaseException]] = [None] * nranks
    nparams = _fn_nparams(fn)

    def worker(rank: int):
        # Backward passes run on this rank's own thread.  By default
        # autograd runs a CUDA backward on one worker thread per device,
        # where the ranks' blocking backward collectives would queue
        # behind each other and deadlock; the flag is thread-local, so
        # nothing outside the rank threads changes.
        with _bind_rank(RankContext(world, rank)), \
                torch.autograd.set_multithreading_enabled(False):
            try:
                if dev.type == "cuda":
                    torch.cuda.set_device(dev)
                results[rank] = fn(rank) if nparams >= 1 else fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors[rank] = e
                world.fail(e)

    threads = [threading.Thread(target=worker, args=(r,), name=f"rank{r}")
               for r in range(nranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    _raise_primary(errors, world._first_error)
    return results if return_results else []
