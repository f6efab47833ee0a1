"""The process transport: real worker processes behind the chokepoints.

Port of ``mpi4torch_tpu/transport/process.py``.  One ``run_ranks`` call:

* the parent leases N pooled workers (pool.py) and ships each a ``run``
  frame: the rank body (by value, _ship.py), the world's device, the
  process state (``config.snapshot_process_state``: the configuration
  and torch's numeric state), the fault plan's specs and counters and
  the tracer's ring size;
* each worker runs the body against a ``World`` whose ``*_wire`` seams
  forward to the parent over the framed socket (wire.py); everything
  above the seams (tracer, fault hooks, retry accounting, signature and
  integrity checks, the ``read`` of an exchange) is inherited runtime
  code running in the worker;
* the parent's **switchboard** is the rendezvous.  It collects the
  exchange deposits and answers every rank in one round trip with every
  rank's payload, signature and integrity verdicts (N payloads in, N^2
  out per rendezvous), keeps the p2p mailboxes, the parked receives and
  the stash of dropped messages, runs the health rounds, and enforces
  every waiter's patience (timeout plus retry windows) from a janitor
  thread, with the same typed, attributed errors the rank threads'
  barrier gives.  It moves payloads as :class:`~.wire.Packed` bytes and
  never unpickles one;
* a reader thread per worker is also its reaper: a ``dying`` frame (a
  fault-injected death ships its evidence, then the worker SIGKILLs
  itself) or an EOF (a real kill) marks the rank dead and fails its
  parked peers with its name;
* at the end the parent merges each worker's epilogue (fired faults,
  per-rank fault counters, preemption notices, trace events and
  postmortems) into the parent's plan and tracer, so they read as they
  do on threads, and unpacks the results onto the world's device.

``ProcessTransport.last_stats`` keeps the last run's wire census: the
rendezvous, messages and payload bytes into and out of the parent.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import _ship
from .base import Transport
from .pool import Worker, shared_pool
from .wire import Packed, WireError, recv_frame, unpack

__all__ = ["ProcessTransport"]

_TICK_S = 0.02

# Replies carrying at least this many payload bytes go out to their
# workers in parallel (one thread a worker; each send releases the GIL):
# a rendezvous's n^2 payloads otherwise leave through one socket at a
# time.  Below it a thread a reply costs more than it saves.  On an H100
# host (tools/transport_numbers.py) the serial flush was 1.1-1.9x faster
# for an 8-byte Allreduce on 2 and 4 ranks, the parallel one 1.7-2.8x
# faster for 4 x 2^24 float32; the crossover between is not measured.
_PARALLEL_FLUSH_BYTES = 1 << 20


class _XWait:
    """One parked exchange waiter: its arrival and its patience."""

    __slots__ = ("arrival", "timeout", "retries", "backoff", "patience")

    def __init__(self, arrival, timeout, retries, backoff):
        from ..runtime import _backoff_pause
        self.arrival = arrival
        self.timeout = timeout
        self.retries = retries
        self.backoff = backoff
        self.patience = timeout + sum(
            _backoff_pause(k, backoff, timeout)
            for k in range(1, retries + 1))


class _RWait:
    """One parked p2p receive and its chain of retry windows."""

    __slots__ = ("rank", "key", "timeout", "retries", "backoff",
                 "attempt", "deadline")

    def __init__(self, rank, key, timeout, retries, backoff):
        self.rank = rank
        self.key = key
        self.timeout = timeout
        self.retries = retries
        self.backoff = backoff
        self.attempt = 0
        self.deadline = time.monotonic() + timeout


def _used_windows(elapsed: float, timeout: float, retries: int,
                  backoff: float) -> int:
    """The retry windows a waiter that blocked ``elapsed`` seconds used:
    the parent's mirror of the rank threads' barrier accounting."""
    from ..runtime import _backoff_pause
    if retries <= 0 or elapsed <= timeout:
        return 0
    acc, used = timeout, 0
    while used < retries and elapsed > acc:
        used += 1
        acc += _backoff_pause(used, backoff, timeout)
    return used


class _Switchboard:
    """The parent's rendezvous state of one process-backend world.

    Every method changes state under one lock and returns the frames to
    send, which go out after the lock is released (a reply to one worker
    is never held up by another's).  It is also the world the parent's
    tracer keys the run's events and postmortems on (it has a ``size``,
    which is all the tracer reads).
    """

    def __init__(self, size: int, timeout: float, workers: List[Worker],
                 on_preempt: Optional[Callable[[int, int], None]] = None):
        self.size = size
        self.timeout = timeout
        self._workers = workers
        self._on_preempt = on_preempt
        self._lock = threading.Lock()
        # the exchange round
        self._x_sigs: Dict[int, Any] = {}
        self._x_pay: Dict[int, Packed] = {}
        self._x_verdicts: Dict[int, tuple] = {}
        self._x_wait: Dict[int, _XWait] = {}
        self._x_broken: Optional[BaseException] = None
        # p2p
        self._mail: Dict[Tuple[int, int, int], List[Packed]] = {}
        self._dropped: Dict[Tuple[int, int, int], List[Packed]] = {}
        self._recv_wait: Dict[Tuple[int, int, int], List[_RWait]] = {}
        # the health round
        self._h_arrive: Dict[int, float] = {}
        self._h_wait: Dict[int, Tuple[float, float]] = {}
        # failures
        self._dead: Dict[int, BaseException] = {}
        self._failed = False
        self.first_error: Optional[BaseException] = None
        # the wire census (last_stats)
        self.stats = {"rendezvous": 0, "messages": 0, "payload_bytes_in": 0,
                      "payload_bytes_out": 0}

    # -------------------------------------------------------- messaging

    def _flush(self, sends: List[Tuple[int, dict]]) -> None:
        big = sum(p.nbytes for _, f in sends
                  for p in f.get("payloads", ())) >= _PARALLEL_FLUSH_BYTES
        if len(sends) > 1 and big:
            threads = [threading.Thread(target=self._send, args=s)
                       for s in sends]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            for rank, frame in sends:
                self._send(rank, frame)

    def _send(self, rank: int, frame: dict) -> None:
        try:
            self._workers[rank].send(frame)
        except OSError:
            # The addressee died after it parked; its reader thread
            # attributes the death.
            pass

    @staticmethod
    def _ok(rank: int, **kw) -> Tuple[int, dict]:
        return rank, {"kind": "reply", "ok": True, **kw}

    @staticmethod
    def _err(rank: int, error: BaseException) -> Tuple[int, dict]:
        return rank, {"kind": "reply", "ok": False, "error": error}

    # ----------------------------------------------------------- errors
    # The messages are runtime.World's: a survivor reads the same
    # attribution on every backend.

    def _already_failed_error(self) -> BaseException:
        from ..runtime import CommError, RankFailedError
        if self._dead:
            dead = sorted(self._dead)
            return RankFailedError(
                f"collective cannot start: rank(s) {dead} failed "
                "(preempted or crashed)", ranks=dead)
        return CommError(
            "communication world already failed on another rank")

    def _rank_failed_error(self, verb: str) -> BaseException:
        from ..runtime import RankFailedError
        dead = sorted(self._dead)
        return RankFailedError(
            f"collective {verb}: rank(s) {dead} failed (preempted or "
            "crashed)", ranks=dead)

    def _deadlock_error(self, arrived) -> BaseException:
        from ..runtime import DeadlockError
        arrived = frozenset(arrived)
        missing = frozenset(range(self.size)) - arrived
        return DeadlockError(
            f"collective rendezvous timed out after {self.timeout}s — a "
            "rank did not reach the matching collective (every rank must "
            "execute the same communication sequence).  Ranks "
            f"{sorted(arrived)} arrived; ranks {sorted(missing)} did not",
            arrived=arrived, missing=missing)

    @staticmethod
    def _recv_dead_src_error(src, dst, tag) -> BaseException:
        from ..runtime import RankFailedError
        return RankFailedError(
            f"receive (src={src}, dst={dst}, tag={tag}) cannot "
            f"complete: rank {src} failed", ranks=(src,))

    def _recv_timeout_error(self, key) -> BaseException:
        from ..runtime import DeadlockError
        src, dst, tag = key
        dropped = bool(self._dropped.get(key))
        return DeadlockError(
            f"receive (src={src}, dst={dst}, tag={tag}) timed "
            f"out after {self.timeout}s — the matching send was "
            "never posted" + (
                " (a fault-injected drop consumed the message "
                "and config.comm_retries is exhausted or unset)"
                if dropped else ""))

    # --------------------------------------------------------- dispatch

    def handle_op(self, f: dict) -> None:
        grace = f.get("preempt")
        if grace is not None and self._on_preempt is not None:
            self._on_preempt(f["rank"], grace)
        sends: List[Tuple[int, dict]] = []
        with self._lock:
            op = f["op"]
            if op == "exchange":
                self._op_exchange(f, sends)
            elif op == "p2p_send":
                self._op_send(f, sends)
            elif op == "drop_stash":
                key = (f["src"], f["dst"], f["tag"])
                self._dropped.setdefault(key, []).append(f["payload"])
            elif op == "p2p_recv":
                self._op_recv(f, sends)
            elif op == "health":
                self._op_health(f, sends)
            else:
                from ..runtime import CommError
                sends.append(self._err(
                    f["rank"], CommError(f"unknown transport op {op!r}")))
        self._flush(sends)

    # --------------------------------------------------------- exchange

    def _op_exchange(self, f: dict, sends) -> None:
        r = f["rank"]
        if self._failed:
            sends.append(self._err(r, self._already_failed_error()))
            return
        if self._x_broken is not None:
            # A peer's timeout tore the rendezvous: a late arrival reads
            # the same attribution (the broken barrier on threads).
            sends.append(self._err(r, self._x_broken))
            return
        self._x_sigs[r] = f["signature"]
        self._x_pay[r] = f["payload"]
        self._x_verdicts[r] = f["verdicts"]
        self._x_wait[r] = _XWait(time.monotonic(), f["timeout"],
                                 f["retries"], f["backoff"])
        self.stats["payload_bytes_in"] += f["payload"].nbytes
        if len(self._x_wait) == self.size:
            self._complete_exchange(sends)

    def _complete_exchange(self, sends) -> None:
        n = self.size
        sigs = [self._x_sigs[i] for i in range(n)]
        pays = [self._x_pay[i] for i in range(n)]
        verdicts = [self._x_verdicts[i] for i in range(n)]
        now = time.monotonic()
        for r, w in self._x_wait.items():
            used = _used_windows(now - w.arrival, w.timeout,
                                 w.retries, w.backoff)
            sends.append(self._ok(r, sigs=sigs, payloads=pays,
                                  verdicts=verdicts, retries_used=used))
        self.stats["rendezvous"] += 1
        self.stats["payload_bytes_out"] += n * sum(p.nbytes for p in pays)
        self._clear_exchange()

    def _clear_exchange(self) -> None:
        self._x_wait.clear()
        self._x_sigs.clear()
        self._x_pay.clear()
        self._x_verdicts.clear()

    # -------------------------------------------------------------- p2p

    def _deliver(self, rank: int, payload: Packed, used: int, sends):
        self.stats["messages"] += 1
        self.stats["payload_bytes_out"] += payload.nbytes
        sends.append(self._ok(rank, payload=payload, retries_used=used))

    def _op_send(self, f: dict, sends) -> None:
        key = (f["src"], f["dst"], f["tag"])
        self.stats["payload_bytes_in"] += f["payload"].nbytes
        parked = self._recv_wait.get(key)
        if parked:
            p = parked.pop(0)
            if not parked:
                del self._recv_wait[key]
            self._deliver(p.rank, f["payload"], 0, sends)
        else:
            self._mail.setdefault(key, []).append(f["payload"])

    def _op_recv(self, f: dict, sends) -> None:
        r = f["rank"]
        key = (f["src"], f["dst"], f["tag"])
        # The dead-source attribution comes before the world check: the
        # rank threads' receive loop has that order.
        if f["src"] in self._dead:
            sends.append(self._err(r, self._recv_dead_src_error(*key)))
            return
        if self._failed:
            sends.append(self._err(r, self._already_failed_error()))
            return
        box = self._mail.get(key)
        if box:
            payload = box.pop(0)
            if not box:
                del self._mail[key]
            self._deliver(r, payload, 0, sends)
            return
        self._recv_wait.setdefault(key, []).append(
            _RWait(r, key, f["timeout"], f["retries"], f["backoff"]))

    # ------------------------------------------------------------ health

    def _op_health(self, f: dict, sends) -> None:
        r = f["rank"]
        now = time.monotonic()
        self._h_arrive[r] = now
        self._h_wait[r] = (now, f["timeout"])
        if len(self._h_wait) == self.size:
            arrive_t = dict(self._h_arrive)
            for rr in self._h_wait:
                sends.append(self._ok(rr, healthy=True,
                                      arrived=sorted(arrive_t),
                                      arrive_t=arrive_t))
            self._h_wait.clear()
            self._h_arrive.clear()

    def _fail_health_round(self, sends) -> None:
        """Report the current probe round failed to every waiter, with
        its arrivals; the round then starts afresh (resettable)."""
        arrive_t = dict(self._h_arrive)
        arrived = sorted(arrive_t)
        for rr in self._h_wait:
            sends.append(self._ok(rr, healthy=False, arrived=arrived,
                                  arrive_t=arrive_t))
        self._h_wait.clear()
        self._h_arrive.clear()

    # ----------------------------------------------------- failure paths

    def rank_died(self, rank: int, exc: BaseException) -> None:
        """The reaper: a worker SIGKILLed itself (a ``dying`` frame), was
        killed for real (EOF), or crashed.  Attribute it and wake every
        parked peer, as ``World.mark_dead`` does on threads."""
        sends: List[Tuple[int, dict]] = []
        with self._lock:
            self._dead[rank] = exc
            self._failed = True
            if self.first_error is None:
                self.first_error = exc
            err = self._rank_failed_error("aborted")
            for r in self._x_wait:
                if r != rank:
                    sends.append(self._err(r, err))
            self._clear_exchange()
            for key, parked in self._recv_wait.items():
                for p in parked:
                    if p.rank == rank:
                        continue
                    sends.append(self._err(
                        p.rank, self._recv_dead_src_error(*key)
                        if key[0] == rank else self._already_failed_error()))
            self._recv_wait.clear()
            self._h_wait.pop(rank, None)
            self._h_arrive.pop(rank, None)
            if self._h_wait:
                self._fail_health_round(sends)
        self._flush(sends)

    def world_failed(self, exc: BaseException) -> None:
        """A rank's body raised (its ``done`` frame carried the error):
        wake the parked peers, as ``World.fail`` does on threads."""
        from ..runtime import CommError
        sends: List[Tuple[int, dict]] = []
        with self._lock:
            if self.first_error is None:
                self.first_error = exc
            if self._failed:
                return
            self._failed = True
            err = CommError("collective aborted because another rank failed")
            for r in self._x_wait:
                sends.append(self._err(r, err))
            self._clear_exchange()
            for parked in self._recv_wait.values():
                for p in parked:
                    sends.append(self._err(
                        p.rank, self._already_failed_error()))
            self._recv_wait.clear()
            if self._h_wait:
                self._fail_health_round(sends)
        self._flush(sends)

    # ------------------------------------------------------------ janitor

    def tick(self) -> None:
        """The janitor's beat: an expired exchange round tears with
        arrived/missing attribution; an expired receive window first
        redelivers a dropped message, then extends with capped
        exponential backoff, then raises the timed-out receive."""
        now = time.monotonic()
        sends: List[Tuple[int, dict]] = []
        with self._lock:
            self._tick_exchange(now, sends)
            self._tick_recv(now, sends)
            self._tick_health(now, sends)
        self._flush(sends)

    def _tick_exchange(self, now, sends) -> None:
        if any(now > w.arrival + w.patience for w in self._x_wait.values()):
            err = self._deadlock_error(self._x_wait)
            self._x_broken = err
            for rr in self._x_wait:
                sends.append(self._err(rr, err))
            self._clear_exchange()

    def _tick_recv(self, now, sends) -> None:
        from ..runtime import _backoff_pause
        for key, parked in list(self._recv_wait.items()):
            keep = []
            for p in parked:
                if now <= p.deadline:
                    keep.append(p)
                elif p.attempt < p.retries:
                    p.attempt += 1
                    stash = self._dropped.get(key)
                    if stash:
                        self._deliver(p.rank, stash.pop(0), 1, sends)
                        continue
                    p.deadline = now + _backoff_pause(
                        p.attempt, p.backoff, p.timeout)
                    keep.append(p)
                else:
                    sends.append(self._err(
                        p.rank, self._recv_timeout_error(key)))
            if keep:
                self._recv_wait[key] = keep
            else:
                self._recv_wait.pop(key, None)

    def _tick_health(self, now, sends) -> None:
        if any(now > arrival + timeout
               for arrival, timeout in self._h_wait.values()):
            self._fail_health_round(sends)


class _RunState:
    """What the reader threads collect in one run."""

    def __init__(self, n: int):
        self.results: List[Any] = [None] * n
        self.errors: List[Optional[BaseException]] = [None] * n
        self.epilogues: List[Optional[dict]] = [None] * n
        self.finished = [False] * n
        self.died = [False] * n


def _device_spec(device) -> str:
    """The world's device as the workers resolve it: CUDA unless the
    caller asks for another.  A CUDA device without an index takes this
    process's current one when CUDA is already initialised here, else
    the worker's default; this process does not initialise CUDA for
    it."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None \
            and torch.cuda.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


class ProcessTransport(Transport):
    """``run_ranks`` over pooled worker processes (see the module
    docstring)."""

    name = "process"

    def __init__(self):
        # One world at a time per parent: the switchboard's rank is the
        # leased worker's index.
        self._run_lock = threading.Lock()
        self.last_stats: Dict[str, Any] = {}

    def run_ranks(self, fn: Callable, nranks: int,
                  timeout: Optional[float] = None,
                  return_results: bool = True, device=None) -> List[Any]:
        from .. import config as _cfg
        from ..runtime import _fn_nparams, _raise_primary
        from . import note_external_preemption

        # The parent builds no World, so World's size guard lives here.
        if nranks < 1:
            raise ValueError("World size must be >= 1")
        timeout = _cfg.world_timeout() if timeout is None \
            else float(timeout)
        dev = _device_spec(device)
        fn_bytes = _ship.dumps(fn)
        nparams = _fn_nparams(fn)
        state = _cfg.snapshot_process_state()
        plan = _cfg.fault_plan()
        plan_frame = None if plan is None else {
            "specs": plan.specs, "counts": dict(plan._counts)}
        tracer = _cfg.comm_tracer()
        trace_frame = None if tracer is None else {"ring": tracer.ring}

        with self._run_lock:
            pool = shared_pool()
            t0 = time.perf_counter()
            workers = pool.lease(nranks, device=dev)
            sb = _Switchboard(nranks, timeout, workers,
                              on_preempt=note_external_preemption)
            st = _RunState(nranks)
            try:
                for rank, w in enumerate(workers):
                    w.send({"kind": "run", "rank": rank, "size": nranks,
                            "timeout": timeout, "device": dev,
                            "fn": fn_bytes, "nparams": nparams,
                            "config": state, "plan": plan_frame,
                            "trace": trace_frame})
                stop = threading.Event()
                janitor = threading.Thread(
                    target=self._janitor, args=(sb, stop), daemon=True)
                janitor.start()
                readers = [threading.Thread(
                    target=self._reader, args=(r, w, sb, st), daemon=True)
                    for r, w in enumerate(workers)]
                for t in readers:
                    t.start()
                for t in readers:
                    t.join()
                stop.set()
                janitor.join()
            finally:
                self._merge_epilogues(nranks, plan, tracer, sb, st)
                pool.release(workers)
                self.last_stats = dict(
                    sb.stats, nranks=nranks, pids=[w.pid for w in workers],
                    seconds=time.perf_counter() - t0)

        _raise_primary(st.errors, sb.first_error)
        if not return_results:
            return []
        return [unpack(r, dev) for r in st.results]

    # ------------------------------------------------------------ threads

    @staticmethod
    def _janitor(sb: _Switchboard, stop: threading.Event) -> None:
        while not stop.wait(_TICK_S):
            sb.tick()

    @staticmethod
    def _reader(rank: int, w: Worker, sb: _Switchboard,
                st: _RunState) -> None:
        from ..runtime import RankFailedError
        while True:
            try:
                f = recv_frame(w.sock)
            except WireError:
                f = None
            if f is None:
                # EOF.  A clean run ended with a ``done`` frame; anything
                # else is a death (a SIGKILL lands here, with or without a
                # ``dying`` frame before it).
                w.mark_dead()
                if not st.finished[rank]:
                    err = RankFailedError(
                        f"rank {rank} died: transport worker (pid "
                        f"{w.pid}) exited without a final frame",
                        ranks=(rank,))
                    st.errors[rank] = err
                    st.finished[rank] = True
                    st.died[rank] = True
                    sb.rank_died(rank, err)
                return
            kind = f.get("kind")
            if kind == "op":
                sb.handle_op(f)
            elif kind == "dying":
                # A fault-injected death: the evidence, then the SIGKILL
                # whose EOF follows.
                st.epilogues[rank] = f.get("epilogue")
                st.errors[rank] = f["error"]
                st.finished[rank] = True
                st.died[rank] = True
                sb.rank_died(rank, f["error"])
            elif kind == "done":
                st.epilogues[rank] = f.get("epilogue")
                if f["ok"]:
                    st.results[rank] = f["result"]
                else:
                    st.errors[rank] = f["error"]
                    sb.world_failed(f["error"])
                st.finished[rank] = True
                return

    # -------------------------------------------------------------- merge

    @staticmethod
    def _merge_epilogues(nranks: int, plan, tracer, sb: _Switchboard,
                         st: _RunState) -> None:
        from . import note_external_preemption
        eps = [st.epilogues[r] or {} for r in range(nranks)]
        if plan is not None:
            for r, ep in enumerate(eps):
                if ep.get("plan"):
                    plan.absorb_remote(r, ep["plan"])
        for r, ep in enumerate(eps):
            if ep.get("preempt") is not None:
                note_external_preemption(r, ep["preempt"])
        if tracer is not None:
            tracer.absorb(sb, [ep.get("trace") for ep in eps])
            for r, ep in enumerate(eps):
                # The reaper's flight-recorder duty for a rank that died
                # without shipping a postmortem of its own.
                shipped = (ep.get("trace") or {}).get("postmortems")
                if st.died[r] and st.errors[r] is not None \
                        and not shipped:
                    tracer.note_rank_failure(sb, r, st.errors[r])
