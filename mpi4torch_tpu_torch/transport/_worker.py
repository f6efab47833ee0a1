"""Transport worker: one pooled process, one rank body at a time.

Port of ``mpi4torch_tpu/transport/_worker.py``.  Launched by the pool as
``python -m mpi4torch_tpu_torch.transport._worker <socket> [<device>]``:
it makes the device's context when the device is CUDA, connects back,
says ``hello`` with its PID, then serves ``run`` frames.
For each it applies the shipped state (the configuration and torch's
numeric state, the fault plan's specs and counters, a fresh tracer),
makes the world's device current, runs the rank body on a fresh thread
(as a rank thread would: no thread-local state carries over from the
previous run) against a :class:`_ProcessWorld` whose ``*_wire`` seams
are request/reply frames to the parent's switchboard, and answers with
a ``done`` frame carrying the packed result and the epilogue (fired
faults and counters, the preemption notice, the tracer's events and
postmortems).

Two signals are real here:

* a fault-injected ``rank_death``/``preempt`` of this rank reaches
  :meth:`_ProcessWorld.mark_dead`, which ships a ``dying`` frame (the
  error and the epilogue) and then SIGKILLs its own process, so the
  survivors attribute a rank that is really gone;
* ``SIGTERM`` is a preemption notice: the handler latches it and the next
  frame to the parent carries it (grace ``MPI4TORCH_TPU_PREEMPT_GRACE``,
  64 ops), onto ``transport.external_preemptions()``.
"""

from __future__ import annotations

import os
import pickle
import signal
import socket
import sys
import threading
import time

import torch

from .wire import (WireError, pack, recv_frame, send_frame, tune_socket,
                   unpack)

PREEMPT_GRACE_ENV = "MPI4TORCH_TPU_PREEMPT_GRACE"
_DEFAULT_PREEMPT_GRACE = int(os.environ.get(PREEMPT_GRACE_ENV, "64"))

# SIGTERM latch: {"grace": n} once a notice arrived and has not yet been
# reported to the parent.
_PREEMPT: dict = {}


def _on_sigterm(signum, frame):
    _PREEMPT["grace"] = _DEFAULT_PREEMPT_GRACE


def _sanitize_error(err: BaseException) -> BaseException:
    """An error that survives the wire: itself when it pickles, else a
    CommError naming it."""
    try:
        pickle.loads(pickle.dumps(err, protocol=pickle.HIGHEST_PROTOCOL))
        return err
    except Exception:
        from ..runtime import CommError
        return CommError(f"{type(err).__name__}: {err}")


class _Client:
    """The worker's side of the wire: blocking calls and one-way casts on
    the one socket (only the rank body's thread uses it, one frame at a
    time)."""

    def __init__(self, sock: socket.socket):
        self._sock = sock

    def _stamp(self, frame: dict) -> dict:
        frame["kind"] = "op"
        grace = _PREEMPT.pop("grace", None)
        if grace is not None:
            frame["preempt"] = grace
        return frame

    def call(self, frame: dict) -> dict:
        send_frame(self._sock, self._stamp(frame))
        rep = recv_frame(self._sock)
        if rep is None:
            raise WireError("the transport parent closed the connection")
        return rep

    def cast(self, frame: dict) -> None:
        send_frame(self._sock, self._stamp(frame))

    def send_raw(self, frame: dict) -> None:
        send_frame(self._sock, frame)


def _make_world(size: int, rank: int, timeout: float, device,
                client: _Client, epilogue_cb):
    from .. import config as _cfg
    from .. import runtime as _rt

    class _ProcessWorld(_rt.World):
        """A World whose wire is the parent's switchboard."""

        def __init__(self):
            super().__init__(size, timeout=timeout, device=device)
            self.local_ranks = range(rank, rank + 1)
            self._rank = rank
            self._client = client

        def _call(self, frame: dict) -> dict:
            rep = self._client.call(frame)
            if not rep["ok"]:
                self._apply_remote_failure(rep["error"])
                raise rep["error"]
            return rep

        # ---------------------------------------------------- wire seams

        def _exchange_wire(self, r, signature, payload, read=None,
                           checks=(), meter=None):
            # Each rank judges its own deposited payload; the verdicts
            # travel with the frame so every rank reports the same ranks.
            verdicts = tuple(c.ok(payload) for c in checks)
            t0 = time.perf_counter()
            rep = self._call({
                "op": "exchange", "rank": r, "signature": signature,
                "payload": pack(payload), "verdicts": verdicts,
                "timeout": self.timeout, "retries": _cfg.comm_retries(),
                "backoff": _cfg.comm_backoff()})
            if meter is not None:
                meter.add_wait(t0, time.perf_counter())
            if rep["retries_used"]:
                self._count_retries(rep["retries_used"], meter)
            self._check_sig_agreement(rep["sigs"])
            for i, check in enumerate(checks):
                bad = [q for q, v in enumerate(rep["verdicts"]) if not v[i]]
                if bad:
                    check.report(bad)
            out = [payload if q == r else unpack(p, self.device)
                   for q, p in enumerate(rep["payloads"])]
            return out if read is None else read(out)

        def _p2p_send_wire(self, src, dst, tag, payload):
            self._client.cast({"op": "p2p_send", "rank": self._rank,
                               "src": src, "dst": dst, "tag": tag,
                               "payload": pack(payload)})

        def _on_wire_drop(self, src, dst, tag):
            # The plan stashed the dropped payload here, but redelivery
            # happens at the receiver: move it to the switchboard.
            with self._mb_lock:
                stash = self._dropped.get((src, dst, tag))
                payload = stash.pop() if stash else None
            self._client.cast({"op": "drop_stash", "rank": self._rank,
                               "src": src, "dst": dst, "tag": tag,
                               "payload": pack(payload)})

        def _p2p_recv_wire(self, src, dst, tag, meter):
            rep = self._call({
                "op": "p2p_recv", "rank": self._rank, "src": src,
                "dst": dst, "tag": tag, "timeout": self.timeout,
                "retries": _cfg.comm_retries(),
                "backoff": _cfg.comm_backoff()})
            if rep["retries_used"]:
                self._count_retries(rep["retries_used"], meter)
            return unpack(rep["payload"], self.device)

        def _health_wire(self, r, probe_timeout):
            rep = self._client.call({"op": "health", "rank": r,
                                     "timeout": probe_timeout})
            return (rep["healthy"], frozenset(rep["arrived"]),
                    dict(rep["arrive_t"]))

        # ------------------------------------------------- failure paths

        def _apply_remote_failure(self, err):
            """Latch the world's failure locally so later ops fail fast
            with the inherited ``_check_failed`` attribution (what the
            shared World gives rank threads)."""
            if isinstance(err, _rt.RankFailedError) and err.ranks:
                with self._err_lock:
                    for q in err.ranks:
                        if q != self._rank:
                            self._dead.setdefault(q, err)
                    if self._first_error is None:
                        self._first_error = err
                self._failed.set()
            elif type(err) is _rt.CommError:
                # A bare CommError reply is a world-level abort; the typed
                # subclasses (mismatch, deadlock) are per round and do not
                # latch, as on threads.
                with self._err_lock:
                    if self._first_error is None:
                        self._first_error = err
                self._failed.set()

        def mark_dead(self, r, exc):
            if r != self._rank:
                return super().mark_dead(r, exc)
            # A fault killed this rank: note it in the flight recorder
            # (after the SIGKILL nobody here can), ship the evidence, die.
            try:
                tracer = _cfg.comm_tracer()
                if tracer is not None:
                    tracer.note_rank_failure(self, r, exc)
                self._client.send_raw({
                    "kind": "dying", "rank": r,
                    "error": _sanitize_error(exc),
                    "epilogue": epilogue_cb()})
            except Exception:
                pass   # the EOF after the SIGKILL attributes us anyway
            finally:
                os.kill(os.getpid(), signal.SIGKILL)

    return _ProcessWorld()


def _epilogue(rank: int) -> dict:
    from .. import config as _cfg

    ep: dict = {"preempt": _PREEMPT.pop("grace", None)}
    plan = _cfg.fault_plan()
    if plan is not None:
        with plan._lock:
            ep["plan"] = {
                "fired": list(plan.fired),
                "counts": {k: v for k, v in plan._counts.items()
                           if k[1] == rank},
                "notices": {r: v for r, v in plan._preempt_death_at.items()
                            if r == rank},
            }
    tracer = _cfg.comm_tracer()
    if tracer is not None:
        ep["trace"] = {"events": list(tracer.events),
                       "spans": list(tracer.spans),
                       "postmortems": list(tracer.postmortems),
                       "dropped": tracer.dropped}
    return ep


def _body(f: dict, client: _Client, out: dict) -> None:
    """One rank body, on its own thread (what run_ranks' rank thread
    does, over a _ProcessWorld)."""
    from .. import config as _cfg
    from .. import runtime as _rt
    from . import _ship

    rank = f["rank"]
    tracer = _cfg.comm_tracer()
    world = None
    try:
        dev = _rt.resolve_device(f["device"])
        world = _make_world(f["size"], rank, f["timeout"], dev, client,
                            lambda: _epilogue(rank))
        fn = _ship.loads(f["fn"])
        with _rt._bind_rank(_rt.RankContext(world, rank)), \
                torch.autograd.set_multithreading_enabled(False):
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            out["result"] = fn(rank) if f["nparams"] >= 1 else fn()
    except BaseException as e:  # noqa: BLE001 — reported to the parent
        out["error"] = e
        if tracer is not None and world is not None:
            # The worker's half of run_ranks' reaper: the shipped
            # postmortem carries this rank's ring tail.
            tracer.note_rank_failure(world, rank, e)


def _run(client: _Client, f: dict) -> None:
    from .. import config as _cfg

    rank = f["rank"]
    _cfg.apply_process_state(f["config"])
    # A worker never recurses into the process backend.
    _cfg.set_comm_transport("thread")
    plan = None
    if f["plan"] is not None:
        from ..resilience.faults import FaultPlan

        plan = FaultPlan(f["plan"]["specs"])
        plan._counts.update(f["plan"]["counts"])
    _cfg.set_fault_plan(plan)
    tracer = None
    if f["trace"] is not None:
        from ..obs.trace import CommTracer

        tracer = CommTracer(ring=f["trace"]["ring"])
    _cfg.set_comm_tracer(tracer)

    out: dict = {}
    t = threading.Thread(target=_body, args=(f, client, out),
                         name=f"rank{rank}")
    t.start()
    t.join()
    ep = _epilogue(rank)
    try:
        if "error" not in out:
            frame = {"kind": "done", "rank": rank, "ok": True,
                     "result": pack(out.get("result")), "epilogue": ep}
        else:
            frame = {"kind": "done", "rank": rank, "ok": False,
                     "error": _sanitize_error(out["error"]),
                     "epilogue": ep}
        client.send_raw(frame)
    except (WireError, OSError):
        raise
    except Exception:
        # An unpicklable result: still answer, or the parent reads the
        # silence as a death.
        from ..runtime import CommError

        client.send_raw({
            "kind": "done", "rank": rank, "ok": False, "epilogue": ep,
            "error": CommError(f"rank {rank}'s result could not cross the "
                               "transport wire (unpicklable)")})
    finally:
        _cfg.set_fault_plan(None)
        _cfg.set_comm_tracer(None)


def _warm(device: str) -> None:
    """Make a CUDA device's context (and load the kernel of one op) so
    that the first rank body starts as promptly as on a reused worker."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.ones(1, device=dev).add_(1).cpu()


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    if len(argv) > 2:
        _warm(argv[2])
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    tune_socket(sock)
    sock.connect(argv[1])
    send_frame(sock, {"kind": "hello", "pid": os.getpid()})
    signal.signal(signal.SIGTERM, _on_sigterm)
    client = _Client(sock)
    while True:
        try:
            f = recv_frame(sock)
            if f is None or f.get("kind") == "shutdown":
                return 0
            if f.get("kind") == "run":
                _run(client, f)
        except (WireError, OSError):
            return 1   # the parent is gone


if __name__ == "__main__":
    sys.exit(main())
