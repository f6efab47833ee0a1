"""The worker pool: real processes, spawned once and reused.

Port of ``mpi4torch_tpu/transport/pool.py``.  A worker costs a whole
interpreter and the ``torch`` import (seconds), and on the card its own
CUDA context, so the process transport never pays that per run: one
process-global pool spawns workers lazily, leases ``n`` of them to each
``run_ranks`` call and takes them back.  Only a worker that died (a
SIGKILL, a crash) is replaced, and ``spawned_total`` counts every spawn.

The workers connect back to an ``AF_UNIX`` listener in a private
temporary directory and introduce themselves with a ``hello`` frame
carrying their PID, by which a socket is matched to its ``Popen``
(connections arrive in any order).  A worker is
``python -m mpi4torch_tpu_torch.transport._worker <socket> [<device>]``
with this checkout on ``PYTHONPATH`` and the parent's environment
otherwise.  A worker spawned for a CUDA world makes its context before it
says hello, so a replacement for a killed worker starts its first body as
promptly as the reused ones (a consensus probe's timeout is shorter than
a context).  A
worker that does not say hello within the spawn timeout
(``MPI4TORCH_TPU_TRANSPORT_SPAWN_TIMEOUT``, 300 s) is a
:class:`TimeoutError`; nothing falls back to threads.
"""

from __future__ import annotations

import atexit
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

from .wire import recv_frame, send_frame, tune_socket

__all__ = ["Worker", "WorkerPool", "shared_pool", "shutdown_shared_pool"]

SPAWN_TIMEOUT_ENV = "MPI4TORCH_TPU_TRANSPORT_SPAWN_TIMEOUT"


def _spawn_timeout() -> float:
    return float(os.environ.get(SPAWN_TIMEOUT_ENV, "300"))


class Worker:
    """One pooled worker process and the parent's socket to it."""

    __slots__ = ("proc", "sock", "pid", "wlock", "alive")

    def __init__(self, proc: subprocess.Popen, sock: socket.socket,
                 pid: int):
        self.proc = proc
        self.sock = sock
        self.pid = pid
        # The parent writes to one worker from its reader, janitor and
        # switchboard threads.
        self.wlock = threading.Lock()
        self.alive = True

    def send(self, frame: dict) -> None:
        send_frame(self.sock, frame, lock=self.wlock)

    def mark_dead(self) -> None:
        self.alive = False

    def is_live(self) -> bool:
        return self.alive and self.proc.poll() is None


class WorkerPool:
    """A lazily grown pool of transport workers, reused by default."""

    def __init__(self):
        self._tmpdir = tempfile.mkdtemp(prefix="m4t_transport_")
        self.addr = os.path.join(self._tmpdir, "sock")
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.addr)
        self._listener.listen(64)
        self._workers: List[Worker] = []
        self._lock = threading.Lock()
        self._closed = False
        # Every spawn this pool made: two healthy runs in a row must not
        # move it.
        self.spawned_total = 0

    # ------------------------------------------------------------ spawn

    def _spawn_env(self) -> Dict[str, str]:
        env = dict(os.environ)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        return env

    def _spawn(self, n: int, device: Optional[str] = None) -> List[Worker]:
        env = self._spawn_env()
        argv = [sys.executable, "-m", "mpi4torch_tpu_torch.transport._worker",
                self.addr] + ([] if device is None else [str(device)])
        procs = [subprocess.Popen(argv, env=env, stdin=subprocess.DEVNULL)
                 for _ in range(n)]
        by_pid: Dict[int, subprocess.Popen] = {p.pid: p for p in procs}
        out: List[Worker] = []
        timeout = _spawn_timeout()
        deadline = time.monotonic() + timeout
        try:
            while by_pid:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"transport worker spawn timed out after {timeout} s "
                        f"waiting for {len(by_pid)} worker(s) to connect")
                self._listener.settimeout(min(remaining, 0.5))
                try:
                    sock, _ = self._listener.accept()
                except socket.timeout:
                    gone = {pid: p.returncode for pid, p in by_pid.items()
                            if p.poll() is not None}
                    if gone:
                        raise TimeoutError(
                            f"transport worker(s) exited before connecting "
                            f"(pid: exit code {gone})") from None
                    continue
                sock.settimeout(None)
                tune_socket(sock)
                hello = recv_frame(sock)
                proc = by_pid.pop(hello.get("pid"), None) \
                    if hello and hello.get("kind") == "hello" else None
                if proc is None:
                    # Not a worker of this batch: refuse it.
                    sock.close()
                    continue
                out.append(Worker(proc, sock, proc.pid))
                self.spawned_total += 1
        except BaseException:
            for w in out:
                w.sock.close()
            for p in procs:
                p.kill()
                p.wait()
            raise
        return out

    # ------------------------------------------------------------ lease

    def lease(self, n: int, device: Optional[str] = None) -> List[Worker]:
        """``n`` live workers, spawning only the deficit; a spawned
        worker makes ``device``'s context first when it is CUDA."""
        with self._lock:
            if self._closed:
                raise RuntimeError("the worker pool is shut down")
            self._prune_dead()
            deficit = n - len(self._workers)
            if deficit > 0:
                self._workers.extend(self._spawn(deficit, device))
            return self._workers[:n]

    def _prune_dead(self) -> None:
        live = []
        for w in self._workers:
            if w.is_live():
                live.append(w)
                continue
            try:
                w.sock.close()
            except OSError:
                pass
            if w.proc.poll() is None:
                w.proc.kill()
            w.proc.wait()
        self._workers = live

    def release(self, workers: List[Worker]) -> None:
        """Take leased workers back: the dead are reaped, the live
        kept."""
        with self._lock:
            self._prune_dead()

    def pids(self) -> List[int]:
        with self._lock:
            return [w.pid for w in self._workers if w.is_live()]

    # --------------------------------------------------------- shutdown

    def shutdown(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for w in self._workers:
                if w.is_live():
                    try:
                        w.send({"kind": "shutdown"})
                    except OSError:
                        pass
                try:
                    w.sock.close()
                except OSError:
                    pass
            for w in self._workers:
                try:
                    w.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    w.proc.kill()
                    w.proc.wait()
            self._workers = []
            try:
                self._listener.close()
            finally:
                shutil.rmtree(self._tmpdir, ignore_errors=True)


_shared: Optional[WorkerPool] = None
_shared_lock = threading.Lock()


def shared_pool() -> WorkerPool:
    """The process-global pool (made on first use, shut down at exit)."""
    global _shared
    with _shared_lock:
        if _shared is None or _shared._closed:
            _shared = WorkerPool()
            atexit.register(_shared.shutdown)
        return _shared


def shutdown_shared_pool() -> None:
    global _shared
    with _shared_lock:
        pool, _shared = _shared, None
    if pool is not None:
        pool.shutdown()
