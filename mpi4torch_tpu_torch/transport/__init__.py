"""mpi4torch_tpu_torch.transport — the backends of ``run_ranks``.

Port of ``mpi4torch_tpu/transport``.  One registry, two backends:

* ``thread`` — N rank threads in the launcher process (the default;
  thread.py delegates to the code ``runtime.run_ranks`` always ran);
* ``process`` — N pooled worker processes over a framed socket wire
  (process.py): each rank with its own interpreter, GIL, CUDA context and
  stream, real SIGKILLs and SIGTERMs, and the same chokepoints, bitwise
  results and attributed failures (base.py states the contract).

Selection: ``run_ranks(..., backend=...)`` per call, or
``config.set_comm_transport`` / ``config.transport_scope`` /
``MPI4TORCH_TPU_TRANSPORT`` process-wide.  A rank body for the process
backend must be importable or a closure/local function (shipped by
value, ``_ship.py``); a function defined at module level in a file the
workers cannot import (a test file, ``__main__`` excepted) is not.

The module also keeps the **external preemption board**: a worker that
receives a real ``SIGTERM`` reports it on its next frame and the parent
records it here; ``resilience.pending_preemptions`` merges this board
with the fault plan's, so a really preempted rank is drained by the same
code as a fault-injected notice.

``python -m mpi4torch_tpu_torch.transport --smoke`` runs the transport's
smoke lanes (``__main__.py``).
"""

from __future__ import annotations

import threading
from typing import Dict, Type

from .base import Transport
from .process import ProcessTransport
from .thread import ThreadTransport

__all__ = [
    "Transport",
    "TRANSPORTS",
    "register_transport",
    "get_transport",
    "available_transports",
    "external_preemptions",
    "note_external_preemption",
    "clear_external_preemption",
    "shutdown",
]

TRANSPORTS: Dict[str, Type[Transport]] = {}
_instances: Dict[str, Transport] = {}
_inst_lock = threading.Lock()


def register_transport(cls: Type[Transport]) -> Type[Transport]:
    """Register a Transport subclass under ``cls.name`` (idempotent for
    the same class; another class under a taken name is refused)."""
    have = TRANSPORTS.get(cls.name)
    if have is not None and have is not cls:
        raise ValueError(
            f"transport {cls.name!r} already registered by "
            f"{have.__module__}.{have.__qualname__}")
    TRANSPORTS[cls.name] = cls
    return cls


def get_transport(name: str) -> Transport:
    """The backend instance registered as ``name`` (one per name)."""
    cls = TRANSPORTS.get(name)
    if cls is None:
        raise ValueError(f"unknown transport {name!r}; registered: "
                         f"{sorted(TRANSPORTS)}")
    with _inst_lock:
        inst = _instances.get(name)
        if inst is None:
            inst = _instances[name] = cls()
        return inst


def available_transports():
    return sorted(TRANSPORTS)


def shutdown() -> None:
    """Release every backend's long-lived resources (the worker pool)."""
    with _inst_lock:
        insts = list(_instances.values())
    for inst in insts:
        inst.shutdown()
    from .pool import shutdown_shared_pool
    shutdown_shared_pool()


register_transport(ThreadTransport)
register_transport(ProcessTransport)


# ------------------------------------------------ external preemptions

_ext_lock = threading.Lock()
_ext_preempt: Dict[int, int] = {}


def note_external_preemption(rank: int, grace: int) -> None:
    """Record a real preemption notice (a worker's SIGTERM) for a rank
    position.  The board outlives the run: it is polled between phases,
    like a fault plan's notice board."""
    with _ext_lock:
        _ext_preempt[rank] = int(grace)


def external_preemptions() -> Dict[int, int]:
    with _ext_lock:
        return dict(_ext_preempt)


def clear_external_preemption(rank: int) -> None:
    """Consume a notice once the rank has been drained out of the
    world."""
    with _ext_lock:
        _ext_preempt.pop(rank, None)
