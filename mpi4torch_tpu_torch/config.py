"""Framework configuration flags read by the serving slice.

Port of the part of ``mpi4torch_tpu/config.py`` this package reads:
``deterministic_mode`` (thread-local, as there), the overlap policy of
the serving decode collectives, and the deadlock timeout of rank worlds.
The deterministic flag is per thread, so a scope opened before
``run_ranks`` is not seen by the rank threads.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager

_state = threading.local()
_UNSET = object()

# Environment override of the rank-world deadlock timeout (seconds): a
# wall clock for detecting a rank that never reaches a collective, not a
# performance knob.  The same variable as the JAX package's.
WORLD_TIMEOUT_ENV = "MPI4TORCH_TPU_WORLD_TIMEOUT"


def world_timeout() -> float:
    return float(os.environ.get(WORLD_TIMEOUT_ENV, "60"))


def deterministic_reductions() -> bool:
    return getattr(_state, "deterministic", False)


def set_deterministic_reductions(value: bool) -> None:
    _state.deterministic = bool(value)


@contextmanager
def deterministic_mode(value: bool = True):
    """Ask for deterministic reductions inside the block.  Every eager
    reduction of this package already folds in ascending rank order, so
    the flag changes no result here; it is kept so that code written for
    the JAX package runs unchanged."""
    prev = deterministic_reductions()
    set_deterministic_reductions(value)
    try:
        yield
    finally:
        set_deterministic_reductions(prev)


_process_overlap = None


def default_overlap():
    """The overlap policy the serving decode collectives use when none is
    passed: the process-wide :func:`set_default_overlap` value.  Only
    ``None`` and ``False`` (blocking collectives) exist in this
    package."""
    return _process_overlap


def set_default_overlap(value) -> None:
    global _process_overlap
    if value is not None and value is not False:
        raise NotImplementedError(
            f"overlap={value!r}: the split-phase overlap scheduler is not "
            "ported yet (ROADMAP.md, Queue 1 item 4); use None or False")
    _process_overlap = value
