"""Split-phase collectives and the overlap scheduler.

Port of ``mpi4torch_tpu/overlap`` on the rank-thread runtime:
``comm.Allreduce_start`` / ``Reduce_scatter_start`` / ``Allgather_start``
return a :class:`SplitWaitHandle` with the ``WaitHandle`` API
(``.dummy``; :func:`~mpi4torch_tpu_torch.JoinDummiesHandle` composes),
completed by the same ``comm.Wait`` verb, and the scheduler
(:mod:`.scheduler`) keeps a window of bucket collectives between their
starts and their Waits.

On the rank threads a start runs the blocking collective at once and the
handle carries its result (the JAX package's eager form): the Wait is
the exactly-once completion point — a second Wait raises
:class:`~mpi4torch_tpu_torch.runtime.BifurcationError` — and the result
is bit-identical to the blocking op.  Split-phase transfers are exact:
an explicit codec raises, a scope default degrades to the exact wire.

``overlap=True`` means a window of 2 collectives in flight, an
``int >= 1`` sets the window depth (``config.overlap_scope``,
``config.set_default_overlap``).  The JAX package's compiled split-phase
forms and their tier-stack window belong to the compiled backend
(ROADMAP.md Queue 1 item 4); ``scheduled_exposure`` reads lowered
StableHLO and goes with ``analyze/`` (item 7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

import torch

from .. import config as _config
from ..comm import WaitHandle
from ..ops.eager import join_dummies as _join_dummies
from ..runtime import BifurcationError, effective_rank_context

__all__ = [
    "SplitWaitHandle",
    "SpmdWaitHandle",
    "allreduce_start",
    "reduce_scatter_start",
    "allgather_start",
    "complete_generic",
    "resolve_overlap",
    "overlap_depth",
    "overlap_allreduce_tree",
    "overlap_reduce_scatter_tree",
    "overlap_split_allreduce",
    "prefetch_allgather_tree",
]

_DESC_LEN = 8


@dataclass
class _SplitState:
    """Completion state of a split-phase handle: the blocking value was
    computed at start time; Wait is the exactly-once completion point."""
    opname: str
    result: Any
    waited: bool = False


class SplitWaitHandle(WaitHandle):
    """Wait handle of a split-phase collective, with the
    :class:`~mpi4torch_tpu_torch.WaitHandle` API: ``.dummy`` for
    :func:`~mpi4torch_tpu_torch.JoinDummies`;
    :func:`~mpi4torch_tpu_torch.JoinDummiesHandle` composes (the dummies
    land on the descriptor slot, and the Wait ties them into the
    result), and ``comm.Wait`` completes it exactly once.  The handle
    carries its own :class:`_SplitState`, shared across
    ``JoinDummiesHandle`` copies so a double Wait through either copy
    still raises."""

    def __init__(self, raw_handle: List, state: _SplitState = None):
        super().__init__(raw_handle)
        self._split_state = state

    def _with_raw(self, raw_handle: List) -> "SplitWaitHandle":
        return SplitWaitHandle(raw_handle, self._split_state)


# The JAX package's name for the same handle.
SpmdWaitHandle = SplitWaitHandle


def _start_generic(opname: str, value) -> SplitWaitHandle:
    """Compute-at-start split-phase form: the blocking collective already
    ran (``value``); the handle's Wait returns it through a
    dependency-carrying JoinDummies, bit-identical to the blocking op."""
    desc = _join_dummies(
        torch.zeros(_DESC_LEN, dtype=torch.float32, device=value.device),
        [value.reshape(-1)[:1]])
    state = _SplitState(opname=opname, result=value)
    return SplitWaitHandle([desc, value, value], state)


def complete_generic(handle: SplitWaitHandle):
    """Complete a split-phase handle (``comm.Wait`` dispatches here)."""
    state = handle._split_state
    if state.waited:
        raise BifurcationError(
            "Detected bifurcation in Wait handle usage: this split-phase "
            f"{state.opname} was already waited on (a WaitHandle "
            "completes exactly once)")
    state.waited = True
    # Tie through the descriptor so JoinDummiesHandle chains survive.
    return _join_dummies(state.result, [handle._handle[0]])


def allreduce_start(comm, tensor, op: int, compression=None,
                    algorithm=None) -> SplitWaitHandle:
    """Facade body of ``comm.Allreduce_start``: the blocking
    ``Allreduce``'s plan (one resolution path, so the scope/explicit
    rules cannot drift), then the split-phase rule — split transfers are
    exact, so an explicit codec raises and a scope default degrades to
    the exact wire.  Owns the op's span so the resolved algorithm can
    suffix it (``mpi4torch.Allreduce_start.rhd``)."""
    from ..ops import eager as _eager

    codec, algo = comm._allreduce_plan(tensor, op, compression, algorithm)
    if codec is not None:
        if compression is not None:
            raise ValueError(
                f"compression={codec.name!r} cannot ride a split-phase "
                "Allreduce — the codec pipeline is a fused multi-step "
                "collective with no start/wait form; use the blocking "
                "Allreduce, or compression=False to split-phase exact")
        codec = None  # scope default yields: exact split-phase wire
    span = "mpi4torch.Allreduce_start"
    if algo not in (None, "ring"):
        span += f".{algo}"
    with torch.profiler.record_function(span):
        val = _eager.allreduce(effective_rank_context(), tensor, op,
                               algorithm=algo)
        return _start_generic("Allreduce", val)


def reduce_scatter_start(comm, tensor, op: int,
                         scatteraxis: int) -> SplitWaitHandle:
    """Facade body of ``comm.Reduce_scatter_start``."""
    from ..ops import eager as _eager

    return _start_generic("Reduce_scatter", _eager.reduce_scatter(
        effective_rank_context(), tensor, op, scatteraxis))


def allgather_start(comm, tensor, gatheraxis: int) -> SplitWaitHandle:
    """Facade body of ``comm.Allgather_start``."""
    from ..ops import eager as _eager

    return _start_generic("Allgather", _eager.allgather(
        effective_rank_context(), tensor, gatheraxis))


def resolve_overlap(overlap):
    """Resolve an ``overlap=`` argument: ``None`` defers to the
    :func:`~mpi4torch_tpu_torch.config.overlap_scope` / process default;
    explicit values are validated (``True``/``False``/depth ``>= 1``)."""
    if overlap is None:
        return _config.default_overlap()
    return _config._validated_overlap(overlap)


def overlap_depth(value, default: int = 2) -> int:
    """Window depth of a truthy overlap value (``True`` → the
    double-buffered default of 2)."""
    return default if value is True else max(int(value), 1)


# Scheduler entry points (the fused tree collectives, the ZeRO helpers
# and the serving decode step route through these).
from .scheduler import (overlap_allreduce_tree,            # noqa: E402
                        overlap_reduce_scatter_tree,
                        overlap_split_allreduce,
                        prefetch_allgather_tree)
