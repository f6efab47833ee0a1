"""Preemption-safe checkpoint recovery.

Port of ``mpi4torch_tpu/resilience/recovery.py``.  A single save of
``utils/checkpoint.py`` is atomic, but storage is not always atomic end
to end, and a preempted job may die mid-save anyway: the
``truncate_save`` fault kind (:mod:`.faults`) models that, the newest
step directory exists but its data is torn.  A plain
``restore(latest_step())`` crashes on it and loses every checkpoint's
worth of work to one bad write.

:func:`restore_or_init` is the resume verb that survives it: walk the
steps newest first, restore the first one that loads, skip garbage (a
torn data file, a stray numeric directory with no checkpoint in it), and
record every skip in the result's ``skipped`` ledger as well as in a
warning; fall back to the initial state only when nothing usable is
left::

    res = mpi.resilience.restore_or_init(workdir, template=state)
    state, step = res                      # unpacks as a pair
    for s in res.skipped:                  # the torn-step ledger
        log.warning("skipped step %d: %s", s.step, s.reason)
"""

from __future__ import annotations

import os
import warnings
from typing import Any, NamedTuple, Optional, Tuple

__all__ = ["restore_or_init", "RestoreResult", "SkippedStep"]


class SkippedStep(NamedTuple):
    """One step directory :func:`restore_or_init` walked past: the step
    and why it was unusable (the exception class and message of the
    failed restore)."""
    step: int
    reason: str


class RestoreResult(tuple):
    """The :func:`restore_or_init` result: unpacks as ``(state, step)``
    and carries the torn-step ledger as ``.skipped``."""

    def __new__(cls, state, step, skipped=()):
        self = super().__new__(cls, (state, step))
        self._skipped = tuple(skipped)
        return self

    @property
    def state(self):
        return self[0]

    @property
    def step(self) -> Optional[int]:
        return self[1]

    @property
    def skipped(self) -> Tuple[SkippedStep, ...]:
        return self._skipped


def _scan_steps(directory: str):
    """The step directories under ``directory``, newest first."""
    from ..utils.checkpoint import CheckpointManager

    return CheckpointManager(directory).all_steps()[::-1]


def restore_or_init(directory: str, template: Any, *,
                    init: Any = None,
                    max_to_keep: Optional[int] = None,
                    expect_epoch: Optional[int] = None
                    ) -> RestoreResult:
    """Restore the newest loadable checkpoint under ``directory`` into
    ``template``'s structure, stepping back past torn or garbage steps;
    returns a :class:`RestoreResult` (``(state, step)`` with the ledger
    on ``.skipped``).

    ``step`` is the restored step, or ``None`` when no usable checkpoint
    exists; then ``state`` is ``init`` (or ``template`` when ``init`` is
    not given).  A step that holds no complete checkpoint (a
    ``CheckpointError``) or cannot be read (an ``OSError``) is skipped,
    never fatal, and every skip is in ``.skipped`` with its reason.  Any
    other error propagates: a device error while the state is copied to
    the template's device (out of memory, say) says nothing about the
    step.  Nor is a ``CommError`` skipped:
    a template whose leaf shapes differ from the saved ones (another
    layout) or a step saved under another world epoch than
    ``expect_epoch`` holds for every step of the history, and walking
    back would silently restart from ``init``.  ``max_to_keep`` is the
    JAX package's manager option; restoring deletes nothing, so it is
    accepted and unused."""
    from ..utils.checkpoint import CheckpointError, restore_checkpoint

    state_init = template if init is None else init
    if not os.path.isdir(directory):
        return RestoreResult(state_init, None)
    skipped = []
    for step in _scan_steps(directory):
        try:
            state = restore_checkpoint(os.path.join(directory, str(step)),
                                       template, expect_epoch=expect_epoch)
        except (CheckpointError, OSError) as e:     # torn or garbage step
            reason = f"{type(e).__name__}: {str(e)[:200]}"
            skipped.append(SkippedStep(step, reason))
            warnings.warn(
                f"checkpoint step {step} is unusable "
                f"({type(e).__name__}); falling back to the previous "
                "complete step", RuntimeWarning, stacklevel=2)
            continue
        return RestoreResult(state, step, skipped)
    return RestoreResult(state_init, None, skipped)
