"""Fault tolerance of the rank-thread runtime: deterministic fault
injection, failure attribution, retry with backoff, integrity guards and
gray-failure detection.

Port of the core of ``mpi4torch_tpu.resilience``:

* fault injection (:mod:`.faults`): ``fault_scope`` /
  ``config.set_fault_plan`` inject faults keyed by ``(rank, op-kind,
  call-index)`` at the rendezvous and the p2p wire: rank death, delays,
  dropped messages, NaN/Inf payloads, bit-flips on the encoded int8
  wire, slow ranks, jitter, flaky links, brownouts;
* attribution: a timed-out rendezvous raises ``DeadlockError`` with its
  ``arrived`` / ``missing`` ranks, a dead rank ``RankFailedError``
  naming it on every survivor, a corrupt payload ``IntegrityError``
  naming its contributor, and ``comm.check_health()`` probes;
* survival: transient faults retry with capped exponential backoff
  (``config.comm_retries`` / ``comm_backoff``); the integrity guards
  (``config.comm_finite_guard``, ``config.comm_wire_checksum``,
  :mod:`.guards`) catch lying payloads and cost one attribute read per
  collective while off;
* gray failures (:mod:`.health`): the slow rank attributed from the comm
  tracer's events (:class:`SlowRankReport`, :class:`SlowRankError`);
* recovery (:mod:`.recovery`): :func:`restore_or_init` resumes from the
  newest checkpoint that loads, past torn saves, with the skipped steps
  in its ledger;
* the fault matrix (:mod:`.matrix`): every kind against one collective
  per subsystem, with its typed expected outcome.

Not ported yet: ``degrade`` (ROADMAP.md, Queue 1 item 6, with the
controller and ``elastic``) and ``chaos`` (item 6).
"""

from __future__ import annotations

from ..runtime import (DeadlockError, HealthReport, IntegrityError,
                       RankFailedError)
from .faults import (FAULT_KINDS, FaultKind, FaultPlan, FaultSpec,
                     as_plan, fault_scope, pending_preemptions,
                     register_fault_kind)
from .guards import (IntegrityWarning, check_contributions,
                     clear_violations, last_violation, spmd_finite_value,
                     verify_wire, wire_checksum)
from .health import (GrayFailureDetector, RankCommStats, SlowRankError,
                     SlowRankReport, detect_slow_ranks)
from .recovery import RestoreResult, SkippedStep, restore_or_init

__all__ = [
    "FAULT_KINDS",
    "FaultKind",
    "FaultPlan",
    "FaultSpec",
    "as_plan",
    "fault_scope",
    "pending_preemptions",
    "register_fault_kind",
    "IntegrityWarning",
    "check_contributions",
    "spmd_finite_value",
    "wire_checksum",
    "verify_wire",
    "last_violation",
    "clear_violations",
    "GrayFailureDetector",
    "RankCommStats",
    "SlowRankError",
    "SlowRankReport",
    "detect_slow_ranks",
    "restore_or_init",
    "RestoreResult",
    "SkippedStep",
    "DeadlockError",
    "RankFailedError",
    "IntegrityError",
    "HealthReport",
]
