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
  per subsystem, with its typed expected outcome;
* degraded mode (:mod:`.degrade`): the policies that adapt the running
  configuration to a gray failure (``codec_escalate``,
  ``schedule_failover``, ``spare_demote``), each switch ratified by one
  epoch-fenced consensus round of ``elastic``;
* the chaos matrix (:mod:`.chaos`): every gray kind against every
  subsystem and seeded multi-fault storms
  (``python -m mpi4torch_tpu_torch.resilience --chaos``).
"""

from __future__ import annotations

from ..runtime import (DeadlockError, HealthReport, IntegrityError,
                       RankFailedError)
from .faults import (FAULT_KINDS, FaultKind, FaultPlan, FaultSpec,
                     as_plan, fault_scope, pending_preemptions,
                     register_fault_kind)
from .degrade import (DEGRADE_POLICIES, DegradeController, DegradeError,
                      DegradeTransition, failover_schedule,
                      rank_wire_bytes, register_degrade_policy)
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
    "DEGRADE_POLICIES",
    "DegradeController",
    "DegradeError",
    "DegradeTransition",
    "failover_schedule",
    "rank_wire_bytes",
    "register_degrade_policy",
    "restore_or_init",
    "RestoreResult",
    "SkippedStep",
    "DeadlockError",
    "RankFailedError",
    "IntegrityError",
    "HealthReport",
]
