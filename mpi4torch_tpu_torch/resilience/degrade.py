"""The adaptive degraded-mode runtime: what to DO about a gray failure.

Port of ``mpi4torch_tpu/resilience/degrade.py``.

A detected slow rank (:mod:`.health`) is not an error — the job can
keep running, just not the way it was configured.  This module is the
closed, registry-sync-guarded set of *degrade policies* that adapt the
running configuration, every transition ratified through the elastic
runtime's epoch-fenced consensus so all ranks switch in LOCK-STEP
(cross-rank bitwise parity survives the switch; a bifurcated world
where half the ranks run q8 and half run exact would deadlock or
corrupt):

* ``codec_escalate`` — exact → q8 under brownout, via the existing
  process-wide compression default (``config.set_default_compression``,
  visible in every rank thread).  Brownout throttles proportionally to
  censused wire bytes, so the q8 wire provably stalls ~4x less (the
  fired-fault ledger records bytes and sleep per firing — the chaos
  matrix's verdict).
* ``schedule_failover`` — re-rank the schedule candidates by
  **per-rank wire census** (:func:`rank_wire_bytes`) and pin the one
  that moves the fewest bytes through the slow rank
  (``config.set_default_algorithm``).  The census is deterministic:
  e.g. the binomial ``tree`` rooted AWAY from the slow rank routes ``2B`` through it where
  ``ring`` routes ``4B(N-1)/N`` — the slow leaf sends its contribution
  once and receives the result once, full stop.
* ``spare_demote`` — demote a SLOW (not just dead) rank to spare duty
  and promote a hot spare into its data slot (:mod:`..elastic.spare`
  slot-map permutation + local mirror slice — zero reshard, zero
  wire).  No spare available raises a typed :class:`DegradeError`
  naming the documented fallback (the planned elastic drain).

The :class:`DegradeController` owns the transition protocol: one
consensus round (epoch += 1, every rank ratifies the same view — a
stale phase raises ``StaleEpochError`` instead of running the old
schedule), then the process-wide switch, then a
:class:`DegradeTransition` record and a
``mpi4torch_degrade_transitions_total`` metric tick.  ``reset()``
restores every knob a policy touched (first-write-wins snapshots), so
a degraded mode is an episode, not a ratchet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..runtime import CommError
from .health import SlowRankReport

__all__ = [
    "DegradeError",
    "DegradeTransition",
    "DEGRADE_POLICIES",
    "register_degrade_policy",
    "rank_wire_bytes",
    "failover_schedule",
    "DegradeController",
]


class DegradeError(CommError):
    """A degrade policy could not apply (unknown policy, no spare to
    promote, no applicable failover candidate) — typed, with the
    documented fallback in the message."""


# ---------------------------------------------------------------------------
# Per-rank wire census
# ---------------------------------------------------------------------------

def _tree_rounds(nranks: int) -> List[Tuple[int, int]]:
    """(receiver_rel, sender_rel) pairs of the binomial reduce schedule
    over relative ranks 0..nranks-1 (root = rel 0) — the bcast is the
    byte-for-byte mirror.  Matches ops/spmd.py's tree forms: round k
    folds rel ``r + 2**k`` into ``r`` for every r divisible by
    ``2**(k+1)``."""
    pairs = []
    k = 1
    while k < nranks:
        for r in range(0, nranks, 2 * k):
            if r + k < nranks:
                pairs.append((r, r + k))
        k *= 2
    return pairs


def rank_wire_bytes(algorithm: str, nranks: int, nbytes: int, *,
                    root: int = 0) -> List[int]:
    """Deterministic per-rank wire census: bytes each rank SENDS +
    RECEIVES through its links for one ``nbytes`` allreduce under
    ``algorithm`` — the quantity a slow rank's stall scales with, and
    the ranking key of :func:`failover_schedule`.

    The uniform schedules (``ring``/``bidir``/``rhd`` and the grouped
    ``hier``/``torus``) load every rank alike; ``tree`` concentrates
    ``2·log2(N)·B`` on the root and only ``2·B`` on an odd-relative
    leaf — which is exactly what failover exploits by rooting the tree
    away from the slow rank.  Totals are self-consistent by
    construction: every modeled message is counted once at its sender
    and once at its receiver (the tree total is ``4(N-1)B``, the ring
    total ``N · 4(N-1)B/N = 4(N-1)B`` — same traffic, different
    concentration)."""
    n, b = int(nranks), float(nbytes)
    if n <= 1:
        return [0] * max(n, 1)
    if algorithm in ("ring", "bidir", "rhd"):
        # Ring RS+AG: each rank sends and receives (N-1) chunks of B/N
        # in each half.  bidir's two counter-rotating half-payload
        # chains and rhd's shrinking butterfly move the same per-rank
        # total (B(1-1/N) sent per half), just in different step
        # shapes.
        per = 4.0 * (n - 1) * b / n
        return [int(round(per))] * n
    if algorithm in ("hier", "torus"):
        from ..tune.registry import best_group

        g = best_group(n)
        if g is None:
            raise DegradeError(
                f"algorithm {algorithm!r} needs a factorable world; "
                f"{n} has no nontrivial divisor")
        groups = n // g
        # Intra-group RS + AG on the full payload, inter-group
        # allreduce on the B/g shard (torus stripes the same totals
        # across two channels).
        per = (4.0 * (g - 1) * b / g
               + 4.0 * (groups - 1) * (b / g) / groups)
        return [int(round(per))] * n
    if algorithm == "tree":
        out = [0.0] * n
        for recv_rel, send_rel in _tree_rounds(n):
            # Reduce leg: sender ships B up; bcast leg mirrors it down.
            for rel, bytes_ in ((recv_rel, 2.0 * b), (send_rel, 2.0 * b)):
                out[(rel + root) % n] += bytes_
        return [int(round(v)) for v in out]
    raise DegradeError(
        f"no per-rank wire model for algorithm {algorithm!r} — extend "
        "rank_wire_bytes (and the chaos/bench censuses) to admit it as "
        "a failover candidate")


def failover_schedule(slow_rank: int, nranks: int, nbytes: int, *,
                      candidates: Optional[Sequence[str]] = None
                      ) -> Tuple[str, Dict[str, List[int]]]:
    """Re-rank schedule candidates by bytes through ``slow_rank``:
    returns ``(winner, {candidate: per-rank bytes})``.  Candidates
    default to the modeled registry algorithms applicable to the world
    (``tree`` evaluated rooted at ``slow_rank + 1`` so the slow rank
    is an odd-relative leaf); ties break on total wire, then name —
    fully deterministic."""
    from .. import tune

    if candidates is None:
        candidates = [a for a in ("ring", "bidir", "rhd", "tree")
                      if tune.get_algorithm(a).applicable(nranks)]
    if not candidates:
        raise DegradeError(
            f"no applicable failover candidate on a {nranks}-rank world")
    table: Dict[str, List[int]] = {}
    for name in candidates:
        table[name] = rank_wire_bytes(
            name, nranks, nbytes,
            root=(slow_rank + 1) % max(nranks, 1))
    winner = min(
        table,
        key=lambda a: (table[a][slow_rank], sum(table[a]), a))
    return winner, table


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

def _policy_codec_escalate(ctl: "DegradeController",
                           report: Optional[SlowRankReport], *,
                           codec: str = "q8") -> dict:
    """Exact → compressed wire, process-wide (the brownout response:
    the throttle is proportional to censused bytes, so a ~4x smaller
    wire stalls ~4x less)."""
    from .. import config as _cfg
    from ..compress import get_codec

    get_codec(codec)   # raise on unknown names BEFORE the switch
    ctl._save_once("compression", _cfg.default_compression(),
                   _cfg.set_default_compression)
    _cfg.set_default_compression(codec)
    return {"codec": codec}


def _policy_schedule_failover(ctl: "DegradeController",
                              report: Optional[SlowRankReport], *,
                              nbytes: int = 4 * 1024 * 1024,
                              candidates: Optional[Sequence[str]] = None
                              ) -> dict:
    """Pin the process-wide algorithm default to the candidate moving
    the fewest bytes through the slow rank (per-rank wire census)."""
    from .. import config as _cfg

    if report is None or not report.slow:
        raise DegradeError(
            "schedule_failover needs a SlowRankReport naming the slow "
            "rank (run the gray-failure detector first)")
    slow = min(report.slow)
    size = ctl.runtime.view.size
    winner, table = failover_schedule(slow, size, nbytes,
                                      candidates=candidates)
    ctl._save_once("algorithm", _cfg.default_algorithm(),
                   _cfg.set_default_algorithm)
    _cfg.set_default_algorithm(winner)
    return {"algorithm": winner, "slow_rank": slow, "nbytes": nbytes,
            "slow_rank_bytes": {a: t[slow] for a, t in table.items()},
            "per_rank_bytes": table}


def _policy_spare_demote(ctl: "DegradeController",
                         report: Optional[SlowRankReport], *,
                         n_data: int,
                         slots: Optional[Sequence[Optional[int]]] = None
                         ) -> dict:
    """Demote the slow DATA rank to spare duty and promote a hot spare
    into its deal slot (the elastic.spare slot-map permutation): the
    spare's mirror already holds the slot's state bitwise, so takeover
    is a LOCAL slice — ``takeover_shard``/``takeover_bank_slot`` — and
    the slow rank keeps answering collectives as an arithmetically
    invisible mirror instead of gating every fold with its stall."""
    if report is None or not report.slow:
        raise DegradeError(
            "spare_demote needs a SlowRankReport naming the slow rank")
    size = ctl.runtime.view.size
    if slots is None:
        slots = tuple(p if p < n_data else None for p in range(size))
    slots = list(slots)
    if len(slots) != size:
        raise DegradeError(
            f"slots maps {len(slots)} positions, world has {size}")
    slow_pos = next((p for p in sorted(report.slow)
                     if 0 <= p < size and slots[p] is not None), None)
    if slow_pos is None:
        raise DegradeError(
            f"no slow DATA rank to demote (slow={sorted(report.slow)}, "
            f"slots={tuple(slots)})")
    spare_pos = next((p for p, s in enumerate(slots)
                      if s is None and p not in report.slow), None)
    if spare_pos is None:
        raise DegradeError(
            "no hot spare available to promote — fall back to the "
            "planned elastic drain (elastic.replan / "
            "ElasticRuntime.drain), which reshards the slow rank's "
            "state off over the wire instead")
    moved = slots[slow_pos]
    slots[spare_pos], slots[slow_pos] = moved, None
    return {"slots": tuple(slots), "demoted": slow_pos,
            "promoted": spare_pos, "slot": moved, "n_data": n_data}


# The closed policy registry (registry-sync guarded: a policy without a
# chaos-matrix degrade cell — or a covered name that is not registered
# — fails the chaos smoke lane; see analyze.registry.degrade_problems).
DEGRADE_POLICIES = {
    "codec_escalate": _policy_codec_escalate,
    "schedule_failover": _policy_schedule_failover,
    "spare_demote": _policy_spare_demote,
}


def register_degrade_policy(name: str, fn) -> None:
    """Register a degrade policy ``fn(controller, report, **kw) ->
    action dict``.  The chaos-matrix guard makes an uncovered policy a
    CI failure — register AND add a degrade cell, or the suite tells
    you."""
    DEGRADE_POLICIES[name] = fn


@dataclass(frozen=True)
class DegradeTransition:
    """One ratified degrade transition: the epoch every rank agreed on
    BEFORE the switch, the policy, its action record, and the slow
    ranks that motivated it."""
    epoch: int
    policy: str
    action: dict
    slow: Tuple[int, ...] = ()


class DegradeController:
    """Drives epoch-fenced degrade transitions over an elastic runtime.

    ::

        ctl = DegradeController(n_ranks=8)
        report = detector.check()            # SlowRankReport
        tr = ctl.apply("schedule_failover", report)
        ...run the next phase against ctl.runtime.view (epoch-fenced)...
        ctl.reset()                          # end of the episode

    ``apply`` runs ONE membership-consensus round first (epoch += 1,
    every rank ratifies the same view over the probe-then-ratify
    protocol of ``elastic``) and only then flips the
    process-wide knob — so a rank still holding the previous epoch's
    phase is FENCED (``StaleEpochError``) rather than silently running
    the old schedule against peers running the new one.  Pass
    ``consensus=False`` only on a single-process caller that owns all
    ranks' configuration by construction (the Mode B chaos harness
    still runs the round — that is what its lock-step assertion
    checks).  ``device`` is the device of the runtime built from
    ``n_ranks`` (CUDA unless the caller passes ``"cpu"``)."""

    def __init__(self, runtime=None, *, n_ranks: Optional[int] = None,
                 device=None):
        if runtime is None:
            if n_ranks is None:
                raise DegradeError(
                    "DegradeController needs a runtime= or n_ranks=")
            from ..elastic.runtime import ElasticRuntime

            runtime = ElasticRuntime(n_ranks, device=device)
        self.runtime = runtime
        self.transitions: List[DegradeTransition] = []
        self._saved: Dict[str, Tuple] = {}
        # Decision ledger (ctl.ledger.DecisionLedger):
        # None on a bare DegradeController; the SelfTuningController
        # subclass installs one so fault-path transitions land in the
        # same "why did we switch" record as drift/crossover/recovery
        # switches.
        self.ledger = None

    def _save_once(self, key: str, value, setter) -> None:
        """Snapshot a knob the FIRST time a policy touches it, so
        :meth:`reset` restores the pre-episode configuration even
        across repeated transitions."""
        if key not in self._saved:
            self._saved[key] = (value, setter)

    def apply(self, policy: str,
              report: Optional[SlowRankReport] = None, *,
              consensus: bool = True, **kw) -> DegradeTransition:
        fn = DEGRADE_POLICIES.get(policy)
        if fn is None:
            raise DegradeError(
                f"unknown degrade policy {policy!r}; registered: "
                f"{sorted(DEGRADE_POLICIES)}")
        # ONE switching mechanism: the consensus round, the
        # process-wide mutation and the record all run through the
        # controller's ratified_switch — the fault fast path and the
        # measurement-triggered drift/crossover/recovery switches are
        # the same code with different triggers.
        from ..ctl.controller import POLICY_TRIGGER, ratified_switch

        view, action = ratified_switch(
            self, lambda host, _view: fn(host, report, **kw),
            consensus=consensus)
        tr = DegradeTransition(
            epoch=view.epoch, policy=policy, action=action,
            slow=tuple(sorted(report.slow)) if report is not None
            else ())
        self.transitions.append(tr)
        from ..obs import metrics as _metrics

        _metrics.inc(f'degrade_transitions_total{{policy="{policy}"}}',
                     help="epoch-fenced degrade-mode transitions by "
                          "policy (resilience.degrade)")
        if self.ledger is not None:
            est = getattr(self, "estimator", None)
            self.ledger.record(
                view.epoch, POLICY_TRIGGER.get(policy, "fault"),
                policy=policy,
                estimates=est.tier_estimates() if est is not None
                else (),
                new=dict(action),
                note=f"policy={policy} slow={tr.slow}")
        return tr

    def reset(self) -> None:
        """Restore every process-wide knob the episode's policies
        touched (original values, first-write-wins)."""
        for value, setter in self._saved.values():
            setter(value)
        self._saved.clear()
