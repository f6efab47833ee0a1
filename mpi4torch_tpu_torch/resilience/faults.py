"""Deterministic fault injection at the rank-thread chokepoints.

Port of ``mpi4torch_tpu/resilience/faults.py``.  Every collective of the
port goes through ``World.exchange`` and every message through
``World.p2p_send`` / ``p2p_recv``.  This module injects faults there,
keyed by ``(rank, op-kind, call-index)``, so one plan grammar covers
plain, fused, compressed and overlapped traffic without a hook per
subsystem::

    plan = FaultPlan([
        FaultSpec("delay", rank=2, op="Allreduce", seconds=0.5),
        FaultSpec("rank_death", rank=1, op="Allreduce", index=3),
        FaultSpec("bitflip", rank=0, op="Allgather.c"),
    ])
    with mpi.resilience.fault_scope(plan):
        mpi.run_ranks(step, 4)

* ``kind``: a registered :class:`FaultKind` (:data:`FAULT_KINDS`);
* ``rank``: the injected rank (None: any);
* ``op``: a prefix of the rendezvous op token, the first element of the
  exchange signature (``"Allreduce"``, ``"Allgather.c"``, ...), ``"p2p"``
  for the mailboxes, ``"ckpt_save"`` for checkpoint writes (None: any);
* ``index`` / ``count``: fire on the ``index``-th to
  ``index + count - 1``-th matching call on that rank (per-rank
  counters make the injection deterministic for a deterministic
  program).

Faults act before the payload is deposited, so corruption rides the
same wire as honest data and must be caught by the integrity guards
(:mod:`.guards`); a delay is rescued by the same retries as a real
straggler (``config.comm_retries``); a killed rank tears the world down
through the same attribution path as a real failure
(:class:`~mpi4torch_tpu_torch.runtime.RankFailedError`).

A corrupting fault never writes into the caller's tensor: a payload on
the card is a live tensor that autograd may have saved for the
backward, so ``corrupt_nan`` / ``corrupt_inf`` / ``bitflip`` act on a
clone, on the payload's own device.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..runtime import CommError, RankFailedError, _P2P_DROPPED
from ..utils.tree import tree_leaves, tree_unflatten

__all__ = [
    "FaultKind",
    "FaultSpec",
    "FaultPlan",
    "FAULT_KINDS",
    "register_fault_kind",
    "fault_scope",
    "as_plan",
    "pending_preemptions",
]


def pending_preemptions() -> Dict[int, int]:
    """The merged preemption notice board, ``{rank: ops_remaining}``: the
    active fault plan's posted notices
    (:meth:`FaultPlan.preemption_notices`) plus the transport's external
    board, the notices a real ``SIGTERM`` to a process-backend worker
    posts (``transport.external_preemptions``).  A caller cannot tell,
    and need not care, which of the two posted a notice."""
    from .. import config as _cfg
    from ..transport import external_preemptions

    plan = _cfg.fault_plan()
    out = dict(plan.preemption_notices()) if plan is not None else {}
    for rank, grace in external_preemptions().items():
        out.setdefault(rank, grace)
    return out


@dataclass(frozen=True)
class FaultKind:
    """A registered fault class: its name, the injection sites it can
    fire at, and whether it is *transient* (recoverable within
    ``config.comm_retries`` / ``comm_backoff``) or *permanent* (it must
    raise its typed, rank-attributed error).

    ``sites`` is a subset of {"exchange", "p2p", "checkpoint"}."""
    name: str
    sites: FrozenSet[str]
    transient: bool
    doc: str


FAULT_KINDS: Dict[str, FaultKind] = {}


def register_fault_kind(kind: FaultKind) -> FaultKind:
    """Register a fault kind."""
    if not kind.sites <= {"exchange", "p2p", "checkpoint"}:
        raise ValueError(f"unknown fault sites {sorted(kind.sites)}")
    FAULT_KINDS[kind.name] = kind
    return kind


register_fault_kind(FaultKind(
    "rank_death", frozenset({"exchange", "p2p"}), transient=False,
    doc="the rank dies mid-collective (simulated preemption): it raises "
        "RankFailedError and every peer blocked on the rendezvous gets "
        "the same typed error naming the dead rank"))
register_fault_kind(FaultKind(
    "delay", frozenset({"exchange", "p2p"}), transient=True,
    doc="the rank arrives `seconds` late: recovered within "
        "config.comm_retries backoff extensions, else attributed "
        "DeadlockError (arrived/missing rank sets) on the punctual ranks"))
register_fault_kind(FaultKind(
    "drop_p2p", frozenset({"p2p"}), transient=True,
    doc="the message vanishes off the mailbox wire: the receiver's retry "
        "triggers redelivery (the NACK-retransmission analogue), else "
        "DeadlockError"))
register_fault_kind(FaultKind(
    "corrupt_nan", frozenset({"exchange", "p2p"}), transient=False,
    doc="a NaN is written into the rank's float payload: detected by "
        "config.comm_finite_guard as IntegrityError naming the rank"))
register_fault_kind(FaultKind(
    "corrupt_inf", frozenset({"exchange", "p2p"}), transient=False,
    doc="an Inf is written into the rank's float payload: detected by "
        "config.comm_finite_guard as IntegrityError naming the rank"))
register_fault_kind(FaultKind(
    "bitflip", frozenset({"exchange", "p2p"}), transient=False,
    doc="a low bit flips in the rank's encoded integer wire block (the "
        "int8/int16 codec payload): detected by config.comm_wire_checksum "
        "as IntegrityError naming the rank; float payloads have no "
        "eligible leaf, so the fault is inert off the compressed wire"))
register_fault_kind(FaultKind(
    "preempt", frozenset({"exchange", "p2p"}), transient=False,
    doc="advance-notice teardown (the cloud-preemption shape): on the "
        "spec's FIRST matching call the rank posts a preemption notice "
        "(FaultPlan.preemption_notices) but keeps answering collectives "
        "and probes; on the LAST call of the index..index+count window "
        "it dies exactly like rank_death (RankFailedError naming the "
        "rank on every peer).  count-1 ops of advance notice: an elastic "
        "runtime that drains the rank inside the window resumes on the "
        "shrunk world; a job that ignores the "
        "notice gets the attributed raise"))
register_fault_kind(FaultKind(
    "truncate_save", frozenset({"checkpoint"}), transient=True,
    doc="the checkpoint write is killed mid-save (the just-written step's "
        "largest file is truncated): resilience.restore_or_init falls "
        "back to the last complete step.  Its site, "
        "FaultPlan.on_checkpoint_save, runs after every save of "
        "utils.checkpoint"))

# ------------------------------------------------------ gray failures
# Performance faults: nothing dies, nothing corrupts, the job just gets
# slow.  Same two chokepoints, same plan grammar; detection reads the
# obs CommEvent stream (resilience/health.py) instead of an error type.

register_fault_kind(FaultKind(
    "slow_rank", frozenset({"exchange", "p2p"}), transient=True,
    doc="a chronically slow rank: every matching chokepoint call on the "
        "rank is delayed by `seconds` (use count>1 for persistence — "
        "the canonical gray failure).  Recovered within "
        "config.comm_retries backoff like `delay`; DETECTED by the "
        "gray-failure detector (resilience.health) as the rank whose "
        "pre-barrier local latency dominates while its barrier wait "
        "stays near zero — everyone waits on it, it waits on no one"))
register_fault_kind(FaultKind(
    "jitter", frozenset({"exchange", "p2p"}), transient=True,
    doc="noisy-neighbor latency jitter: each matching call sleeps a "
        "seeded-deterministic duration in [0, `seconds`) (FNV-hashed "
        "from (seed, rank, call index) — reproducible storms).  "
        "Recovered under retries; raises the rank's latency variance "
        "without the persistent signature of slow_rank"))
register_fault_kind(FaultKind(
    "flaky_link", frozenset({"p2p"}), transient=True,
    doc="a lossy-but-alive link: each matching p2p send is dropped with "
        "seeded-deterministic probability `p` (the hash discipline of "
        "jitter), recovered through the SAME redelivery path as "
        "drop_p2p (stash + NACK-retransmission on recv retry).  Off "
        "the p2p wire it is inert — the exchange rendezvous has no "
        "per-link messages to lose"))
register_fault_kind(FaultKind(
    "brownout", frozenset({"exchange", "p2p"}), transient=True,
    doc="a browned-out link: each matching call is throttled "
        "proportionally to its CENSUSED payload bytes "
        "(`per_byte_s` x obs.events.payload_nbytes) — so compressed "
        "traffic PROVABLY suffers less (a q8 wire carries ~1/4 the "
        "bytes and sleeps ~1/4 as long; the fired-fault ledger records "
        "bytes and sleep per firing).  The degrade policy it motivates "
        "is codec escalation (resilience.degrade)"))


@dataclass(frozen=True)
class FaultSpec:
    """One planned fault: WHAT (``kind``), WHERE (``rank`` × ``op``),
    WHEN (``index``/``count`` among that rank's matching calls), plus
    kind-specific parameters: ``seconds`` (``delay``/``slow_rank`` per
    call; ``jitter`` maximum), ``nflips`` (``bitflip``), ``p``
    (``flaky_link`` drop probability), ``per_byte_s`` (``brownout``
    throttle per censused payload byte), ``seed`` (the deterministic
    jitter/flaky hash salt)."""
    kind: str
    rank: Optional[int] = None
    op: Optional[str] = None
    index: int = 0
    count: int = 1
    seconds: float = 0.25
    nflips: int = 1
    p: float = 1.0
    per_byte_s: float = 1e-3
    seed: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; registered kinds: "
                f"{sorted(FAULT_KINDS)}")
        if self.index < 0 or self.count < 1:
            raise ValueError("FaultSpec needs index >= 0 and count >= 1")
        if not (0.0 <= self.p <= 1.0):
            raise ValueError(f"FaultSpec p must be in [0, 1], got {self.p}")
        if self.per_byte_s < 0:
            raise ValueError(
                f"FaultSpec per_byte_s must be >= 0, got {self.per_byte_s}")


@dataclass
class FiredFault:
    """Ledger entry: a fault that actually acted on a payload/rank.
    ``info`` carries kind-specific firing evidence (the brownout
    entry's ``bytes`` and ``sleep_s``)."""
    kind: str
    rank: int
    op: str
    site: str
    info: Optional[dict] = None


class FaultPlan:
    """A set of :class:`FaultSpec` with deterministic per-(spec, rank)
    call counters and a fired-fault ledger (``fired``, the evidence that
    a run really exercised its fault)."""

    def __init__(self, specs: Sequence[FaultSpec]):
        self.specs: Tuple[FaultSpec, ...] = tuple(
            s if isinstance(s, FaultSpec) else FaultSpec(**s)
            for s in specs)
        self._counts: Dict[Tuple[int, int], int] = {}
        self._lock = threading.Lock()
        self.fired: List[FiredFault] = []
        # Preemption notice board (the `preempt` kind): rank -> index of
        # the matching call it will die on.  Plan-scoped, not
        # world-scoped: a notice outlives the world of the run_ranks
        # call that posted it.
        self._preempt_death_at: Dict[int, Tuple[int, int]] = {}

    # ------------------------------------------------------------ match

    def _matching(self, site: str, rank: int, op: str):
        """(spec-index, spec) pairs firing NOW for this (site, rank, op)
        call — each matching spec's per-rank counter advances exactly
        once per call, so the index window is deterministic.  Corruption
        kinds REFUND the counter when a call carried no eligible leaf
        (:meth:`_refund`), so their call-index counts eligible wire
        payloads, not protocol chatter."""
        out = []
        with self._lock:
            for i, spec in enumerate(self.specs):
                kind = FAULT_KINDS[spec.kind]
                if site not in kind.sites:
                    continue
                if spec.rank is not None and spec.rank != rank:
                    continue
                if spec.op is not None and not op.startswith(spec.op):
                    continue
                seen = self._counts.get((i, rank), 0)
                self._counts[(i, rank)] = seen + 1
                if spec.index <= seen < spec.index + spec.count:
                    out.append((i, spec))
        return out

    def _refund(self, spec_idx: int, rank: int) -> None:
        with self._lock:
            self._counts[(spec_idx, rank)] -= 1

    def _note(self, spec: FaultSpec, rank: int, op: str, site: str,
              info: Optional[dict] = None):
        with self._lock:
            self.fired.append(FiredFault(spec.kind, rank, op, site, info))

    def fired_kinds(self) -> FrozenSet[str]:
        with self._lock:
            return frozenset(f.kind for f in self.fired)

    def preemption_notices(self) -> Dict[int, int]:
        """The preemption notice board: ``{rank: ops_remaining}`` for
        every rank with a posted (and not yet consumed) advance notice —
        ``ops_remaining`` counts the matching calls the rank will still
        answer, including the one it dies on."""
        out = {}
        with self._lock:
            for rank, (spec_idx, death_at) in \
                    self._preempt_death_at.items():
                seen = self._counts.get((spec_idx, rank), 0)
                remaining = death_at - (seen - 1)
                if remaining > 0:
                    out[rank] = remaining
        return out

    def clear_preemption(self, rank: int) -> None:
        """Drop ``rank``'s notice (once the rank has been drained out of
        the world, its death op never runs), the transport's external
        notice for it included: the drain consumed whichever posted
        it."""
        with self._lock:
            self._preempt_death_at.pop(rank, None)
        from ..transport import clear_external_preemption

        clear_external_preemption(rank)

    def absorb_remote(self, rank: int, dump: dict) -> None:
        """Merge a process-backend worker's plan epilogue into this
        (parent) plan: ``rank``'s fired-fault entries, its per-(spec,
        rank) call counters and the preemption notice it posted.  Only
        ``rank``'s own keys move (a rank advances only its own counters),
        so the merges of several ranks commute and the plan reads as if
        its hooks had run in this process."""
        with self._lock:
            for key, n in (dump.get("counts") or {}).items():
                if key[1] == rank:
                    self._counts[key] = max(self._counts.get(key, 0), n)
            self.fired.extend(f for f in (dump.get("fired") or ())
                              if f.rank == rank)
            for r, v in (dump.get("notices") or {}).items():
                if r == rank:
                    self._preempt_death_at[r] = tuple(v)

    def wants_checkpoint(self) -> bool:
        """Does any spec target the checkpoint site at all?"""
        return any("checkpoint" in FAULT_KINDS[s.kind].sites
                   for s in self.specs)

    # ------------------------------------------------------- injection

    def on_exchange(self, world, rank: int, signature, payload):
        """Runtime hook: called by ``World.exchange`` before the payload
        is deposited.  May sleep (delay), raise (rank_death — after
        ``world.mark_dead`` so peers attribute promptly), or return a
        corrupted payload."""
        op = str(signature[0])
        for i, spec in self._matching("exchange", rank, op):
            payload = self._fire(i, spec, world, rank, op, "exchange",
                                 payload)
        return payload

    def on_p2p_send(self, world, src: int, dst: int, tag: int, payload):
        """Runtime hook: called by ``World.p2p_send``.  Same actions as
        the exchange hook, plus ``drop_p2p`` (returns the runtime's drop
        sentinel after stashing the payload for retry redelivery).
        Every matched spec fires even when one of them is a drop — the
        drop is applied LAST, so a co-matched delay/corruption is not
        silently swallowed with its index window already consumed (and
        behavior does not depend on spec order).  ``flaky_link`` is the
        probabilistic drop: it consumes its index window on every
        matching call (the link IS flaky whether or not this message
        drops) but only fires — and drops — when its seeded hash says
        so."""
        drop_spec = None
        for i, spec in self._matching("p2p", src, "p2p"):
            if spec.kind == "drop_p2p":
                drop_spec = spec
                continue
            if spec.kind == "flaky_link":
                with self._lock:
                    seen = self._counts[(i, src)] - 1
                if _hash01(spec.seed, src, seen) < spec.p:
                    drop_spec = spec
                continue
            payload = self._fire(i, spec, world, src, "p2p", "p2p",
                                 payload)
        if drop_spec is not None:
            with world._mb_lock:
                world._dropped.setdefault(
                    (src, dst, tag), []).append(payload)
            self._note(drop_spec, src, "p2p", "p2p")
            return _P2P_DROPPED
        return payload

    def on_checkpoint_save(self, path: str, rank: int = 0) -> None:
        """Checkpoint hook, called after a save finalizes with the step
        directory: ``truncate_save`` damages the just-written step, the
        deterministic stand-in for a kill mid-save.  Every save of
        ``utils/checkpoint.py`` calls it."""
        for i, spec in self._matching("checkpoint", rank, "ckpt_save"):
            if spec.kind == "truncate_save":
                if _truncate_tree(path):
                    self._note(spec, rank, "ckpt_save", "checkpoint")
                else:
                    self._refund(i, rank)

    def _fire(self, spec_idx: int, spec: FaultSpec, world, rank: int,
              op: str, site: str, payload):
        if spec.kind == "delay":
            self._note(spec, rank, op, site)
            time.sleep(spec.seconds)
            return payload
        if spec.kind == "slow_rank":
            # The persistent gray failure: a fixed per-call tax on every
            # matching chokepoint call of the rank.
            self._note(spec, rank, op, site,
                       info={"sleep_s": spec.seconds})
            time.sleep(spec.seconds)
            return payload
        if spec.kind == "jitter":
            with self._lock:
                seen = self._counts[(spec_idx, rank)] - 1
            pause = spec.seconds * _hash01(spec.seed, rank, seen)
            self._note(spec, rank, op, site, info={"sleep_s": pause})
            time.sleep(pause)
            return payload
        if spec.kind == "brownout":
            # Throttle proportional to the payload bytes (encoded bytes
            # on a compressed wire), so a codec shortens the stall.
            from ..obs.events import payload_nbytes

            nbytes = payload_nbytes(payload)
            pause = spec.per_byte_s * nbytes
            self._note(spec, rank, op, site,
                       info={"bytes": nbytes, "sleep_s": pause})
            time.sleep(pause)
            return payload
        if spec.kind == "rank_death":
            self._note(spec, rank, op, site)
            err = RankFailedError(
                f"rank {rank} was killed by fault injection during {op} "
                "(simulated preemption)", ranks=(rank,))
            world.mark_dead(rank, err)
            raise err
        if spec.kind == "preempt":
            with self._lock:
                seen = self._counts[(spec_idx, rank)] - 1
            if seen == spec.index:
                # The NOTICE: posted on the window's first matching
                # call; the rank keeps answering until the window ends.
                # Posting is the firing evidence (the teardown below
                # may legitimately never run — a drained rank leaves
                # the world before its death op).
                with self._lock:
                    self._preempt_death_at[rank] = (
                        spec_idx, spec.index + spec.count - 1)
                self._note(spec, rank, op, site)
            if seen == spec.index + spec.count - 1:
                err = RankFailedError(
                    f"rank {rank} was preempted during {op} after "
                    f"{spec.count - 1} op(s) of advance notice (the "
                    "notice went unanswered)", ranks=(rank,))
                world.mark_dead(rank, err)
                raise err
            return payload
        if spec.kind in ("corrupt_nan", "corrupt_inf"):
            value = float("nan") if spec.kind == "corrupt_nan" \
                else float("inf")
            payload, hit = _map_first_leaf(
                payload, _is_float_leaf, lambda a: _poison(a, value))
            if hit:
                self._note(spec, rank, op, site)
            else:
                # No eligible leaf: the window is not consumed, so the
                # spec keeps hunting for the first corruptible payload.
                self._refund(spec_idx, rank)
            return payload
        if spec.kind == "bitflip":
            payload, hit = _map_first_leaf(
                payload, _is_int_wire_leaf,
                lambda a: _flip_bits(a, spec.nflips))
            if hit:
                self._note(spec, rank, op, site)
            else:
                self._refund(spec_idx, rank)
            return payload
        raise CommError(
            f"fault kind {spec.kind!r} has no injection action for site "
            f"{site!r}")


# ---------------------------------------------------------------- mutation

def _hash01(seed: int, rank: int, idx: int) -> float:
    """Deterministic draw in [0, 1) from (seed, rank, call index): FNV-1a
    over the triple, so jitter and flaky-link drops replay bit for bit
    under the same plan."""
    h = 0x811C9DC5
    for part in (seed, rank, idx):
        for ch in str(int(part)).encode():
            h ^= ch
            h = (h * 0x01000193) & 0xFFFFFFFF
        h ^= 0x7C
        h = (h * 0x01000193) & 0xFFFFFFFF
    return (h & 0xFFFFFF) / float(1 << 24)


def _is_float_leaf(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() > 0 and leaf.is_floating_point()
    return (isinstance(leaf, np.ndarray) and leaf.size > 0
            and np.issubdtype(leaf.dtype, np.floating))


def _is_int_wire_leaf(leaf) -> bool:
    """Encoded wire blocks only: integer tensors (the int8 q8 payload,
    int16 words).  Python ints (counts, roots) are protocol data, not
    wire payload."""
    if isinstance(leaf, torch.Tensor):
        return (leaf.numel() > 0 and not leaf.is_floating_point()
                and not leaf.is_complex() and leaf.dtype != torch.bool)
    return (isinstance(leaf, np.ndarray) and leaf.size > 0
            and np.issubdtype(leaf.dtype, np.integer))


def _map_first_leaf(payload, pred, fn):
    """Replace the first leaf of ``payload`` satisfying ``pred`` by
    ``fn(leaf)`` in a rebuilt tree; returns ``(new_payload, fired)``.
    The leaf order is the tree order, so the same plan always corrupts
    the same leaf."""
    leaves = tree_leaves(payload)
    for i, leaf in enumerate(leaves):
        if pred(leaf):
            leaves[i] = fn(leaf)
            return tree_unflatten(payload, leaves), True
    return payload, False


def _fresh(leaf):
    """A private contiguous copy of ``leaf``, on its own device."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone(memory_format=torch.contiguous_format)
    return np.array(leaf, copy=True)


def _poison(leaf, value: float):
    a = _fresh(leaf)
    a.reshape(-1)[0] = value
    return a


def _flip_bits(leaf, nflips: int):
    a = _fresh(leaf)
    if isinstance(a, torch.Tensor):
        view = a.reshape(-1).view(torch.uint8)
        n = view.numel()
    else:
        view = a.reshape(-1).view(np.uint8)
        n = view.size
    for k in range(max(int(nflips), 1)):
        # Advance the bit once the byte index wraps: flipping the same
        # bit twice would undo the corruption the ledger records.
        view[k % n] ^= 1 << ((k // n) % 8)
    return a


def _truncate_tree(path: str) -> bool:
    """Damage a checkpoint step directory as a kill mid-save would: the
    largest regular file (ties broken by name) is cut to half its size.
    Returns whether anything was damaged."""
    import os

    best = None
    for root, _dirs, files in os.walk(path):
        for name in files:
            p = os.path.join(root, name)
            try:
                size = os.path.getsize(p)
            except OSError:
                continue
            if size > 0 and (best is None or (-size, p) < best[0]):
                best = ((-size, p), p, size)
    if best is None:
        return False
    _key, p, size = best
    with open(p, "r+b") as f:
        f.truncate(size // 2)
    return True


# ---------------------------------------------------------------- scoping

def as_plan(plan) -> FaultPlan:
    """Coerce a FaultPlan, a FaultSpec or a sequence of specs to a
    plan."""
    if isinstance(plan, FaultPlan):
        return plan
    if isinstance(plan, FaultSpec):
        return FaultPlan([plan])
    return FaultPlan(list(plan))


class fault_scope:
    """Install a fault plan for a ``with`` block::

        with mpi.resilience.fault_scope([
                mpi.resilience.FaultSpec("delay", rank=1, seconds=0.3)]):
            mpi.run_ranks(step, 4)

    Process-wide (``config.set_fault_plan``), unlike the per-thread
    compression and fusion scopes: faults must reach the rank threads
    ``run_ranks`` starts, which a thread-local scope opened outside them
    never could.  The previous plan is restored on exit.  Yields the
    installed :class:`FaultPlan` (its ``fired`` ledger shows what
    acted)."""

    def __init__(self, plan):
        self._plan = as_plan(plan)
        self._prev = None

    def __enter__(self) -> FaultPlan:
        from .. import config as _cfg

        self._prev = _cfg.fault_plan()
        _cfg.set_fault_plan(self._plan)
        return self._plan

    def __exit__(self, *exc):
        from .. import config as _cfg

        _cfg.set_fault_plan(self._prev)
        return False
