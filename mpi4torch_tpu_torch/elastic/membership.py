"""Membership consensus: who is in the world, under which epoch.

Port of ``mpi4torch_tpu/elastic/membership.py``.

The elastic runtime's first problem is agreement: after an attributed
failure (``RankFailedError.ranks``) or a preemption notice
(:func:`mpi4torch_tpu_torch.resilience.pending_preemptions`), the survivors
must all adopt the SAME shrunk (or grown) membership before any of them
re-lays state — two ranks replanning against different worlds is silent
corruption.  This module runs that agreement as a two-round protocol
built entirely on existing runtime primitives:

1. **probe** — every live rank calls ``World.health_check`` (the
   resettable attributed barrier of runtime.py): dead and hung ranks
   land in ``missing``, and the probe *returns* its report instead of
   tearing collective state, so consensus can run on a world whose
   collective barrier is already broken.
2. **ratify** — the arrived ranks exchange proposals over the p2p
   mailboxes (epoch-fenced tags — see :func:`fence_tag`): each
   proposes ``WorldView(epoch + 1, survivors, mesh)``; the lowest
   arrived rank collects, picks the modal proposal, and answers every
   participant with the verdict.  Disagreement raises a typed,
   rank-attributed :class:`ConsensusError` naming the ranks whose
   proposal lost; a SECOND failure mid-consensus surfaces as the
   runtime's own typed errors (a dead peer's ``RankFailedError``, a
   bounded-timeout ``DeadlockError``) — never a hang, because every
   wait in the protocol is the runtime's own bounded wait.

**Epoch fencing.**  ``WorldView.epoch`` increases by exactly one per
adopted transition.  Consensus traffic is tagged by the epoch it
transitions FROM (:func:`fence_tag`), so a straggler's stale round
cannot be consumed by a later one; checkpoint steps record the epoch
they were saved under (``utils/checkpoint.py``) so a stale-world resume
raises instead of loading shards whose meaning changed; and the elastic
runtime (:class:`~mpi4torch_tpu_torch.elastic.runtime.ElasticRuntime`) refuses
to run a phase against a view object whose epoch is not current
(:class:`StaleEpochError` naming both epochs).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from ..runtime import CommError, effective_rank_context

__all__ = [
    "WorldView",
    "ElasticError",
    "ConsensusError",
    "StaleEpochError",
    "fence_tag",
    "agree_world_view",
]


class ElasticError(CommError):
    """Base class for elastic world-resize errors."""


class ConsensusError(ElasticError):
    """Membership consensus failed: the participants did not propose
    the same next world view.  ``ranks`` names the STABLE IDS whose
    proposal disagreed with the ratified (modal) one — the
    rank-attribution discipline of the fault layer applied to coordination."""

    def __init__(self, message: str, ranks=()):
        super().__init__(message)
        self.ranks = frozenset(ranks)


class StaleEpochError(ElasticError):
    """An operation presented a world view from a superseded epoch.
    Carries both epochs — the one presented and the one current — the
    same both-sides attribution the checkpoint fence gives."""

    def __init__(self, message: str, have: int, want: int):
        super().__init__(message)
        self.have = int(have)
        self.want = int(want)

    def __reduce__(self):
        # Crosses the process transport's wire with both epochs.
        return (type(self), (str(self), self.have, self.want),
                self.__dict__)


# Tag namespace for consensus p2p traffic: far above anything user code
# or the subsystems use.  Each epoch owns a disjoint block of
# _PHASES_PER_EPOCH tags, so a stale round's messages can never be
# consumed by a later epoch's ratification — the mailbox keys simply
# differ.
_TAG_BASE = 7_340_000
_PHASES_PER_EPOCH = 4
_PROPOSE, _VERDICT = 0, 1


def fence_tag(epoch: int, phase: int) -> int:
    """The p2p tag of consensus ``phase`` for the round transitioning
    FROM ``epoch`` — the epoch fence made concrete."""
    if not (0 <= phase < _PHASES_PER_EPOCH):
        raise ValueError(f"phase must be in [0, {_PHASES_PER_EPOCH})")
    return _TAG_BASE + int(epoch) * _PHASES_PER_EPOCH + phase


@dataclass(frozen=True)
class WorldView:
    """An agreed membership: monotonically increasing ``epoch``, the
    sorted tuple of STABLE rank ids that are alive, and the virtual mesh
    shape the survivors run as.  World positions are the indices of
    ``alive``: the rank-``j`` thread of an epoch's Mode B world acts for
    id ``alive[j]`` — ids persist across resizes, positions do not."""

    epoch: int
    alive: Tuple[int, ...]
    mesh_shape: Tuple[int, ...]

    def __post_init__(self):
        alive = tuple(int(r) for r in self.alive)
        mesh = tuple(int(m) for m in self.mesh_shape)
        object.__setattr__(self, "alive", alive)
        object.__setattr__(self, "mesh_shape", mesh)
        if self.epoch < 0:
            raise ElasticError(f"epoch must be >= 0, got {self.epoch}")
        if not alive:
            raise ElasticError("a WorldView needs at least one rank")
        if list(alive) != sorted(set(alive)):
            raise ElasticError(
                f"alive ids must be sorted and unique, got {alive}")
        if not mesh or any(m < 1 for m in mesh):
            raise ElasticError(f"invalid mesh shape {mesh}")
        if math.prod(mesh) != len(alive):
            raise ElasticError(
                f"mesh shape {mesh} spans {math.prod(mesh)} ranks but "
                f"{len(alive)} are alive")

    @property
    def size(self) -> int:
        return len(self.alive)

    def position(self, rank_id: int) -> int:
        """World position of stable id ``rank_id`` in this epoch."""
        try:
            return self.alive.index(int(rank_id))
        except ValueError:
            raise ElasticError(
                f"rank id {rank_id} is not alive in epoch {self.epoch} "
                f"(alive: {self.alive})") from None

    def id_at(self, position: int) -> int:
        return self.alive[position]

    def describe(self) -> str:
        mesh = "x".join(str(m) for m in self.mesh_shape)
        return f"epoch {self.epoch}: ({mesh}) over ids {list(self.alive)}"


def initial_view(n: int, mesh_shape=None) -> WorldView:
    """Epoch-0 view of a fresh ``n``-rank job (ids 0..n-1)."""
    return WorldView(0, tuple(range(int(n))),
                     tuple(mesh_shape) if mesh_shape else (int(n),))


def _emit_transition(view: WorldView, new: WorldView,
                     is_coordinator: bool) -> None:
    """Epoch-transition observability (``obs``): one counter
    tick per adopted transition (the coordinator's), world gauges from
    every adopter (idempotent)."""
    from ..obs import metrics as _metrics

    if is_coordinator:
        _metrics.inc("elastic_epoch_transitions_total",
                     help="adopted elastic world-view transitions")
    _metrics.set_gauge("elastic_world_epoch", new.epoch,
                       help="current elastic world epoch")
    _metrics.set_gauge("elastic_world_size", new.size,
                       help="alive ranks in the current elastic world")


def agree_world_view(view: WorldView, *, leaving=(), joining=(),
                     mesh_shape=None, probe_timeout: Optional[float] = None,
                     _propose=None) -> WorldView:
    """Run one membership-consensus round; every live rank of the
    current world must call it (collectively, like ``check_health``).
    Returns the ratified next :class:`WorldView` on every arrived rank.

    * ``leaving`` — stable ids being drained out deliberately (a
      preemption notice's doomed rank): they PARTICIPATE in the round
      (they are still answering) but are excluded from the next view.
    * ``joining`` — stable ids re-admitted on a grow (capacity
      returned); must be disjoint from the current membership.
    * ``mesh_shape`` — the next view's mesh (default: flat).
    * ``probe_timeout`` — the health-probe bound; dead/hung ranks cost
      exactly this long to detect (``HealthReport.probe_duration_s``).

    Failure modes, all typed and bounded: proposal disagreement (or a
    stale-epoch proposal) raises :class:`ConsensusError` naming the
    losing ids on every participant; a rank dying mid-round surfaces as
    the runtime's attributed ``RankFailedError``/``DeadlockError``.
    ``_propose`` (testing) replaces this rank's proposal — the
    disagreement-injection hook the elastic matrix's consensus cells
    use."""
    ctx = effective_rank_context()
    world, pos = ctx.world, ctx.rank
    if world.size != view.size:
        raise ElasticError(
            f"agree_world_view must run on the world of {view.describe()} "
            f"(size {view.size}); this world has {world.size} ranks")
    leaving_ids = frozenset(int(r) for r in leaving)
    joining_ids = tuple(sorted(int(r) for r in joining))
    bad_leave = leaving_ids - set(view.alive)
    if bad_leave:
        raise ElasticError(
            f"leaving ids {sorted(bad_leave)} are not alive in "
            f"epoch {view.epoch}")
    overlap = set(joining_ids) & set(view.alive)
    if overlap:
        raise ElasticError(
            f"joining ids {sorted(overlap)} are already alive in "
            f"epoch {view.epoch}")

    report = world.health_check(pos, probe_timeout)
    arrived = sorted(report.arrived)
    if not arrived:
        raise ConsensusError(
            "health probe returned an empty arrival set", ranks=())
    survivors = [view.alive[p] for p in arrived
                 if view.alive[p] not in leaving_ids]
    new_alive = tuple(sorted(set(survivors) | set(joining_ids)))
    if not new_alive:
        raise ConsensusError(
            "no rank survives the proposed transition (every arrived "
            "rank is leaving)", ranks=frozenset(leaving_ids))
    proposal = WorldView(
        view.epoch + 1, new_alive,
        tuple(mesh_shape) if mesh_shape else (len(new_alive),))
    if _propose is not None:
        proposal = _propose(proposal)

    coord = arrived[0]
    tag_p = fence_tag(view.epoch, _PROPOSE)
    tag_v = fence_tag(view.epoch, _VERDICT)
    if pos == coord:
        proposals: Dict[int, WorldView] = {coord: proposal}
        for p in arrived[1:]:
            # A peer dying here raises the runtime's attributed
            # RankFailedError; a peer that never sends, the bounded
            # DeadlockError — the "second failure mid-consensus ends in
            # a typed raise" contract comes from the mailbox itself.
            proposals[p] = world.p2p_recv(p, coord, tag_p)
        verdict = _ratify(view, proposals)
        for p in arrived[1:]:
            world.p2p_send(coord, p, tag_v, verdict)
    else:
        world.p2p_send(pos, coord, tag_p, proposal)
        verdict = world.p2p_recv(coord, pos, tag_v)

    kind, payload = verdict
    if kind == "disagree":
        raise ConsensusError(
            f"membership consensus from epoch {view.epoch} failed: "
            f"rank id(s) {sorted(payload)} proposed a different next "
            "world view than the ratified one", ranks=payload)
    ratified: WorldView = payload
    _emit_transition(view, ratified, is_coordinator=(pos == coord))
    return ratified


def _ratify(view: WorldView, proposals: Dict[int, "WorldView"]):
    """The coordinator's verdict: the modal valid proposal wins
    (deterministic tie-break: the lowest proposing position); proposals
    from a different source epoch are stale by definition and can never
    win.  Returns ``("ok", view)`` or ``("disagree", frozenset(ids))``."""
    groups: Dict[object, list] = {}
    for p in sorted(proposals):
        prop = proposals[p]
        valid = (isinstance(prop, WorldView)
                 and prop.epoch == view.epoch + 1)
        groups.setdefault(prop if valid else ("stale", p), []).append(p)
    winner_key = max(
        (k for k in groups if isinstance(k, WorldView)),
        key=lambda k: (len(groups[k]), -min(groups[k])), default=None)
    if winner_key is None:
        # Nobody proposed a valid next view (all stale): attribute all.
        bad = frozenset(view.alive[p] for ps in groups.values()
                        for p in ps)
        return ("disagree", bad)
    losers = [p for k, ps in groups.items() if k != winner_key
              for p in ps]
    if losers:
        return ("disagree", frozenset(view.alive[p] for p in losers))
    return ("ok", winner_key)
