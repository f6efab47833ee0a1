"""The elastic runtime: phase execution + membership transitions.

Port of ``mpi4torch_tpu/elastic/runtime.py``; phases run on the port's
``run_ranks`` on the runtime's ``device`` (CUDA unless ``"cpu"`` is asked
for).

Mode B worlds are per-``run_ranks`` by construction (a world's threads
die with the call), so an elastic job is naturally a sequence of
**phases**: run a phase on the current membership, observe what it
reports (results, an attributed failure, a preemption notice on the
fault plan's board), agree on the next membership, re-lay state, run
the next phase.  :class:`ElasticRuntime` owns exactly that loop state:
the current :class:`~.membership.WorldView`, the set of stable ids
known dead (harvested from ``RankFailedError.ranks`` — the
attribution is what makes this loop possible), and the consensus verb
that turns both into the next agreed view.

Epoch fencing at this layer: :meth:`run_phase` refuses a view object
from a superseded epoch (:class:`~.membership.StaleEpochError` naming
both epochs) — the caller-side analogue of the consensus tag fence and
the checkpoint epoch stamp.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..runtime import RankFailedError, run_ranks
from .membership import (ElasticError, StaleEpochError, WorldView,
                         agree_world_view, initial_view)

__all__ = ["ElasticRuntime"]


class ElasticRuntime:
    """Drives an elastic Mode B job across world resizes.

    ::

        rt = ElasticRuntime(8)
        try:
            outs = rt.run_phase(train_phase)      # body(pos, rank_id)
        except RankFailedError:
            view = rt.consensus()                 # shrink past the dead
            ...replan state, resume on rt.view...

    ``run_phase`` bodies receive ``(position, rank_id)`` — the world
    position (this epoch's comm rank) and the stable id it acts for.
    Failures recorded by :meth:`run_phase` (or :meth:`note_dead`)
    become the absent side of the next :meth:`consensus`: their
    positions run no body (the Mode B stand-in for the machine being
    gone), the probe observes them as ``missing``, and the ratified
    view drops them.  ``note_dead`` is therefore an assertion, not a
    hint — a mistaken note evicts a healthy rank, so only record
    attributions the runtime handed you (``RankFailedError.ranks``).

    ``device`` is the device every phase's world runs on (CUDA unless
    the caller passes ``"cpu"``), as ``run_ranks``'s."""

    def __init__(self, n_ranks: Optional[int] = None, *,
                 view: Optional[WorldView] = None, mesh_shape=None,
                 probe_timeout: float = 1.0,
                 world_timeout: Optional[float] = None, device=None):
        if (n_ranks is None) == (view is None):
            raise ElasticError(
                "ElasticRuntime needs exactly one of n_ranks= or view=")
        self._view = view if view is not None \
            else initial_view(n_ranks, mesh_shape)
        self.probe_timeout = float(probe_timeout)
        self.world_timeout = world_timeout
        self.device = device
        self._dead: Dict[int, str] = {}

    # ------------------------------------------------------------- state

    @property
    def view(self) -> WorldView:
        return self._view

    @property
    def epoch(self) -> int:
        return self._view.epoch

    @property
    def dead_ids(self) -> Dict[int, str]:
        """Stable ids known dead (id -> reason), pending the next
        consensus round."""
        return dict(self._dead)

    def note_dead(self, rank_id: int, reason: str = "reported dead"):
        self._dead[int(rank_id)] = reason

    # ------------------------------------------------------------ phases

    def run_phase(self, body, *, view: Optional[WorldView] = None,
                  timeout: Optional[float] = None) -> List:
        """Run ``body(position, rank_id)`` on every rank of the current
        world; returns the per-position results (the Mode B idiom —
        state rides through the caller between phases).

        A ``RankFailedError`` is harvested for attribution (positions
        mapped back to stable ids, recorded for the next consensus) and
        re-raised — the caller decides whether to shrink or give up.
        Passing ``view`` asserts the phase was built against the
        CURRENT epoch: a stale one raises :class:`StaleEpochError`
        instead of running collectives whose membership assumptions are
        wrong."""
        cur = self._view
        if view is not None and view.epoch != cur.epoch:
            raise StaleEpochError(
                f"phase was prepared against epoch {view.epoch}, but "
                f"the world is at epoch {cur.epoch} — re-lay the phase "
                "against the current view (stale traffic is fenced, "
                "not executed)", have=view.epoch, want=cur.epoch)

        def wrapper(pos):
            return body(pos, cur.alive[pos])

        try:
            return run_ranks(wrapper, cur.size,
                             timeout=timeout or self.world_timeout,
                             device=self.device)
        except RankFailedError as e:
            for pos in e.ranks:
                if 0 <= pos < cur.size:
                    self._dead[cur.alive[pos]] = str(e)
            raise

    # --------------------------------------------------------- consensus

    def consensus(self, *, leaving: Sequence[int] = (),
                  joining: Sequence[int] = (), mesh_shape=None,
                  probe_timeout: Optional[float] = None) -> WorldView:
        """One membership-consensus round over the current world:
        positions whose ids are known dead run no body (the Mode B
        stand-in for a gone machine — they answer nothing, so the
        probe reports them missing and the ratified view drops them),
        live positions run :func:`~.membership.agree_world_view`, and
        the ratified view is adopted.  Returns the new view; typed
        raises propagate (disagreement, second failures) — the
        callers handle or abort, never hang."""
        cur = self._view
        dead = set(self._dead)
        pt = self.probe_timeout if probe_timeout is None else probe_timeout

        def body(pos):
            if cur.alive[pos] in dead:
                return None
            return agree_world_view(
                cur, leaving=leaving, joining=joining,
                mesh_shape=mesh_shape, probe_timeout=pt)

        results = run_ranks(body, cur.size,
                            timeout=self.world_timeout, device=self.device)
        views = [v for v in results if v is not None]
        if not views:
            raise ElasticError(
                "consensus returned no views — every position was "
                "known dead")
        first = views[0]
        if any(v != first for v in views[1:]):
            # The protocol ratifies one modal view on every participant;
            # divergent adopted views mean the ratification itself is
            # broken — refuse to adopt.
            raise ElasticError(
                f"ratified views diverge across survivors: {views}")
        self._view = first
        # Ids that left the membership are settled: drop their death
        # bookkeeping, and consume any preemption notice they posted
        # (their death op will never run — they are out of the world).
        from .. import config as _cfg

        plan = _cfg.fault_plan()
        for rid in list(self._dead):
            if rid not in first.alive:
                self._dead.pop(rid)
        for pos in range(cur.size):
            if cur.alive[pos] not in first.alive:
                if plan is not None:
                    plan.clear_preemption(pos)
                else:
                    # A REAL preemption notice (a SIGTERMed transport
                    # worker) has no plan to clear through — consume it
                    # from the transport board directly.
                    from ..transport import clear_external_preemption
                    clear_external_preemption(pos)
        return first

    def drain(self, replan_body, *, leaving: Sequence[int] = (),
              mesh_shape=None) -> List:
        """The live-shrink round: consensus AND replan in ONE assembly
        of the CURRENT world — every member (including the ranks being
        drained out, who are still answering inside their notice
        window) ratifies the next view, then immediately executes
        ``replan_body(position, rank_id, old_view, new_view)`` while
        the old world is still standing — the drain collectives run
        with every source rank alive, which is what makes the planned
        resize (rather than a checkpoint rewind) possible at all.

        Adopts the ratified view and returns the per-OLD-position
        replan results (the caller re-indexes survivors onto the new
        world's positions)."""
        cur = self._view
        pt = self.probe_timeout

        def body(pos):
            rid = cur.alive[pos]
            new = agree_world_view(cur, leaving=leaving,
                                   mesh_shape=mesh_shape,
                                   probe_timeout=pt)
            return (new, replan_body(pos, rid, cur, new))

        try:
            results = run_ranks(body, cur.size,
                                timeout=self.world_timeout,
                                device=self.device)
        except RankFailedError as e:
            # A drain that overruns a preemption budget meets the
            # doomed rank's death mid-replan: harvest the attribution
            # exactly like run_phase, so the caller's fallback
            # consensus sees the rank as dead instead of re-admitting
            # a gone machine.
            for pos in e.ranks:
                if 0 <= pos < cur.size:
                    self._dead[cur.alive[pos]] = str(e)
            raise
        views = {r[0] for r in results}
        if len(views) != 1:
            raise ElasticError(
                f"drain round ratified divergent views: {views}")
        new = views.pop()
        from .. import config as _cfg

        plan = _cfg.fault_plan()
        for pos in range(cur.size):
            if cur.alive[pos] not in new.alive:
                if plan is not None:
                    plan.clear_preemption(pos)
                else:
                    from ..transport import clear_external_preemption
                    clear_external_preemption(pos)
        self._view = new
        return [r[1] for r in results]

    def pending_preemptions(self) -> Dict[int, int]:
        """Preemption notices by STABLE ID (the fault plan's board is
        keyed by world position; translate through the current view)."""
        from ..resilience import pending_preemptions as _pending

        cur = self._view
        out = {}
        for pos, remaining in _pending().items():
            if 0 <= pos < cur.size:
                out[cur.alive[pos]] = remaining
        return out
