"""Replan-as-reshard: re-laying state onto an agreed new world.

Port of ``mpi4torch_tpu/elastic/replan.py``.

Once membership consensus has ratified a transition (:mod:`.membership`)
the surviving state must land in the new world's deal.  Every training
state kind shards by **leading units** — ZeRO's padded flat elements
(``parallel/zero.py``), TP's heads, MoE's stacked experts — so one
planner covers them all: :func:`mpi4torch_tpu_torch.reshard.plan_resize`,
the cross-world-size form of the reshard planner (same step grammar,
same executors, adjoint = the reverse resize, the backward through
``reshard.apply_plan`` so training graphs crossing a resize stay
differentiable).  This module supplies the glue: embedding maps from
(old view, new view) pairs, the drain/grow execution conventions, and
the per-kind recipes:

* **dense / TP** (:func:`replan_axis0`) — one resize per tensor.
* **ZeRO shards** (:func:`replan_zero`) — per-leaf flat resize of the
  ceil-padded shard representation (parameter shards and elementwise
  optimizer-state shards alike, mapped over matching templates).
* **MoE experts** — the expert stack IS an axis-0 resize; re-dealing
  for balance afterwards is
  :func:`~mpi4torch_tpu_torch.parallel.moe.rebalance_experts` on the new
  world.
* **serve** (:func:`drain_tickets` / :func:`readmit` /
  :func:`stitched_results`) — in-flight requests drain to tickets
  (prompt + tokens emitted so far + the request's ADVANCED sampling
  key) and re-admit through the new engine's ordinary admission
  policies as extended-prompt submissions, so the continuation rides
  the engine's own prefill/decode discipline and the stitched token
  streams equal per-request ``generate()``'s.

Execution conventions (who runs the plan):

* ``mode="drain"`` — the OLD world executes, every source rank still
  answering (the preemption-notice window, or a planned descale):
  ``embed_from`` is the identity, ``embed_to`` places each new deal
  position on the surviving old rank that will carry it.
* ``mode="grow"`` — the NEW world executes after capacity returned:
  ``embed_to`` is the identity, ``embed_from`` locates each old deal
  position among the survivors' new positions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import reshard as _rs
from ..utils.tree import tree_map
from .membership import ElasticError, WorldView

__all__ = [
    "resize_embeds",
    "replan_axis0",
    "replan_axis0_tree",
    "replan_zero",
    "ServeTicket",
    "drain_tickets",
    "readmit",
    "stitched_results",
]


def resize_embeds(old_view: WorldView, new_view: WorldView, mode: str):
    """``(embed_from, embed_to, exec_size)`` for a resize between two
    consecutive views.

    * ``"drain"``: executes on the OLD world (all old positions alive);
      requires ``new_view.alive ⊆ old_view.alive``.
    * ``"grow"``: executes on the NEW world; requires
      ``old_view.alive ⊆ new_view.alive``.
    """
    if mode == "drain":
        missing = set(new_view.alive) - set(old_view.alive)
        if missing:
            raise ElasticError(
                f"drain target names ids {sorted(missing)} not alive in "
                f"the source epoch {old_view.epoch}")
        embed_from = tuple(range(old_view.size))
        embed_to = tuple(old_view.position(rid) for rid in new_view.alive)
        return embed_from, embed_to, old_view.size
    if mode == "grow":
        missing = set(old_view.alive) - set(new_view.alive)
        if missing:
            raise ElasticError(
                f"grow source names ids {sorted(missing)} not alive in "
                f"the target epoch {new_view.epoch}")
        embed_from = tuple(new_view.position(rid) for rid in old_view.alive)
        embed_to = tuple(range(new_view.size))
        return embed_from, embed_to, new_view.size
    raise ElasticError(f"unknown resize mode {mode!r} "
                       "(expected 'drain' or 'grow')")


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(np.shape(x))


def _resize(comm, x, n_units: int, old_view: WorldView,
            new_view: WorldView, mode: str, strategy,
            differentiable: bool):
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=comm.device)
    embed_from, embed_to, exec_size = resize_embeds(old_view, new_view,
                                                    mode)
    if comm.size != exec_size:
        raise ElasticError(
            f"{mode} resize executes on a {exec_size}-rank world; this "
            f"communicator has {comm.size}")
    plan = _rs.plan_resize(
        n_units, tuple(x.shape[1:]), old_view.size, new_view.size,
        x.dtype, embed_from=embed_from, embed_to=embed_to,
        exec_size=exec_size, strategy=strategy)
    return _rs.apply_plan(comm, plan, x, differentiable=differentiable)


def replan_axis0(comm, x, n_units: int, old_view: WorldView,
                 new_view: WorldView, *, mode: str, strategy=None,
                 differentiable: bool = True):
    """Re-deal an axis-0-sharded tensor (TP heads, MoE expert stacks,
    any dense leading-unit deal) from the old view's split to the new
    view's.  ``x`` is this rank's old shard (``mode="drain"``) or its
    old shard if it is a survivor / a zeros buffer of the old shard
    shape if it is a joiner (``mode="grow"``); returns this rank's new
    shard (leavers get zeros)."""
    return _resize(comm, x, int(n_units), old_view, new_view, mode,
                   strategy, differentiable)


def replan_axis0_tree(comm, tree, n_units_tree, old_view, new_view, *,
                      mode: str, strategy=None):
    """Tree-mapped :func:`replan_axis0` (``n_units_tree``: one int per
    leaf, or one int broadcast over the tree)."""
    if isinstance(n_units_tree, int):
        n = n_units_tree
        n_units_tree = tree_map(lambda _: n, tree)
    return tree_map(
        lambda x, n: replan_axis0(comm, x, n, old_view, new_view,
                                  mode=mode, strategy=strategy),
        tree, n_units_tree)


def replan_zero(comm, shard_tree, template, old_view: WorldView,
                new_view: WorldView, *, mode: str, strategy=None):
    """Re-deal a tree of ZeRO flat shards (the ceil-padded per-leaf
    representation of :func:`~mpi4torch_tpu_torch.parallel.zero.
    zero3_shard_params` / ``fused_reduce_scatter_tree``) onto the new
    world's split.  ``template`` supplies each leaf's GLOBAL shape (the
    logical element count; the paddings on both sides are derived, and
    pad slots move as the zeros they are).  Works unchanged for
    elementwise optimizer-state trees whose leaves mirror the shard
    tree — map each state field against the same template."""

    def one(shard, tmpl):
        n = int(np.prod(_shape(tmpl))) if _shape(tmpl) else 1
        return replan_axis0(comm, shard, n, old_view, new_view,
                            mode=mode, strategy=strategy)

    return tree_map(one, shard_tree, template)


# ---------------------------------------------------------------------------
# Serve: drain in-flight requests, re-admit through admission policies.
# ---------------------------------------------------------------------------


@dataclass
class ServeTicket:
    """One in-flight request drained out of an engine: everything the
    new world needs to CONTINUE it — the original prompt, the tokens
    already emitted (final: they were selected before the resize), the
    remaining budget, and the request's advanced threefry key
    (``generate()``'s key discipline: the stream continues where it
    stopped, so sampled continuations match the never-resized stream
    too).

    ``deadline_s`` is the REMAINING deadline budget in seconds at drain
    time (None: no deadline), a duration rather than an instant, because
    the destination engine's clock may be another clock domain; a ticket
    whose budget ran out during the resize is surfaced as
    ``deadline_expired`` at re-admission (:func:`readmit`), never
    dropped.  ``pages`` (None on dense engines) is the block-table state
    at drain time, ``{"block_ids": [...], "n_tokens": int}``: a paged
    source engine registers those pages in its prefix index before
    releasing them, so re-admitting into the SAME pool finds them
    again."""
    rid: Any
    prompt: np.ndarray
    emitted: List[int] = field(default_factory=list)
    max_new: int = 0
    key: Any = None
    deadline_s: Optional[float] = None
    pages: Optional[dict] = None

    @property
    def remaining(self) -> int:
        return self.max_new - len(self.emitted)

    def extended_prompt(self) -> np.ndarray:
        """The re-admission prompt: original prompt + tokens already
        emitted.  The new engine prefills this prefix and decodes the
        continuation."""
        return np.concatenate([
            np.asarray(self.prompt, np.int64),
            np.asarray(self.emitted, np.int64)]).astype(
                np.asarray(self.prompt).dtype, copy=False)


def drain_tickets(engine, *, snapshot: bool = False
                  ) -> Tuple[List[ServeTicket], Dict[Any, np.ndarray]]:
    """Drain (or, with ``snapshot=True``, observe without evicting) an
    engine's in-flight requests as :class:`ServeTicket`\\ s, plus the
    results already finished.  Every rank's engine holds the identical
    host-side request state (tokens are selected host-side,
    deterministically, on every rank), so any SURVIVOR's drain is the
    authoritative one."""
    reqs = engine.snapshot_inflight() if snapshot \
        else engine.drain()
    # Deadlines convert absolute -> remaining here, on the draining
    # engine's own clock.
    now = engine._clock()
    tickets = [ServeTicket(rid=r["rid"], prompt=r["prompt"],
                           emitted=list(r["emitted"]),
                           max_new=r["max_new"], key=r["key"],
                           deadline_s=(None if r.get("deadline") is None
                                       else r["deadline"] - now),
                           pages=r.get("pages"))
               for r in reqs]
    return tickets, engine.results()


def readmit(engine, tickets) -> List[Any]:
    """Re-admit drained tickets through the engine's ordinary admission
    path (its policies pick the order, as for fresh traffic).
    Already-finished tickets are skipped; a ticket whose remaining
    deadline budget is gone is recorded on the engine as a
    ``deadline_expired`` result carrying the tokens it had earned
    (:meth:`Engine.admit_expired`).  Returns the rids re-submitted for
    decoding."""
    out = []
    for t in tickets:
        if t.remaining <= 0:
            continue
        if t.deadline_s is not None and t.deadline_s <= 0:
            engine.admit_expired(t.extended_prompt(), rid=t.rid)
            continue
        engine.submit(t.extended_prompt(), rid=t.rid,
                      max_new=t.remaining, key=t.key,
                      deadline_s=t.deadline_s)
        out.append(t.rid)
    return out


def stitched_results(engine_results: Dict[Any, np.ndarray],
                     tickets) -> Dict[Any, np.ndarray]:
    """Post-resize results against the ORIGINAL prompts: the new engine
    returns ``extended_prompt + continuation``, which is ``original
    prompt + pre-resize tokens + post-resize tokens`` — the
    never-resized sequence.  Tickets that were already finished pass
    through."""
    out = dict(engine_results)
    for t in tickets:
        if t.remaining <= 0 and t.rid not in out:
            out[t.rid] = np.concatenate([
                np.asarray(t.prompt, np.int64),
                np.asarray(t.emitted, np.int64)])
    return out
