"""The continuous-batching serving engine.

Port of the eager dense-slot-table path of
``mpi4torch_tpu/serve/engine.py``: one fixed-capacity slot table
(``ServeConfig.slots`` concurrent sequences) driven by a host loop.

* **admission** — each step first fills free slots from the request queue
  (the :data:`POLICIES` entry picks the order).  A request is admitted by
  a per-request TP prefill at its true prompt length — what
  ``generate()`` does, so the engine's first token and the oracle's come
  from the same prefill — and its cache rows are copied into the slot.
* **decode** — one :func:`~mpi4torch_tpu_torch.serve.kv.decode_step_tp`
  call over the whole slot table per step, free slots riding along as
  NaN-poisoned inert rows.  The greedy choice is taken on the device and
  only ``(slots,)`` token ids move to the host.
* **eviction** — a slot finishes on EOS or its token budget; its cache
  rows are re-poisoned and the slot is free for the next admission.

Under :func:`~mpi4torch_tpu_torch.run_ranks` every rank thread builds its
own engine; the decode collectives run through the rendezvous, and every
rank selects the same tokens (the logits are rank-identical).
``ServeConfig.overlap`` runs every decode collective as a window of
split-phase chunks, and ``ServeConfig.algorithm`` names their schedule.
Paging, chunked prefill, sampling and the compiled SPMD mode are not
ported yet: their options raise ``NotImplementedError`` naming the
ROADMAP.md item that brings them.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..comm import COMM_WORLD
from ..models.transformer import TransformerConfig, select_token
from ..runtime import CommError, resolve_device
from ..utils.profiling import ServeStats
from . import kv as _kv

__all__ = ["ServeConfig", "Request", "Engine", "POLICIES",
           "SHED_POLICIES", "QueueFullError",
           "STATUS_OK", "STATUS_EXPIRED", "STATUS_SHED"]

STATUS_OK = "ok"
STATUS_EXPIRED = "deadline_expired"
STATUS_SHED = "shed"


class QueueFullError(CommError):
    """Raised by :meth:`Engine.submit` when every slot is occupied and the
    bounded queue is full — the backpressure signal a front end turns
    into HTTP 429/503 (unless a shed policy evicts a queued request)."""


def _policy_fcfs(queue) -> int:
    """First come, first served."""
    return 0


def _policy_shortest_first(queue) -> int:
    """Shortest prompt first (stable): cheapest prefill next."""
    return int(np.argmin([len(r.prompt) for r in queue]))


POLICIES = {
    "fcfs": _policy_fcfs,
    "shortest_first": _policy_shortest_first,
}


def _shed_oldest(queue) -> int:
    return 0


def _shed_newest(queue) -> int:
    return len(queue) - 1


SHED_POLICIES = {
    "drop_oldest": _shed_oldest,
    "drop_newest": _shed_newest,
}


@dataclass(frozen=True)
class ServeConfig:
    """Engine configuration, with the JAX package's fields and validation.
    ``slots`` is the slot-table capacity; ``max_new`` the default
    per-request token budget; ``eos`` ends a request early.
    ``queue_limit`` bounds the queue beyond what free slots can absorb
    (None = unbounded); ``shed_policy`` turns a rejection into evicting a
    queued request.  ``cache_dtype`` overrides the KV-cache dtype.
    ``overlap`` is the decode-collective schedule (None =
    ``config.default_overlap()``; truthy = windowed split-phase; False =
    blocking) and ``algorithm`` their wire schedule (None = the
    selector).  ``temperature > 0`` and ``block_size > 0`` (paging, with
    ``num_blocks``/``prefix_cache``/``prefill_chunk``) validate here and
    are refused by :class:`Engine`: they are not ported yet."""
    slots: int = 4
    max_new: int = 16
    eos: Optional[int] = None
    temperature: float = 0.0
    top_k: int = 0
    policy: str = "fcfs"
    overlap: Any = None
    algorithm: Optional[str] = None
    queue_limit: Optional[int] = None
    cache_dtype: Any = None
    shed_policy: Optional[str] = None
    block_size: int = 0
    num_blocks: Optional[int] = None
    prefix_cache: bool = True
    prefill_chunk: Optional[int] = None

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown scheduling policy {self.policy!r}; registered: "
                f"{sorted(POLICIES)}")
        if self.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.queue_limit is not None and self.queue_limit < 0:
            raise ValueError(
                f"queue_limit must be >= 0 or None, got "
                f"{self.queue_limit}")
        if self.shed_policy is not None \
                and self.shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"unknown shed policy {self.shed_policy!r}; registered: "
                f"{sorted(SHED_POLICIES)} (or None to reject with "
                "QueueFullError)")
        if self.block_size < 0:
            raise ValueError(
                f"block_size must be >= 0 (0 = dense slot-table cache), "
                f"got {self.block_size}")
        if self.num_blocks is not None and self.num_blocks < 1:
            raise ValueError(
                f"num_blocks must be >= 1 or None, got {self.num_blocks}")
        if self.prefill_chunk is not None:
            if self.block_size == 0:
                raise ValueError(
                    "prefill_chunk requires paging (block_size > 0) — "
                    "chunked prefill installs per-chunk rows into pages")
            if self.prefill_chunk < 1:
                raise ValueError(
                    f"prefill_chunk must be >= 1 or None, got "
                    f"{self.prefill_chunk}")


@dataclass(eq=False)
class Request:
    """One serving request: ``prompt`` (1-d int array) and its token
    budget — the argument set of a per-request ``generate()`` call, the
    engine's parity oracle.  ``deadline`` is the absolute engine-clock
    instant past which the request is evicted (None = no deadline)."""
    rid: Any
    prompt: np.ndarray
    max_new: int
    deadline: Optional[float] = None
    emitted: List[int] = field(default_factory=list)

    def finished(self, eos: Optional[int]) -> bool:
        if len(self.emitted) >= self.max_new:
            return True
        return (eos is not None and bool(self.emitted)
                and self.emitted[-1] == eos)


def _refuse_unported(serve_cfg: ServeConfig, spmd: bool) -> None:
    roadmap = "(ROADMAP.md, Queue 1 item {})"
    refusals = [
        (spmd, "spmd=True: the compiled SPMD engine needs the compiled "
               "backend " + roadmap.format(4)),
        (serve_cfg.temperature > 0,
         "temperature > 0: sampled decoding needs the threefry key "
         "discipline " + roadmap.format(2)),
        (serve_cfg.block_size > 0,
         "block_size > 0: the paged KV cache " + roadmap.format(2)),
    ]
    for refused, what in refusals:
        if refused:
            raise NotImplementedError(f"{what} is not ported yet")


class Engine:
    """Continuous-batching inference engine over a fixed slot table.

    Construct with full (replicated) parameters; the TP shards, the
    sharded KV cache and the decode collectives follow from the calling
    thread's world.  Drive it with :meth:`submit` + :meth:`step`, or
    :meth:`run` to drain everything.  Greedy decoding emits the tokens of
    a per-request ``models/transformer.generate`` call.  ``device`` is
    where the engine runs: CUDA unless the caller passes ``"cpu"``; the
    parameters are moved there."""

    def __init__(self, cfg: TransformerConfig, params,
                 serve_cfg: ServeConfig = None, *, spmd: bool = False,
                 nranks: Optional[int] = None, mesh=None,
                 axis_name: Optional[str] = None, clock=None, device=None):
        self.cfg = cfg
        self.serve_cfg = serve_cfg or ServeConfig()
        # nranks / mesh / axis_name configure the compiled SPMD mode.
        _refuse_unported(self.serve_cfg, spmd or any(
            x is not None for x in (nranks, mesh, axis_name)))
        self.device = resolve_device(device)
        # The deadline clock (monotonic seconds), injectable so tests
        # drive expiry deterministically.  Multi-rank serving must give
        # every rank the same deterministic clock, or the ranks' slot
        # tables (and so their collectives) could diverge.
        self._clock = clock if clock is not None else time.monotonic
        self._comm = COMM_WORLD
        self._size = self._comm.size
        _kv.validate_tp(cfg, self._size)
        params = _to_device(params, self.device)
        self._dtype = self.serve_cfg.cache_dtype or params["embed"].dtype
        self._shards = _kv.shard_params_tp(cfg, params, self._comm)
        slots = self.serve_cfg.slots
        self._cache = _kv.init_kv_cache_tp(cfg, slots, self._size,
                                           self._dtype, self.device,
                                           poison=True)
        self._tokens = np.zeros((slots,), np.int64)
        self._pos = np.zeros((slots,), np.int64)
        self._slot_req: List[Optional[Request]] = [None] * slots
        self._queue: deque = deque()
        self._results: Dict[Any, np.ndarray] = {}
        self._statuses: Dict[Any, str] = {}
        self._known_rids = set()
        self._next_rid = 0
        self.slot_log: List[tuple] = []   # (rid, slot) admission history
        self.stats = ServeStats()
        # Logits table of the most recent decode step (a device tensor,
        # kept for inspection; the engine never reads it back).
        self.last_logits = None

    # -------------------------------------------------------------- public

    def submit(self, prompt, *, rid=None, max_new: Optional[int] = None,
               deadline_s: Optional[float] = None):
        """Queue one request; returns its id.  Validates the
        ``generate()`` preconditions and applies queue backpressure
        (:class:`QueueFullError` past ``queue_limit``, or a shed per
        ``shed_policy``).  ``deadline_s`` (seconds from now on the engine
        clock) bounds the request's latency."""
        prompt = np.asarray(prompt)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(
                f"prompt must be a non-empty 1-d token array; got shape "
                f"{prompt.shape}")
        budget = int(max_new if max_new is not None
                     else self.serve_cfg.max_new)
        if budget < 1:
            raise ValueError(f"max_new must be >= 1, got {budget}")
        if prompt.size + budget > self.cfg.max_seq:
            raise ValueError(
                f"prompt {prompt.size} + n_new {budget} exceeds max_seq "
                f"{self.cfg.max_seq}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0 seconds, got {deadline_s}")
        limit = self.serve_cfg.queue_limit
        if limit is not None and \
                len(self._queue) >= limit + len(self._free_slots()):
            if self.serve_cfg.shed_policy is not None and self._queue:
                victim = self._queue[
                    SHED_POLICIES[self.serve_cfg.shed_policy](self._queue)]
                self._queue.remove(victim)
                self._finish(victim, status=STATUS_SHED)
            else:
                self.stats.count("rejected")
                raise QueueFullError(
                    f"serve queue full ({len(self._queue)} waiting, "
                    f"{len(self._free_slots())} free of "
                    f"{self.serve_cfg.slots} slots; queue_limit={limit})")
        if rid is None:
            rid = self._next_rid
            self._next_rid += 1
        elif rid in self._known_rids:
            raise ValueError(
                f"request id {rid!r} is already in use by a queued, "
                "in-flight, or finished request of this engine")
        self._known_rids.add(rid)
        deadline = (None if deadline_s is None
                    else self._clock() + float(deadline_s))
        self._queue.append(Request(rid=rid, prompt=prompt, max_new=budget,
                                   deadline=deadline))
        self.stats.mark(rid, "submitted")
        return rid

    def pending(self) -> int:
        """Requests not yet finished (queued + occupying slots)."""
        return len(self._queue) + self.occupancy()

    def occupancy(self) -> int:
        return sum(r is not None for r in self._slot_req)

    def _free_slots(self) -> List[int]:
        return [j for j, r in enumerate(self._slot_req) if r is None]

    # ---------------------------------------------------------- lifecycle

    @staticmethod
    def _select(logits):
        return select_token(logits).tolist()

    def _admit(self, events: dict) -> None:
        """Fill free slots from the queue; admission events (including a
        first token that already finishes the request) land in
        ``events``."""
        chooser = POLICIES[self.serve_cfg.policy]
        while self._queue and self._free_slots():
            req = self._queue[chooser(self._queue)]
            self._queue.remove(req)
            prompt = torch.as_tensor(req.prompt, dtype=torch.int64,
                                     device=self.device)[None, :]
            rows = _kv.init_kv_cache_tp(self.cfg, 1, self._size,
                                        self._dtype, self.device)
            logits, rows = _kv.prefill_tp(self.cfg, self._shards, rows,
                                          prompt, self._comm)
            self.stats.mark(req.rid, "admitted")
            self.stats.count("admitted")
            tok = self._select(logits)[0]
            req.emitted.append(tok)
            self.stats.mark(req.rid, "first_token")
            events["admitted"].append(req.rid)
            events["emitted"].setdefault(req.rid, []).append(tok)
            if req.finished(self.serve_cfg.eos):
                # Finished at admission (max_new=1 / immediate EOS): it
                # never occupied a slot.
                events["finished"].append(req.rid)
                self._finish(req)
                continue
            j = self._free_slots()[0]
            self.slot_log.append((req.rid, j))
            for c, r in zip(self._cache, rows):
                c["k"][j].copy_(r["k"][0])
                c["v"][j].copy_(r["v"][0])
            self._slot_req[j] = req
            self._tokens[j] = tok
            self._pos[j] = int(req.prompt.size)

    def _finish(self, req: Request, status: str = STATUS_OK) -> None:
        self._results[req.rid] = np.concatenate(
            [np.asarray(req.prompt, np.int64),
             np.asarray(req.emitted, np.int64)])
        self._statuses[req.rid] = status
        self.stats.mark(req.rid, "finished")
        self.stats.count("finished" if status == STATUS_OK else status)

    def _release_slots(self, idxs: List[int]) -> None:
        """Return slots to the free pool and re-poison their cache rows:
        stale K/V must be provably inert, not accidentally plausible."""
        if not idxs:
            return
        for j in idxs:
            self._slot_req[j] = None
            self._tokens[j] = 0
            self._pos[j] = 0
        if self._dtype.is_floating_point:
            for c in self._cache:
                for j in idxs:
                    c["k"][j].fill_(float("nan"))
                    c["v"][j].fill_(float("nan"))

    def _evict(self, j: int, status: str = STATUS_OK) -> None:
        req = self._slot_req[j]
        self._release_slots([j])
        self.stats.count("evicted")
        self._finish(req, status=status)

    def _expire_sweep(self, events: dict) -> None:
        """Deadline sweep at the top of every step: queued requests past
        their deadline finish as bare prompts, slotted ones keep the
        tokens emitted so far."""
        now = self._clock()
        for req in [r for r in self._queue
                    if r.deadline is not None and now >= r.deadline]:
            self._queue.remove(req)
            self._finish(req, status=STATUS_EXPIRED)
            events["expired"].append(req.rid)
        for j, req in enumerate(self._slot_req):
            if req is not None and req.deadline is not None \
                    and now >= req.deadline:
                self._evict(j, status=STATUS_EXPIRED)
                events["expired"].append(req.rid)

    def step(self) -> dict:
        """Deadline sweep, admissions, then one decode step over the slot
        table, then evictions.  Returns ``{"admitted": [...], "emitted":
        {rid: [tokens]}, "finished": [...], "expired": [...]}``."""
        events = {"admitted": [], "emitted": {}, "finished": [],
                  "expired": []}
        self._expire_sweep(events)
        self._admit(events)
        active = [j for j, r in enumerate(self._slot_req) if r is not None]
        if not active:
            return events
        live = torch.as_tensor([r is not None for r in self._slot_req],
                               device=self.device)
        logits, self._cache = _kv.decode_step_tp(
            self.cfg, self._shards, self._cache,
            torch.as_tensor(self._tokens, device=self.device),
            torch.as_tensor(self._pos, device=self.device), self._comm,
            overlap=self.serve_cfg.overlap,
            algorithm=self.serve_cfg.algorithm, active=live)
        self.last_logits = logits
        toks = self._select(logits)
        self.stats.tick(len(active), self.serve_cfg.slots)
        for j in active:
            req = self._slot_req[j]
            tok = toks[j]
            req.emitted.append(tok)
            events["emitted"].setdefault(req.rid, []).append(tok)
            self.stats.count("decode_tokens")
            self._pos[j] += 1
            self._tokens[j] = tok
            if req.finished(self.serve_cfg.eos):
                events["finished"].append(req.rid)
                self._evict(j)
        return events

    def run(self, max_steps: Optional[int] = None) -> Dict[Any, np.ndarray]:
        """Drive :meth:`step` until every submitted request finished (or
        ``max_steps``); returns ``{rid: prompt + emitted tokens}``."""
        steps = 0
        while self.pending():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return dict(self._results)

    def results(self) -> Dict[Any, np.ndarray]:
        return dict(self._results)

    def statuses(self) -> Dict[Any, str]:
        """Result status per finished rid: ``"ok"``,
        ``"deadline_expired"`` or ``"shed"``."""
        return dict(self._statuses)

    def status(self, rid) -> Optional[str]:
        return self._statuses.get(rid)

    def pop_results(self) -> Dict[Any, np.ndarray]:
        """Retrieve and drop every finished result, releasing its request
        id for reuse."""
        out, self._results = self._results, {}
        self._known_rids.difference_update(out)
        for rid in out:
            self._statuses.pop(rid, None)
        return out


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)
