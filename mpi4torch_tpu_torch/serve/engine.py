"""The continuous-batching serving engine.

Port of the eager (rank-thread) path of ``mpi4torch_tpu/serve/engine.py``:
one fixed-capacity slot table (``ServeConfig.slots`` concurrent
sequences) driven by a host loop.

* **admission** — each step first fills free slots from the request queue
  (the :data:`POLICIES` entry picks the order).  A dense engine admits a
  request by a per-request TP prefill at its true prompt length — what
  ``generate()`` does — and copies its cache rows into the slot.  A paged
  engine (``ServeConfig.block_size > 0``) matches the prompt against its
  prefix index first, adopts the shared pages (copying a partly shared
  tail page: copy-on-write), and prefills only the rest: in one shot, or
  one ``prefill_chunk`` per step between decode steps.
* **decode** — one :func:`~mpi4torch_tpu_torch.serve.kv.decode_step_tp`
  (dense) or :func:`~mpi4torch_tpu_torch.serve.kv.decode_step_paged`
  call over the whole slot table per step, free slots riding along as
  inert rows.  Before it, a paged engine maps a fresh page for every slot
  whose next write crosses into one, preempting the newest request when
  the pool is dry (it re-queues with its tokens folded into its prompt
  and its advanced key, and re-admission finds its pages in the prefix
  index).
* **selection** — the JAX package's key discipline: each request's key
  splits once per chosen token (greedy too), on the host.  The whole
  ``(slots, vocab)`` table is chosen in one batched call on the device
  (greedy argmax, or one threefry draw of every row's Gumbel noise from
  its own key), and only the ``(slots,)`` token ids move to the host.
* **eviction** — a slot finishes on EOS or its token budget; a dense slot's
  cache rows are re-poisoned, a paged slot's written rows are indexed for
  later prefix hits and its pages released.

Under :func:`~mpi4torch_tpu_torch.run_ranks` every rank thread builds its
own engine; the decode collectives run through the rendezvous, and every
rank makes the same host decisions and selects the same tokens.
``ServeConfig.overlap`` runs every decode collective as a window of
split-phase chunks, and ``ServeConfig.algorithm`` names their schedule.

``Engine(..., spmd=True, nranks=n)`` (or ``mesh=``/``axis_name=``) is the
SPMD engine of Mode A: one engine drives every rank.  The TP shards are
made once under :func:`~mpi4torch_tpu_torch.ops.spmd.run_spmd` and kept,
like the KV cache or page pool, as stacked state with one row per rank
of the world; each prefill, chunk prefill and decode step is one
``run_spmd`` call whose body takes this rank's row
(:func:`~mpi4torch_tpu_torch.ops.spmd.world_rank`).  The body keeps the
JAX package's functional contract: it decodes into a private copy of its
cache row and returns it, and ``run_spmd`` stacks the rows into the next
state, so a step copies the cache twice.  Admission, page copies, row
installs, the past gather and release act on every row of the stacked
state on the host side.  ``lower_step`` reads a lowered program: not
ported (ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..comm import COMM_WORLD
from ..models.transformer import TransformerConfig, select_token
from ..ops.ragged import block_gather, live_cells, write_cells
from ..runtime import CommError, resolve_device
from ..utils import threefry
from ..utils.tree import tree_map
from ..utils.profiling import ServeStats, _register_serve_stats
from . import kv as _kv
from . import paging as _paging

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
    selector).  ``temperature``/``top_k`` follow the ``generate()``
    contract per request (each request brings its own key).

    **Paging.**  ``block_size > 0`` replaces the dense ``(slots,
    max_seq)`` cache with a pool of ``block_size``-token pages addressed
    through a per-slot block table (``block_size`` must divide
    ``cfg.max_seq``; checked at engine construction).  ``num_blocks``
    sizes the pool (None = ``slots * max_seq / block_size``, the dense
    capacity; fewer pages overcommit, which is the point).
    ``prefix_cache`` shares identical prompt prefixes copy-on-write
    across requests, prefilled once; ``prefill_chunk`` caps the prompt
    tokens prefilled per engine step, so a long prompt lands chunk by
    chunk between the resident slots' decode steps.  Both need
    ``cache_dtype`` equal to the parameters' dtype (a narrower cache
    would re-round shared prefix rows that a per-request ``generate()``
    keeps at full precision); otherwise the engine pages without sharing
    or chunking."""
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
    """One serving request: ``prompt`` (1-d int array), its token budget
    and, for sampled decoding, its own key (two 32-bit words) — the
    argument set of a per-request ``generate()`` call, the engine's parity
    oracle.  ``deadline`` is the absolute engine-clock instant past which
    the request is evicted (None = no deadline)."""
    rid: Any
    prompt: np.ndarray
    max_new: int
    key: Any = None
    deadline: Optional[float] = None
    emitted: List[int] = field(default_factory=list)

    def finished(self, eos: Optional[int]) -> bool:
        if len(self.emitted) >= self.max_new:
            return True
        return (eos is not None and bool(self.emitted)
                and self.emitted[-1] == eos)


@dataclass(eq=False)
class _PrefillJob:
    """A chunked prefill in progress (paged engines): the request holds
    its reserved slot (left out of decode) while its prompt lands one
    chunk per engine step.  ``done`` counts prompt rows whose K/V is
    installed, a shared prefix included."""
    req: Request
    slot: int
    seq: np.ndarray
    done: int = 0


class Engine:
    """Continuous-batching inference engine over a fixed slot table.

    Construct with full (replicated) parameters; the TP shards, the
    sharded KV cache (dense rows or a page pool) and the decode
    collectives follow from the calling thread's world.  Drive it with
    :meth:`submit` + :meth:`step`, or :meth:`run` to drain everything.
    Greedy and sampled decoding emit the tokens of a per-request
    ``models/transformer.generate`` call with the same key.  ``device`` is
    where the engine runs: CUDA unless the caller passes ``"cpu"``; the
    parameters are moved there.  ``shards`` (a port extension) hands the
    engine this rank's serving shards in :func:`serve.kv.shard_params_tp`'s
    layout, e.g. from :func:`serve.kv.admit_zero3`, in place of sharding
    full ``params`` (which may then be None).  ``spmd=True`` with
    ``nranks`` (or ``mesh`` and ``axis_name``) is the SPMD engine (module
    docstring); it shards ``params`` itself, so ``shards`` is refused
    there."""

    def __init__(self, cfg: TransformerConfig, params,
                 serve_cfg: ServeConfig = None, *, spmd: bool = False,
                 nranks: Optional[int] = None, mesh=None,
                 axis_name: Optional[str] = None, clock=None, device=None,
                 shards=None):
        self.cfg = cfg
        self.serve_cfg = serve_cfg or ServeConfig()
        self._spmd = bool(spmd)
        if self._spmd and shards is not None:
            raise ValueError(
                "Engine(spmd=True) makes its TP shards from params under "
                "run_spmd; shards= (one rank's serving shards) is a "
                "rank-thread extension with no SPMD form — pass params")
        # The deadline clock (monotonic seconds), injectable so tests
        # drive expiry deterministically.  Multi-rank serving must give
        # every rank the same deterministic clock, or the ranks' slot
        # tables (and so their collectives) could diverge.
        self._clock = clock if clock is not None else time.monotonic
        self._comm = COMM_WORLD
        self._paged = self.serve_cfg.block_size > 0
        if self._spmd:
            from ..ops.spmd import _device_count, _mesh_device, run_spmd

            if mesh is not None:
                if axis_name is None:
                    raise ValueError(
                        "Engine(spmd=True, mesh=...) needs axis_name= — the "
                        "mesh axis the TP collectives run over (other axes "
                        "replicate)")
                self.device = _mesh_device(mesh, device)
                self._size = int(mesh.shape[axis_name])
                self._rows_n = math.prod(int(mesh.shape[a])
                                         for a in mesh.axis_names)
                kw = {"mesh": mesh, "axis_name": axis_name}
            else:
                self.device = resolve_device(device)
                self._size = int(nranks or _device_count(self.device))
                self._rows_n = self._size
                kw = {"nranks": self._size, "device": self.device}
        else:
            self.device = resolve_device(device)
            self._size = self._comm.size
        _kv.validate_tp(cfg, self._size)
        if self._spmd:
            full = _to_device(params, self.device)
            # Shard once: the stacked (rows, ...) shards ride as engine
            # state, like the cache.
            self._shards = run_spmd(
                lambda: _kv.shard_params_tp(cfg, full, COMM_WORLD), **kw)()
            self._step_call = run_spmd(
                self._traced_step_paged if self._paged
                else self._traced_step, **kw)
            self._prefill_call = run_spmd(self._traced_prefill, **kw)
            self._chunk_call = run_spmd(self._traced_prefill_chunk, **kw) \
                if self._paged else None
        elif shards is None:
            self._shards = _kv.shard_params_tp(
                cfg, _to_device(params, self.device), self._comm)
        else:
            self._shards = _to_device(shards, self.device)
        compute_dtype = self._shards["embed"].dtype
        self._dtype = self.serve_cfg.cache_dtype or compute_dtype
        # Prefix sharing and chunked prefill splice cache-dtype rows into
        # prefill attention: exact only when the cache has the compute
        # dtype.
        self._exact_kv = self._dtype == compute_dtype
        slots = self.serve_cfg.slots
        if self._paged:
            bs = self.serve_cfg.block_size
            if cfg.max_seq % bs != 0:
                raise ValueError(
                    f"block_size={bs} must divide max_seq={cfg.max_seq} "
                    "(the paged gather reconstructs the dense attention "
                    "extent — see serve.kv.init_kv_pool_tp)")
            self._blocks_per_seq = cfg.max_seq // bs
            nb = (self.serve_cfg.num_blocks
                  if self.serve_cfg.num_blocks is not None
                  else slots * self._blocks_per_seq)
            self._cache = _kv.init_kv_pool_tp(cfg, nb, bs, self._size,
                                              self._dtype, self.device)
            self._mgr = _paging.BlockManager(
                nb, bs, prefix_cache=(self.serve_cfg.prefix_cache
                                      and self._exact_kv))
            # The host's block table; each decode step reads it.
            self._table = np.full((slots, self._blocks_per_seq), -1,
                                  np.int64)
            self._prefill_jobs: deque = deque()
            self._admit_seq = 0                  # preemption-victim order
            self._slot_seq = [0] * slots
            self._chunk = (self.serve_cfg.prefill_chunk
                           if self._exact_kv else None)
        else:
            self._cache = _kv.init_kv_cache_tp(cfg, slots, self._size,
                                               self._dtype, self.device,
                                               poison=True)
            self._mgr = None
            self._table = None
            self._chunk = None
        if self._spmd:
            # One row per rank of the world: run_spmd's stacked layout, so
            # the state round-trips step to step.
            self._cache = self._stacked(self._cache)
        self._tokens = np.zeros((slots,), np.int64)
        self._pos = np.zeros((slots,), np.int64)
        self._slot_req: List[Optional[Request]] = [None] * slots
        # True while a slot's chunked prefill is in flight: the slot is
        # reserved (occupancy counts it) but left out of decode until its
        # first token lands.
        self._prefilling: List[bool] = [False] * slots
        self._queue: deque = deque()
        self._results: Dict[Any, np.ndarray] = {}
        self._statuses: Dict[Any, str] = {}
        self._known_rids = set()
        self._next_rid = 0
        self.slot_log: List[tuple] = []   # (rid, slot) admission history
        self.stats = _register_serve_stats(ServeStats())
        # Logits table of the most recent decode step (a device tensor,
        # kept for inspection; the engine reads back only the tokens).
        self.last_logits = None
        # The self-tuning controller consulted before every step
        # (:meth:`attach_controller`), or None.
        self._controller = None

    # -------------------------------------------------------------- public

    def submit(self, prompt, *, rid=None, max_new: Optional[int] = None,
               key=None, deadline_s: Optional[float] = None):
        """Queue one request; returns its id.  Validates the
        ``generate()`` preconditions (the budget fits ``max_seq`` and, on
        a paged engine, the pool; sampled decoding needs a ``key``: two
        32-bit words, e.g. ``utils.threefry.PRNGKey(seed)``) and applies
        queue backpressure (:class:`QueueFullError` past ``queue_limit``,
        or a shed per ``shed_policy``).  ``deadline_s`` (seconds from now
        on the engine clock) bounds the request's latency."""
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
        if self._paged:
            # Worst-case page footprint (positions 0 .. p+budget-2; the
            # last token is chosen, never written): a request that could
            # not run even alone on the pool would preempt forever.
            bs = self.serve_cfg.block_size
            need = -(-(int(prompt.size) + budget - 1) // bs)
            if need > self._mgr.num_blocks:
                raise ValueError(
                    f"prompt {prompt.size} + n_new {budget} needs "
                    f"{need} pages of {bs} tokens; the pool has only "
                    f"{self._mgr.num_blocks} — raise num_blocks or "
                    "shrink the request")
        if self.serve_cfg.temperature > 0 and key is None:
            raise ValueError("temperature > 0 requires a PRNG `key`")
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
        rid = self._claim_rid(rid)
        deadline = (None if deadline_s is None
                    else self._clock() + float(deadline_s))
        self._queue.append(Request(
            rid=rid, prompt=prompt, max_new=budget,
            key=None if key is None else threefry.as_key(key),
            deadline=deadline))
        self.stats.mark(rid, "submitted")
        return rid

    def admit_expired(self, prompt, *, rid=None, emitted=()):
        """Record a request that arrives already past its deadline (a
        drained request whose deadline ran out before re-admission) with
        the ``deadline_expired`` status and the tokens it carries; no
        prefill, slot or decode step is spent.  ``rid`` is validated as in
        :meth:`submit`."""
        rid = self._claim_rid(rid)
        req = Request(rid=rid, prompt=np.asarray(prompt), max_new=0,
                      emitted=list(emitted))
        self.stats.mark(rid, "submitted")
        self._finish(req, status=STATUS_EXPIRED)
        return rid

    def _claim_rid(self, rid):
        if rid is None:
            rid = self._next_rid
            self._next_rid += 1
        elif rid in self._known_rids:
            raise ValueError(
                f"request id {rid!r} is already in use by a queued, "
                "in-flight, or finished request of this engine")
        self._known_rids.add(rid)
        return rid

    def pending(self) -> int:
        """Requests not yet finished (queued + occupying slots)."""
        return len(self._queue) + self.occupancy()

    def occupancy(self) -> int:
        return sum(r is not None for r in self._slot_req)

    def _free_slots(self) -> List[int]:
        return [j for j, r in enumerate(self._slot_req) if r is None]

    # ---------------------------------------------------------- selection

    @staticmethod
    def _next_key(req: Request):
        """Advance ``req``'s key and return the subkey of this choice:
        ``generate()``'s split, greedy or not."""
        if req.key is None:
            req.key = threefry.PRNGKey(0)     # unused on the greedy path
        req.key, sub = threefry.split(req.key)
        return sub

    def _select(self, reqs: List[Optional[Request]], logits) -> List[int]:
        """One choice per row of ``logits`` ``(rows, vocab)`` for the
        requests of ``reqs`` (None rows are chosen and ignored): every
        request's key splits on the host, the whole table is chosen in one
        batched call on the device, and the ids come back in one read."""
        subs = [(0, 0) if r is None else self._next_key(r) for r in reqs]
        scfg = self.serve_cfg
        keys = None
        if scfg.temperature > 0:
            keys = torch.tensor(subs, dtype=torch.int64,
                                device=logits.device)
        return select_token(logits, keys, scfg.temperature,
                            scfg.top_k).tolist()

    # --------------------------------------------------------------- SPMD

    @staticmethod
    def _rank_slice(stacked):
        """This rank's leaves off a stacked ``(rows, ...)`` state tree:
        views of the row of :func:`~mpi4torch_tpu_torch.ops.spmd.
        world_rank`."""
        from ..ops.spmd import world_rank

        row = world_rank()
        return tree_map(lambda a: a[row], stacked)

    def _traced_step(self, shards, cache, tokens, pos, active):
        """Mode A decode step: this rank's shards and cache row off the
        stacked state, the decode into a private copy of the row (the body
        must not write its inputs), and ``(logits, cache row)``, which
        ``run_spmd`` stacks into the next state."""
        own = tree_map(torch.clone, self._rank_slice(cache))
        return _kv.decode_step_tp(
            self.cfg, self._rank_slice(shards), own, tokens, pos,
            COMM_WORLD, overlap=self.serve_cfg.overlap,
            algorithm=self.serve_cfg.algorithm, active=active)

    def _traced_prefill(self, shards, prompt):
        """Mode A prefill of one prompt: a full ``max_seq`` row (dense) or
        an exact-length one (paged), filled by ``prefill_tp``."""
        rows = self._rows(prompt.shape[1]) if self._paged else \
            _kv.init_kv_cache_tp(self.cfg, 1, self._size, self._dtype,
                                 prompt.device)
        return _kv.prefill_tp(self.cfg, self._rank_slice(shards), rows,
                              prompt, COMM_WORLD)

    def _traced_step_paged(self, shards, pool, table, tokens, pos, active):
        """Mode A paged decode step: shards and pool stacked per rank, the
        host's block table, positions and live mask passed as host arrays
        (the step picks its write cells on the host)."""
        own = tree_map(torch.clone, self._rank_slice(pool))
        return _kv.decode_step_paged(
            self.cfg, self._rank_slice(shards), own, table, tokens, pos,
            COMM_WORLD, overlap=self.serve_cfg.overlap,
            algorithm=self.serve_cfg.algorithm, active=active)

    def _traced_prefill_chunk(self, shards, past, chunk):
        """Mode A chunk or suffix prefill against the stacked exact-length
        prefix rows gathered from the pool."""
        return _kv.prefill_chunk_tp(self.cfg, self._rank_slice(shards),
                                    self._rank_slice(past), chunk,
                                    COMM_WORLD)

    def _stacked(self, tree):
        """``tree`` repeated on a new leading axis, one row per rank."""
        return tree_map(lambda a: a.unsqueeze(0).expand(
            (self._rows_n,) + tuple(a.shape)).contiguous(), tree)

    def lower_step(self):
        """The JAX package's lowered decode-step program (its StableHLO
        census surface): the port has no lowered-program reader yet."""
        raise NotImplementedError(
            "Engine.lower_step: the decode-step census reads a lowered "
            "StableHLO program, which the port has no reader for yet "
            "(ROADMAP.md, Queue 1 item 7)")

    # ---------------------------------------------------------- lifecycle

    def _admit(self, events: dict) -> None:
        """Fill free slots from the queue; admission events (including a
        first token that already finishes the request) land in
        ``events``."""
        chooser = POLICIES[self.serve_cfg.policy]
        while self._queue and self._free_slots():
            req = self._queue[chooser(self._queue)]
            if self._paged:
                if not self._admit_paged(req, events):
                    # The pool cannot supply the pages even after
                    # evicting cached ones: the request stays queued.
                    break
                continue
            self._queue.remove(req)
            prompt = torch.as_tensor(req.prompt, dtype=torch.int64,
                                     device=self.device)[None, :]
            if self._spmd:
                logits, rows = self._prefill_call(self._shards, prompt)
                logits = logits[0]
            else:
                rows = _kv.init_kv_cache_tp(self.cfg, 1, self._size,
                                            self._dtype, self.device)
                logits, rows = _kv.prefill_tp(self.cfg, self._shards, rows,
                                              prompt, self._comm)
            self.stats.mark(req.rid, "admitted")
            self.stats.count("admitted")
            tok = self._select([req], logits)[0]
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
                for name in ("k", "v"):
                    if self._spmd:
                        c[name][:, j].copy_(r[name][:, 0])
                    else:
                        c[name][j].copy_(r[name][0])
            self._slot_req[j] = req
            self._tokens[j] = tok
            self._pos[j] = int(req.prompt.size)

    # -------------------------------------------------------------- paged

    def _rows(self, n: int):
        """Per-layer ``(1, n, kv_heads/size, head_dim)`` K/V buffers: the
        exact-length prefill cache of a paged admission."""
        hd = self.cfg.d_model // self.cfg.n_heads
        shape = (1, n, self.cfg.kv_heads // self._size, hd)
        return [{"k": torch.empty(shape, dtype=self._dtype,
                                  device=self.device),
                 "v": torch.empty(shape, dtype=self._dtype,
                                  device=self.device)}
                for _ in range(self.cfg.n_layers)]

    def _copy_block(self, dst: int, src: int) -> None:
        """Copy page ``src`` to ``dst`` in every layer (copy-on-write: a
        partly shared tail page is duplicated before a new suffix lands
        in it)."""
        for c in self._cache:
            for name in ("k", "v"):
                if self._spmd:
                    c[name][:, dst].copy_(c[name][:, src])
                else:
                    c[name][dst].copy_(c[name][src])
        self.stats.count("cow_copies")

    def _install_rows(self, j: int, rows, lo: int, hi: int) -> None:
        """Write prefill K/V rows for positions ``lo..hi-1`` of slot ``j``
        into its pages, one cell write per layer and leaf.  ``rows`` is
        the per-layer ``[{"k", "v"}]`` prefill output whose row axis
        starts at ``lo`` (trailing rows beyond ``hi`` are ignored).  The
        targets are private pages by the copy-on-write rule."""
        bs = self.serve_cfg.block_size
        at = np.arange(lo, hi)
        pool0 = self._cache[0]["k"]
        cells = live_cells(self._table[j, at // bs], at % bs,
                           pool0[0] if self._spmd else pool0)
        for c, r in zip(self._cache, rows):
            for name in ("k", "v"):
                if self._spmd:
                    for w in range(self._rows_n):
                        write_cells(c[name][w], cells,
                                    r[name][w, 0, :hi - lo])
                else:
                    write_cells(c[name], cells, r[name][0, :hi - lo])

    def _gather_past(self, j: int, n: int):
        """Exact-length past K/V (positions ``0..n-1``) of slot ``j``, the
        input of a suffix or chunk prefill: one gather per layer and leaf
        of the pages the host's table names."""
        if n == 0:
            return self._stacked(self._rows(0)) if self._spmd \
                else self._rows(0)
        nblk = -(-n // self.serve_cfg.block_size)
        ids = torch.as_tensor(self._table[j:j + 1, :nblk], device=self.device)

        def take(pool):
            if self._spmd:
                return torch.stack([block_gather(p, ids)[:, :n]
                                    for p in pool.unbind(0)])
            return block_gather(pool, ids)[:, :n]

        return [{"k": take(c["k"]), "v": take(c["v"])} for c in self._cache]

    def _admit_paged(self, req: Request, events: dict) -> bool:
        """Paged admission: match the prompt against the prefix index,
        adopt the shared pages (copying a partly shared tail), allocate
        private pages for the rest, then prefill only the unmatched
        suffix — in one shot if it fits ``prefill_chunk`` (or chunking is
        off), else as a :class:`_PrefillJob` advanced one chunk per step.
        Returns False (the request stays queued) when the pool cannot
        supply the pages."""
        bs = self.serve_cfg.block_size
        prompt = np.asarray(req.prompt)
        p_len = int(prompt.size)
        # At most p_len - 1 matched: the first token needs last-token
        # logits, so at least one suffix token is always computed.
        shared, l0 = self._mgr.match(prompt, p_len - 1)
        partial = l0 % bs != 0
        total = -(-p_len // bs)
        # Pages not fully covered by the share; a partly matched tail
        # page sits in `shared` but is copied into the first fresh page.
        # The matched pages are not referenced yet: `keep` stops the
        # allocation from reclaiming them (the JAX package's engine lets it,
        # and then serves another prompt's rows; ROADMAP.md Queue 3).
        fresh = self._mgr.alloc(total - l0 // bs, keep=shared)
        if fresh is None:
            return False
        self._mgr.ref(shared)
        j = self._free_slots()[0]
        self._table[j, :l0 // bs] = shared[:l0 // bs]
        self._table[j, l0 // bs:total] = fresh
        if partial:
            self._copy_block(fresh[0], shared[-1])
            self._mgr.release([shared[-1]])   # keep only the copy
        self._queue.remove(req)
        self.stats.count("prefix_hits" if l0 else "prefix_misses")
        self._slot_req[j] = req
        self._slot_seq[j] = self._admit_seq
        self._admit_seq += 1
        self.slot_log.append((req.rid, j))
        self._prefilling[j] = True
        self._pos[j] = l0          # rows installed so far
        job = _PrefillJob(req=req, slot=j, seq=prompt, done=l0)
        if l0 == 0 and (self._chunk is None or p_len <= self._chunk):
            # A whole-prompt miss that fits one shot: the ordinary prefill
            # of the dense engine and of generate().
            pj = torch.as_tensor(prompt, dtype=torch.int64,
                                 device=self.device)[None, :]
            if self._spmd:
                logits, rows = self._prefill_call(self._shards, pj)
                logits = logits[0]
            else:
                logits, rows = _kv.prefill_tp(self.cfg, self._shards,
                                              self._rows(p_len), pj,
                                              self._comm)
            self._install_rows(j, rows, 0, p_len)
            self.stats.count("prefill_tokens", p_len)
            job.done = p_len
            self._complete_admission(job, logits, events)
        elif self._chunk is None or p_len - l0 <= self._chunk:
            # The suffix fits one chunk: prefill it now.
            self._advance_job_chunk(job, events, cap=p_len - l0)
        else:
            # A long suffix: one chunk per step rides along with decode.
            self._prefill_jobs.append(job)
        return True

    def _advance_job_chunk(self, job: _PrefillJob, events: dict,
                           cap: Optional[int] = None) -> bool:
        """Prefill one chunk of ``job``; True when the prompt is fully
        installed (first token chosen, slot active)."""
        j = job.slot
        p_len = len(job.seq)
        c_len = min(cap if cap is not None else self._chunk,
                    p_len - job.done)
        past = self._gather_past(j, job.done)
        chunk = torch.as_tensor(job.seq[job.done:job.done + c_len],
                                dtype=torch.int64, device=self.device)[None]
        if self._spmd:
            logits, rows = self._chunk_call(self._shards, past, chunk)
            logits = logits[0]
        else:
            logits, rows = _kv.prefill_chunk_tp(self.cfg, self._shards, past,
                                                chunk, self._comm)
        self._install_rows(j, rows, job.done, job.done + c_len)
        self.stats.count("prefill_tokens", c_len)
        job.done += c_len
        self._pos[j] = job.done
        if job.done == p_len:
            self._complete_admission(job, logits, events)
            return True
        return False

    def _complete_admission(self, job: _PrefillJob, logits,
                            events: dict) -> None:
        """The prompt is resident: choose the first token, index the
        prompt's pages for later sharers and activate the slot — or
        finish at once (``max_new=1`` / immediate EOS), releasing the
        pages."""
        req, j = job.req, job.slot
        bs = self.serve_cfg.block_size
        p_len = len(job.seq)
        self.stats.mark(req.rid, "admitted")
        self.stats.count("admitted")
        tok = self._select([req], logits)[0]
        req.emitted.append(tok)
        self.stats.mark(req.rid, "first_token")
        events["admitted"].append(req.rid)
        events["emitted"].setdefault(req.rid, []).append(tok)
        # Content-addressed, so indexing the slot's own prompt pages
        # (immutable while it lives) is safe: the next identical prompt
        # prefills only its last token.
        self._mgr.register(job.seq, self._table[j, :-(-p_len // bs)]
                           .tolist(), p_len)
        self._prefilling[j] = False
        self._tokens[j] = tok
        self._pos[j] = p_len
        if req.finished(self.serve_cfg.eos):
            events["finished"].append(req.rid)
            self._release_slots([j])
            self._finish(req)

    def _prefill_tick(self, events: dict) -> None:
        """Advance the head chunked-prefill job by one chunk: the per-step
        prefill bound that keeps TTFT and resident decode latency
        bounded together."""
        if self._prefill_jobs and self._advance_job_chunk(
                self._prefill_jobs[0], events):
            self._prefill_jobs.popleft()

    def _preempt_one(self) -> bool:
        """Preempt the most recently admitted resident request to free
        pages: its written rows are indexed before release, and it
        re-queues at the head with its emitted tokens folded into the
        prompt and its advanced key.  Re-admission finds its own pages in
        the prefix index, so the restart costs about one page copy and a
        one-token suffix, and its stream stays ``generate()``'s."""
        cands = [j for j in range(self.serve_cfg.slots)
                 if self._slot_req[j] is not None]
        if not cands:
            return False
        j = max(cands, key=lambda s: self._slot_seq[s])
        req = self._slot_req[j]
        prompt = np.asarray(req.prompt)
        ext = np.concatenate([prompt.astype(np.int64),
                              np.asarray(req.emitted, np.int64)]) \
            .astype(prompt.dtype, copy=False)
        nreq = Request(rid=req.rid, prompt=ext,
                       max_new=req.max_new - len(req.emitted),
                       key=req.key, deadline=req.deadline)
        self._release_slots([j])   # indexes the rows, frees the pages
        self._queue.appendleft(nreq)
        self.stats.count("preempted")
        return True

    def _alloc_tick(self) -> None:
        """Before decode, map a page for every active slot whose write
        position crosses into an unmapped one; when the pool is dry,
        preempt (newest admitted first) until the page lands.  Each
        preemption frees real capacity (the victim's pages become cached,
        then evictable), so the loop ends; a request too large to ever fit
        was refused at submit."""
        bs = self.serve_cfg.block_size
        for j in range(self.serve_cfg.slots):
            while True:
                req = self._slot_req[j]
                if req is None or self._prefilling[j]:
                    break
                bi = int(self._pos[j]) // bs
                if self._table[j, bi] >= 0:
                    break
                got = self._mgr.alloc(1)
                if got is not None:
                    self._table[j, bi] = got[0]
                    break
                if not self._preempt_one():
                    break

    def kv_bytes_resident(self) -> int:
        """KV bytes held for request state right now (one rank's shard):
        every occupied slot's full ``max_seq`` rows on a dense engine, the
        pages in use on a paged one (a shared prefix counted once)."""
        hd = self.cfg.d_model // self.cfg.n_heads
        row = 2 * (self.cfg.kv_heads // self._size) * hd \
            * self.cfg.n_layers * self._dtype.itemsize
        if self._paged:
            return self._mgr.blocks_in_use * self.serve_cfg.block_size * row
        return self.occupancy() * self.cfg.max_seq * row

    def _finish(self, req: Request, status: str = STATUS_OK) -> None:
        self._results[req.rid] = np.concatenate(
            [np.asarray(req.prompt, np.int64),
             np.asarray(req.emitted, np.int64)])
        self._statuses[req.rid] = status
        self.stats.mark(req.rid, "finished")
        self.stats.count("finished" if status == STATUS_OK else status)

    def _release_slots(self, idxs: List[int]) -> None:
        """Return slots to the free pool.  A dense slot's cache rows are
        re-poisoned (stale K/V must be provably inert); a paged slot's
        written rows (prompt and emitted tokens up to its write frontier)
        are indexed before its pages are released, so eviction, drain and
        preemption all leave the prefix index able to hand the same pages
        back to a re-admission."""
        if not idxs:
            return
        if self._paged:
            bs = self.serve_cfg.block_size
            for j in idxs:
                req = self._slot_req[j]
                if req is not None:
                    n = int(self._pos[j])
                    if n:
                        seq = np.concatenate(
                            [np.asarray(req.prompt, np.int64),
                             np.asarray(req.emitted, np.int64)])[:n]
                        self._mgr.register(
                            seq, self._table[j, :-(-n // bs)].tolist(), n)
                    self._mgr.release(
                        [int(b) for b in self._table[j] if b >= 0])
                    self._table[j, :] = -1
                if self._prefilling[j]:
                    self._prefilling[j] = False
                    self._prefill_jobs = deque(
                        job for job in self._prefill_jobs if job.slot != j)
        for j in idxs:
            self._slot_req[j] = None
            self._tokens[j] = 0
            self._pos[j] = 0
        # A paged engine needs no poison: a free page is unmapped (-1),
        # block_gather zeroes it, and the causal frontier keeps stale
        # mapped rows inert.
        if not self._paged and self._dtype.is_floating_point:
            for c in self._cache:
                for j in idxs:
                    for name in ("k", "v"):
                        (c[name][:, j] if self._spmd
                         else c[name][j]).fill_(float("nan"))

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
        """Deadline sweep, admissions (and on a paged engine one prefill
        chunk and the page allocations), then one decode step over the
        slot table, then evictions.  Returns ``{"admitted": [...],
        "emitted": {rid: [tokens]}, "finished": [...], "expired":
        [...]}``; a request admitted this step may emit two tokens (its
        first and its first decoded one).

        An attached controller is consulted first: a step boundary is the
        one safe switch point (no collective in flight), so a ratified
        codec or schedule switch takes effect on this step's traffic as a
        whole.  Disabled (the default) or detached, the consult is one
        attribute read."""
        if self._controller is not None:
            self._controller.poll()
        events = {"admitted": [], "emitted": {}, "finished": [],
                  "expired": []}
        self._expire_sweep(events)
        self._admit(events)
        if self._paged:
            self._prefill_tick(events)
            self._alloc_tick()
        active = [j for j, r in enumerate(self._slot_req)
                  if r is not None and not self._prefilling[j]]
        if not active:
            if self._paged:
                self._pool_levels()
            return events
        live = np.zeros((self.serve_cfg.slots,), bool)
        live[active] = True
        tokens = torch.as_tensor(self._tokens, device=self.device)
        if self._spmd:
            if self._paged:
                logits, self._cache = self._step_call(
                    self._shards, self._cache, self._table, tokens,
                    self._pos, live)
            else:
                logits, self._cache = self._step_call(
                    self._shards, self._cache, tokens,
                    torch.as_tensor(self._pos), torch.as_tensor(live))
            logits = logits[0]
        elif self._paged:
            logits, self._cache = _kv.decode_step_paged(
                self.cfg, self._shards, self._cache, self._table, tokens,
                self._pos, self._comm, overlap=self.serve_cfg.overlap,
                algorithm=self.serve_cfg.algorithm, active=live)
        else:
            logits, self._cache = _kv.decode_step_tp(
                self.cfg, self._shards, self._cache, tokens,
                torch.as_tensor(self._pos, device=self.device), self._comm,
                overlap=self.serve_cfg.overlap,
                algorithm=self.serve_cfg.algorithm,
                active=torch.as_tensor(live, device=self.device))
        self.last_logits = logits
        toks = self._select([r if live[j] else None
                             for j, r in enumerate(self._slot_req)], logits)
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
        if self._paged:
            self._pool_levels()
        return events

    def _pool_levels(self) -> None:
        """The pool's populations into the ServeStats gauges, at the end
        of every step."""
        self.stats.level("blocks_in_use", self._mgr.blocks_in_use)
        self.stats.level("blocks_free", self._mgr.free_blocks)
        self.stats.level("blocks_cached", self._mgr.cached_blocks)

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

    # ------------------------------------------------------------ drain

    def _inflight_records(self) -> List[dict]:
        """A host snapshot of every unfinished request, slotted ones in
        slot order then the queue: prompt, tokens emitted so far,
        remaining budget, the advanced key, the deadline and, for a paged
        slot, the pages holding its written rows (a re-admission into the
        same pool finds them through the prefix index)."""
        recs, pages = [], {}
        for j, req in enumerate(self._slot_req):
            if req is not None:
                recs.append(req)
                if self._paged:
                    n = int(self._pos[j])
                    bs = self.serve_cfg.block_size
                    pages[id(req)] = {
                        "block_ids": [int(b) for b in
                                      self._table[j, :-(-n // bs)]],
                        "n_tokens": n}
        recs.extend(self._queue)
        return [{"rid": r.rid,
                 "prompt": np.array(r.prompt, copy=True),
                 "emitted": list(r.emitted),
                 "max_new": r.max_new,
                 "key": r.key,
                 "deadline": r.deadline,
                 "pages": pages.get(id(r))} for r in recs]

    def attach_controller(self, controller) -> None:
        """Attach a :class:`mpi4torch_tpu_torch.ctl.SelfTuningController`:
        every later :meth:`step` calls ``controller.poll()`` first (the
        between-steps switch point).  With ``config.ctl_enabled()`` False
        (the default) the engine's behaviour is unchanged;
        ``attach_controller(None)`` detaches."""
        self._controller = controller

    def snapshot_inflight(self) -> List[dict]:
        """:meth:`drain`'s records with the engine untouched."""
        return self._inflight_records()

    def drain(self) -> List[dict]:
        """Drain every unfinished request out of the engine: returns their
        records (see :meth:`snapshot_inflight`), releases their slots and
        clears the queue.  Finished results stay retrievable; the drained
        rids leave this engine's ledger, to be submitted again here or on
        another engine."""
        recs = self._inflight_records()
        self._release_slots([j for j, req in enumerate(self._slot_req)
                             if req is not None])
        self._queue.clear()
        self._known_rids.difference_update(r["rid"] for r in recs)
        return recs


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)
