"""Mode A: SPMD collectives over a named mesh axis, on rank threads.

Port of ``mpi4torch_tpu/ops/spmd.py``.  In the JAX package the whole
per-rank program is traced once under ``jax.shard_map`` and every
communication op lowers to an XLA collective.  PyTorch has no
``shard_map`` (and NCCL refuses two ranks of one communicator on one
card), so the port runs the same per-rank program on its rank threads
under JAX's Mode A contract:

* ``comm.rank`` is symbolic (:class:`RankExpr`): ring arithmetic such as
  ``(comm.rank + 1) % comm.size`` stays a static permutation, ``comm.rank
  ^ k`` a butterfly (:class:`PermRank`), and anything else materializes
  to a 0-d int64 tensor of the rank on the world's device.
  ``int(comm.rank)`` raises.
* Point-to-point peers are static permutations checked to be
  bijections; a matched ``Isend``/``Irecv`` pair becomes one permute.
  Unmatched sends and receives and un-waited split-phase handles raise
  :class:`DeadlockError` when the region ends; a double Wait and a
  spliced handle raise at once.
* Every Allreduce, Bcast_ and Reduce_ builds its schedule program in
  the collective-schedule IR (:mod:`mpi4torch_tpu_torch.csched`) and
  lowers it at the call site, as the JAX package does; the backward
  lowers the transposed program.  The emitters are the hand-written
  schedule bodies below: each ``lax.ppermute`` is one exchange round of
  the world, each ``lax.scan`` a Python loop with the same masked
  selects, and every rank does the work of every step.  The XLA-native
  collectives (``psum``, ``psum_scatter``, ``all_gather``,
  ``all_to_all``) are one exchange each, folding in ascending rank order
  within the axis group, so they give the bits of the port's Mode B.
* Every op is one ``torch.autograd.Function`` whose backward is the
  adjoint collective, and :func:`run_spmd` stacks the per-rank outputs
  along a leading axis whose gradient, taken from outside, runs every
  rank's backward on rank threads of the same world.

Every exchange is a rendezvous of the whole world through
``World.exchange(read=)``, the runtime's chokepoint, so tracing, fault
injection, the guards and the deadlock timeout cover Mode A unchanged.
On a 2-D mesh an axis collective is still a rendezvous of every rank of
the world, each reading only its own axis group (rank threads have no
sub-communicators); the world's signature check turns a rank that runs
another op into :class:`~mpi4torch_tpu_torch.runtime.
CollectiveMismatchError`.

Nothing is compiled: ``run_spmd(jit=True)`` runs eagerly, since ``jit``
has no counterpart the port needs (PyTorch runs eagerly; where launch
overhead dominates, a CUDA graph is the tool).  A program's record for
the analyzer comes from one recorded run (``analyze.lower``).  The
compressed collectives live in
``compress/spmd.py`` and the SPMD reshard executor in
``reshard/executor.py``; :class:`SpmdBackend` routes to them.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import config as _config
from .. import constants as C
from .. import csched as _csched
from ..runtime import (BifurcationError, CommError, DeadlockError, World,
                       resolve_device, run_rank_threads)
from ..utils.tree import tree_flatten, tree_from_structure
from .eager import _norm_axis
from .eager import join_dummies as _join_dummies

# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------


@dataclass
class _PendingP2P:
    kind: str                 # "send" | "recv"
    perm: Tuple[int, ...]     # canonical send permutation (dest of each
                              # rank); a recv stores the inverse of its
                              # source table — matched when equal
    tag: int
    value: Any                # payload (send) / buffer (recv)
    handle_state: "_HandleState"


@dataclass
class _HandleState:
    kind: str                 # "send" | "recv"
    perm: Tuple[int, ...]
    tag: int
    waited: bool = False
    matched: bool = False
    loop: Any = None          # loop-through (send)
    result: Any = None        # permute output (recv)
    buf: Any = None           # weak reference to the handle's buffer


@dataclass
class _CollState:
    """One posted split-phase collective (``overlap``): phase 1 (the
    *start*) already ran its communication; ``complete`` finishes phase 2
    at Wait time (``None``: the start ran the whole collective and Wait
    is the completion point)."""
    opname: str               # "Allreduce" | "Reduce_scatter" | "Allgather"
    complete: Any = None      # callable(phase1_value) -> final value
    waited: bool = False
    buf: Any = None           # weak reference to the handle's buffer


@dataclass
class SpmdContext:
    """An active SPMD region bound to a mesh axis on one rank thread.

    ``axis_name`` is a mesh axis name (a tuple of names for the group
    spanned by several axes), ``size`` its extent, ``index`` this rank's
    position along it (``lax.axis_index``), ``group`` the world ranks of
    its axis group in axis order, and ``world``/``rank`` the rank-thread
    world and this thread's rank in it."""
    axis_name: Any
    size: int
    world: Optional[World] = None
    rank: int = 0
    index: int = 0
    group: Tuple[int, ...] = ()
    pending: List[_PendingP2P] = field(default_factory=list)
    handles: Dict[int, _HandleState] = field(default_factory=dict)
    # Split-phase collective handles (overlap): keyed by the phase-1
    # buffer's id, like the p2p handle table; the pending list backs the
    # un-waited-at-region-exit guard.
    coll_handles: Dict[int, _CollState] = field(default_factory=dict)
    coll_pending: List[_CollState] = field(default_factory=list)
    _index_tensor: Any = None

    def index_tensor(self) -> torch.Tensor:
        """This rank's axis index as a 0-d int64 tensor on the world's
        device (made once per region by a fill, no host-to-device copy)."""
        if self._index_tensor is None:
            dev = self.world.device if self.world is not None else None
            self._index_tensor = torch.full(
                (), self.index, dtype=torch.int64,
                device=dev if dev is not None else "cpu")
        return self._index_tensor


class _Region:
    """One rank thread's view of a :func:`run_spmd` region: the world,
    this thread's rank, the mesh (axis names and extents, row-major over
    the world's ranks, the last axis fastest) and the axis
    ``COMM_WORLD`` resolves to.  Contexts are made per axis (or tuple of
    axes) on first use and live for the region, so the p2p ops posted by
    different calls match."""

    def __init__(self, world: World, rank: int, names: Tuple[str, ...],
                 shape: Tuple[int, ...], axis_name: str):
        self.world, self.rank = world, rank
        self.names, self.shape = names, shape
        self.axis_name = axis_name
        self.contexts: Dict[Any, SpmdContext] = {}
        from ..mesh import mesh_coords
        self.coords = mesh_coords(rank, shape)

    def ctx(self, axes) -> SpmdContext:
        key = tuple(axes) if isinstance(axes, (tuple, list)) else axes
        ctx = self.contexts.get(key)
        if ctx is None:
            ctx = self.contexts[key] = self.new_ctx(key)
        return ctx

    def new_ctx(self, key) -> SpmdContext:
        """A fresh context for the axis (or axes) ``key``: the world ranks
        that share this rank's coordinates on every other axis, row-major
        over ``key``'s axes."""
        from ..mesh import rank_of_coords
        names = key if isinstance(key, tuple) else (key,)
        for nm in names:
            if nm not in self.names:
                raise CommError(
                    f"axis {nm!r} not in mesh axes {self.names} of this "
                    "run_spmd region")
        pos = [self.names.index(nm) for nm in names]
        sizes = [self.shape[p] for p in pos]
        group = []
        for flat in range(math.prod(sizes)):
            coords = list(self.coords)
            rem = flat
            for p, s in zip(reversed(pos), reversed(sizes)):
                coords[p] = rem % s
                rem //= s
            group.append(rank_of_coords(coords, self.shape))
        return SpmdContext(axis_name=key, size=len(group), world=self.world,
                           rank=self.rank, index=group.index(self.rank),
                           group=tuple(group))


_tls = threading.local()


def _current_region() -> Optional[_Region]:
    return getattr(_tls, "region", None)


def world_rank() -> "RankExpr":
    """This rank's position in the whole ``run_spmd`` world (row-major over
    the mesh axes), symbolic: the row of a :func:`run_spmd` output that
    this rank produces, since outputs stack over every mesh position.  On
    a one-axis world it is ``COMM_WORLD.rank``."""
    region = _current_region()
    if region is None:
        raise CommError("world_rank is defined inside a run_spmd region "
                        "only")
    names = region.names[0] if len(region.names) == 1 else region.names
    return RankExpr(names, region.world.size)


def current_spmd_context() -> Optional[SpmdContext]:
    """The context of the axis ``COMM_WORLD`` resolves to on this rank
    thread, or None outside a :func:`run_spmd` region."""
    region = _current_region()
    return None if region is None else region.ctx(region.axis_name)


# ---------------------------------------------------------------------------
# Symbolic rank
# ---------------------------------------------------------------------------


def _axis_index_tensor(axis_name) -> torch.Tensor:
    region = _current_region()
    if region is None:
        raise CommError(
            f"a symbolic rank of axis {axis_name!r} was used outside its "
            "run_spmd region")
    return region.ctx(axis_name).index_tensor()


def _materialize_args(args):
    if isinstance(args, (RankExpr, PermRank)):
        return args._materialize()
    if isinstance(args, (list, tuple)):
        return type(args)(_materialize_args(a) for a in args)
    if isinstance(args, dict):
        return {k: _materialize_args(v) for k, v in args.items()}
    return args


class _Symbolic:
    """Shared torch dispatch of the symbolic ranks: any torch function or
    tensor operator that meets one materializes it (indexing included)."""

    __slots__ = ()

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.Tensor.__getitem__ and not kwargs \
                and isinstance(args[1], RankExpr):
            # ``x[comm.rank]``: this rank's row, a view, as indexing by
            # the materialized 0-d tensor gives, without reading the
            # index back from the device.
            return args[0][args[1]._concrete()]
        return func(*_materialize_args(args),
                    **_materialize_args(kwargs or {}))


class RankExpr(_Symbolic):
    """Symbolic ``axis_index + offset (mod size)``.

    Keeps ring arithmetic like ``(comm.rank + 1) % comm.size`` *static* so
    Isend/Irecv destinations stay a fixed permutation.  Any other
    arithmetic (e.g. ``res * comm.rank``) materializes the rank as a 0-d
    int64 tensor on the world's device, as does its use in a torch
    function or as a tensor index.
    """

    __slots__ = ("axis_name", "size", "offset", "wrapped")

    def __init__(self, axis_name, size: int, offset: int = 0,
                 wrapped: bool = False):
        self.axis_name = axis_name
        self.size = size
        # ``wrapped`` records whether the user applied ``% size``; only then
        # does materialization wrap.  ``comm.rank + 1`` as a plain value is
        # rank+1 (8 on the last of 8 ranks), NOT (rank+1) % size.
        self.offset = offset % size if wrapped else offset
        self.wrapped = wrapped

    # -- static shift algebra ------------------------------------------------
    def __add__(self, k):
        if isinstance(k, int) and not self.wrapped:
            return RankExpr(self.axis_name, self.size, self.offset + k)
        # Arithmetic past a `% size` is no longer an affine-shift-with-one-
        # wrap; materialize for correctness.
        return self._materialize() + k

    __radd__ = __add__

    def __sub__(self, k):
        if isinstance(k, int) and not self.wrapped:
            return RankExpr(self.axis_name, self.size, self.offset - k)
        return self._materialize() - k

    def __mod__(self, m):
        if isinstance(m, int) and m == self.size:
            return RankExpr(self.axis_name, self.size, self.offset,
                            wrapped=True)
        return self._materialize() % m

    def __xor__(self, k):
        # `comm.rank ^ k` is the butterfly-exchange peer — a static
        # bijection whenever every `i ^ k` stays in [0, size).
        if isinstance(k, int) and self.offset == 0 and not self.wrapped:
            table = [i ^ k for i in range(self.size)]
            if any(not (0 <= t < self.size) for t in table):
                raise CommError(
                    f"comm.rank ^ {k} leaves [0, {self.size}) on some rank "
                    f"(e.g. rank {table.index(max(table))} -> {max(table)}); "
                    "a butterfly exchange needs the axis size to cover the "
                    "xor image"
                )
            return PermRank(self.axis_name, self.size, table)
        return self._materialize() ^ k

    __rxor__ = __xor__

    # -- materialization -----------------------------------------------------
    def _materialize(self):
        idx = _axis_index_tensor(self.axis_name)
        if self.offset:
            out = idx + self.offset
            return out % self.size if self.wrapped else out
        return idx

    def _concrete(self) -> int:
        """The value :meth:`_materialize` holds, for the runtime's own
        indexing (never handed to a user body as a Python int)."""
        region = _current_region()
        if region is None:
            raise CommError(
                f"a symbolic rank of axis {self.axis_name!r} was used "
                "outside its run_spmd region")
        out = region.ctx(self.axis_name).index + self.offset
        return out % self.size if self.wrapped else out

    def __mul__(self, other):
        return self._materialize() * other

    __rmul__ = __mul__

    def __rsub__(self, other):
        return other - self._materialize()

    def __eq__(self, other):
        if isinstance(other, RankExpr):
            return (self.axis_name == other.axis_name
                    and self.size == other.size
                    and self.offset == other.offset
                    and self.wrapped == other.wrapped)
        return self._materialize() == other

    def __hash__(self):
        return hash((self.axis_name, self.size, self.offset, self.wrapped))

    def __int__(self):
        raise CommError(
            "comm.rank is symbolic under SPMD tracing (one trace for all "
            "ranks); it cannot be converted to a Python int.  Use it in "
            "array arithmetic (it materializes to lax.axis_index) or in "
            "ring shifts like (comm.rank + 1) % comm.size for p2p "
            "destinations.  For concrete Python ranks use the eager "
            "thread-SPMD runtime (run_ranks)."
        )

    __index__ = __int__

    def __repr__(self):
        return (f"RankExpr({self.axis_name!r}, size={self.size}, "
                f"offset={self.offset})")


class PermRank(_Symbolic):
    """Symbolic p2p peer given by an explicit per-rank table: on rank ``i``
    the peer is ``table[i]``.  Produced by rank algebra (``comm.rank ^ 1``)
    or passed directly to Isend/Irecv as a sequence.  The table must be a
    bijection — every static permutation becomes ONE permute."""

    __slots__ = ("axis_name", "size", "table")

    def __init__(self, axis_name, size: int, table):
        table = tuple(int(t) for t in table)
        if len(table) != size:
            raise CommError(
                f"peer table has {len(table)} entries for axis size {size}"
            )
        if sorted(table) != list(range(size)):
            raise CommError(
                f"peer table {table} is not a permutation of 0..{size - 1}; "
                "a point-to-point exchange under SPMD must be a bijection "
                "(two ranks sending to one destination would need MPI "
                "message queues, which the single-trace program has no "
                "analogue for)"
            )
        self.axis_name = axis_name
        self.size = size
        self.table = table

    def _materialize(self):
        idx = _axis_index_tensor(self.axis_name)
        peer = self.table[_current_region().ctx(self.axis_name).index]
        return torch.full((), peer, dtype=torch.int64, device=idx.device)

    def __repr__(self):
        return f"PermRank({self.axis_name!r}, table={self.table})"


@functools.lru_cache(maxsize=512)
def _perm_desc(perm: Tuple[int, ...]) -> str:
    """Human form of a send permutation for error messages."""
    n = len(perm)
    shifts = {(perm[r] - r) % n for r in range(n)}
    if len(shifts) == 1:
        return f"ring shift {next(iter(shifts))}"
    return f"perm {list(perm)}"


@functools.lru_cache(maxsize=512)
def _ring_table(n: int, k: int) -> Tuple[int, ...]:
    """Send-permutation table of the ring shift ``+k`` on ``n`` ranks."""
    return tuple((r + k) % n for r in range(n))


def _peer_table(ctx: SpmdContext, peer, what: str) -> Tuple[int, ...]:
    """Resolve a p2p peer spec to the per-rank peer table t (t[r] = rank r's
    peer), validated to be a static bijection."""
    n = ctx.size
    if isinstance(peer, RankExpr):
        if peer.axis_name != ctx.axis_name:
            raise CommError(
                f"{what} rank belongs to axis {peer.axis_name!r}, not the "
                f"communicator's axis {ctx.axis_name!r}"
            )
        if not peer.wrapped and peer.offset != 0:
            # `comm.rank + k` without `% size` is out of [0, size) on some
            # rank — MPI would reject it there; SPMD rejects it everywhere
            # instead of silently wrapping.
            raise CommError(
                f"{what} rank `comm.rank {peer.offset:+d}` is out of range "
                f"on some ranks (size {ctx.size}); write "
                f"`(comm.rank {peer.offset:+d}) % comm.size` for a ring "
                "shift"
            )
        return _ring_table(n, peer.offset % n)
    if isinstance(peer, PermRank):
        if peer.axis_name != ctx.axis_name or peer.size != n:
            raise CommError(
                f"{what} peer table belongs to axis {peer.axis_name!r} "
                f"(size {peer.size}), not the communicator's axis "
                f"{ctx.axis_name!r} (size {n})"
            )
        return peer.table
    if isinstance(peer, (list, tuple)) and all(
            isinstance(t, (int,)) or hasattr(t, "__index__") for t in peer):
        return PermRank(ctx.axis_name, n, peer).table
    raise CommError(
        f"Under SPMD tracing, the {what} of a point-to-point op must be a "
        "static permutation of comm.rank: a ring shift like "
        "(comm.rank + 1) % comm.size, a butterfly like comm.rank ^ 1, or an "
        f"explicit per-rank table of length {n}; got {peer!r}.  A literal "
        "rank would mean every rank sends to the same destination, which is "
        "not a permutation.  Use the eager thread-SPMD runtime for "
        "arbitrary concrete destinations."
    )


def _invert_perm(table: Tuple[int, ...]) -> Tuple[int, ...]:
    inv = [0] * len(table)
    for r, t in enumerate(table):
        inv[t] = r
    return tuple(inv)


@functools.lru_cache(maxsize=64)
def _identity_perm(n: int) -> Tuple[int, ...]:
    return tuple(range(n))


# ---------------------------------------------------------------------------
# Exchange primitives: each is ONE rendezvous of the world in which every
# rank reads its axis group (the lax collectives of the JAX package).
# ---------------------------------------------------------------------------


def _sig(x) -> Tuple:
    return (tuple(x.shape), str(x.dtype))


def _xchg(ctx: SpmdContext, kind: str, payload, read, extra=()):
    return ctx.world.exchange(
        ctx.rank, ("spmd." + kind, ctx.axis_name) + tuple(extra)
        + (_sig(payload),), payload, read=read)


def _members(ctx: SpmdContext, groups) -> Tuple[Tuple[int, ...], int]:
    """``(world ranks of this rank's group, its position in it)``:
    ``groups`` is ``None`` (the whole axis) or lists of axis indices
    (``axis_index_groups``)."""
    if groups is None:
        return ctx.group, ctx.index
    for grp in groups:
        if ctx.index in grp:
            return tuple(ctx.group[i] for i in grp), list(grp).index(
                ctx.index)
    raise CommError(f"axis index {ctx.index} is in no group of {groups}")


def _fold(op: int, vals):
    """Ascending fold of ``vals``; always a tensor of this rank's own."""
    out = vals[0]
    for v in vals[1:]:
        out = C.combine2(op, out, v)
    return out.clone() if len(vals) == 1 else out


def _ppermute(ctx: SpmdContext, v, pairs):
    """``lax.ppermute``: ``pairs`` of (source, destination) axis indices;
    a rank no pair sends to receives zeros."""
    pairs = tuple(pairs)
    src = None
    for s, d in pairs:
        if d == ctx.index:
            src = s

    def read(vals):
        if src is None:
            return torch.zeros_like(v)
        return vals[ctx.group[src]].clone()

    return _xchg(ctx, "ppermute", v, read, (pairs,))


def _all_gather(ctx: SpmdContext, v, groups=None):
    """``lax.all_gather(tiled=False)``: the group's values stacked on a new
    leading axis, in group order."""
    members, _ = _members(ctx, groups)
    return _xchg(ctx, "all_gather", v,
                 lambda vals: torch.stack([vals[m] for m in members]),
                 (groups and tuple(map(tuple, groups)),))


def _all_gather_tiled(ctx: SpmdContext, v, ax: int, groups=None):
    """``lax.all_gather(tiled=True)``: concatenation along ``ax``."""
    members, _ = _members(ctx, groups)
    return _xchg(ctx, "all_gather_tiled", v,
                 lambda vals: torch.cat([vals[m] for m in members], dim=ax)
                 if len(members) > 1 else v.clone(),
                 (ax, groups and tuple(map(tuple, groups))))


def _psum(ctx: SpmdContext, v, op: int = C.MPI_SUM, groups=None):
    """``lax.psum``/``pmax``/``pmin``: the group's ascending fold, on every
    member (the bits of the port's Mode B fold)."""
    members, _ = _members(ctx, groups)
    return _xchg(ctx, "psum", v,
                 lambda vals: _fold(op, [vals[m] for m in members]),
                 (op, groups and tuple(map(tuple, groups))))


def _psum_scatter(ctx: SpmdContext, v, op: int, dim: int, groups=None):
    """``lax.psum_scatter(tiled=True)``: member ``p`` of the group receives
    segment ``p`` along ``dim`` of the group's ascending fold (every
    contribution sliced before the fold)."""
    members, pos = _members(ctx, groups)
    shard = v.shape[dim] // len(members)
    return _xchg(ctx, "psum_scatter", v, lambda vals: _fold(
        op, [vals[m].narrow(dim, pos * shard, shard) for m in members]),
        (op, dim, groups and tuple(map(tuple, groups))))


def _all_to_all(ctx: SpmdContext, v, split_axis: int, concat_axis: int,
                groups=None):
    """``lax.all_to_all(tiled=True)``: split along ``split_axis`` into one
    piece per group member, exchange within the group
    (``axis_index_groups``), concatenate along ``concat_axis`` in group
    order."""
    members, pos = _members(ctx, groups)
    n = len(members)
    chunk = v.shape[split_axis] // n

    def read(vals):
        if n == 1:
            return v.clone()
        return torch.cat([vals[m].narrow(split_axis, pos * chunk, chunk)
                          for m in members], dim=concat_axis)

    return _xchg(ctx, "all_to_all", v, read,
                 (split_axis, concat_axis,
                  groups and tuple(map(tuple, groups))))


def _mask_to_root(ctx: SpmdContext, x, root: int):
    return x if ctx.index == root else torch.zeros_like(x)


def _pad_flat(x, multiple: int):
    """The flat view of ``x`` zero-padded to a multiple of ``multiple``."""
    flat = x.reshape(-1)
    total = flat.numel()
    padded = -(-total // multiple) * multiple
    if padded != total:
        flat = torch.cat([flat, flat.new_zeros(padded - total)])
    return flat


# ---------------------------------------------------------------------------
# Allreduce schedules: the JAX package's hand-written forms (its IR's
# emitter bodies), step for step.  Every combine is an explicit combine2
# with a FIXED association; the relay and tree forms only move data, so
# unlike the masked-psum broadcast they never flip the sign of -0.0.
# ---------------------------------------------------------------------------


def _gather_fold_allreduce(ctx: SpmdContext, x, op: int):
    """All-gather + fixed ascending-rank fold (the small-payload form)."""
    stacked = _all_gather(ctx, x)
    out = stacked[0]
    for i in range(1, ctx.size):
        out = C.combine2(op, out, stacked[i])
    return out


def _ring_fold_allreduce(ctx: SpmdContext, x, op: int):
    """Chunked pipelined ring fold: the fixed ascending-rank reduction of
    :func:`_gather_fold_allreduce` (hence its bits), with extra memory
    that does not grow with the rank count.  Chunk ``j`` rides the ring
    0→1→…→size-1, each hop adding that rank's contribution on the right
    (``combine2(acc, mine)``); chunks pipeline one step apart.

    **Phase pipelining** (``config.phase_pipelined_ring()``, default on):
    a chunk whose fold completed on the last rank starts its all-gather
    relay around the same ring at once, so the loop is
    ``nchunks + 2(size-1)`` steps with two chunk-sized permutes each.
    With the knob off, the two-phase form runs: the fold loop, then the
    binomial-tree broadcast from the last rank.  Both move completed
    chunks by pure data movement, so the bits are identical."""
    n, idx = ctx.size, ctx.index
    shape, total = x.shape, x.numel()
    chunk_elems = max(1, _config.ordered_ring_chunk_bytes()
                      // x.element_size())
    nchunks = -(-total // chunk_elems)
    xc = _pad_flat(x, chunk_elems).reshape(nchunks, chunk_elems)
    ring = tuple((i, (i + 1) % n) for i in range(n))

    def clip(j):
        return min(max(j, 0), nchunks - 1)

    if not _config.phase_pipelined_ring():
        # Two-phase form: fold every chunk (size+nchunks-1 steps), then
        # one full-payload tree broadcast from the last rank.
        prev, out = x.new_zeros(chunk_elems), torch.zeros_like(xc)
        for t in range(n + nchunks - 1):
            recv = _ppermute(ctx, prev, ring)
            j = t - idx
            active = 0 <= j < nchunks
            mine = xc[clip(j)]
            folded = C.combine2(op, recv, mine)
            acc = mine if idx == 0 else folded
            if active and idx == n - 1:
                out[clip(j)] = acc
            if active:
                prev = acc
        result = _tree_bcast_value(ctx, out.reshape(-1), n - 1)
        return result[:total].reshape(shape)

    # Fold lane (the two-phase schedule's bits) + relay lane: chunk j,
    # completed on rank n-1 at step j+n-1, rides the +1 ring; rank r (at
    # relay distance hops = (r+1) % n from the last rank) receives it at
    # step j + n-1 + hops, stores it and forwards it (rank n-2, the last
    # receiver, stops).  Chunks arrive one step apart: one relay slot.
    hops = (idx + 1) % n
    fold_prev = x.new_zeros(chunk_elems)
    relay_prev = x.new_zeros(chunk_elems)
    out = torch.zeros_like(xc)
    for t in range(nchunks + 2 * (n - 1)):
        fold_recv = _ppermute(ctx, fold_prev, ring)
        relay_recv = _ppermute(ctx, relay_prev, ring)
        j = t - idx
        active_f = 0 <= j < nchunks
        mine = xc[clip(j)]
        folded = C.combine2(op, fold_recv, mine)
        acc = mine if idx == 0 else folded
        fold_next = acc if active_f else fold_prev
        land = active_f and idx == n - 1
        jr = t - (n - 1) - hops
        active_r = 0 <= jr < nchunks and hops >= 1
        relay_next = acc if land else (
            relay_recv if (active_r and idx != n - 2) else relay_prev)
        # The landing rank keeps its completed chunk, every other rank
        # the relayed one; mutually exclusive (hops >= 1 excludes n-1).
        if land:
            out[clip(j)] = acc
        elif active_r:
            out[clip(jr)] = relay_recv
        fold_prev, relay_prev = fold_next, relay_next
    return out.reshape(-1)[:total].reshape(shape)


def _ring_fold_reduce_scatter(ctx: SpmdContext, x, op: int, ax: int,
                              shard: int):
    """Chunked ring fold that delivers segment ``s`` of the ascending-rank
    reduction directly to rank ``s``: the deterministic reduce-scatter
    for payloads past the gather threshold.  Two lanes, one chunk wide:
    the fold lane is :func:`_ring_fold_allreduce`'s schedule; a completed
    chunk whose owner is not the last rank rides the same +1 ring,
    unreduced, until it reaches ``owner(j) = j // chunks_per_segment``."""
    n, idx = ctx.size, ctx.index
    xm = torch.movedim(x, ax, 0)
    rest_shape = tuple(xm.shape[1:])
    seg_elems = shard * math.prod(rest_shape)
    xm = xm.reshape(n, seg_elems)
    chunk_elems = max(1, _config.ordered_ring_chunk_bytes()
                      // x.element_size())
    cps = -(-seg_elems // chunk_elems)            # chunks per segment
    if cps * chunk_elems != seg_elems:
        xm = torch.cat([xm, xm.new_zeros(n, cps * chunk_elems - seg_elems)],
                       dim=1)
    xc = xm.reshape(n * cps, chunk_elems)
    nchunks = n * cps
    ring = tuple((i, (i + 1) % n) for i in range(n))
    hops = (idx + 1) % n                          # ring distance n-1 → idx

    def clip(j):
        return min(max(j, 0), nchunks - 1)

    fold_prev = x.new_zeros(chunk_elems)
    relay_prev = x.new_zeros(chunk_elems)
    out = x.new_zeros(cps, chunk_elems)
    for t in range(nchunks + 2 * n - 2):
        fold_recv = _ppermute(ctx, fold_prev, ring)
        relay_recv = _ppermute(ctx, relay_prev, ring)
        j = t - idx
        active_f = 0 <= j < nchunks
        jc = clip(j)
        mine = xc[jc]
        folded = C.combine2(op, fold_recv, mine)
        acc = mine if idx == 0 else folded
        fold_next = acc if active_f else fold_prev
        # Landing on the last rank: keep my own segment, relay the rest.
        land = active_f and idx == n - 1
        land_mine = land and jc // cps == idx
        land_relay = land and jc // cps != idx
        # The chunk passing rank idx at step t left the last rank at
        # j_r + n - 1.
        jr = t - (n - 1) - hops
        active_r = 0 <= jr < nchunks and hops >= 1
        jrc = clip(jr)
        capture = active_r and jrc // cps == idx
        relay_next = acc if land_relay else (
            relay_recv if (active_r and not capture) else relay_prev)
        if land_mine:
            out[jc % cps] = acc
        elif capture:
            out[jrc % cps] = relay_recv
        fold_prev, relay_prev = fold_next, relay_next
    seg = out.reshape(-1)[:seg_elems].reshape((shard,) + rest_shape)
    return torch.movedim(seg, 0, ax).contiguous()


def _ordered_fold_allreduce(ctx: SpmdContext, x, op: int):
    """Fixed ascending-rank fold, the bits of the port's Mode B: small
    payloads take the all-gather+fold, large ones the chunked ring."""
    if ctx.size == 1:
        return x
    gathered_bytes = x.numel() * x.element_size() * ctx.size
    if gathered_bytes <= _config.ordered_fold_gather_max_bytes():
        return _gather_fold_allreduce(ctx, x, op)
    return _ring_fold_allreduce(ctx, x, op)


def _rhd_allreduce_value(ctx: SpmdContext, x, op: int):
    """Recursive-halving/doubling (butterfly) allreduce: 2·log2(N)
    permutes of halving/doubling width.  Power-of-two worlds only.  After
    the halving phase rank ``r`` holds segment ``r`` in the balanced-tree
    association of :func:`constants.reduce_rhd`; the doubling phase
    concatenates the segments back."""
    n = ctx.size
    if n == 1:
        return x
    if n & (n - 1):
        raise CommError(
            f"the 'rhd' (recursive halving/doubling) schedule needs a "
            f"power-of-two world; got {n} ranks — use 'tree' for the "
            "logarithmic schedule at this size, or 'ring'")
    idx = ctx.index
    shape, total = x.shape, x.numel()
    buf = _pad_flat(x, n)
    d = n // 2
    while d >= 1:
        m = buf.numel() // 2
        lo, hi = buf[:m], buf[m:]
        bit = (idx & d) != 0
        send, kept = (lo, hi) if bit else (hi, lo)
        recv = _ppermute(ctx, send, [(i, i ^ d) for i in range(n)])
        buf = C.combine2(op, kept, recv)
        d //= 2
    d = 1
    while d < n:
        recv = _ppermute(ctx, buf, [(i, i ^ d) for i in range(n)])
        buf = torch.cat([recv, buf] if (idx & d) != 0 else [buf, recv])
        d *= 2
    return buf[:total].reshape(shape)


def _tree_reduce_value(ctx: SpmdContext, x, op: int, root: int):
    """Binomial-tree reduce-to-root: at step ``s = 2^(k-1), …, 2, 1``
    relative ranks ``[s, 2s)`` (when present) send their partials to
    ``[0, s)``, one full-payload permute a round.  Non-root results are
    zeroed (the Reduce_ contract).  The association is
    :func:`constants.reduce_tree`'s."""
    n = ctx.size
    if n == 1:
        return x
    rel = (ctx.index - root) % n
    acc = x
    s = 1
    while s < n:
        s *= 2
    s //= 2
    while s >= 1:
        perm = [((r + s + root) % n, (r + root) % n)
                for r in range(s) if r + s < n]
        if perm:
            recv = _ppermute(ctx, acc, perm)
            folded = C.combine2(op, acc, recv)
            acc = folded if (rel < s and rel + s < n) else acc
        s //= 2
    return _mask_to_root(ctx, acc, root)


def _tree_bcast_value(ctx: SpmdContext, x, root: int):
    """Binomial-tree broadcast: round k sends from relative ranks
    [0, 2^k) to [2^k, 2^{k+1})."""
    n = ctx.size
    rel = (ctx.index - root) % n
    val = _mask_to_root(ctx, x, root)
    step = 1
    while step < n:
        perm = [((r + root) % n, (r + step + root) % n)
                for r in range(min(step, n - step))]
        recv = _ppermute(ctx, val, perm)
        val = recv if step <= rel < 2 * step else val
        step *= 2
    return val


def _tree_allreduce_value(ctx: SpmdContext, x, op: int):
    """Logarithmic tree allreduce: binomial reduce to rank 0 + binomial
    broadcast back, 2·ceil(log2 N) full-payload permutes."""
    if ctx.size == 1:
        return x
    return _tree_bcast_value(ctx, _tree_reduce_value(ctx, x, op, 0), 0)


def _hier_group_for(ctx: SpmdContext) -> int:
    """Intra-group size of the single-axis ``hier``/``torus`` split, the
    shared ``tune.resolve_hier_group`` rule."""
    from ..tune import resolve_hier_group

    return resolve_hier_group(ctx.size)


def _hier_groups(n: int, g: int):
    ngroups = n // g
    inner = [[b * g + i for i in range(g)] for b in range(ngroups)]
    outer = [[i + b * g for b in range(ngroups)] for i in range(g)]
    return inner, outer, ngroups


def _grouped_sum_schedule(x, g: int, rs, ar, ag):
    """The 2-level SUM allreduce body of both hier forms: pad the flat
    payload to ``g`` rows, intra-tier reduce-scatter, inter-tier
    allreduce, intra-tier all-gather.  Each of ``rs``/``ar``/``ag`` is
    ``(context, axis_index_groups)`` (groups ``None``: the context's
    whole axis)."""
    shape, total = x.shape, x.numel()
    xc = _pad_flat(x, g).reshape(g, -1)
    part = _psum_scatter(rs[0], xc, C.MPI_SUM, 0, rs[1])
    part = _psum(ar[0], part, C.MPI_SUM, ar[1])
    out = _all_gather_tiled(ag[0], part, 0, ag[1])
    return out.reshape(-1)[:total].reshape(shape)


def _grouped_ordered_fold(x, op: int, g: int, ngroups: int, inner, outer):
    """Deterministic 2-level grouped fold of both hier forms: ascending
    within the ``g``-rank inner tier, then ascending over the ``ngroups``
    group partials — :func:`constants.reduce_grouped`'s association.
    ``inner``/``outer``: ``(context, axis_index_groups)``."""
    stacked = _all_gather(inner[0], x, inner[1])
    intra = stacked[0]
    for i in range(1, g):
        intra = C.combine2(op, intra, stacked[i])
    stacked2 = _all_gather(outer[0], intra, outer[1])
    out = stacked2[0]
    for b in range(1, ngroups):
        out = C.combine2(op, out, stacked2[b])
    return out


def _hier_allreduce_value(ctx: SpmdContext, x, op: int):
    """Hierarchical 2-level allreduce on a single axis: intra-group
    reduce-scatter → inter-group allreduce → intra-group all-gather, with
    groups of ``g`` consecutive ranks.  SUM outside deterministic mode
    takes the grouped native triple; everything else the grouped ordered
    fold."""
    n = ctx.size
    if n == 1:
        return x
    g = _hier_group_for(ctx)
    inner, outer, ngroups = _hier_groups(n, g)
    if op == C.MPI_SUM and not _config.deterministic_reductions():
        return _grouped_sum_schedule(x, g, (ctx, inner), (ctx, outer),
                                     (ctx, inner))
    return _grouped_ordered_fold(x, op, g, ngroups, (ctx, inner),
                                 (ctx, outer))


def _ring_allreduce_chain(ctx: SpmdContext, flat, op: int, direction: int):
    """One directional ring allreduce of permutes: reduce-scatter (N-1
    hops) + all-gather (N-1 hops) on the ring ``i -> (i + direction) %
    N``, the payload split into N segments.  Segment ``j`` folds
    cyclically from rank ``j`` onward (``combine2(partial, mine)`` a
    hop), completing at rank ``(j - direction) % N``.  The JAX package
    unrolls small worlds and scans large ones; the steps are the same."""
    n, idx = ctx.size, ctx.index
    total = flat.numel()
    segs = _pad_flat(flat, n).reshape(n, -1)
    d = 1 if direction >= 0 else -1
    perm = [(i, (i + d) % n) for i in range(n)]
    part = segs[idx]
    for t in range(n - 1):
        recv = _ppermute(ctx, part, perm)
        part = C.combine2(op, recv, segs[(idx - d * (t + 1)) % n])
    out = torch.zeros_like(segs)
    out[(idx + d) % n] = part
    cur = part
    for t in range(n - 1):
        cur = _ppermute(ctx, cur, perm)
        out[(idx - d * t) % n] = cur
    return out.reshape(-1)[:total]


def _bidir_allreduce_value(ctx: SpmdContext, x, op: int,
                           reverse: bool = False):
    """Bidirectional dual-ring allreduce (``bidir``): the flat payload
    splits at :func:`constants.multipath_split` into two halves on
    counter-rotating :func:`_ring_allreduce_chain` chains.  ``reverse``
    swaps the halves' directions (the adjoint).  Under deterministic
    reductions the halves are disjoint ranges of an elementwise fold, so
    the association is the ascending-rank ordered fold."""
    n = ctx.size
    if n == 1:
        return x
    if op in (C.MPI_MINLOC, C.MPI_MAXLOC):
        C.combine2(op, x, x)  # raises NotImplementedError with explanation
    if _config.deterministic_reductions():
        return _ordered_fold_allreduce(ctx, x, op)
    shape = x.shape
    flat = x.reshape(-1)
    total = flat.numel()
    m = C.multipath_split(total)
    d0, d1 = (-1, 1) if reverse else (1, -1)
    h0 = _ring_allreduce_chain(ctx, flat[:m], op, d0)
    if m >= total:
        return h0.reshape(shape)
    h1 = _ring_allreduce_chain(ctx, flat[m:], op, d1)
    return torch.cat([h0, h1]).reshape(shape)


def _torus_allreduce_value(ctx: SpmdContext, x, op: int):
    """Multi-axis torus multipath allreduce (``torus``) on a flat axis:
    the 2-level factorization of :func:`_hier_allreduce_value` viewed as
    a virtual 2D torus, with the payload STRIPED across the two axes —
    half 0 runs its grouped channel with the inner tier first, half 1
    with the tiers transposed.  Deterministic / non-native ops fold each
    half in its channel's fixed 2-level association,
    :func:`constants.reduce_torus`."""
    n = ctx.size
    if n == 1:
        return x
    if op in (C.MPI_MINLOC, C.MPI_MAXLOC):
        C.combine2(op, x, x)  # raises NotImplementedError with explanation
    g = _hier_group_for(ctx)
    inner, outer, ngroups = _hier_groups(n, g)
    shape = x.shape
    flat = x.reshape(-1)
    total = flat.numel()
    m = C.multipath_split(total)
    if op == C.MPI_SUM and not _config.deterministic_reductions():
        o0 = _grouped_sum_schedule(flat[:m], g, (ctx, inner), (ctx, outer),
                                   (ctx, inner))
        o1 = (_grouped_sum_schedule(flat[m:], ngroups, (ctx, outer),
                                    (ctx, inner), (ctx, outer))
              if m < total else None)
    else:
        o0 = _grouped_ordered_fold(flat[:m], op, g, ngroups, (ctx, inner),
                                   (ctx, outer))
        o1 = (_grouped_ordered_fold(flat[m:], op, ngroups, g, (ctx, outer),
                                    (ctx, inner))
              if m < total else None)
    if o1 is None:
        return o0.reshape(shape)
    return torch.cat([o0, o1]).reshape(shape)


def _handwritten_allreduce_value(ctx: SpmdContext, x, op: int,
                                 algorithm: Optional[str] = "ring",
                                 reverse: bool = False):
    """The hand-written dispatch over the schedules above, the reference
    the IR route (:func:`_allreduce_fwd_value`) is held to bitwise, in
    values, gradients and exchanges, by the tests and the card smoke.
    ``reverse`` is the SUM adjoint: ``bidir``'s halves swap directions,
    every other schedule runs again as it is."""
    algorithm = algorithm or "ring"
    n = ctx.size
    det = _config.deterministic_reductions()
    if algorithm == "rhd":
        return _rhd_allreduce_value(ctx, x, op)
    if algorithm == "tree":
        return _tree_allreduce_value(ctx, x, op)
    if algorithm == "hier":
        return _hier_allreduce_value(ctx, x, op)
    if algorithm == "bidir":
        return _bidir_allreduce_value(ctx, x, op, reverse=reverse)
    if algorithm == "torus":
        return _torus_allreduce_value(ctx, x, op)
    if algorithm == "ring":
        # The native collective (psum/pmax/pmin): SUM outside
        # deterministic mode, MAX and MIN always; the rest fold in order.
        if op in (C.MPI_MAX, C.MPI_MIN) or (op == C.MPI_SUM and not det):
            return _psum(ctx, x, op)
        if op in (C.MPI_MINLOC, C.MPI_MAXLOC):
            C.combine2(op, x, x)  # raises with explanation
        return _ordered_fold_allreduce(ctx, x, op)
    raise CommError(
        f"no Mode A schedule for collective algorithm {algorithm!r} "
        "(registered: ring, rhd, tree, hier, bidir, torus)")


def _csched_args(x):
    """The static call data the IR program constructors key on."""
    return x.numel(), x.element_size()


def _allreduce_program(ctx: SpmdContext, x, op: int, algorithm):
    nelems, itemsize = _csched_args(x)
    return _csched.programs.cached(
        _csched.allreduce_program, algorithm, ctx.size, op,
        deterministic=_config.deterministic_reductions(), nelems=nelems,
        itemsize=itemsize)


def _allreduce_fwd_value(ctx: SpmdContext, x, op: int,
                         algorithm: Optional[str] = "ring"):
    """ONE dispatch for every allreduce schedule: build the algorithm's
    IR program (:mod:`mpi4torch_tpu_torch.csched`; the hand-written
    forms above are its emitter bodies) and lower it at the call site."""
    return _csched.lower_allreduce(
        _allreduce_program(ctx, x, op, algorithm), ctx, x, op)


def _allreduce_bwd_value(ctx: SpmdContext, g, algorithm):
    """The SUM-allreduce adjoint: the TRANSPOSED program of the forward
    (``bidir``'s halves swap directions, every other schedule re-runs as
    it is)."""
    prog = _allreduce_program(ctx, g, C.MPI_SUM, algorithm)
    return _csched.lower_allreduce(
        _csched.programs.cached(_csched.transpose, prog), ctx, g,
        C.MPI_SUM)


def _bwd_scope(opname: str):
    """Profiler span of a collective adjoint (``mpi4torch.<Op>Backward``),
    the reference's autograd node names."""
    return torch.profiler.record_function(f"mpi4torch.{opname}Backward")


def _sum_only(op: int, what: str) -> None:
    if op != C.MPI_SUM:
        raise RuntimeError(
            f"Backward pass for {what} with {C.op_name(op)} is not "
            "implemented — only MPI_SUM is differentiable (reference: "
            "MPIUnimplementedNode, csrc/extension.cpp:194-202)"
        )


def _auto_allreduce_algorithm(ctx: SpmdContext, x) -> str:
    """Auto selection (``tune.select_auto``), three tiers: the measured
    cache winner for this (dtype, size bucket, rank count, platform) key,
    a latency algorithm at or below the measured latency crossover, the
    multipath tier at or above the bandwidth crossover, else ``ring``; a
    pure function of the call, the knobs and the tune cache."""
    from .. import tune as _tune

    return _tune.select_auto(
        collective="allreduce", nbytes=x.numel() * x.element_size(),
        dtype=x.dtype, nranks=ctx.size,
        deterministic=_config.deterministic_reductions())


def _check_payload(ctx: SpmdContext, x, what: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what} takes a torch.Tensor, got {type(x)}")
    dev = ctx.world.device
    if dev is not None and x.device != dev:
        raise CommError(f"{what} payload is on {x.device} but this SPMD "
                        f"region runs on {dev}")


class _Allreduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, op, algorithm):
        fctx.sctx, fctx.op, fctx.algorithm = ctx, op, algorithm
        return _allreduce_fwd_value(ctx, x, op, algorithm)

    @staticmethod
    def backward(fctx, g):
        _sum_only(fctx.op, "Allreduce")
        with _bwd_scope("Allreduce"):
            return (_allreduce_bwd_value(fctx.sctx, g.contiguous(),
                                         fctx.algorithm), None, None, None)


def allreduce(ctx: SpmdContext, x, op: int, algorithm=None,
              algorithm_explicit: bool = False):
    """SPMD Allreduce.  ``algorithm`` picks the schedule (``ring``: the
    native psum for SUM, the ordered fold under deterministic mode;
    ``rhd``, ``tree``, ``hier``, ``bidir``, ``torus``); ``None`` is the
    selector's choice.  The backward is the transposed schedule on the
    cotangents; other ops' backward raises.  ``algorithm_explicit``
    carries the facade's degrade/raise rule into the hier group check:
    explicit requests raise, scope defaults degrade to ``ring``."""
    _check_payload(ctx, x, "Allreduce")
    from ..resilience import guards as _guards
    x = _guards.spmd_finite_value(x, "Allreduce")
    from ..obs.trace import spmd_collective_event
    x = spmd_collective_event(x, "Allreduce")
    if algorithm is None:
        algorithm = _auto_allreduce_algorithm(ctx, x)
    if algorithm in ("hier", "torus") and ctx.size > 1:
        try:
            _hier_group_for(ctx)
        except CommError:
            if algorithm_explicit:
                raise
            algorithm = "ring"
    return _Allreduce.apply(x, ctx, op, algorithm)


# ---------------------------------------------------------------------------
# Bcast_ / Reduce_
# ---------------------------------------------------------------------------


def _bcast_value(ctx: SpmdContext, x, root: int, algorithm=None):
    """Bcast_ through the IR: ``tree`` is the binomial program (whose
    transpose is the tree Reduce_ program), ``ring`` the mask + psum
    pair, ``None`` the size dispatch (``config.bcast_tree_max_bytes``)."""
    if ctx.size == 1:
        return x
    nelems, itemsize = _csched_args(x)
    prog = _csched.programs.cached(_csched.bcast_program, algorithm,
                                   ctx.size, root, nbytes=nelems * itemsize)
    return _csched.lower_value(prog, ctx, x, C.MPI_SUM)


def _reduce_value(ctx: SpmdContext, x, op: int, root: int, algorithm=None):
    """Reduce_ through the IR: ``tree`` is the binomial reduce program;
    everything else the ring allreduce program with a root mask appended
    (non-root results zeroed)."""
    nelems, itemsize = _csched_args(x)
    prog = _csched.programs.cached(
        _csched.reduce_program, algorithm, ctx.size, op, root,
        deterministic=_config.deterministic_reductions(), nelems=nelems,
        itemsize=itemsize)
    return _csched.lower_value(prog, ctx, x, op)


def _check_root(ctx: SpmdContext, root: int) -> None:
    if not (0 <= root < ctx.size):
        raise CommError(f"invalid root rank {root} (axis size {ctx.size})")


class _Bcast(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, root, algorithm):
        fctx.sctx, fctx.root, fctx.algorithm = ctx, root, algorithm
        return _bcast_value(ctx, x, root, algorithm)

    @staticmethod
    def backward(fctx, g):
        with _bwd_scope("Bcast"):
            return (_reduce_value(fctx.sctx, g.contiguous(), C.MPI_SUM,
                                  fctx.root, fctx.algorithm),
                    None, None, None)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, op, root, algorithm):
        fctx.sctx, fctx.op, fctx.root, fctx.algorithm = \
            ctx, op, root, algorithm
        return _reduce_value(ctx, x, op, root, algorithm)

    @staticmethod
    def backward(fctx, g):
        _sum_only(fctx.op, "Reduce_")
        with _bwd_scope("Reduce"):
            return (_bcast_value(fctx.sctx, g.contiguous(), fctx.root,
                                 fctx.algorithm), None, None, None, None)


def bcast_(ctx: SpmdContext, x, root: int, algorithm=None):
    """SPMD broadcast; adjoint is Reduce_(SUM, root) on the matching
    algorithm."""
    _check_root(ctx, root)
    _check_payload(ctx, x, "Bcast_")
    return _Bcast.apply(x, ctx, root, algorithm)


def reduce_(ctx: SpmdContext, x, op: int, root: int, algorithm=None):
    """SPMD reduce-to-root with zeroed non-root results; adjoint is
    Bcast_(root) on the matching algorithm; only SUM differentiable."""
    _check_root(ctx, root)
    _check_payload(ctx, x, "Reduce_")
    return _Reduce.apply(x, ctx, op, root, algorithm)


# ---------------------------------------------------------------------------
# Allgather / Reduce_scatter / Gather / Scatter / Alltoall
# ---------------------------------------------------------------------------


class _Allgather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, ax):
        fctx.sctx, fctx.ax = ctx, ax
        return _all_gather_tiled(ctx, x, ax)

    @staticmethod
    def backward(fctx, g):
        with _bwd_scope("Allgather"):
            return (_psum_scatter(fctx.sctx, g.contiguous(), C.MPI_SUM,
                                  fctx.ax), None, None)


def allgather(ctx: SpmdContext, x, gatheraxis: int):
    """SPMD allgather along any axis; the adjoint is the native
    reduce-scatter of the cotangents."""
    _check_payload(ctx, x, "Allgather")
    return _Allgather.apply(x, ctx, _norm_axis(gatheraxis, x.dim()))


def _reduce_scatter_value(ctx: SpmdContext, v, op: int, ax: int,
                          shard: int):
    if op == C.MPI_SUM and not _config.deterministic_reductions():
        return _psum_scatter(ctx, v, op, ax)
    start = ctx.index * shard
    if op in (C.MPI_MAX, C.MPI_MIN):
        # One native collective covers the full tensor; slice after.
        total = _allreduce_fwd_value(ctx, v, op)
        return total.narrow(ax, start, shard).clone()
    if op in (C.MPI_MINLOC, C.MPI_MAXLOC):
        C.combine2(op, v, v)  # raises NotImplementedError
    # Ordered fold (SUM under deterministic mode, and ops with no native
    # collective).  Small payloads: all-gather, then slice each rank's
    # contribution to MY segment before folding (the elementwise fold
    # commutes with slicing).  Large ones: the relay-routed chunked ring
    # fold delivers each rank its segment of the same bits.
    if v.numel() * v.element_size() * ctx.size \
            <= _config.ordered_fold_gather_max_bytes():
        stacked = _all_gather(ctx, v)
        pieces = stacked.narrow(1 + ax, start, shard)
        return _fold(op, [pieces[i] for i in range(ctx.size)])
    return _ring_fold_reduce_scatter(ctx, v, op, ax, shard)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, op, ax, shard):
        fctx.sctx, fctx.op, fctx.ax = ctx, op, ax
        return _reduce_scatter_value(ctx, x, op, ax, shard)

    @staticmethod
    def backward(fctx, g):
        _sum_only(fctx.op, "Reduce_scatter")
        with _bwd_scope("Reduce_scatter"):
            return (_all_gather_tiled(fctx.sctx, g.contiguous(), fctx.ax),
                    None, None, None, None)


def reduce_scatter(ctx: SpmdContext, x, op: int, scatteraxis: int):
    """SPMD block reduce-scatter.  SUM is ONE native reduce-scatter;
    non-SUM ops and deterministic mode reduce through the ordered forms
    and slice.  Adjoint (SUM only): the all-gather of the shard
    cotangents."""
    _check_payload(ctx, x, "Reduce_scatter")
    ax = _norm_axis(scatteraxis, x.dim())
    if x.shape[ax] % ctx.size != 0:
        raise CommError(
            f"Reduce_scatter axis {scatteraxis} length {x.shape[ax]} must "
            f"be divisible by the communicator size {ctx.size}")
    return _ReduceScatter.apply(x, ctx, op, ax, x.shape[ax] // ctx.size)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, ax, root):
        fctx.sctx, fctx.ax, fctx.root = ctx, ax, root
        return _mask_to_root(ctx, _all_gather_tiled(ctx, x, ax), root)

    @staticmethod
    def backward(fctx, g):
        # Only the root's upstream gradient is real (non-root forward
        # outputs are zeros); one root-masked reduce-scatter delivers
        # each rank its segment of it.
        with _bwd_scope("Gather"):
            ctx = fctx.sctx
            return (_psum_scatter(ctx, _mask_to_root(ctx, g.contiguous(),
                                                     fctx.root),
                                  C.MPI_SUM, fctx.ax), None, None, None)


def gather(ctx: SpmdContext, x, gatheraxis: int, root: int):
    """SPMD gather-to-root: an all-gather with non-root results zeroed.
    Adjoint: the root's gradient scattered back (a root-masked
    reduce-scatter)."""
    _check_root(ctx, root)
    _check_payload(ctx, x, "Gather")
    return _Gather.apply(x, ctx, _norm_axis(gatheraxis, x.dim()), root)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, ax, root):
        fctx.sctx, fctx.ax, fctx.root = ctx, ax, root
        # Root-masked reduce-scatter: one collective delivers each rank
        # exactly its segment of the root's tensor.
        return _psum_scatter(ctx, _mask_to_root(ctx, x, root), C.MPI_SUM,
                             ax)

    @staticmethod
    def backward(fctx, g):
        with _bwd_scope("Scatter"):
            ctx = fctx.sctx
            full = _all_gather_tiled(ctx, g.contiguous(), fctx.ax)
            # The gradient is real only on the root (non-root inputs were
            # ignored); the collective stays in every rank's program.
            return _mask_to_root(ctx, full, fctx.root), None, None, None


def scatter(ctx: SpmdContext, x, scatteraxis: int, numelem: int, root: int):
    """SPMD scatter-from-root: all ranks pass same-shaped inputs and
    segments are equal; ``numelem`` must equal ``axis_len // size``.  The
    root's data wins.  Adjoint: Gather(grad, scatteraxis, root)."""
    _check_root(ctx, root)
    _check_payload(ctx, x, "Scatter")
    ax = _norm_axis(scatteraxis, x.dim())
    axlen = x.shape[ax]
    if axlen % ctx.size != 0 or numelem != axlen // ctx.size:
        raise ValueError(
            f"Scatter under SPMD requires numelem ({numelem}) == axis length "
            f"({axlen}) // mesh size ({ctx.size}); per-rank-varying segments "
            "need the eager runtime (SURVEY.md §7 hard part 2)"
        )
    return _Scatter.apply(x, ctx, ax, root)


class _Alltoall(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, ga, sa):
        fctx.sctx, fctx.ga, fctx.sa = ctx, ga, sa
        return _all_to_all(ctx, x, sa, ga)

    @staticmethod
    def backward(fctx, g):
        with _bwd_scope("Alltoall"):
            return (_all_to_all(fctx.sctx, g.contiguous(), fctx.ga,
                                fctx.sa), None, None, None)


def alltoall(ctx: SpmdContext, x, gatheraxis: int, scatteraxis: int,
             numelem: int):
    """SPMD all-to-all: split the local block along ``scatteraxis``,
    exchange, concatenate along ``gatheraxis``.  Adjoint: the
    axes-swapped all-to-all."""
    _check_payload(ctx, x, "Alltoall")
    ga = _norm_axis(gatheraxis, x.dim())
    sa = _norm_axis(scatteraxis, x.dim())
    axlen = x.shape[sa]
    if axlen % ctx.size != 0 or numelem != axlen // ctx.size:
        raise ValueError(
            f"Alltoall under SPMD requires numelem ({numelem}) == scatter "
            f"axis length ({axlen}) // mesh size ({ctx.size}); "
            "per-rank-varying segments need the eager runtime"
        )
    return _Alltoall.apply(x, ctx, ga, sa)


# ---------------------------------------------------------------------------
# Point-to-point: Isend / Irecv / Wait through matched permutes
# ---------------------------------------------------------------------------


class _PPermute(torch.autograd.Function):
    """A matched Isend/Irecv pair: one permute along the send table;
    the adjoint is the permute along the inverse table (the
    reverse-direction gradient ring)."""

    @staticmethod
    def forward(fctx, x, ctx, perm):
        fctx.sctx, fctx.perm = ctx, perm
        return _ppermute(ctx, x, [(i, perm[i]) for i in range(ctx.size)])

    @staticmethod
    def backward(fctx, g):
        inv = _invert_perm(fctx.perm)
        return (_ppermute(fctx.sctx, g.contiguous(),
                          [(i, inv[i]) for i in range(fctx.sctx.size)]),
                None, None)


def _emit_permute(ctx: SpmdContext, value, perm: Tuple[int, ...]):
    if perm == _identity_perm(ctx.size):
        # Self-send on every rank (MPI permits Isend(dest=rank)): a local
        # buffer hand-off, no collective; the value IS the message.
        return value
    return _PPermute.apply(value, ctx, perm)


def _try_match(ctx: SpmdContext) -> None:
    """Pair pending sends with pending recvs of the same tag and the same
    canonical send permutation; each pair becomes one permute whose
    output is stored on the recv handle."""
    sends = [p for p in ctx.pending if p.kind == "send"]
    recvs = [p for p in ctx.pending if p.kind == "recv"]
    for s in sends:
        for r in recvs:
            if s.tag == r.tag and s.perm == r.perm:
                if (tuple(s.value.shape) != tuple(r.value.shape)
                        or s.value.dtype != r.value.dtype):
                    raise CommError(
                        f"matched Isend/Irecv on tag {s.tag} disagree on "
                        f"shape/dtype: send {tuple(s.value.shape)}/"
                        f"{s.value.dtype} vs recv buffer "
                        f"{tuple(r.value.shape)}/{r.value.dtype}"
                    )
                y = _emit_permute(ctx, s.value, s.perm)
                r.handle_state.result = y
                r.handle_state.matched = True
                s.handle_state.matched = True
                ctx.pending.remove(s)
                ctx.pending.remove(r)
                return _try_match(ctx)


def _fresh(x):
    """A new tensor object for ``x`` (a differentiable identity view): the
    handle identity key, the counterpart of the reference's
    buffer-pointer hash."""
    return x.view_as(x)


_SPMD_DESC_LEN = 8


def _descriptor(buf):
    """The handle's descriptor slot: zeros tied to the buffer, where
    JoinDummiesHandle chains land."""
    return _join_dummies(torch.zeros(_SPMD_DESC_LEN, dtype=torch.float32,
                                     device=buf.device), [buf])


def _lookup(table: Dict[int, Any], buf):
    """The state registered for this very buffer object, or None (ids of
    dead buffers may be reused, so the weak reference must still point
    at ``buf``)."""
    state = table.get(id(buf))
    if state is None or state.buf() is not buf:
        return None
    return state


def isend(ctx: SpmdContext, x, dest, tag: int) -> List:
    """SPMD nonblocking send.  ``dest`` must be a static permutation of
    ``comm.rank`` (a ring shift, a butterfly, an explicit per-rank table,
    or ``comm.rank`` itself).  The transfer becomes one permute when the
    matching Irecv appears.  Returns the raw 3-tensor handle
    [descriptor, buffer, loopthrough]."""
    _check_payload(ctx, x, "Isend")
    perm = _peer_table(ctx, dest, "destination")
    buf = _fresh(x)
    state = _HandleState(kind="send", perm=perm, tag=tag, loop=buf,
                         buf=weakref.ref(buf))
    ctx.handles[id(buf)] = state
    ctx.pending.append(_PendingP2P("send", perm, tag, x, state))
    _try_match(ctx)
    return [_descriptor(buf), buf, buf]


def irecv(ctx: SpmdContext, x, source, tag: int) -> List:
    """SPMD nonblocking receive.  ``source`` must be a static permutation
    of ``comm.rank``; a source table matches sends whose destination
    table is its inverse."""
    _check_payload(ctx, x, "Irecv")
    send_perm = _invert_perm(_peer_table(ctx, source, "source"))
    buf = _fresh(x)
    state = _HandleState(kind="recv", perm=send_perm, tag=tag,
                         buf=weakref.ref(buf))
    ctx.handles[id(buf)] = state
    ctx.pending.append(_PendingP2P("recv", send_perm, tag, buf, state))
    _try_match(ctx)
    return [_descriptor(buf), buf, buf]


def wait(ctx: SpmdContext, handle: List):
    """SPMD Wait.  A receive returns the matched permute's output (the
    gradient flows back through the permute's adjoint); a send returns
    its loop-through.  Unknown/spliced handles and double waits raise
    :class:`BifurcationError`; a receive waited on before its send
    exists raises :class:`DeadlockError` (under MPI every rank would
    block in it)."""
    desc, buf, loop = handle
    state = _lookup(ctx.handles, buf)
    if state is None:
        raise BifurcationError(
            "Detected bifurcation in Wait handle usage: this handle's buffer "
            "does not belong to any posted request in the active SPMD region "
            "(handles must not be rebuilt from parts of other handles; "
            "reference guard csrc/extension.cpp:1231-1237)"
        )
    if state.waited:
        raise BifurcationError(
            "Detected bifurcation in Wait handle usage: this request was "
            "already waited on (a WaitHandle completes exactly once)"
        )
    state.waited = True
    if state.kind == "send":
        # A send may be waited on before its matching Irecv appears later
        # in the program (blocking Send = Isend+Wait): completion of a
        # buffered send is local; a send that never matches is caught at
        # region exit.
        return _join_dummies(loop, [desc])
    if not state.matched:
        raise DeadlockError(
            f"trace-time deadlock: Wait on a receive (tag {state.tag}, "
            f"{_perm_desc(state.perm)}) before the matching Isend appears in "
            "the program.  Under single-trace SPMD every rank runs the same "
            "program, so a blocking Recv with no prior matching send means "
            "ALL ranks block in Recv — a real deadlock under MPI too.  Post "
            "the Isend first (Isend -> Recv -> Wait, as in the reference "
            "examples), or use Irecv and delay the Wait past the send."
        )
    return _join_dummies(state.result, [desc])


# ---------------------------------------------------------------------------
# Split-phase collectives (overlap): Allreduce_start / Reduce_scatter_start
# / Allgather_start + the collective Wait.  The start runs the
# collective's first (or only) phase; the Wait completes it.  Both phases
# are this module's differentiable collectives tied by JoinDummies, so
# the backward is split-phase too with the wait chain reversed.
# ---------------------------------------------------------------------------


def _register_coll(ctx: SpmdContext, opname: str, value, complete=None
                   ) -> List:
    """Post a split-phase collective: the raw 3-tensor handle
    ``[descriptor, buffer, loopthrough]`` around the phase-1 value, its
    completion state keyed by the buffer (the p2p handles' scheme)."""
    buf = _fresh(value)
    state = _CollState(opname=opname, complete=complete,
                       buf=weakref.ref(buf))
    ctx.coll_handles[id(buf)] = state
    ctx.coll_pending.append(state)
    return [_descriptor(buf), buf, buf]


def allreduce_start(ctx: SpmdContext, x, op: int, algorithm=None,
                    algorithm_explicit: bool = False) -> List:
    """Split-phase SPMD Allreduce, phase 1.  Ring-SUM outside
    deterministic mode runs the reduce-scatter half here and leaves the
    all-gather half to the Wait (the fused bucket path's pair, so both
    give the same bits); every other form computes the blocking value in
    phase 1 and the Wait is its completion point."""
    if algorithm is None:
        algorithm = _auto_allreduce_algorithm(ctx, x)
    n = ctx.size
    use_pair = (op == C.MPI_SUM and n > 1
                and not _config.deterministic_reductions()
                and algorithm in (None, "ring"))
    if not use_pair:
        val = allreduce(ctx, x, op, algorithm,
                        algorithm_explicit=algorithm_explicit)
        return _register_coll(ctx, "Allreduce", val)
    shape, total = x.shape, x.numel()
    part = reduce_scatter(ctx, _pad_flat(x, n).reshape(n, -1), op, 0)

    def complete(val):
        full = allgather(ctx, val, 0)
        return full.reshape(-1)[:total].reshape(shape)

    return _register_coll(ctx, "Allreduce", part, complete)


def reduce_scatter_start(ctx: SpmdContext, x, op: int,
                         scatteraxis: int) -> List:
    """Split-phase SPMD Reduce_scatter: the collective runs here; the Wait
    pins where its result is consumed.  Same bits as the blocking op."""
    return _register_coll(ctx, "Reduce_scatter",
                          reduce_scatter(ctx, x, op, scatteraxis))


def allgather_start(ctx: SpmdContext, x, gatheraxis: int) -> List:
    """Split-phase SPMD Allgather (the ZeRO-3 prefetch form).  Same bits
    as the blocking op."""
    return _register_coll(ctx, "Allgather", allgather(ctx, x, gatheraxis))


_NOT_COLL = object()


def collective_wait(ctx: SpmdContext, handle: List):
    """Complete a split-phase collective handle; ``_NOT_COLL`` when the
    handle is not in the collective table (the caller falls through to
    the p2p Wait).  A double Wait raises :class:`BifurcationError`."""
    desc, buf, loop = handle
    state = _lookup(ctx.coll_handles, buf)
    if state is None:
        return _NOT_COLL
    if state.waited:
        raise BifurcationError(
            "Detected bifurcation in Wait handle usage: this split-phase "
            f"{state.opname} was already waited on (a WaitHandle "
            "completes exactly once)")
    state.waited = True
    ctx.coll_pending.remove(state)
    # Tie the phase-1 value to the descriptor chain so JoinDummiesHandle
    # dependencies reach the result.
    val = _join_dummies(buf, [desc])
    if state.complete is not None:
        val = state.complete(val)
    return val


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


class SpmdBackend:
    """Binds the facade op table to an active SPMD context."""

    def __init__(self, ctx: SpmdContext):
        self._ctx = ctx

    @property
    def rank(self) -> RankExpr:
        return RankExpr(self._ctx.axis_name, self._ctx.size)

    @property
    def size(self) -> int:
        return self._ctx.size

    @property
    def device(self):
        return self._ctx.world.device

    def allreduce(self, x, op, algorithm=None, algorithm_explicit=False):
        return allreduce(self._ctx, x, op, algorithm,
                         algorithm_explicit=algorithm_explicit)

    def allreduce_compressed(self, x, op, codec, algorithm=None,
                             algorithm_explicit=False):
        from ..compress import spmd as _cspmd
        return _cspmd.allreduce(self._ctx, x, op, codec,
                                algorithm=algorithm,
                                algorithm_explicit=algorithm_explicit)

    def allgather_compressed(self, x, gatheraxis, codec):
        from ..compress import spmd as _cspmd
        return _cspmd.allgather(self._ctx, x, gatheraxis, codec)

    def bcast_(self, x, root, algorithm=None):
        return bcast_(self._ctx, x, root, algorithm)

    def reduce_(self, x, op, root, algorithm=None):
        return reduce_(self._ctx, x, op, root, algorithm)

    def gather(self, x, gatheraxis, root):
        return gather(self._ctx, x, gatheraxis, root)

    def allgather(self, x, gatheraxis):
        return allgather(self._ctx, x, gatheraxis)

    def reduce_scatter(self, x, op, scatteraxis):
        return reduce_scatter(self._ctx, x, op, scatteraxis)

    def scatter(self, x, scatteraxis, numelem, root):
        return scatter(self._ctx, x, scatteraxis, numelem, root)

    def alltoall(self, x, gatheraxis, scatteraxis, numelem):
        return alltoall(self._ctx, x, gatheraxis, scatteraxis, numelem)

    def isend(self, x, dest, tag):
        return isend(self._ctx, x, dest, tag)

    def irecv(self, x, source, tag):
        return irecv(self._ctx, x, source, tag)

    def wait(self, handle):
        # Split-phase collective handles share the Wait surface with the
        # p2p trio (one completion verb, like MPI_Wait).
        out = collective_wait(self._ctx, handle)
        if out is not _NOT_COLL:
            return out
        return wait(self._ctx, handle)

    def allreduce_start(self, x, op, algorithm=None,
                        algorithm_explicit=False):
        return allreduce_start(self._ctx, x, op, algorithm,
                               algorithm_explicit=algorithm_explicit)

    def reduce_scatter_start(self, x, op, scatteraxis):
        return reduce_scatter_start(self._ctx, x, op, scatteraxis)

    def allgather_start(self, x, gatheraxis):
        return allgather_start(self._ctx, x, gatheraxis)


def _region_exit_check(ctx: SpmdContext) -> None:
    """The region-exit guards: unmatched p2p operations and un-waited
    split-phase handles raise :class:`DeadlockError`."""
    if ctx.pending:
        leftover = ", ".join(
            f"{p.kind}(tag={p.tag}, {_perm_desc(p.perm)})"
            for p in ctx.pending
        )
        raise DeadlockError(
            f"trace-time deadlock: unmatched point-to-point operations "
            f"at the end of the SPMD region: {leftover} — every Isend "
            "needs a complementary Irecv with the same tag (under MPI "
            "this program would hang)"
        )
    if ctx.coll_pending:
        leftover = ", ".join(f"{s.opname}_start" for s in ctx.coll_pending)
        raise DeadlockError(
            f"un-waited split-phase collective handle(s) at the end "
            f"of the SPMD region: {leftover} — every *_start needs a "
            "matching Wait (the result exists only at the Wait; "
            "dropping the handle silently discards the collective)"
        )


class _bind_spmd:
    """Bind ``ctx`` as its axis's context on this rank thread for the
    block; at a clean exit the region-exit guards run on it."""

    def __init__(self, ctx: SpmdContext):
        self.ctx = ctx

    def __enter__(self):
        region = _current_region()
        if region is None:
            raise CommError("an SPMD context binds inside a run_spmd "
                            "region only")
        self.region = region
        self.prev = region.contexts.get(self.ctx.axis_name)
        region.contexts[self.ctx.axis_name] = self.ctx
        return self.ctx

    def __exit__(self, exc_type, *rest):
        if self.prev is None:
            del self.region.contexts[self.ctx.axis_name]
        else:
            self.region.contexts[self.ctx.axis_name] = self.prev
        if exc_type is None:
            _region_exit_check(self.ctx)
        return False


class TierStackBackend:
    """N-level communicator over N mesh axes, outermost (slowest
    interconnect) first (``comm_from_mesh(mesh, ("pod", "host", "chip"))``):
    ranks are row-major over the axes, the LAST axis the fastest tier.

    Allreduce-only by design: the staged per-tier schedule — innermost
    reduce-scatter, recursing outward, innermost all-gather (or the
    deterministic grouped-fold chain).  Every other op needs a
    single-axis communicator and raises a :class:`CommError` saying so.
    The tier sizes come from the mesh axes, not from
    ``config.tier_stack``."""

    supports_compression = False
    owns_algorithm_resolution = True

    _UNSUPPORTED_OPS = frozenset({
        "bcast_", "reduce_", "gather", "allgather", "reduce_scatter",
        "scatter", "alltoall", "isend", "irecv", "wait",
        "allreduce_compressed", "allgather_compressed",
    })

    def __init__(self, axis_names: Tuple[str, ...],
                 axis_sizes: Tuple[int, ...]):
        names = tuple(axis_names)
        sizes = tuple(int(s) for s in axis_sizes)
        if len(names) < 2 or len(names) != len(sizes):
            raise CommError(
                "a tier-stack communicator takes >= 2 mesh axis names "
                f"(outermost first) with their sizes; got {names!r} / "
                f"{sizes!r}")
        self.axis_names = names
        self.axis_sizes = sizes

    def _ctx(self, axes) -> SpmdContext:
        region = _current_region()
        if region is None:
            raise CommError(
                "a mesh communicator's collectives run inside "
                "run_spmd(fn, mesh=...) only")
        return region.ctx(axes)

    @property
    def rank(self):
        return self._ctx(self.axis_names).index_tensor()

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def device(self):
        return self._ctx(self.axis_names).world.device

    def allreduce(self, x, op, algorithm=None, algorithm_explicit=False):
        if len(self.axis_names) == 2:
            return hier_allreduce_2d(self, x, op, algorithm,
                                     explicit=algorithm_explicit)
        return tier_allreduce_nd(self, x, op, algorithm,
                                 explicit=algorithm_explicit)

    def __getattr__(self, name):
        if name in TierStackBackend._UNSUPPORTED_OPS:
            raise CommError(
                "tier-stack mesh communicators support Allreduce only "
                f"(the staged per-tier wire schedule); {name!r} needs "
                "a single-axis communicator — use "
                "comm_from_mesh(mesh, axis_name) with one axis")
        raise AttributeError(name)


class HierMeshBackend(TierStackBackend):
    """Two-tier communicator over TWO mesh axes ``(outer, inner)``
    (``comm_from_mesh(mesh, ("dp", "tp"))``): the 2-level member of
    :class:`TierStackBackend`."""

    def __init__(self, axis_names: Tuple[str, str],
                 axis_sizes: Tuple[int, int]):
        if len(tuple(axis_names)) != 2:
            raise CommError(
                "HierMeshBackend is the 2-axis tier stack; use "
                f"TierStackBackend for {len(tuple(axis_names))} axes")
        super().__init__(axis_names, axis_sizes)


def _torus2d_fwd_value(hb: HierMeshBackend, x, op: int):
    """``torus`` on a 2-axis mesh communicator: half 0's grouped channel
    leads with the inner axis, half 1's with the outer axis; the
    deterministic form folds each half in its channel's 2-level
    association (:func:`constants.reduce_torus` with ``inner`` = the inner
    axis extent)."""
    outer, inner = (hb._ctx(a) for a in hb.axis_names)
    so, si = hb.axis_sizes
    if so * si == 1:
        return x
    if op in (C.MPI_MINLOC, C.MPI_MAXLOC):
        C.combine2(op, x, x)  # raises with explanation
    shape = x.shape
    flat = x.reshape(-1)
    total = flat.numel()
    m = C.multipath_split(total)
    h0, h1 = flat[:m], flat[m:]
    if op == C.MPI_SUM and not _config.deterministic_reductions():
        o0 = _grouped_sum_schedule(h0, si, (inner, None), (outer, None),
                                   (inner, None))
        o1 = (_grouped_sum_schedule(h1, so, (outer, None), (inner, None),
                                    (outer, None))
              if m < total else None)
    else:
        o0 = _grouped_ordered_fold(h0, op, si, so, (inner, None),
                                   (outer, None))
        o1 = (_grouped_ordered_fold(h1, op, so, si, (outer, None),
                                    (inner, None))
              if m < total else None)
    if o1 is None:
        return o0.reshape(shape)
    return torch.cat([o0, o1]).reshape(shape)


def _hier2d_fwd_value(hb: HierMeshBackend, x, op: int, algorithm: str):
    so, si = hb.axis_sizes
    if so * si == 1:
        return x
    if algorithm == "torus":
        return _torus2d_fwd_value(hb, x, op)
    outer, inner = (hb._ctx(a) for a in hb.axis_names)
    det = _config.deterministic_reductions()
    if not det and op == C.MPI_SUM:
        if algorithm == "ring":
            return _psum(hb._ctx(hb.axis_names), x, op)
        return _grouped_sum_schedule(x, si, (inner, None), (outer, None),
                                     (inner, None))
    if not det and op in (C.MPI_MAX, C.MPI_MIN):
        return _psum(hb._ctx(hb.axis_names), x, op)
    if op in (C.MPI_MINLOC, C.MPI_MAXLOC):
        C.combine2(op, x, x)  # raises with explanation
    # Deterministic / non-native ops: the grouped ordered fold, inner
    # tier first — constants.reduce_grouped with group = the inner axis.
    return _grouped_ordered_fold(x, op, si, so, (inner, None),
                                 (outer, None))


class _TierAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, value_fn, op):
        fctx.value_fn, fctx.op = value_fn, op
        return value_fn(x, op)

    @staticmethod
    def backward(fctx, g):
        _sum_only(fctx.op, "Allreduce")
        with _bwd_scope("Allreduce"):
            return fctx.value_fn(g.contiguous(), C.MPI_SUM), None, None


def hier_allreduce_2d(hb: HierMeshBackend, x, op: int, algorithm=None,
                      explicit: bool = False):
    """Differentiable 2-level allreduce over a 2-axis mesh communicator;
    the adjoint is the same 2-level collective on the cotangents.  An
    explicit ``rhd``/``tree``/``bidir`` raises (they need a single ring
    axis), a scope default yields to ``hier``; auto picks ``torus`` at or
    above the measured bandwidth crossover (outside deterministic
    mode)."""
    if algorithm in (None, "auto"):
        algorithm = "hier"
        bw = _config.bandwidth_crossover_bytes()
        if bw is not None and not _config.deterministic_reductions():
            if x.numel() * x.element_size() >= bw:
                algorithm = "torus"
    if algorithm not in ("hier", "ring", "torus"):
        if not explicit:
            algorithm = "hier"
        else:
            raise CommError(
                f"a 2-axis mesh communicator lowers algorithm 'hier' "
                f"(the staged 2-level schedule), 'torus' (per-axis "
                f"multipath striping), or 'ring' (flat psum over both "
                f"axes); got {algorithm!r} — rhd/tree/bidir need a "
                "single-axis communicator")
    return _TierAllreduce.apply(
        x, lambda v, o: _hier2d_fwd_value(hb, v, o, algorithm), op)


def _tier_sum_schedule(tb: TierStackBackend, x, names, sizes):
    """The N-level native SUM allreduce: grouped reduce-scatter over the
    innermost axis, the remaining axes' allreduce on the shard, grouped
    all-gather back."""
    if len(names) == 1:
        return _psum(tb._ctx(names[0]), x, C.MPI_SUM)
    inner = tb._ctx(names[-1])
    shape, total = x.shape, x.numel()
    xc = _pad_flat(x, sizes[-1]).reshape(sizes[-1], -1)
    part = _psum_scatter(inner, xc, C.MPI_SUM, 0)
    part = _tier_sum_schedule(tb, part, names[:-1], sizes[:-1])
    out = _all_gather_tiled(inner, part, 0)
    return out.reshape(-1)[:total].reshape(shape)


def _tier_ordered_fold(tb: TierStackBackend, x, op: int, names, sizes):
    """Deterministic N-level grouped fold: one all-gather + ascending fold
    per tier, innermost first."""
    for nm, s in zip(reversed(names), reversed(sizes)):
        stacked = _all_gather(tb._ctx(nm), x)
        out = stacked[0]
        for i in range(1, s):
            out = C.combine2(op, out, stacked[i])
        x = out
    return x


def _tier_fwd_value(tb: TierStackBackend, x, op: int, algorithm: str):
    names, sizes = tb.axis_names, tb.axis_sizes
    if tb.size == 1:
        return x
    det = _config.deterministic_reductions()
    if not det and op == C.MPI_SUM:
        if algorithm == "ring":
            return _psum(tb._ctx(names), x, op)
        return _tier_sum_schedule(tb, x, names, sizes)
    if not det and op in (C.MPI_MAX, C.MPI_MIN):
        return _psum(tb._ctx(names), x, op)
    if op in (C.MPI_MINLOC, C.MPI_MAXLOC):
        C.combine2(op, x, x)  # raises with explanation
    return _tier_ordered_fold(tb, x, op, names, sizes)


def tier_allreduce_nd(tb: TierStackBackend, x, op: int, algorithm=None,
                      explicit: bool = False):
    """Differentiable N-level allreduce over an N-axis tier stack (N > 2);
    explicit single-ring-axis algorithms and ``torus`` raise, scope
    defaults yield to ``hier``."""
    if algorithm in (None, "auto"):
        algorithm = "hier"
    if algorithm not in ("hier", "ring"):
        if not explicit:
            algorithm = "hier"
        else:
            raise CommError(
                f"an N-axis tier-stack communicator lowers algorithm "
                f"'hier' (the staged per-tier schedule) or 'ring' "
                f"(flat psum over all axes); got {algorithm!r} — "
                "'torus' stripes over exactly two axes, and "
                "rhd/tree/bidir need a single-axis communicator")
    return _TierAllreduce.apply(
        x, lambda v, o: _tier_fwd_value(tb, v, o, algorithm), op)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def comm_from_mesh(mesh, axis_name):
    """Adopt a mesh axis as a communicator inside ``run_spmd(fn,
    mesh=mesh)``: the analogue of the reference's foreign-communicator
    interop.  Its ``size`` is static; its ops and ``rank`` resolve on the
    calling rank thread's region.

    A TUPLE of axis names (outermost/slowest first) adopts them as a
    tier-stack communicator: two names build the two-tier
    :class:`HierMeshBackend` (``Allreduce`` runs the 2-level ``hier``
    schedule keyed off the mesh axis sizes), three or more the N-level
    :class:`TierStackBackend`."""
    from ..comm import MPI_Communicator

    if isinstance(axis_name, (tuple, list)):
        names = tuple(axis_name)
        if len(names) < 2:
            raise CommError(
                "a tier-stack communicator takes two or more axis "
                f"names (outermost first); got {names!r} — for one "
                "axis pass the bare name")
        for nm in names:
            if nm not in mesh.axis_names:
                raise CommError(
                    f"axis {nm!r} not in mesh axes {mesh.axis_names}")
        sizes = tuple(mesh.shape[nm] for nm in names)
        backend = (HierMeshBackend(names, sizes) if len(names) == 2
                   else TierStackBackend(names, sizes))
        comm = MPI_Communicator(lambda: backend)
        comm._hier_axes = (names, sizes)
        return comm

    if axis_name not in mesh.axis_names:
        raise CommError(
            f"axis {axis_name!r} not in mesh axes {mesh.axis_names}"
        )
    size = mesh.shape[axis_name]

    def resolver():
        region = _current_region()
        if region is None:
            raise CommError(
                f"the mesh communicator over axis {axis_name!r} runs "
                "inside run_spmd(fn, mesh=...) only")
        ctx = region.ctx(axis_name)
        # Two meshes can reuse an axis name with other extents; adopting
        # the other mesh's context would misroute ring arithmetic.
        if ctx.size != size:
            raise CommError(
                f"axis {axis_name!r} has {ctx.size} ranks in this run_spmd "
                f"region, not the {size} of the communicator's mesh")
        return SpmdBackend(ctx)

    comm = MPI_Communicator(resolver)
    comm._spmd_axis = (axis_name, size)
    return comm


@contextlib.contextmanager
def p2p_scope(comm):
    """Raising p2p-matching scope for a mesh communicator: unmatched
    point-to-point operations posted through ``comm`` inside the block
    raise :class:`DeadlockError` at its exit, not only at the end of the
    run_spmd region::

        def body(x):
            with mpi.p2p_scope(comm):
                h = comm.Isend(x, dst, tag=0)
                y = comm.Recv(torch.zeros_like(x), src, tag=0)
                comm.Wait(h)
            return y
        mpi.run_spmd(body, mesh=mesh, axis_name="w")(x)
    """
    axis = getattr(comm, "_spmd_axis", None)
    if axis is None:
        raise CommError(
            "p2p_scope requires a mesh-derived communicator "
            "(comm_from_mesh); COMM_WORLD inside run_spmd already has a "
            "raising scope")
    region = _current_region()
    if region is None:
        raise CommError("p2p_scope binds inside a run_spmd region only")
    proto = region.new_ctx(axis[0])
    with _bind_spmd(proto):
        yield comm


DEFAULT_AXIS = "mpi"


def _device_count(dev: torch.device) -> int:
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _mesh_device(mesh, device, lay=None):
    """The one device of a mesh's ranks (of this process's ranks, under
    ``init_distributed``): rank threads of one world share one device."""
    devs = mesh.devices.reshape(-1)
    if lay is not None:
        devs = devs[mesh.process_index.reshape(-1) == lay[0]]
    devs = {torch.device(d) for d in devs}
    if len(devs) != 1:
        raise CommError(
            f"run_spmd runs every rank of the mesh as a thread on one "
            f"device; this mesh holds {len(devs)} devices ({sorted(map(str, devs))})")
    dev = resolve_device(next(iter(devs)))
    if device is not None and resolve_device(device) != dev:
        raise CommError(f"device {device!r} differs from the mesh's device "
                        f"{dev}")
    return dev


def _dist_device(lay, device):
    """The device of this process's ranks under ``init_distributed``."""
    dev = lay[2]
    if device is not None and resolve_device(device) != dev:
        raise CommError(f"device {device!r} differs from the device {dev} "
                        "this process was initialized with")
    return dev


def _check_mesh_layout(mesh, lay) -> None:
    """A mesh under ``init_distributed`` covers every global rank, each
    process's positions its contiguous block in row-major order."""
    want = [q for q, c in enumerate(lay[1]) for _ in range(c)]
    got = [int(q) for q in mesh.process_index.reshape(-1)]
    if got != want:
        raise CommError(
            f"this mesh places its positions on processes {got}; under "
            f"init_distributed a run_spmd mesh covers the {len(want)} "
            f"global ranks in process order ({want}) — build it with "
            "device_mesh or hybrid_mesh")


class _SpmdRun:
    """One call of a :func:`run_spmd` function: the world, every rank's
    detached input leaves and outputs (kept for the backward), and the
    configuration captured from the caller."""

    def __init__(self, fn, names, shape, axis_name, device, scopes,
                 args_flat, args_def, tensor_slots, distributed=False):
        self.fn, self.names, self.shape = fn, names, shape
        self.axis_name, self.device, self.scopes = axis_name, device, scopes
        self.args_flat, self.args_def = args_flat, args_def
        self.tensor_slots = tensor_slots
        self.distributed = distributed
        self.world = None
        self.leaves = self.outs = None
        self.out_def = None

    @contextlib.contextmanager
    def _rank_scope(self, rank: int):
        det, comp, bb, ovl, algo = self.scopes
        region = _Region(self.world, rank, self.names, self.shape,
                         self.axis_name)
        prev = _current_region()
        _tls.region = region
        # A lowering in progress (analyze.lower) records this rank thread.
        rec = _config.program_recorder()
        recording = rec.rank_stream(self, rank) if rec is not None \
            else contextlib.nullcontext()
        try:
            # Backward passes run on this rank's own thread: autograd's
            # CUDA worker thread would queue the ranks' blocking adjoint
            # collectives behind each other (run_ranks' rule).
            with _config.deterministic_mode(det), \
                    _config.compression_scope(comp), \
                    _config.fusion_scope(bb), _config.overlap_scope(ovl), \
                    _config.algorithm_scope(algo), \
                    torch.autograd.set_multithreading_enabled(False), \
                    recording:
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                yield region
        finally:
            _tls.region = prev

    def _make_world(self, n: int) -> None:
        """The run's world: every rank on threads of this process, or,
        under ``init_distributed``, the distributed world of which this
        process runs its block of ranks."""
        if not self.distributed:
            self.world = World(n, device=self.device)
            return
        from .. import distributed as _dist
        from ..transport.dist import DistWorld
        self.world = DistWorld(n, _dist.local_ranks(),
                               _dist.process_of_ranks(), device=self.device)

    def forward(self, tensors, track: bool) -> List[torch.Tensor]:
        n = math.prod(self.shape)
        self._make_world(n)
        leaves: List[Any] = [None] * n
        outs: List[Any] = [None] * n
        defs: List[Any] = [None] * n

        def body(rank):
            mine = [t.detach().requires_grad_(track and t.requires_grad)
                    for t in tensors]
            flat = list(self.args_flat)
            for slot, t in zip(self.tensor_slots, mine):
                flat[slot] = t
            with self._rank_scope(rank) as region:
                out = self.fn(*tree_from_structure(self.args_def, flat))
                for ctx in list(region.contexts.values()):
                    _region_exit_check(ctx)
            leaves[rank] = mine
            outs[rank], defs[rank] = tree_flatten(out)

        ranks = self.world.local_ranks
        run_rank_threads(self.world, body)
        outs = [outs[r] for r in ranks]
        defs = [defs[r] for r in ranks]
        if any(d != defs[0] for d in defs):
            raise CommError(
                "run_spmd: the ranks returned differently structured "
                f"outputs ({defs[0]} on rank {ranks[0]})")
        self.out_def = defs[0]
        stacked = []
        for k in range(len(outs[0])):
            col = [o[k] for o in outs]
            if col[0] is None:
                if any(c is not None for c in col):
                    raise CommError("run_spmd: an output is None on some "
                                    "ranks only")
                stacked.append(None)
                continue
            col = [c if isinstance(c, torch.Tensor)
                   else torch.as_tensor(c, device=self.device) for c in col]
            stacked.append(torch.stack([c.detach() for c in col]))
        self.present = [s is not None for s in stacked]
        if track:
            self.leaves = leaves
            self.outs = [None] * n
            for r, o in zip(ranks, outs):
                self.outs[r] = [c if isinstance(c, torch.Tensor) else None
                                for c in o]
        return stacked

    def backward(self, gouts) -> List[Optional[torch.Tensor]]:
        n = self.world.size
        grads: List[Any] = [None] * n
        ranks = self.world.local_ranks

        def body(rank):
            # Row of this rank in the stacked outputs of this process.
            row = rank - ranks[0]
            pairs = [(o, g[row]) for o, g in zip(self.outs[rank], gouts)
                     if o is not None and o.requires_grad and g is not None]
            wanted = [i for i, t in enumerate(self.leaves[rank])
                      if t.requires_grad]
            if not pairs or not wanted:
                grads[rank] = [None] * len(self.leaves[rank])
                return
            with self._rank_scope(rank):
                got = torch.autograd.grad(
                    [o for o, _ in pairs], [self.leaves[rank][i]
                                            for i in wanted],
                    grad_outputs=[g for _, g in pairs], allow_unused=True)
            out = [None] * len(self.leaves[rank])
            for i, g in zip(wanted, got):
                out[i] = g
            grads[rank] = out

        run_rank_threads(self.world, body)
        if self.distributed:
            # Every process's per-rank cotangents, so that each sums all
            # of them in the one-process order (partial sums per process
            # would change the bits).
            from ..transport.dist import allgather_objects
            every = allgather_objects([grads[r] for r in ranks],
                                      self.device)
            grads = [g for block in every for g in block]
        result = []
        for i in range(len(self.tensor_slots)):
            total = None
            # The replicated input's cotangent: the per-rank cotangents
            # summed in ascending rank order.
            for r in range(n):
                g = grads[r][i]
                if g is not None:
                    total = g if total is None else total + g
            result.append(total)
        return result


class _SpmdCall(torch.autograd.Function):
    """Differentiable stacking of a :func:`run_spmd` call: the forward
    runs the world, the backward runs every rank's backward on rank
    threads of the same world and sums the input cotangents over ranks."""

    @staticmethod
    def forward(fctx, run, *tensors):
        fctx.run = run
        fctx.devices = [t.device for t in tensors]
        outs = run.forward(tensors, track=True)
        live = [o for o in outs if o is not None]
        fctx.mark_non_differentiable(
            *[o for o in live if not (o.is_floating_point()
                                      or o.is_complex())])
        fctx.slots = [i for i, o in enumerate(outs) if o is not None]
        fctx.nout = len(outs)
        return tuple(live)

    @staticmethod
    def backward(fctx, *gouts):
        full = [None] * fctx.nout
        for i, g in zip(fctx.slots, gouts):
            full[i] = g
        grads = fctx.run.backward(full)
        return (None,) + tuple(
            None if g is None else g.to(dev)
            for g, dev in zip(grads, fctx.devices))


def run_spmd(fn, nranks: Optional[int] = None, mesh=None,
             axis_name: str = DEFAULT_AXIS, jit: bool = True, device=None):
    """Run ``fn`` SPMD over a mesh axis — the counterpart of
    :func:`~mpi4torch_tpu_torch.run_ranks` under the Mode A contract.

    Returns a function ``call(*args)``: ``fn(*args)`` runs once on every
    rank thread, the inputs replicated to every rank (rank-local data
    comes from ``COMM_WORLD.rank``, a :class:`RankExpr`).  Each output
    gains a leading ``nranks`` axis holding the per-rank results, and is
    differentiable from outside: ``torch.autograd.grad`` of a reduction
    of the stacked outputs runs every rank's backward (on rank threads
    of the same world) and sums the input cotangents over the ranks in
    ascending order, like ``backward()`` on every MPI rank.

    ``nranks=None`` with no ``mesh`` means the number of devices of the
    world's device type (one H100: 1; the CPU: 1).  With a ``mesh``
    (:func:`~mpi4torch_tpu_torch.mesh.device_mesh`) the world has one
    rank per mesh position, row-major, outputs stack over all of them,
    and ``COMM_WORLD`` is the ``axis_name`` axis; the mesh's other axes
    are reached through :func:`comm_from_mesh`.  Every rank is a thread
    on one device (``device``: CUDA unless the caller passes ``"cpu"``).

    Under :func:`~mpi4torch_tpu_torch.init_distributed` the world spans
    the processes: with no ``mesh`` it holds every global rank
    (``nranks`` must be None or their count), a ``mesh`` must cover them
    in the processes' order (``device_mesh``/``hybrid_mesh`` build one),
    each process runs its own block of ranks on the device it was
    initialized with, and every collective crosses the processes
    (``transport/dist.py``).  Outputs stack this process's rows
    (:func:`~mpi4torch_tpu_torch.local_values` names their ranks), and a
    gradient from outside is collective: every process takes it, and a
    replicated input's cotangent sums every global rank's.

    The caller's deterministic mode, compression, fusion and overlap
    scopes are read at call time and bound in every rank thread.  Inputs
    are shared across the ranks, not copied: a body must not modify them
    in place.  Nothing is compiled: ``jit`` is accepted for the JAX
    package's signature and the call runs eagerly either way; ``jit``
    has no counterpart the port needs (PyTorch runs eagerly)."""
    from .. import distributed as _dist
    lay = _dist.layout()
    if mesh is None:
        if lay is None:
            dev = resolve_device(device)
            n = nranks or _device_count(dev)
        else:
            dev = _dist_device(lay, device)
            n = sum(lay[1])
            if nranks is not None and nranks != n:
                raise CommError(
                    f"nranks={nranks} under init_distributed: the world "
                    f"holds every global rank ({n})")
        names, shape = (axis_name,), (int(n),)
    else:
        if axis_name not in mesh.axis_names:
            raise CommError(
                f"axis {axis_name!r} not in mesh axes {mesh.axis_names}")
        if lay is not None:
            _check_mesh_layout(mesh, lay)
        dev = _mesh_device(mesh, device, lay)
        names = tuple(mesh.axis_names)
        shape = tuple(int(mesh.shape[a]) for a in names)
        if nranks is not None and nranks != math.prod(shape):
            raise CommError(f"nranks={nranks} differs from the mesh's "
                            f"{math.prod(shape)} ranks")

    def call(*args):
        scopes = (_config.deterministic_reductions(),
                  _config.default_compression(),
                  _config.default_bucket_bytes(),
                  _config.default_overlap(),
                  _config.default_algorithm())
        flat, adef = tree_flatten(list(args))
        slots = [i for i, a in enumerate(flat) if isinstance(a, torch.Tensor)]
        tensors = [flat[i].to(dev) for i in slots]
        run = _SpmdRun(fn, names, shape, axis_name, dev, scopes, flat, adef,
                       slots, distributed=lay is not None)
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tensors):
            live = iter(_SpmdCall.apply(run, *tensors))
            stacked = [next(live) if p else None for p in run.present]
        else:
            stacked = run.forward(tensors, track=False)
        return tree_from_structure(run.out_def, stacked)

    return call

