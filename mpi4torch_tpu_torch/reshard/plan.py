"""The reshard planner: (mesh, spec) -> (mesh', spec') as a program of
portable collective steps with bounded peak memory.

Port of ``mpi4torch_tpu/reshard/plan.py``; pure Python and numpy, so a
plan is the JAX package's plan field for field (strategy, steps, tables,
groups, chunks and the ``(wire_bytes, peak_bytes)`` estimates).  Every
sharding transition is a short sequence of portable collectives —
all-gather, all-to-all, collective-permute, slice — chosen so that peak
live bytes stay ``O(shard + chunk)`` instead of the ``O(full array)`` of
gathering everything and slicing:

* :class:`Layout` — a ``(mesh_shape, spec)`` pair over a flat world of
  ``prod(mesh_shape)`` ranks (rank -> mesh coordinates row-major,
  :func:`mpi4torch_tpu_torch.mesh.mesh_coords`).  ``spec`` assigns mesh
  axes to array axes; unused mesh axes replicate.
* :func:`plan_reshard` — puts a transition on the common chunk grid
  (per axis the ``lcm`` of the two sharding factors) and emits the
  cheapest applicable strategy:

  ========== ================================================= ==========
  strategy   shape of the transition                           wire steps
  ========== ================================================= ==========
  local      every rank already holds its target shard         none
  permute    whole shards move bijectively between ranks       1 permute
  allgather  pure coarsening (sharding drops / replication     1 gather
             grows), aligned blocks                            per axis
  alltoall   uniform chunk exchange within disjoint rank       1 all-to-
             groups (the (8,)->(2,4) migration shape)          all
  rounds     anything else: chunk-granular permute rounds,     <=R
             one chunk per rank in flight per round            permutes
  gather     the baseline: gather everything, slice            1 gather
  ========== ================================================= ==========

  Auto selection takes the measured tune-cache winner of the transition
  when it names an applicable strategy (the ``|transition=`` key
  dimension of :mod:`mpi4torch_tpu_torch.tune.autotuner`), else the
  first applicable strategy in the order above; ``gather``, the
  baseline, wins only through the cache.
* :meth:`ReshardPlan.adjoint` — the reverse plan.  Every step kind's
  adjoint is a step kind of the same grammar (permute -> inverse
  permute, all-to-all -> table-swapped all-to-all, all-gather ->
  reduce-scatter, slice -> pad), so the backward of a reshard is a
  reshard.
* :func:`plan_permutation` (MoE expert rebalancing) and
  :func:`plan_resize` (the elastic world's axis-0 re-deal; its caller,
  ``elastic``, is ROADMAP.md Queue 1 item 6) build plans of the same
  kind on other routes.

Plans are cached per (transition, global shape, dtype, strategy).  A
dtype is named as the JAX package names it (``"float32"``,
``"bfloat16"``), whether it comes as a torch or a numpy dtype.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import config as _config
from ..mesh import mesh_coords
from ..runtime import CommError
from ..tune import generation as _tune_generation

# Registered plan-step kinds.  The registry guard of
# tests/test_torch_reshard.py fails when a kind exists without an
# executor entry, an adjoint in the grammar and a case that runs it.
STEP_KINDS = ("slice", "pad", "permute", "alltoall", "allgather",
              "reduce_scatter")

# Planner strategies ("auto" = the preference order).
STRATEGIES = ("local", "permute", "allgather", "alltoall", "rounds",
              "gather")

_MOVE_KINDS = ("slice", "pad", "permute", "alltoall")

def dtype_name(dtype) -> str:
    """A torch or numpy dtype as the JAX package names it
    (``"float32"``, ``"bfloat16"``, ``"int32"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype)[len("torch."):]
    if isinstance(dtype, str) and \
            isinstance(getattr(torch, dtype, None), torch.dtype):
        return dtype_name(getattr(torch, dtype))
    return str(np.dtype(dtype))


def dtype_itemsize(dtype) -> int:
    """Bytes of one element of a torch or numpy dtype, or of a dtype
    named as :func:`dtype_name` names it."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return getattr(torch, dtype_name(dtype)).itemsize


def _norm_entry(e) -> Tuple[int, ...]:
    if e is None:
        return ()
    if isinstance(e, (int, np.integer)):
        return (int(e),)
    return tuple(int(i) for i in e)


@dataclass(frozen=True)
class Layout:
    """A sharding layout: ``mesh`` is the virtual mesh shape over the
    flat world (``prod(mesh)`` ranks, coordinates row-major — the same
    8-as-(2,4) convention as the torus schedules); ``spec[a]`` names the
    mesh axes (by index, major-to-minor) sharding array axis ``a``.
    Mesh axes used by no array axis replicate the data."""

    mesh: Tuple[int, ...]
    spec: Tuple[Tuple[int, ...], ...]

    def __post_init__(self):
        mesh = tuple(int(m) for m in self.mesh)
        spec = tuple(_norm_entry(e) for e in self.spec)
        object.__setattr__(self, "mesh", mesh)
        object.__setattr__(self, "spec", spec)
        if not mesh or any(m < 1 for m in mesh):
            raise CommError(f"invalid mesh shape {mesh}")
        used = [i for e in spec for i in e]
        for i in used:
            if not (0 <= i < len(mesh)):
                raise CommError(
                    f"spec names mesh axis {i}, but the mesh has "
                    f"{len(mesh)} axes")
        if len(set(used)) != len(used):
            raise CommError(
                f"each mesh axis may shard at most one array axis; "
                f"spec {spec} reuses one")

    @property
    def size(self) -> int:
        return math.prod(self.mesh)

    @property
    def ndim(self) -> int:
        return len(self.spec)

    def factor(self, a: int) -> int:
        return math.prod(self.mesh[i] for i in self.spec[a])

    @property
    def factors(self) -> Tuple[int, ...]:
        return tuple(self.factor(a) for a in range(self.ndim))

    @property
    def replica_axes(self) -> Tuple[int, ...]:
        used = {i for e in self.spec for i in e}
        return tuple(i for i in range(len(self.mesh)) if i not in used)

    def block(self, rank: int) -> Tuple[int, ...]:
        """Per-array-axis block index of ``rank``'s shard."""
        coords = mesh_coords(rank, self.mesh)
        out = []
        for e in self.spec:
            b = 0
            for i in e:
                b = b * self.mesh[i] + coords[i]
            out.append(b)
        return tuple(out)

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        gs = tuple(int(s) for s in global_shape)
        if len(gs) != self.ndim:
            raise CommError(
                f"layout has {self.ndim} array axes but the array has "
                f"{len(gs)}")
        for a, s in enumerate(gs):
            if s % self.factor(a):
                raise CommError(
                    f"axis {a} length {s} is not divisible by its "
                    f"sharding factor {self.factor(a)} under layout "
                    f"{self.describe()}")
        return tuple(s // self.factor(a) for a, s in enumerate(gs))

    def global_shape(self, shard_shape) -> Tuple[int, ...]:
        ss = tuple(int(s) for s in shard_shape)
        if len(ss) != self.ndim:
            raise CommError(
                f"layout has {self.ndim} array axes but the shard has "
                f"{len(ss)}")
        return tuple(s * self.factor(a) for a, s in enumerate(ss))

    def describe(self) -> str:
        spec = ",".join(
            "r" if not e else "m" + "".join(str(i) for i in e)
            for e in self.spec)
        return f"{'x'.join(str(m) for m in self.mesh)}[{spec}]"


def layout(mesh, *spec) -> Layout:
    """Convenience constructor: ``layout((2, 4), (0, 1), None)`` shards
    array axis 0 over both mesh axes and replicates axis 1."""
    return Layout(tuple(mesh), tuple(spec))


# ---------------------------------------------------------------------------
# Steps.  All fields are static tuples (plans are cached); per-rank
# tables are tuples indexed by rank; the eager executor indexes them
# with its own rank.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LocalStep:
    """Local chunk moves: extract ``src_chunk``-shaped blocks from the
    current value and place (``pad``: accumulate) them into the output
    buffer.  ``moves[r]`` is a tuple of ``(valid, src_start, dst_start)``
    triples, padded to a uniform length across ranks."""
    kind: str                      # "slice" | "pad"
    moves: Tuple                   # per rank: ((valid, src, dst), ...)
    src_chunk: Tuple[int, ...]
    dst_chunk: Tuple[int, ...]
    in_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]

    def adjoint(self) -> "LocalStep":
        flipped = tuple(
            tuple((v, d, s) for (v, s, d) in per_rank)
            for per_rank in self.moves)
        return LocalStep(
            kind="pad" if self.kind == "slice" else "slice",
            moves=flipped, src_chunk=self.dst_chunk,
            dst_chunk=self.src_chunk, in_shape=self.out_shape,
            out_shape=self.in_shape)


@dataclass(frozen=True)
class PermuteStep:
    """One chunk per rank rides one ``collective_permute``.  ``table``
    is the completed send bijection; ``send[r] = (valid, src_start)``,
    ``recv[r] = (valid, dst_start)``.  ``accumulate`` marks adjoint
    placement (cotangents of a replicated chunk add up)."""
    kind: str
    table: Tuple[int, ...]
    send: Tuple
    recv: Tuple
    chunk: Tuple[int, ...]
    in_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]
    accumulate: bool = False

    def adjoint(self) -> "PermuteStep":
        inv = [0] * len(self.table)
        for s, d in enumerate(self.table):
            inv[d] = s
        return PermuteStep(
            kind="permute", table=tuple(inv), send=self.recv,
            recv=self.send, chunk=self.chunk, in_shape=self.out_shape,
            out_shape=self.in_shape, accumulate=not self.accumulate)


@dataclass(frozen=True)
class AllToAllStep:
    """Uniform chunk exchange within disjoint, equally-sized rank
    groups: each rank packs ``slots`` chunks (``cpr`` per group peer, in
    group-position order), one grouped ``all_to_all`` swaps them, each
    rank places the ``slots`` received chunks.  ``send[r]``/``recv[r]``
    are the per-slot element offsets."""
    kind: str
    groups: Tuple[Tuple[int, ...], ...]
    cpr: int                       # chunks per (src, dst) pair
    send: Tuple                    # per rank: (src_start, ...) per slot
    recv: Tuple                    # per rank: (dst_start, ...) per slot
    chunk: Tuple[int, ...]
    in_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]
    accumulate: bool = False

    def adjoint(self) -> "AllToAllStep":
        return AllToAllStep(
            kind="alltoall", groups=self.groups, cpr=self.cpr,
            send=self.recv, recv=self.send, chunk=self.chunk,
            in_shape=self.out_shape, out_shape=self.in_shape,
            accumulate=not self.accumulate)


@dataclass(frozen=True)
class AllGatherStep:
    """Value -> value transform: concatenate the group members' values
    along ``axis`` in group order (``axis=None``: stack the whole
    world's values along a new leading axis — the gather-baseline's
    wide hop, the one a wire codec may ride)."""
    kind: str
    groups: Optional[Tuple[Tuple[int, ...], ...]]
    axis: Optional[int]
    in_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]

    def adjoint(self) -> "ReduceScatterStep":
        return ReduceScatterStep(
            kind="reduce_scatter", groups=self.groups, axis=self.axis,
            in_shape=self.out_shape, out_shape=self.in_shape)


@dataclass(frozen=True)
class ReduceScatterStep:
    """The all-gather adjoint: sum the group members' cotangents
    (ascending group order under ``deterministic_mode`` — the eager
    oracle's association) and keep this rank's segment/slot."""
    kind: str
    groups: Optional[Tuple[Tuple[int, ...], ...]]
    axis: Optional[int]
    in_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]

    def adjoint(self) -> AllGatherStep:
        return AllGatherStep(
            kind="allgather", groups=self.groups, axis=self.axis,
            in_shape=self.out_shape, out_shape=self.in_shape)


@dataclass(frozen=True)
class ReshardPlan:
    """A compiled transition: the step program plus its static
    metadata.  ``wire_bytes``/``peak_bytes`` are the deterministic
    per-rank estimates of the plan (the JAX package's accounting)."""
    steps: Tuple
    strategy: str
    size: int
    in_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]
    dtype: str
    wire_bytes: int
    peak_bytes: int
    transition: str

    def adjoint(self) -> "ReshardPlan":
        steps = tuple(s.adjoint() for s in reversed(self.steps))
        return ReshardPlan(
            steps=steps, strategy=self.strategy + ".adjoint",
            size=self.size, in_shape=self.out_shape,
            out_shape=self.in_shape, dtype=self.dtype,
            wire_bytes=self.wire_bytes, peak_bytes=self.peak_bytes,
            transition=self.transition + ".adjoint")


# ---------------------------------------------------------------------------
# Route computation: the transition on the common chunk grid.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Routes:
    """Per-transition chunk routing: ``local[r]`` are (src_start,
    dst_start) element-offset pairs of chunks rank ``r`` already holds;
    ``wire`` is the global list of (src, dst, src_start, dst_start)
    moves."""
    size: int
    chunk: Tuple[int, ...]
    in_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]
    local: Tuple
    wire: Tuple


def _owners_map(lay: Layout):
    """block-vector -> sorted rank list (replicas included)."""
    owners = {}
    for r in range(lay.size):
        owners.setdefault(lay.block(r), []).append(r)
    return owners


def _routes_from_wants(size, chunk, in_shape, out_shape, wants):
    """``wants``: iterable of (dst_rank, src_owner_ranks, src_start,
    dst_start).  Splits into local/wire with the replica-spreading
    source pick."""
    local = [[] for _ in range(size)]
    wire = []
    for d, owners, src_start, dst_start in wants:
        if d in owners:
            local[d].append((src_start, dst_start))
        else:
            s = owners[d % len(owners)]
            wire.append((s, d, src_start, dst_start))
    return _Routes(size=size, chunk=chunk, in_shape=tuple(in_shape),
                   out_shape=tuple(out_shape),
                   local=tuple(tuple(m) for m in local),
                   wire=tuple(wire))


def _compute_routes(src_lay: Layout, dst_lay: Layout,
                    global_shape) -> _Routes:
    gs = tuple(int(s) for s in global_shape)
    nd = len(gs)
    Ff, Ft = src_lay.factors, dst_lay.factors
    G = tuple(math.lcm(Ff[a], Ft[a]) for a in range(nd))
    chunk = tuple(gs[a] // G[a] for a in range(nd))
    qin = tuple(G[a] // Ff[a] for a in range(nd))
    qout = tuple(G[a] // Ft[a] for a in range(nd))
    in_shape = src_lay.shard_shape(gs)
    out_shape = dst_lay.shard_shape(gs)
    owners = _owners_map(src_lay)
    size = src_lay.size

    wants = []
    for d in range(size):
        bt = dst_lay.block(d)
        for lt in np.ndindex(*qout):
            c = tuple(bt[a] * qout[a] + lt[a] for a in range(nd))
            bf = tuple(c[a] // qin[a] for a in range(nd))
            src_start = tuple((c[a] - bf[a] * qin[a]) * chunk[a]
                              for a in range(nd))
            dst_start = tuple(lt[a] * chunk[a] for a in range(nd))
            wants.append((d, owners[bf], src_start, dst_start))
    return _routes_from_wants(size, chunk, in_shape, out_shape, wants)


def _permutation_routes(lay: Layout, axis: int, perm, global_shape
                        ) -> _Routes:
    """Routes for a block permutation along one array axis: new unit
    ``u`` of the chunk grid holds old unit ``perm[u]`` (both layouts =
    ``lay``).  Used by MoE expert rebalancing, where the units are the
    stacked experts."""
    gs = tuple(int(s) for s in global_shape)
    nd = len(gs)
    perm = tuple(int(p) for p in perm)
    n_units = len(perm)
    if sorted(perm) != list(range(n_units)):
        raise CommError(f"perm {perm} is not a permutation of "
                        f"0..{n_units - 1}")
    F = lay.factors
    if n_units % F[axis] or gs[axis] % n_units:
        raise CommError(
            f"{n_units} permutation units must be a multiple of the "
            f"axis-{axis} sharding factor {F[axis]} and divide the "
            f"axis length {gs[axis]}")
    G = tuple(n_units if a == axis else F[a] for a in range(nd))
    chunk = tuple(gs[a] // G[a] for a in range(nd))
    qin = tuple(G[a] // F[a] for a in range(nd))
    in_shape = lay.shard_shape(gs)
    owners = _owners_map(lay)
    size = lay.size

    wants = []
    for d in range(size):
        bt = lay.block(d)
        for lt in np.ndindex(*qin):
            # New chunk at my slot lt along `axis` maps to old unit
            # perm[global unit]; other axes are untouched.
            c_new = tuple(bt[a] * qin[a] + lt[a] for a in range(nd))
            c_old = tuple(perm[c_new[a]] if a == axis else c_new[a]
                          for a in range(nd))
            bf = tuple(c_old[a] // qin[a] for a in range(nd))
            src_start = tuple((c_old[a] - bf[a] * qin[a]) * chunk[a]
                              for a in range(nd))
            dst_start = tuple(lt[a] * chunk[a] for a in range(nd))
            wants.append((d, owners[bf], src_start, dst_start))
    return _routes_from_wants(size, chunk, in_shape, in_shape, wants)


# ---------------------------------------------------------------------------
# Strategy builders.  Each returns a step tuple or None (inapplicable).
# ---------------------------------------------------------------------------


def _pad_moves(local, nd):
    """Per-rank move lists padded to uniform length with invalid
    entries (zero starts, which the executor skips)."""
    zero = (0,) * nd
    n = max((len(m) for m in local), default=0)
    return tuple(
        tuple((True, s, d) for s, d in m)
        + ((False, zero, zero),) * (n - len(m))
        for m in local)


def _local_steps(routes: _Routes):
    """The shared local-placement step (chunks that never touch the
    wire), or () when every chunk moves."""
    if not any(routes.local):
        return ()
    return (LocalStep(kind="slice",
                      moves=_pad_moves(routes.local, len(routes.chunk)),
                      src_chunk=routes.chunk, dst_chunk=routes.chunk,
                      in_shape=routes.in_shape,
                      out_shape=routes.out_shape),)


def _build_local(routes: _Routes):
    if routes.wire:
        return None
    if routes.in_shape == routes.out_shape and all(
            src == dst for per in routes.local for src, dst in per):
        return ()                  # identity transition: empty plan
    return _local_steps(routes)


def _build_permute(routes: _Routes):
    """Whole shards move bijectively: every rank sends its entire shard
    to one destination (chunk == shard, contiguous) and receives one.
    Ranks that keep their shard become self-pairs of the same
    ``collective_permute``."""
    if (routes.in_shape != routes.out_shape
            or routes.chunk != routes.in_shape):
        return None
    table = [None] * routes.size
    recv_from = [None] * routes.size
    for r in range(routes.size):
        if len(routes.local[r]) == 1:
            table[r] = r
            recv_from[r] = r
        elif routes.local[r]:
            return None
    for s, d, ss, ds in routes.wire:
        if table[s] is not None or recv_from[d] is not None:
            return None
        table[s] = d
        recv_from[d] = s
    if any(t is None for t in table) or any(s is None for s in recv_from):
        return None
    shard = routes.in_shape
    zero = (0,) * len(shard)
    valid = tuple((True, zero) for _ in range(routes.size))
    return (PermuteStep(kind="permute", table=tuple(table), send=valid,
                        recv=valid, chunk=shard, in_shape=shard,
                        out_shape=shard),)


def _build_allgather(src_lay: Layout, dst_lay: Layout, global_shape):
    """Pure coarsening with aligned blocks on a replication-free
    source: one grouped all-gather per coarsened axis."""
    if src_lay.replica_axes:
        return None
    gs = tuple(int(s) for s in global_shape)
    Ff, Ft = src_lay.factors, dst_lay.factors
    nd = len(gs)
    ratios = []
    for a in range(nd):
        if Ff[a] % Ft[a]:
            return None
        ratios.append(Ff[a] // Ft[a])
    if all(r == 1 for r in ratios):
        return None
    size = src_lay.size
    blocks = [src_lay.block(r) for r in range(size)]
    for r in range(size):
        if dst_lay.block(r) != tuple(blocks[r][a] // ratios[a]
                                     for a in range(nd)):
            return None
    steps = []
    cur = list(src_lay.shard_shape(gs))
    for a in range(nd):
        k = ratios[a]
        if k == 1:
            continue
        groups = {}
        for r in range(size):
            key = blocks[r][:a] + (blocks[r][a] // k,) + blocks[r][a + 1:]
            groups.setdefault(key, []).append(r)
        glist = tuple(
            tuple(sorted(g, key=lambda r: blocks[r][a]))
            for _, g in sorted(groups.items()))
        if any(len(g) != k for g in glist):
            return None
        nxt = list(cur)
        nxt[a] = cur[a] * k
        steps.append(AllGatherStep(kind="allgather", groups=glist,
                                   axis=a, in_shape=tuple(cur),
                                   out_shape=tuple(nxt)))
        cur = nxt
    return tuple(steps)


def _build_alltoall(routes: _Routes):
    """Uniform grouped exchange: the (src, dst) pair graph (self pairs
    included) decomposes into equal-size groups in which every ordered
    pair exchanges exactly ``cpr`` chunks."""
    if not routes.wire:
        return None
    size = routes.size
    pairs = {}
    for s, d, ss, ds in routes.wire:
        pairs.setdefault((s, d), []).append((ss, ds))
    for r in range(size):
        for ss, ds in routes.local[r]:
            pairs.setdefault((r, r), []).append((ss, ds))
    parent = list(range(size))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for (s, d) in pairs:
        rs, rd = find(s), find(d)
        if rs != rd:
            parent[rs] = rd
    comps = {}
    for r in range(size):
        comps.setdefault(find(r), []).append(r)
    groups = tuple(tuple(sorted(g)) for g in
                   sorted(comps.values(), key=lambda g: g[0]))
    g = len(groups[0])
    if g < 2 or any(len(grp) != g for grp in groups):
        return None
    cprs = {len(v) for v in pairs.values()}
    if len(cprs) != 1:
        return None
    cpr = cprs.pop()
    if len(pairs) != len(groups) * g * g:
        return None
    slots = g * cpr
    nd = len(routes.chunk)
    send = [[None] * slots for _ in range(size)]
    recv = [[None] * slots for _ in range(size)]
    pos = {}
    for grp in groups:
        for p, r in enumerate(grp):
            pos[r] = p
    for (s, d), moves in pairs.items():
        moves = sorted(moves)
        for k, (ss, ds) in enumerate(moves):
            send[s][pos[d] * cpr + k] = ss
            recv[d][pos[s] * cpr + k] = ds
    return (AllToAllStep(kind="alltoall", groups=groups, cpr=cpr,
                         send=tuple(tuple(x) for x in send),
                         recv=tuple(tuple(x) for x in recv),
                         chunk=routes.chunk, in_shape=routes.in_shape,
                         out_shape=routes.out_shape),)


def _build_rounds(routes: _Routes):
    """The general fallback: greedy matching packs the wire moves into
    rounds of at most one send + one receive per rank; each round is
    one chunk-sized ``collective_permute``.  Peak live bytes:
    in-shard + out-shard + two chunks in flight."""
    if not routes.wire:
        return None
    size = routes.size
    nd = len(routes.chunk)
    zero = (0,) * nd
    remaining = list(routes.wire)
    steps = list(_local_steps(routes))
    while remaining:
        used_s, used_d = set(), set()
        this, rest = [], []
        for mv in remaining:
            s, d = mv[0], mv[1]
            if s in used_s or d in used_d:
                rest.append(mv)
            else:
                used_s.add(s)
                used_d.add(d)
                this.append(mv)
        remaining = rest
        table = [None] * size
        send = [(False, zero)] * size
        recv = [(False, zero)] * size
        for s, d, ss, ds in this:
            table[s] = d
            send[s] = (True, ss)
            recv[d] = (True, ds)
        free_d = [d for d in range(size) if d not in {m[1] for m in this}]
        it = iter(free_d)
        for s in range(size):
            if table[s] is None:
                table[s] = next(it)
        steps.append(PermuteStep(
            kind="permute", table=tuple(table), send=tuple(send),
            recv=tuple(recv), chunk=routes.chunk,
            in_shape=routes.in_shape, out_shape=routes.out_shape))
    return tuple(steps)


def _build_gather(routes: _Routes):
    """The gather-then-slice baseline: stack every rank's shard (the
    full array lives on every rank — the peak the planner exists to
    avoid), then slice the target shard from the stack.  Kept as the
    explicit oracle strategy; never auto-selected."""
    size = routes.size
    nd = len(routes.chunk)
    stacked = (size,) + routes.in_shape
    qin = tuple(routes.in_shape[a] // routes.chunk[a] for a in range(nd))
    moves = [[] for _ in range(size)]
    for r in range(size):
        for ss, ds in routes.local[r]:
            moves[r].append(((r,) + ss, ds))
    for s, d, ss, ds in routes.wire:
        moves[d].append(((s,) + ss, ds))
    padded = _pad_moves(tuple(tuple(m) for m in moves), nd + 1)
    # _pad_moves pads dst starts to nd+1 too; trim them back to nd.
    padded = tuple(tuple((v, s, d[:nd] if len(d) > nd else d)
                         for v, s, d in per) for per in padded)
    return (AllGatherStep(kind="allgather", groups=None, axis=None,
                          in_shape=routes.in_shape, out_shape=stacked),
            LocalStep(kind="slice", moves=padded,
                      src_chunk=(1,) + routes.chunk,
                      dst_chunk=routes.chunk, in_shape=stacked,
                      out_shape=routes.out_shape))


# ---------------------------------------------------------------------------
# Estimates + assembly
# ---------------------------------------------------------------------------


def _estimates(steps, in_shape, out_shape, itemsize, size):
    """Deterministic per-device (wire_bytes, peak_bytes) of a step
    program.  Wire follows the ring accountings of the JAX package's
    bench; peak counts the shard buffers plus each step's own live
    buffers."""
    nbytes = lambda shape: int(math.prod(shape)) * itemsize  # noqa: E731
    in_b, out_b = nbytes(in_shape), nbytes(out_shape)
    wire = 0
    peak = in_b + out_b
    for st in steps:
        if st.kind == "permute":
            wire += nbytes(st.chunk)
            peak = max(peak, in_b + out_b + 2 * nbytes(st.chunk))
        elif st.kind == "alltoall":
            g = len(st.groups[0])
            slots_b = st.cpr * g * nbytes(st.chunk)
            wire += (g - 1) * st.cpr * nbytes(st.chunk)
            peak = max(peak, in_b + out_b + 2 * slots_b)
        elif st.kind in ("allgather", "reduce_scatter"):
            g = len(st.groups[0]) if st.groups else size
            small = min(nbytes(st.in_shape), nbytes(st.out_shape))
            wire += (g - 1) * small
            peak = max(peak, nbytes(st.in_shape) + nbytes(st.out_shape))
        else:  # slice / pad: local
            peak = max(peak, nbytes(st.in_shape) + nbytes(st.out_shape))
    return wire, peak


def _transition_key(src_lay, dst_lay, global_shape) -> str:
    return (f"{src_lay.describe()}->{dst_lay.describe()}"
            f"@{'x'.join(str(s) for s in global_shape)}")


def _assemble(steps, strategy, size, routes, dtype, transition):
    itemsize = dtype_itemsize(dtype)
    wire, peak = _estimates(steps, routes.in_shape, routes.out_shape,
                            itemsize, size)
    return ReshardPlan(steps=tuple(steps), strategy=strategy, size=size,
                       in_shape=routes.in_shape,
                       out_shape=routes.out_shape, dtype=str(dtype),
                       wire_bytes=wire, peak_bytes=peak,
                       transition=transition)


def _candidates(src_lay, dst_lay, global_shape, routes,
                with_gather=None):
    """(strategy, steps) for every applicable strategy, in auto
    preference order (cheapest peak memory first; ``gather`` last and
    never auto-picked).  ``with_gather`` overrides the src_lay-presence
    gate (resize routes have no source Layout but do want the gather
    baseline: the full restart the live replan is compared with)."""
    if with_gather is None:
        with_gather = src_lay is not None
    out = []
    for name in STRATEGIES:
        if name == "local":
            steps = _build_local(routes)
        elif name == "permute":
            steps = _build_permute(routes)
        elif name == "allgather":
            steps = (_build_allgather(src_lay, dst_lay, global_shape)
                     if dst_lay is not None else None)
        elif name == "alltoall":
            steps = _build_alltoall(routes)
        elif name == "rounds":
            steps = _build_rounds(routes)
        else:
            steps = _build_gather(routes) if with_gather else None
        if steps is not None:
            out.append((name, steps))
    return out


def _pick(cands, dtype, nbytes, size, transition):
    """Auto selection: the measured tune-cache winner for this transition
    when one names an applicable strategy, else the first (cheapest-peak)
    applicable candidate.  ``gather`` only ever wins through the cache."""
    names = [n for n, _ in cands]
    from ..tune import lookup_algorithm

    winner = lookup_algorithm("reshard", dtype, nbytes, size,
                              transition=transition)
    if winner in names:
        return winner
    for n in names:
        if n != "gather":
            return n
    return names[0]


def _resolve_strategy(strategy) -> Optional[str]:
    if strategy is None:
        strategy = _config.default_reshard_strategy()
    if strategy in (None, "auto"):
        return None
    if strategy not in STRATEGIES:
        raise CommError(
            f"unknown reshard strategy {strategy!r}; expected one of "
            f"{STRATEGIES} or 'auto'")
    return strategy


@functools.lru_cache(maxsize=256)
def _plan_cached(src_lay, dst_lay, global_shape, dtype, strategy,
                 _gen):
    routes = _compute_routes(src_lay, dst_lay, global_shape)
    cands = _candidates(src_lay, dst_lay, global_shape, routes)
    trans = _transition_key(src_lay, dst_lay, global_shape)
    nbytes = int(math.prod(routes.in_shape)) * dtype_itemsize(dtype)
    if strategy is None:
        name = _pick(cands, dtype, nbytes, src_lay.size, trans)
    else:
        name = strategy
        if name not in [n for n, _ in cands]:
            raise CommError(
                f"reshard strategy {name!r} cannot serve the transition "
                f"{trans} (applicable: {[n for n, _ in cands]})")
    steps = dict(cands)[name]
    return _assemble(steps, name, src_lay.size, routes, dtype, trans)


def plan_reshard(from_layout: Layout, to_layout: Layout, global_shape,
                 dtype, strategy=None) -> ReshardPlan:
    """Plan the (mesh, spec) -> (mesh', spec') transition of one array.

    ``strategy=None`` defers to :func:`mpi4torch_tpu_torch.config.
    default_reshard_strategy` (``"auto"``: the preference order); an
    explicit strategy that cannot serve the transition raises.  Plans
    are cached per (transition, shape, dtype, strategy)."""
    if from_layout.size != to_layout.size:
        raise CommError(
            f"transition changes the world size: {from_layout.size} "
            f"ranks -> {to_layout.size} (elastic resize must go through "
            "checkpoint restore, utils/checkpoint.restore_resharded)")
    return _plan_cached(from_layout, to_layout,
                        tuple(int(s) for s in global_shape),
                        dtype_name(dtype), _resolve_strategy(strategy),
                        _tune_generation())


@functools.lru_cache(maxsize=256)
def _perm_plan_cached(lay, axis, perm, global_shape, dtype, strategy,
                      _gen):
    routes = _permutation_routes(lay, axis, perm, global_shape)
    cands = [(n, s) for n, s in _candidates(None, None, global_shape,
                                            routes)]
    trans = (f"{lay.describe()}@perm{axis}:"
             f"{'x'.join(str(s) for s in global_shape)}")
    nbytes = int(math.prod(routes.in_shape)) * dtype_itemsize(dtype)
    if strategy is None:
        name = _pick(cands, dtype, nbytes, lay.size, trans)
    else:
        name = strategy
        if name not in [n for n, _ in cands]:
            raise CommError(
                f"reshard strategy {name!r} cannot serve the block "
                f"permutation {trans}")
    steps = dict(cands)[name]
    return _assemble(steps, name, lay.size, routes, dtype, trans)


def plan_permutation(lay: Layout, axis: int, perm, global_shape, dtype,
                     strategy=None) -> ReshardPlan:
    """Plan a block permutation along ``axis`` under a fixed layout —
    the MoE expert-rebalancing transition: unit ``u`` of the result
    holds old unit ``perm[u]``.  Same strategies, caching and adjoint
    contract as :func:`plan_reshard` (``gather`` is deliberately
    excluded from the candidate set here — a permutation never wants
    the full-materialization baseline)."""
    return _perm_plan_cached(lay, int(axis), tuple(int(p) for p in perm),
                             tuple(int(s) for s in global_shape),
                             dtype_name(dtype),
                             _resolve_strategy(strategy), _tune_generation())


# ---------------------------------------------------------------------------
# Elastic world resize: axis-0 redistribution ACROSS world sizes.
# ---------------------------------------------------------------------------
#
# plan_reshard deliberately refuses transitions that change the world
# size — within one world there is nothing a size change could mean.
# The elastic runtime (ROADMAP.md Queue 1 item 6) needs exactly that
# transition: state dealt over W ranks re-dealt over M ranks, executed
# on whichever world holds both memberships (the OLD world for a
# graceful drain — every source rank still alive — or the NEW world for
# a grow, with the survivors embedded among the joiners).  The from/to
# deals are the repo's standard axis-0 conventions: ``n`` leading units
# (ZeRO's padded flat elements, TP's heads, MoE's stacked experts)
# ceil-split into ``per = ceil(n / size)`` units per rank, the tail
# rank zero-padded.  Because every shard boundary is a multiple of
# ``gcd(per_from, per_to)``, chunking at that gcd puts each chunk
# inside exactly one source shard and one target shard — the same
# uniform-chunk _Routes the existing strategy builders and BOTH
# executor already serves, so a resize plan is an ordinary ReshardPlan:
# permute/alltoall/rounds candidates, the gather baseline (= the
# full-restart restore every rank re-materializes), adjoint() = the
# reverse (grow-back) plan, and the differentiable execution of
# executor.apply_plan.


def _resize_routes(n: int, row: Tuple[int, ...], from_size: int,
                   to_size: int, embed_from, embed_to,
                   exec_size: int) -> _Routes:
    per_f = -(-n // from_size)
    per_t = -(-n // to_size)
    c = math.gcd(per_f, per_t)
    nd = 1 + len(row)
    in_shape = (per_f,) + row
    out_shape = (per_t,) + row
    chunk = (c,) + row
    # Route every chunk that carries logical data (start < n); chunks
    # fully inside the padding are zeros on both sides and the output
    # buffer starts as zeros, so routing them would be wire for nothing.
    wants = []
    zero_tail = (0,) * len(row)
    for k in range(min(-(-n // c), (per_t * to_size) // c)):
        start = k * c
        i = start // per_f               # source deal position
        j = start // per_t               # target deal position
        wants.append((embed_to[j], [embed_from[i]],
                      (start - i * per_f,) + zero_tail,
                      (start - j * per_t,) + zero_tail))
    return _routes_from_wants(exec_size, chunk, in_shape, out_shape,
                              wants)


@functools.lru_cache(maxsize=256)
def _resize_plan_cached(n, row, from_size, to_size, embed_from,
                        embed_to, exec_size, dtype, strategy, _gen):
    routes = _resize_routes(n, row, from_size, to_size, embed_from,
                            embed_to, exec_size)
    cands = _candidates(None, None, (n,) + row, routes,
                        with_gather=True)
    trans = (f"resize[{from_size}->{to_size}]"
             f"@{'x'.join(str(s) for s in (n,) + row)}"
             f"/exec{exec_size}:{_fnv_embed(embed_from, embed_to)}")
    nbytes = int(math.prod(routes.in_shape)) * dtype_itemsize(dtype)
    if strategy is None:
        name = _pick(cands, dtype, nbytes, exec_size, trans)
    else:
        name = strategy
        if name not in [nm for nm, _ in cands]:
            raise CommError(
                f"reshard strategy {name!r} cannot serve the resize "
                f"{trans} (applicable: {[nm for nm, _ in cands]})")
    steps = dict(cands)[name]
    return _assemble(steps, name, exec_size, routes, dtype, trans)


def _fnv_embed(embed_from, embed_to) -> str:
    """Short stable fingerprint of the embedding maps for the
    transition key (full tuples would make the key unwieldy on big
    worlds)."""
    h = 0x811C9DC5
    for v in (*embed_from, -1, *embed_to):
        h ^= (v + 2) & 0xFF
        h = (h * 0x01000193) & 0xFFFFFFFF
    return f"{h:08x}"


def plan_resize(n: int, row_shape, from_size: int, to_size: int, dtype,
                *, embed_from, embed_to, exec_size: int,
                strategy=None) -> ReshardPlan:
    """Plan the elastic axis-0 re-deal of ``n`` leading units (each of
    shape ``row_shape``) from a ``from_size``-way ceil-split to a
    ``to_size``-way ceil-split, executed on a world of ``exec_size``
    ranks that embeds both memberships:

    * ``embed_from[i]`` — the executing rank holding source deal
      position ``i``'s shard (ranks outside the map feed a zeros
      buffer of the source shard shape);
    * ``embed_to[j]`` — the executing rank that ends with target deal
      position ``j``'s shard (ranks outside the map end with zeros).

    A shrink drain runs on the OLD world (``exec_size == from_size``,
    ``embed_from`` identity, ``embed_to`` = the survivors' old ranks);
    a grow runs on the NEW world (``embed_to`` identity, ``embed_from``
    = the survivors' new ranks).  Same strategy set, caching, adjoint
    (= the reverse resize) and executor contract as
    :func:`plan_reshard`; ``gather`` is the explicit full-restart
    baseline and is never auto-picked."""
    n = int(n)
    from_size, to_size = int(from_size), int(to_size)
    exec_size = int(exec_size)
    if n < 1 or from_size < 1 or to_size < 1:
        raise CommError(
            f"plan_resize needs n >= 1 and positive world sizes; got "
            f"n={n}, {from_size}->{to_size}")
    embed_from = tuple(int(r) for r in embed_from)
    embed_to = tuple(int(r) for r in embed_to)
    if len(embed_from) != from_size or len(embed_to) != to_size:
        raise CommError(
            f"embed_from/embed_to must map every deal position: need "
            f"lengths {from_size}/{to_size}, got "
            f"{len(embed_from)}/{len(embed_to)}")
    for name, emb in (("embed_from", embed_from), ("embed_to", embed_to)):
        if any(not (0 <= r < exec_size) for r in emb):
            raise CommError(
                f"{name} names ranks outside the executing world "
                f"(size {exec_size}): {emb}")
        if len(set(emb)) != len(emb):
            raise CommError(
                f"{name} maps two deal positions onto one executing "
                f"rank ({emb}) — each rank holds ONE uniform shard "
                "buffer per side")
    return _resize_plan_cached(
        n, tuple(int(s) for s in row_shape), from_size, to_size,
        embed_from, embed_to, exec_size, dtype_name(dtype),
        _resolve_strategy(strategy), _tune_generation())
