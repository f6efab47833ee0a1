"""The reshard executor: one plan, two backends, the same bits.

Port of ``mpi4torch_tpu/reshard/executor.py``.  Mode B (the rank-thread
world of ``run_ranks``) replays each step of a
:class:`~.plan.ReshardPlan` through the rendezvous (``World.exchange``),
so reshard traffic is traced by ``obs`` and rides the fault grammar of
``resilience`` like every other collective:

* move steps (``slice``, ``pad``, ``permute``, ``alltoall``) write the
  chunks they place into one fresh output buffer by slice assignment
  (``pad`` adds, as the JAX package's ``.at[].add``);
* transform steps (``allgather``, ``reduce_scatter``) map the value to a
  new one; the reduce-scatter folds the group members' cotangents left
  to right in group order, which is the JAX package's association, so a
  replication adjoint is bitwise the JAX package's.

Whatever a step takes from another rank's payload it takes inside the
rendezvous (``exchange(read=...)``), before the owner can go on and
modify it.  Each step's rendezvous signature is the JAX package's,
element for element: ``("Reshard.<kind>", step, group_size, shape,
dtype)`` with the dtype named as JAX names it, so a traced reshard's
event stream equals the JAX package's.

Mode A (:func:`~mpi4torch_tpu_torch.ops.spmd.run_spmd`) runs the same
plan as the JAX package's SPMD lowering does: a permute round is one
``ppermute`` (self-pairs kept local), an exchange step one grouped
all-to-all, a coarsening or replication step one (grouped) all-gather or
reduce-scatter, and the local moves read this rank's row of the plan's
static per-rank tables.  Under ``deterministic_mode`` the reduce-scatter
is the gather and ordered fold of the JAX package (its bits are then the
Mode B fold's); outside it, the port's native reduce-scatter, which
folds in ascending group order too.  The compressed wide hop rides
``compress/spmd.allgather``.

The facade (:func:`reshard_value`, :func:`reshard_tree`, surfaced as
``comm.Reshard``) runs a whole plan inside one
``torch.autograd.Function`` whose backward runs
:meth:`~.plan.ReshardPlan.adjoint`, the reverse plan, on the cotangents,
on either backend.
"""

from __future__ import annotations

import torch

from .. import config as _config
from ..compress import eager as _ceager
from ..constants import MPI_SUM
from ..ops import spmd as _spmd
from ..ops.eager import _check_payload
from ..runtime import CommError, effective_rank_context
from ..utils.tree import tree_map
from .plan import (Layout, ReshardPlan, _MOVE_KINDS, dtype_name,
                   plan_permutation, plan_reshard)

__all__ = [
    "apply_plan", "execute_plan", "reshard_value", "reshard_tree",
    "reshard_blocks", "gather_then_slice", "slice_shard", "shard_of",
    "shard_template", "global_template",
]


def as_layout(spec) -> Layout:
    if isinstance(spec, Layout):
        return spec
    if isinstance(spec, (tuple, list)) and len(spec) == 2:
        return Layout(tuple(spec[0]), tuple(spec[1]))
    raise CommError(
        f"expected a reshard Layout (or a (mesh, spec) pair); got "
        f"{spec!r}")


# ---------------------------------------------------------------------------
# The step program on the rank threads
# ---------------------------------------------------------------------------


def _region(buf, starts, shape):
    return buf[tuple(slice(int(s), int(s) + int(c))
                     for s, c in zip(starts, shape))]


def _put(out, starts, val, accumulate):
    dst = _region(out, starts, val.shape)
    if accumulate:
        dst.add_(val)
    else:
        dst.copy_(val)


def _esig(st, i, v):
    """Rendezvous signature of one step: the JAX package's, with the
    step's replica-group size (``None``: the whole communicator)."""
    groups = getattr(st, "groups", None)
    gs = len(groups[0]) if groups else None
    return (f"Reshard.{st.kind}", i, gs, tuple(v.shape),
            dtype_name(v.dtype))


def _local_moves(st, moves, v, out):
    """The valid moves of one rank's row of a ``slice``/``pad`` step."""
    accumulate = st.kind == "pad"
    for valid, src, dst in moves:
        if valid:
            chunk = _region(v, src, st.src_chunk).reshape(st.dst_chunk)
            _put(out, dst, chunk, accumulate)
    return out


def _eager_local(rctx, i, st, v, out):
    return _local_moves(st, st.moves[rctx.rank], v, out)


def _eager_permute(rctx, i, st, v, out):
    rank = rctx.rank
    sv, ss = st.send[rank]
    buf = _region(v, ss, st.chunk) if sv \
        else v.new_zeros(st.chunk)
    src = st.table.index(rank)
    rv, rs = st.recv[rank]

    def place(vals):
        if rv:
            _put(out, rs, vals[src], st.accumulate)

    rctx.world.exchange(rank, _esig(st, i, buf), buf, read=place)
    return out


def _eager_alltoall(rctx, i, st, v, out):
    rank = rctx.rank
    buf = torch.stack([_region(v, s, st.chunk) for s in st.send[rank]])
    grp = next(g for g in st.groups if rank in g)
    pos = grp.index(rank)

    def place(vals):
        for t, dst in enumerate(st.recv[rank]):
            p, k = divmod(t, st.cpr)
            _put(out, dst, vals[grp[p]][pos * st.cpr + k], st.accumulate)

    rctx.world.exchange(rank, _esig(st, i, buf), buf, read=place)
    return out


def _eager_allgather(rctx, i, st, v, codec=None):
    rank = rctx.rank
    if st.axis is None and codec is not None:
        return _ceager.allgather(rctx, v[None], 0, codec)
    if st.axis is None:
        read = torch.stack
    else:
        grp = next(g for g in st.groups if rank in g)

        def read(vals):
            return torch.cat([vals[m] for m in grp], dim=st.axis)

    return rctx.world.exchange(rank, _esig(st, i, v), v, read=read)


def _eager_reduce_scatter(rctx, i, st, v):
    """Each rank folds only the segment it keeps: the sum is element-wise,
    so the bits equal those of folding the whole value and slicing."""
    rank = rctx.rank
    if st.axis is None:
        grp, part = range(rctx.world.size), (lambda w: w[rank])
    else:
        grp = next(g for g in st.groups if rank in g)
        seg = st.out_shape[st.axis]
        lo = grp.index(rank) * seg

        def part(w):
            return w.narrow(st.axis, lo, seg)

    def fold(vals):
        acc = part(vals[grp[0]])
        for m in grp[1:]:
            acc = acc + part(vals[m])
        return acc.clone() if len(grp) == 1 else acc

    return rctx.world.exchange(rank, _esig(st, i, v), v, read=fold)


_EAGER_EXEC = {
    "slice": _eager_local,
    "pad": _eager_local,
    "permute": _eager_permute,
    "alltoall": _eager_alltoall,
    "allgather": _eager_allgather,
    "reduce_scatter": _eager_reduce_scatter,
}


def _run(plan: ReshardPlan, x, move_fn, transform_fn):
    """Thread the value through the step program: move steps fill a zeros
    output buffer; transform steps map value -> value; a transform after
    a move phase consumes that phase's buffer."""
    if tuple(x.shape) != plan.in_shape:
        raise CommError(
            f"Reshard input shard has shape {tuple(x.shape)}, but the "
            f"plan for {plan.transition} expects {plan.in_shape}")
    v, out = x, None
    with torch.no_grad():
        for i, st in enumerate(plan.steps):
            with torch.profiler.record_function(
                    f"mpi4torch.Reshard.{st.kind}"):
                if st.kind in _MOVE_KINDS:
                    if out is None:
                        out = x.new_zeros(st.out_shape)
                    out = move_fn(i, st, v, out)
                else:
                    if out is not None:
                        v, out = out, None
                    v = transform_fn(i, st, v)
    return out if out is not None else v


def _exec_eager(rctx, plan: ReshardPlan, x, codec=None):
    def move(i, st, v, out):
        return _EAGER_EXEC[st.kind](rctx, i, st, v, out)

    def transform(i, st, v):
        if st.kind == "allgather":
            return _eager_allgather(rctx, i, st, v, codec)
        return _EAGER_EXEC[st.kind](rctx, i, st, v)

    return _run(plan, x, move, transform)


# ---------------------------------------------------------------------------
# Mode A: the plan on the SPMD exchange primitives
# ---------------------------------------------------------------------------


def _rank_row(ctx, table):
    """This rank's row of a static per-rank table of the plan (the JAX
    package's masked ``where(valid, ...)`` placements then reduce to
    skipping the moves that are not valid)."""
    return table[ctx.index]


def _spmd_local(ctx, st, v, out):
    return _local_moves(st, _rank_row(ctx, st.moves), v, out)


def _spmd_permute(ctx, st, v, out):
    sv, ss = _rank_row(ctx, st.send)
    buf = _region(v, ss, st.chunk) if sv else v.new_zeros(st.chunk)
    n = len(st.table)
    pairs = tuple((i, st.table[i]) for i in range(n) if st.table[i] != i)
    got = buf
    if pairs:
        got = _spmd._ppermute(ctx, buf.contiguous(), pairs)
        if st.table[ctx.index] == ctx.index:
            # A self-pair is a local hand-off (the permute carries only
            # the real moves): this rank keeps its own chunk.
            got = buf
    rv, rs = _rank_row(ctx, st.recv)
    if rv:
        _put(out, rs, got, st.accumulate)
    return out


def _spmd_alltoall(ctx, st, v, out):
    buf = torch.stack([_region(v, s, st.chunk)
                       for s in _rank_row(ctx, st.send)])
    got = _spmd._all_to_all(ctx, buf, 0, 0, groups=st.groups)
    for t, dst in enumerate(_rank_row(ctx, st.recv)):
        _put(out, dst, got[t], st.accumulate)
    return out


def _spmd_allgather(ctx, st, v, codec=None):
    if st.axis is None:
        if codec is not None:
            from ..compress import spmd as _cspmd

            return _cspmd.allgather(ctx, v[None], 0, codec)
        return _spmd._all_gather(ctx, v)
    return _spmd._all_gather_tiled(ctx, v, st.axis, groups=st.groups)


def _group_pos(groups, size):
    pos = [0] * size
    for g in groups:
        for p, r in enumerate(g):
            pos[r] = p
    return tuple(pos)


def _spmd_reduce_scatter(ctx, st, v):
    """The replication adjoint.  Under ``deterministic_mode`` the JAX
    package's ordered form: gather the group's values and fold them left
    to right in group order, then keep this rank's segment; outside it
    the native reduce-scatter (whose port folds in the same order)."""
    det = _config.deterministic_reductions()
    if st.axis is None:
        n = ctx.size
        if det:
            stacked = _spmd._all_gather(ctx, v)
            acc = stacked[0]
            for i in range(1, n):
                acc = acc + stacked[i]
            return acc[ctx.index]
        part = _spmd._psum_scatter(ctx, v.reshape(n, -1), MPI_SUM, 0)
        return part.reshape(st.out_shape)
    if det:
        stacked = _spmd._all_gather(ctx, v, groups=st.groups)
        acc = stacked[0]
        for i in range(1, stacked.shape[0]):
            acc = acc + stacked[i]
        pos = _rank_row(ctx, _group_pos(st.groups, ctx.size))
        seg = st.out_shape[st.axis]
        return acc.narrow(st.axis, pos * seg, seg)
    return _spmd._psum_scatter(ctx, v, MPI_SUM, st.axis, groups=st.groups)


_SPMD_EXEC = {
    "slice": _spmd_local,
    "pad": _spmd_local,
    "permute": _spmd_permute,
    "alltoall": _spmd_alltoall,
    "allgather": _spmd_allgather,
    "reduce_scatter": _spmd_reduce_scatter,
}


def _exec_spmd(ctx, plan: ReshardPlan, x, codec=None):
    def move(i, st, v, out):
        return _SPMD_EXEC[st.kind](ctx, st, v, out)

    def transform(i, st, v):
        if st.kind == "allgather":
            return _spmd_allgather(ctx, st, v, codec)
        return _SPMD_EXEC[st.kind](ctx, st, v)

    return _run(plan, x, move, transform)


# ---------------------------------------------------------------------------
# Dispatch + facade
# ---------------------------------------------------------------------------


def _bind(comm, plan: ReshardPlan, x):
    """``(executor, context)`` of ``comm``'s backend for ``plan``, the
    input checked: the SPMD executor under Mode A, the rendezvous replay
    on the rank threads.  A tier-stack communicator is refused: the
    virtual mesh lives in the Layouts."""
    from ..comm import MPI_Communicator

    if not isinstance(comm, MPI_Communicator):
        raise CommError(
            "Reshard needs the rank-thread world (COMM_WORLD inside "
            "run_ranks, or the size-1 world outside it) or a run_spmd "
            f"communicator; {type(comm).__name__} is neither")
    backend = comm._spmd()
    if isinstance(backend, _spmd.TierStackBackend):
        raise CommError(
            "Reshard needs a flat communicator (the virtual mesh lives "
            "in the Layouts); use comm_from_mesh with ONE axis name or "
            "COMM_WORLD")
    if isinstance(backend, _spmd.SpmdBackend):
        ctx, size, run = backend._ctx, backend.size, _exec_spmd
        _spmd._check_payload(ctx, x, "Reshard")
    else:
        ctx = effective_rank_context()
        size, run = ctx.world.size, _exec_eager
    if size != plan.size:
        raise CommError(
            f"plan for {plan.transition} spans {plan.size} ranks, but "
            f"this communicator has {size}")
    if run is _exec_eager:
        _check_payload(ctx, x, "Reshard")
        ctx.world.check_not_consumed(ctx.rank, x)
    return run, ctx


def execute_plan(comm, plan: ReshardPlan, x, codec=None):
    """Run a compiled plan on ``comm``'s backend (no autograd: use
    :func:`reshard_value` or :func:`apply_plan` for the differentiable
    form)."""
    run, ctx = _bind(comm, plan, x)
    return run(ctx, plan, x, codec)


class _ApplyPlan(torch.autograd.Function):
    """The whole plan as one differentiable op: the backward runs the
    reverse plan on the cotangents, exactly (a compressed forward hop is
    a transport of the forward only)."""

    @staticmethod
    def forward(fctx, x, run, ctx, plan, codec):
        fctx.run, fctx.ctx, fctx.plan = run, ctx, plan
        out = run(ctx, plan, x, codec)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(fctx, g):
        with torch.profiler.record_function("mpi4torch.ReshardBackward"):
            return (fctx.run(fctx.ctx, fctx.plan.adjoint(), g.contiguous(),
                             None), None, None, None, None)


def _resolve_reshard_codec(compression, dtype, plan):
    """Reshard moves state, not gradients: the compression scope and the
    process default are ignored (a lossy migration must be asked for).
    An explicit codec needs a floating dtype and a wide hop (a
    full-world gather step) to ride."""
    if compression is None or compression is False or \
            compression == "none":
        return None
    from ..compress import codec_applicable, get_codec

    codec = get_codec(compression)
    if codec is None:
        return None
    if not codec_applicable(codec, dtype):
        raise ValueError(
            f"compression={codec.name!r} requires a floating tensor; "
            f"got dtype {dtype}")
    wide = any(st.kind == "allgather" and st.axis is None
               for st in plan.steps)
    if not wide:
        raise ValueError(
            f"compression={codec.name!r} rides the wide full-world "
            f"gather hop, and the {plan.strategy!r} plan for "
            f"{plan.transition} has none — drop compression= (the "
            "planned exchange already moves O(shard) bytes) or pin "
            "strategy='gather'")
    return codec


def _apply(comm, plan: ReshardPlan, x, codec):
    run, ctx = _bind(comm, plan, x)
    return _ApplyPlan.apply(x, run, ctx, plan, codec)


def apply_plan(comm, plan: ReshardPlan, x, *, differentiable=True):
    """Execute an already-compiled :class:`~.plan.ReshardPlan` on
    ``comm`` — the entry for plans built outside the Layout-pair facade
    (:func:`~.plan.plan_resize`).  ``differentiable=True`` runs it as one
    differentiable op whose backward is ``plan.adjoint()``."""
    if differentiable:
        return _apply(comm, plan, x, None)
    return execute_plan(comm, plan, x)


def reshard_value(comm, x, from_spec, to_spec, strategy=None,
                  compression=None):
    """Redistribute one shard from ``from_spec`` to ``to_spec`` (both
    :class:`~.plan.Layout`); differentiable, the backward being the
    reverse plan."""
    fl, tl = as_layout(from_spec), as_layout(to_spec)
    gshape = fl.global_shape(x.shape)
    plan = plan_reshard(fl, tl, gshape, x.dtype, strategy)
    codec = _resolve_reshard_codec(compression, x.dtype, plan)
    return _apply(comm, plan, x, codec)


def _structure(tree):
    """Tree structure with dictionary keys sorted (the JAX pytree
    order), so two trees whose dictionaries were built in different
    orders compare equal."""
    if isinstance(tree, dict):
        return (dict, tuple(sorted(tree)),
                tuple(_structure(tree[k]) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_structure(v) for v in tree))
    return None


def _spec_tree(spec, tree):
    """Broadcast a single Layout over the tree, or validate a tree of
    Layouts of the tree's structure."""
    if isinstance(spec, Layout):
        return tree_map(lambda _: spec, tree)
    lays = tree_map(as_layout, spec)
    if _structure(lays) != _structure(tree):
        raise CommError(
            "from_spec/to_spec must be one Layout or a tree of Layouts "
            f"matching the state tree; got structure {_structure(lays)} "
            f"vs {_structure(tree)}")
    return lays


def reshard_tree(comm, tree, from_spec, to_spec, strategy=None,
                 compression=None):
    """The tree form behind ``comm.Reshard``: per-leaf layouts (one
    Layout broadcast over the tree, or a matching tree of Layouts, e.g.
    from :func:`~.rules.match_partition_rules`)."""
    fls = _spec_tree(from_spec, tree)
    tls = _spec_tree(to_spec, tree)
    return tree_map(
        lambda x, fl, tl: reshard_value(comm, x, fl, tl, strategy=strategy,
                                        compression=compression),
        tree, fls, tls)


def gather_then_slice(comm, x, from_spec, to_spec):
    """The baseline transition: gather the full array on every rank and
    slice the target shard (``O(full array)`` peak live bytes).  Every
    planned transition is bitwise equal to it."""
    return reshard_value(comm, x, from_spec, to_spec, strategy="gather")


def reshard_blocks(comm, tree, lay, axis, perm, strategy=None):
    """Apply a block permutation along ``axis`` (see
    :func:`~.plan.plan_permutation`) to every leaf — the MoE
    expert-rebalancing move.  Differentiable; the backward applies the
    inverse permutation."""
    lay = as_layout(lay)

    def one(x):
        plan = plan_permutation(lay, axis, perm,
                                lay.global_shape(x.shape), x.dtype,
                                strategy)
        return _apply(comm, plan, x, None)

    return tree_map(one, tree)


# ---------------------------------------------------------------------------
# Shard helpers (checkpoint migration)
# ---------------------------------------------------------------------------


def _as_tensor(arr):
    return arr if isinstance(arr, torch.Tensor) else torch.as_tensor(arr)


def slice_shard(arr, lay: Layout, rank: int):
    """``rank``'s shard of a global array under ``lay``, as a tensor of
    its own (a copy, on the array's device)."""
    arr = _as_tensor(arr)
    lay = as_layout(lay)
    shard = lay.shard_shape(arr.shape)
    block = lay.block(int(rank))
    return arr[tuple(slice(b * s, (b + 1) * s)
                     for b, s in zip(block, shard))].clone()


def shard_of(tree, spec, rank: int):
    """Tree-mapped :func:`slice_shard`."""
    lays = _spec_tree(spec, tree)
    return tree_map(lambda x, lay: slice_shard(x, lay, rank), tree, lays)


def _meta_like(x, shape):
    return torch.empty(shape, dtype=_as_tensor(x).dtype, device="meta")


def shard_template(tree, spec):
    """A tree of meta tensors of the per-rank shard shapes of a
    global-shaped tree under ``spec`` (every rank's shard has the same
    shape): the counterpart of the JAX package's ``ShapeDtypeStruct``
    tree."""
    lays = _spec_tree(spec, tree)
    return tree_map(
        lambda x, lay: _meta_like(x, lay.shard_shape(_as_tensor(x).shape)),
        tree, lays)


def global_template(tree, spec):
    """A tree of meta tensors of the global shapes whose shards a
    shard-shaped tree describes under ``spec``."""
    lays = _spec_tree(spec, tree)
    return tree_map(
        lambda x, lay: _meta_like(x, lay.global_shape(_as_tensor(x).shape)),
        tree, lays)
