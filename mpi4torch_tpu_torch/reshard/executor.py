"""The reshard executor: a plan replayed on the rank-thread world.

Port of the eager half of ``mpi4torch_tpu/reshard/executor.py``.  Each
step of a :class:`~.plan.ReshardPlan` runs through the rendezvous
(``World.exchange``), so reshard traffic is traced by ``obs`` and rides
the fault grammar of ``resilience`` like every other collective:

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

The facade (:func:`reshard_value`, :func:`reshard_tree`, surfaced as
``comm.Reshard``) runs a whole plan inside one
``torch.autograd.Function`` whose backward runs
:meth:`~.plan.ReshardPlan.adjoint`, the reverse plan, on the cotangents.
The compiled SPMD executor of the JAX package comes with the compiled
backend (ROADMAP.md, Queue 1 item 4).
"""

from __future__ import annotations

import torch

from ..compress import eager as _ceager
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


def _eager_local(rctx, i, st, v, out):
    accumulate = st.kind == "pad"
    for valid, src, dst in st.moves[rctx.rank]:
        if valid:
            chunk = _region(v, src, st.src_chunk).reshape(st.dst_chunk)
            _put(out, dst, chunk, accumulate)
    return out


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


def _exec_eager(rctx, plan: ReshardPlan, x, codec=None):
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
                    out = _EAGER_EXEC[st.kind](rctx, i, st, v, out)
                else:
                    if out is not None:
                        v, out = out, None
                    if st.kind == "allgather":
                        v = _eager_allgather(rctx, i, st, v, codec)
                    else:
                        v = _EAGER_EXEC[st.kind](rctx, i, st, v)
    return out if out is not None else v


# ---------------------------------------------------------------------------
# Dispatch + facade
# ---------------------------------------------------------------------------


def _rank_context(comm, plan: ReshardPlan):
    from ..comm import MPI_Communicator

    if not isinstance(comm, MPI_Communicator):
        raise CommError(
            "Reshard needs the rank-thread world (COMM_WORLD inside "
            "run_ranks, or the size-1 world outside it); the SPMD executor "
            "is not ported yet (ROADMAP.md, Queue 1 item 4.10), and "
            f"{type(comm).__name__} is neither")
    rctx = effective_rank_context()
    if rctx.world.size != plan.size:
        raise CommError(
            f"plan for {plan.transition} spans {plan.size} ranks, but "
            f"this communicator has {rctx.world.size}")
    return rctx


def _check_input(rctx, x):
    _check_payload(rctx, x, "Reshard")
    rctx.world.check_not_consumed(rctx.rank, x)


def execute_plan(comm, plan: ReshardPlan, x, codec=None):
    """Run a compiled plan on ``comm`` (no autograd: use
    :func:`reshard_value` or :func:`apply_plan` for the differentiable
    form)."""
    rctx = _rank_context(comm, plan)
    _check_input(rctx, x)
    return _exec_eager(rctx, plan, x, codec)


class _ApplyPlan(torch.autograd.Function):
    """The whole plan as one differentiable op: the backward runs the
    reverse plan on the cotangents, exactly (a compressed forward hop is
    a transport of the forward only)."""

    @staticmethod
    def forward(fctx, x, rctx, plan, codec):
        fctx.rctx, fctx.plan = rctx, plan
        out = _exec_eager(rctx, plan, x, codec)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(fctx, g):
        with torch.profiler.record_function("mpi4torch.ReshardBackward"):
            return (_exec_eager(fctx.rctx, fctx.plan.adjoint(), g, None),
                    None, None, None)


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
    rctx = _rank_context(comm, plan)
    _check_input(rctx, x)
    return _ApplyPlan.apply(x, rctx, plan, codec)


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
