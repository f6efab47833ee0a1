"""Differentiable collectives on the rank-thread runtime.

Port of ``mpi4torch_tpu/ops/eager.py``: the mpi4torch op table, each op
one ``torch.autograd.Function`` whose backward is the adjoint
communication:

    Allreduce(SUM)  <-> Allreduce(SUM)
    Reduce_scatter  <-> Allgather of the shards
    Bcast_(root)    <-> Reduce_(SUM, root)
    Reduce_(SUM, r) <-> Bcast_(r)
    Gather(ax, r)   <-> Scatter(ax, n, r)
    Allgather(ax)   <-> ordered reduce-scatter (the correct adjoint)
    Scatter(ax,n,r) <-> Gather(ax, r)
    Alltoall(g,s,n) <-> Alltoall(s,g,n')
    Isend/Irecv/Wait <-> reverse-direction messages on tag + 10

Only ``MPI_SUM`` reductions are differentiable; other ops raise in
backward, like the mpi4torch reference's unimplemented node.  Reductions
fold in ascending rank order (:func:`~mpi4torch_tpu_torch.constants.
reduce_ordered`) or, for an ``algorithm=``, in that schedule's
association, so every rank gets the same bits on every run, and the same
bits as the JAX package's Mode B on the same inputs.

Rank threads share one process, and torch tensors are mutable: every
output a rank takes from a rendezvous or a mailbox is its own tensor,
never another rank's object or a view of one (that would let one rank's
in-place edit reach another, and returning another rank's tensor from a
``Function`` would rewrite that tensor's autograd metadata).  Outputs
that are fresh results (a fold, a concatenation) are used as they are;
another rank's tensor, or a slice of one, is copied.  Every read of
another rank's payload runs inside the rendezvous (``World.exchange``'s
``read``), so no owner can modify a payload in place before the others
have taken what they need of it.  A buffered send copies its payload.
Nothing here reads a device value on the host.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .. import constants as C
from ..runtime import (REQ_IRECV, REQ_ISEND, BifurcationError, CommError,
                       RankContext)

# Element count above which Allreduce folds once (rank 0) and shares the
# result instead of every rank thread folding the same list again.  The
# share costs one more rendezvous.
_FOLD_ONCE_MIN = 65536

# Gradient messages travel on tag + GRAD_TAG_OFFSET, apart from the
# forward messages.
GRAD_TAG_OFFSET = 10

# A wait-handle descriptor: [request id, kind, peer, tag, fingerprint] in
# float64 on the CPU (every slot integer-exact; Wait reads it without a
# device round trip).
_DESC_LEN = 5


def _shape_sig(x):
    return (tuple(x.shape), str(x.dtype))


def _norm_axis(axis: int, ndim: int) -> int:
    a = axis + ndim if axis < 0 else axis
    if not 0 <= a < ndim:
        raise ValueError(f"axis {axis} out of range for ndim {ndim}")
    return a


def _check_payload(ctx: RankContext, x, what: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what} takes a torch.Tensor, got {type(x)}")
    device = ctx.world.device
    if device is not None and x.device != device:
        raise CommError(
            f"{what} payload is on {x.device} but this rank world runs on "
            f"{device}")


def _check_root(world, root: int) -> None:
    if not 0 <= root < world.size:
        raise CommError(f"invalid root rank {root} (world size "
                        f"{world.size})")


def _sum_only(op: int, what: str) -> None:
    if op != C.MPI_SUM:
        raise RuntimeError(
            f"Backward pass for {what} with {C.op_name(op)} is not "
            "implemented — only MPI_SUM is differentiable")


def _zero_grad(shape, dtype, device):
    """A zero gradient of ``shape`` that allocates one element."""
    return torch.zeros((), dtype=dtype, device=device).expand(shape)


def _own(t, rank: int, owner: int):
    """``t`` (``owner``'s tensor, or a view of it) as ``rank``'s own: a
    copy unless this rank is the owner."""
    return t if rank == owner else t.clone()


# =========================================================================
# Allreduce
# =========================================================================


def _rendezvous_fold(world_size: int, algorithm):
    """``(name, fold)`` of an Allreduce ``algorithm``: the reduction
    association of the schedule of that name, ``fold(op, values)``.  The
    facade has already checked that the algorithm serves this world."""
    if algorithm in (None, "ring"):
        return "ring", C.reduce_ordered
    if algorithm == "rhd":
        if world_size & (world_size - 1):
            raise CommError(
                f"the 'rhd' schedule needs a power-of-two world; got "
                f"{world_size} ranks — use 'tree' or 'ring'")
        return "rhd", C.reduce_rhd
    if algorithm == "tree":
        return "tree", C.reduce_tree
    if algorithm in ("hier", "torus"):
        from ..tune import resolve_hier_group

        g = resolve_hier_group(world_size)
        if algorithm == "hier":
            return "hier", lambda op, vals: C.reduce_grouped(op, vals, g)
        return "torus", lambda op, vals: C.reduce_torus(op, vals, g)
    if algorithm == "bidir":
        # The two rings carry disjoint element ranges of an elementwise
        # fold, so bidir's association is the ascending-rank one.
        return "bidir", C.reduce_ordered
    raise CommError(f"unknown collective algorithm {algorithm!r} for the "
                    "rank-thread backend")


def _allreduce_value(ctx: RankContext, x, op: int, algorithm=None):
    world, rank = ctx.world, ctx.rank
    _check_payload(ctx, x, "Allreduce")
    name, fold = _rendezvous_fold(world.size, algorithm)
    sig = _shape_sig(x)
    if x.numel() >= _FOLD_ONCE_MIN and C.fold_applicable(op, x.dtype):
        # Every rank would compute the identical fold; above the
        # threshold rank 0 folds once and a second rendezvous shares the
        # result.  The gate is dtype-aware, so an op invalid for the
        # dtype stays on the every-rank path and raises on every rank.
        red = world.exchange(rank, ("Allreduce", op, name, sig), x,
                             read=lambda vals: fold(op, vals)
                             if rank == 0 else None)
        return world.exchange(rank, ("Allreduce.fold", op, name, sig), red,
                              read=lambda vals: _own(vals[0], rank, 0))
    return world.exchange(rank, ("Allreduce", op, name, sig), x,
                          read=lambda vals: fold(op, vals))


class _Allreduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, rctx, op, algorithm):
        fctx.rctx, fctx.op, fctx.algorithm = rctx, op, algorithm
        return _allreduce_value(rctx, x, op, algorithm)

    @staticmethod
    def backward(fctx, g):
        _sum_only(fctx.op, "Allreduce")
        return _allreduce_value(fctx.rctx, g.contiguous(), C.MPI_SUM,
                                fctx.algorithm), None, None, None


def allreduce(ctx: RankContext, x, op: int, algorithm=None):
    """Differentiable Allreduce over ``ctx``'s world, folding in the
    association of ``algorithm`` (``ring``/``bidir``: ascending rank;
    ``rhd``, ``tree``, ``hier``, ``torus``: ``constants.reduce_*``).  The
    backward is the Allreduce of the gradient with the same algorithm, so
    every rank's backward must run (it is a collective)."""
    ctx.world.check_not_consumed(ctx.rank, x)
    return _Allreduce.apply(x, ctx, op, algorithm)


# =========================================================================
# Reduce_scatter
# =========================================================================


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, rctx, op, ax, shard):
        world, rank = rctx.world, rctx.rank
        fctx.rctx, fctx.op, fctx.ax = rctx, op, ax
        # Slice every contribution to this rank's segment, then fold: the
        # elementwise fold commutes with slicing.
        return world.exchange(
            rank, ("Reduce_scatter", op, ax, _shape_sig(x)), x,
            read=lambda vals: C.reduce_ordered(
                op, [v.narrow(ax, rank * shard, shard) for v in vals]))

    @staticmethod
    def backward(fctx, g):
        _sum_only(fctx.op, "Reduce_scatter")
        world, rank = fctx.rctx.world, fctx.rctx.rank
        out = world.exchange(rank, ("Reduce_scatter.bwd", fctx.ax,
                                    _shape_sig(g)), g,
                             read=lambda vals: torch.cat(vals, dim=fctx.ax))
        return out, None, None, None, None


def reduce_scatter(ctx: RankContext, x, op: int, scatteraxis: int):
    """Differentiable block reduce-scatter: every rank contributes an
    identically shaped tensor, rank ``r`` receives segment ``r`` of the
    ascending-rank reduction along ``scatteraxis`` (equal segments).  The
    adjoint (SUM only) is the allgather of the shard gradients."""
    world = ctx.world
    world.check_not_consumed(ctx.rank, x)
    _check_payload(ctx, x, "Reduce_scatter")
    ax = _norm_axis(scatteraxis, x.dim())
    if x.shape[ax] % world.size != 0:
        raise CommError(
            f"Reduce_scatter axis {scatteraxis} length {x.shape[ax]} must "
            f"be divisible by the communicator size {world.size}")
    return _ReduceScatter.apply(x, ctx, op, ax, x.shape[ax] // world.size)


# =========================================================================
# Bcast_ / Reduce_
# =========================================================================


def _root_fold(algorithm, root: int):
    """Reduce-to-root association of ``algorithm``: ``tree`` is the
    binomial tree with ranks relabelled relative to the root (the value
    list rotated root-first), anything else the ascending-rank fold."""
    if algorithm != "tree":
        return C.reduce_ordered

    def fold(op, vals):
        vals = list(vals)
        return C.reduce_tree(op, vals[root:] + vals[:root])

    return fold


def _bcast_value(rctx, v, root: int, label: str):
    return rctx.world.exchange(
        rctx.rank, (label, root, _shape_sig(v)), v,
        read=lambda vals: _own(vals[root], rctx.rank, root))


def _reduce_value(rctx, v, op: int, root: int, fold, label: str, sig):
    def read(vals):
        # Non-root ranks discard the reduction, so they fold only when
        # the fold itself would raise: the rejection stays symmetric.
        if rctx.rank == root or not C.fold_applicable(op, v.dtype):
            red = fold(op, vals)
            return red if rctx.rank == root else torch.zeros_like(red)
        return torch.zeros_like(v)

    return rctx.world.exchange(rctx.rank, sig, v, read=read)


class _Bcast(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, rctx, root, fold):
        fctx.rctx, fctx.root, fctx.fold = rctx, root, fold
        return _bcast_value(rctx, x, root, "Bcast_")

    @staticmethod
    def backward(fctx, g):
        sig = ("Bcast_.bwd", fctx.root, _shape_sig(g))
        return _reduce_value(fctx.rctx, g, C.MPI_SUM, fctx.root, fctx.fold,
                             "Bcast_.bwd", sig), None, None, None


def bcast_(ctx: RankContext, x, root: int, algorithm=None):
    """Differentiable broadcast of ``root``'s tensor (in place in the
    mpi4torch reference; here every rank gets its own copy).  Adjoint:
    ``Reduce_(grad, SUM, root)`` in ``algorithm``'s association."""
    world = ctx.world
    world.check_not_consumed(ctx.rank, x)
    _check_payload(ctx, x, "Bcast_")
    _check_root(world, root)
    return _Bcast.apply(x, ctx, root, _root_fold(algorithm, root))


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, rctx, op, root, algorithm):
        fctx.rctx, fctx.op, fctx.root = rctx, op, root
        sig = ("Reduce_", op, root, algorithm or "ring", _shape_sig(x))
        return _reduce_value(rctx, x, op, root, _root_fold(algorithm, root),
                             "Reduce_", sig)

    @staticmethod
    def backward(fctx, g):
        _sum_only(fctx.op, "Reduce_")
        return _bcast_value(fctx.rctx, g, fctx.root, "Reduce_.bwd"), \
            None, None, None, None


def reduce_(ctx: RankContext, x, op: int, root: int, algorithm=None):
    """Differentiable reduce-to-root.  As in the mpi4torch reference the
    result on non-root ranks is zeros, and the input is consumed: a later
    communication op on this rank rejects it
    (:class:`~mpi4torch_tpu_torch.runtime.InPlaceReuseError`).  Adjoint
    (SUM only): ``Bcast_(grad, root)``."""
    world, rank = ctx.world, ctx.rank
    world.check_not_consumed(rank, x)
    _check_payload(ctx, x, "Reduce_")
    _check_root(world, root)
    out = _Reduce.apply(x, ctx, op, root, algorithm)
    world.mark_consumed(rank, x)
    return out


# =========================================================================
# Gather / Allgather / Scatter / Alltoall
# =========================================================================


def _gather_to(rctx, v, ax: int, root: int):
    """The rendezvous of a Gather: the concatenation along ``ax`` on
    ``root``, and on the other ranks ``(None, shape)`` of it (per-rank
    axis lengths may differ)."""
    othershape = tuple(s for i, s in enumerate(v.shape) if i != ax)

    def read(vals):
        if rctx.rank == root:
            return torch.cat(vals, dim=ax), None
        shape = list(v.shape)
        shape[ax] = sum(t.shape[ax] for t in vals)
        return None, tuple(shape)

    return rctx.world.exchange(
        rctx.rank, ("Gather", ax, root, othershape, str(v.dtype)), v,
        read=read)


def _scatter_from(rctx, v, axis: int, numelem: int, root: int):
    """The rendezvous of a Scatter: a copy of this rank's ``numelem``
    entries of the root's tensor along ``axis`` (non-root inputs are
    ignored, and may be None); the per-rank counts must sum to the root's
    axis length."""
    rank = rctx.rank

    def read(vals):
        counts = [n for n, _ in vals]
        t = vals[root][1]
        ax = _norm_axis(axis, t.dim())
        if sum(counts) != t.shape[ax]:
            raise ValueError(
                f"Scatter: sum of per-rank numelem {counts} = "
                f"{sum(counts)} does not match the root's axis length "
                f"{t.shape[ax]} along axis {ax}")
        # A copy on the root too: its output is a buffer of its own, and
        # a slice would keep the whole (possibly gathered) tensor alive.
        return t.narrow(ax, sum(counts[:rank]), counts[rank]).clone()

    return rctx.world.exchange(rank, ("Scatter", axis, root),
                               (int(numelem), v), read=read)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, rctx, ax, root):
        fctx.rctx, fctx.ax, fctx.root = rctx, ax, root
        fctx.numelem = x.shape[ax]
        out, shape = _gather_to(rctx, x, ax, root)
        return out if out is not None else x.new_zeros(shape)

    @staticmethod
    def backward(fctx, g):
        return _scatter_from(fctx.rctx, g, fctx.ax, fctx.numelem,
                             fctx.root), None, None, None


def gather(ctx: RankContext, x, gatheraxis: int, root: int):
    """Differentiable gather along ``gatheraxis`` with per-rank axis
    lengths; non-root ranks get zeros of the gathered shape.  Adjoint:
    ``Scatter(grad, gatheraxis, numelem, root)`` with this rank's forward
    axis length."""
    world = ctx.world
    world.check_not_consumed(ctx.rank, x)
    _check_payload(ctx, x, "Gather")
    _check_root(world, root)
    return _Gather.apply(x, ctx, _norm_axis(gatheraxis, x.dim()), root)


class _Allgather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, rctx, ax):
        fctx.rctx, fctx.ax = rctx, ax
        othershape = tuple(s for i, s in enumerate(x.shape) if i != ax)
        fctx.counts, out = rctx.world.exchange(
            rctx.rank, ("Allgather", ax, othershape, str(x.dtype)), x,
            read=lambda vals: (tuple(v.shape[ax] for v in vals),
                               torch.cat(vals, dim=ax)))
        return out

    @staticmethod
    def backward(fctx, g):
        rctx, ax, counts = fctx.rctx, fctx.ax, fctx.counts
        # Ordered reduce-scatter: this rank's segment of every rank's
        # gradient, summed in rank order.
        offset = sum(counts[:rctx.rank])
        out = rctx.world.exchange(
            rctx.rank, ("Allgather.bwd", ax, _shape_sig(g)), g,
            read=lambda vals: C.reduce_ordered(C.MPI_SUM, [
                v.narrow(ax, offset, counts[rctx.rank]) for v in vals]))
        return out, None, None


def allgather(ctx: RankContext, x, gatheraxis: int):
    """Differentiable allgather.  Adjoint: the ordered reduce-scatter,
    the mathematically correct one (the mpi4torch reference's backward
    scatters from a constant root and is right only for rank-uniform
    upstream gradients)."""
    ctx.world.check_not_consumed(ctx.rank, x)
    _check_payload(ctx, x, "Allgather")
    return _Allgather.apply(x, ctx, _norm_axis(gatheraxis, x.dim()))


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, rctx, axis, numelem, root):
        fctx.rctx, fctx.axis, fctx.root = rctx, axis, root
        fctx.in_shape, fctx.in_dtype = tuple(x.shape), x.dtype
        return _scatter_from(rctx, x, axis, numelem, root)

    @staticmethod
    def backward(fctx, g):
        rctx = fctx.rctx
        out, _ = _gather_to(rctx, g, _norm_axis(fctx.axis, g.dim()),
                            fctx.root)
        if out is not None:
            return out.to(fctx.in_dtype), None, None, None, None
        return (_zero_grad(fctx.in_shape, fctx.in_dtype, g.device), None,
                None, None, None)


def scatter(ctx: RankContext, x, scatteraxis: int, numelem: int, root: int):
    """Differentiable scatter of ``root``'s tensor along ``scatteraxis``;
    this rank keeps ``numelem`` entries.  Non-root input shapes are
    ignored.  Adjoint: ``Gather(grad, scatteraxis, root)``; non-root
    inputs get a zero gradient, and every rank still joins the backward
    gather."""
    world = ctx.world
    world.check_not_consumed(ctx.rank, x)
    _check_payload(ctx, x, "Scatter")
    _check_root(world, root)
    return _Scatter.apply(x, ctx, scatteraxis, int(numelem), root)


def _alltoall_value(rctx, v, g_ax: int, s_ax: int, numelem: int):
    gathered, _ = _gather_to(rctx, v, g_ax, 0)
    return _scatter_from(rctx, gathered, s_ax, numelem, 0)


class _Alltoall(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, rctx, ga, scatteraxis, numelem):
        fctx.rctx, fctx.ga, fctx.scatteraxis = rctx, ga, scatteraxis
        fctx.back_numelem = x.shape[ga]
        return _alltoall_value(rctx, x, ga, scatteraxis, numelem)

    @staticmethod
    def backward(fctx, g):
        return _alltoall_value(fctx.rctx, g,
                               _norm_axis(fctx.scatteraxis, g.dim()),
                               fctx.ga, fctx.back_numelem), \
            None, None, None, None


def alltoall(ctx: RankContext, x, gatheraxis: int, scatteraxis: int,
             numelem: int):
    """Differentiable all-to-all: gather along ``gatheraxis`` to rank 0,
    then scatter along ``scatteraxis`` with ``numelem`` entries kept
    here (the reference's Scatter∘Gather identity).  Adjoint: the
    axes-swapped Alltoall keeping this rank's forward gather-axis
    length."""
    ctx.world.check_not_consumed(ctx.rank, x)
    _check_payload(ctx, x, "Alltoall")
    return _Alltoall.apply(x, ctx, _norm_axis(gatheraxis, x.dim()),
                           scatteraxis, int(numelem))


# =========================================================================
# Dependency tokens: JoinDummies
# =========================================================================


class _JoinDummies(torch.autograd.Function):
    @staticmethod
    def forward(fctx, loop, *dummies):
        fctx.specs = [(d.shape, d.dtype, d.device) for d in dummies]
        return loop

    @staticmethod
    def backward(fctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=dt, device=dev)
                            for s, dt, dev in fctx.specs)


def join_dummies(loopthrough, dummies: Sequence):
    """The dependency-token primitive.  Forward: ``loopthrough`` itself
    (no copy).  Backward: the gradient flows to ``loopthrough`` and every
    dummy receives a zero gradient, which keeps the edge to the
    communication that produced the dummy in the backward graph (the
    ordering Isend/Irecv/Wait rely on).  With no dummies the input is
    returned untouched.

    The result is a view that a custom ``Function`` returned, so torch
    refuses to modify it in place; copy it first (``.clone()``) to write
    into it."""
    dummies = list(dummies)
    if not dummies:
        return loopthrough
    return _JoinDummies.apply(loopthrough, *dummies)


# =========================================================================
# Nonblocking point-to-point: Isend / Irecv / Wait
# =========================================================================


def _make_descriptor(req):
    return torch.tensor([req.req_id, req.kind, req.peer, req.tag,
                         req.fingerprint], dtype=torch.float64)


def _decode_descriptor(desc) -> Tuple[int, int, int, int, int]:
    if tuple(desc.shape) != (_DESC_LEN,) or desc.device.type != "cpu":
        raise BifurcationError(
            "Detected bifurcation in Wait handle usage: the descriptor "
            f"has shape {tuple(desc.shape)} on {desc.device}, expected "
            f"({_DESC_LEN},) on the CPU")
    req_id, kind, peer, tag, fp = (int(v) for v in desc.tolist())
    return req_id, kind, peer, tag, fp


def _check_tag(tag: int) -> None:
    if not 0 <= tag < (1 << 24) - GRAD_TAG_OFFSET:
        raise CommError(f"tag {tag} out of range [0, 2^24 - "
                        f"{GRAD_TAG_OFFSET})")


def _resolve_peer(ctx: RankContext, peer, what: str) -> int:
    """A peer rank: an int, or a per-rank table holding this rank's
    entry."""
    if isinstance(peer, (list, tuple)):
        size = ctx.world.size
        if len(peer) != size:
            raise CommError(f"{what} table has {len(peer)} entries for "
                            f"world size {size}")
        peer = peer[ctx.rank]
    try:
        return int(peer)
    except (TypeError, ValueError):
        raise CommError(f"{what} must be an integer rank or a per-rank "
                        f"table; got {peer!r}") from None


class _Isend(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, rctx, req):
        fctx.rctx, fctx.dest, fctx.tag = rctx, req.peer, req.tag
        # Buffered send: the message is a copy the receiver owns.
        rctx.world.p2p_send(rctx.rank, req.peer, req.tag, x.clone())
        return _make_descriptor(req), x, x

    @staticmethod
    def backward(fctx, g_desc, g_buf, g_loop):
        rctx = fctx.rctx
        g_remote = rctx.world.p2p_recv(fctx.dest, rctx.rank,
                                       fctx.tag + GRAD_TAG_OFFSET)
        # The local identity paths (buffer and loop-through outputs) add
        # to the gradient that came back over the wire.
        return g_remote + g_buf + g_loop, None, None


def isend(ctx: RankContext, x, dest, tag: int) -> List:
    """Nonblocking (buffered) send.  Returns the raw handle
    ``[descriptor, buffer, loopthrough]``.  The descriptor is a
    differentiable CPU float64 output that gets a zero gradient: the
    ``JoinDummies`` edges through it order the backward, so that every
    rank's ``Wait`` on a receive (which sends a gradient) runs before its
    ``Isend`` backward (which receives one).  Backward: the gradient of
    the sent tensor arrives from ``dest`` on ``tag + 10``."""
    world, rank = ctx.world, ctx.rank
    world.check_not_consumed(rank, x)
    _check_payload(ctx, x, "Isend")
    _check_tag(tag)
    dest = _resolve_peer(ctx, dest, "destination")
    if not 0 <= dest < world.size:
        raise CommError(f"invalid destination rank {dest} (size "
                        f"{world.size})")
    req = world.new_request(REQ_ISEND, rank, dest, tag, tuple(x.shape),
                            x.dtype)
    return list(_Isend.apply(x, ctx, req))


class _Irecv(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, req):
        return _make_descriptor(req), x, x

    @staticmethod
    def backward(fctx, g_desc, g_buf, g_loop):
        return g_buf + g_loop, None


def irecv(ctx: RankContext, x, source, tag: int) -> List:
    """Nonblocking receive into ``x``'s shape and dtype.  Returns the raw
    handle; the message is delivered at :func:`wait`.  Backward: zero
    gradient for the overwritten buffer; the received value's gradient is
    sent back to ``source`` by the Wait's backward."""
    world, rank = ctx.world, ctx.rank
    world.check_not_consumed(rank, x)
    _check_payload(ctx, x, "Irecv")
    _check_tag(tag)
    source = _resolve_peer(ctx, source, "source")
    if not 0 <= source < world.size:
        raise CommError(f"invalid source rank {source} (size "
                        f"{world.size})")
    req = world.new_request(REQ_IRECV, rank, source, tag, tuple(x.shape),
                            x.dtype)
    return list(_Irecv.apply(x, req))


class _Wait(torch.autograd.Function):
    @staticmethod
    def forward(fctx, d, b, l, rctx):
        world, rank = rctx.world, rctx.rank
        req_id, kind, peer, tag, fp = _decode_descriptor(d)
        req = world.complete_request(req_id, tuple(b.shape), b.dtype)
        if req.fingerprint != fp or req.kind != kind:
            raise BifurcationError(
                "Detected bifurcation in Wait handle usage: the descriptor's "
                "fingerprint does not match the posted request")
        fctx.rctx, fctx.kind, fctx.peer, fctx.tag = rctx, kind, peer, tag
        fctx.specs = [(t.shape, t.dtype, t.device) for t in (d, b, l)]
        if kind == REQ_ISEND:
            return l
        out = world.p2p_recv(peer, rank, tag)
        if tuple(out.shape) != tuple(b.shape) or out.dtype != b.dtype:
            raise CommError(
                f"Recv buffer (shape {tuple(b.shape)}, dtype {b.dtype}) "
                f"does not match the incoming message (shape "
                f"{tuple(out.shape)}, dtype {out.dtype}) (source {peer}, "
                f"tag {tag})")
        return out

    @staticmethod
    def backward(fctx, g):
        (sd, dd, vd), (sb, db, vb), (sl, dl, vl) = fctx.specs
        zero_d, zero_b = _zero_grad(sd, dd, vd), _zero_grad(sb, db, vb)
        if fctx.kind == REQ_ISEND:
            # The local contribution goes to the loop-through; the
            # matching Isend's backward adds the remote gradient.
            return zero_d, zero_b, g, None
        rctx = fctx.rctx
        rctx.world.p2p_send(rctx.rank, fctx.peer,
                            fctx.tag + GRAD_TAG_OFFSET, g)
        return zero_d, zero_b, _zero_grad(sl, dl, vl), None


def wait(ctx: RankContext, handle: List):
    """Complete a nonblocking request: checks the descriptor's
    fingerprint and that the request is completed exactly once (else
    :class:`~mpi4torch_tpu_torch.runtime.BifurcationError`), then returns
    the loop-through tensor of a send or the received message of a
    receive.  Backward: a receive's output gradient is sent back to the
    source on ``tag + 10``; a send's goes to its loop-through."""
    desc, buf, loop = handle
    return _Wait.apply(desc, buf, loop, ctx)
