"""Pipeline parallelism: microbatch transport over Isend/Irecv/Wait.

Port of ``mpi4torch_tpu/parallel/pp.py`` on the rank-thread runtime:

* :func:`send_activation` / :func:`recv_activation` — one hop of the
  pipeline with the token discipline applied;
* :func:`pipeline_step` — GPipe fill-drain: stage ``r`` is rank ``r``,
  microbatches stream through on per-microbatch tags, the last stage
  computes the loss.  The differentiated output joins the send tokens,
  so the backward on every rank runs the mirror-image pipeline:
  cotangents travel rank ``r + 1 -> r`` on ``tag + 10`` (the adjoint
  sends of the differentiable Isend/Irecv/Wait) and each stage's
  parameters get their exact gradients;
* :func:`pipeline_step_interleaved` — interleaved virtual stages
  (Megatron-style), breadth-first;
* :func:`schedule_1f1b` and :func:`pipeline_step_1f1b` — the 1F1B
  (PipeDream-flush) schedule, at most ``min(size - rank, n_mb)``
  activation stashes per stage.

The interleaved and 1F1B schedules drive per-microbatch pullbacks by
hand: each microbatch's forward builds its own autograd graph from the
stage's parameter leaves, and its backward is ``torch.autograd.grad`` of
that graph with the received cotangent as ``grad_outputs``; activations
and cotangents move with plain ``Send``/``Recv`` (sends are buffered, so
they never block).  On more than one rank the loss comes back on every
rank as a float64 scalar, the total over microbatches ``Bcast_`` from
the last stage (the other stages cannot know the loss's dtype); on one
rank it keeps the loss's dtype.

:func:`pipeline_spmd` is the single-program GPipe of Mode A
(:func:`~mpi4torch_tpu_torch.ops.spmd.run_spmd`): one uniform program on
every rank, rank-dependent behaviour as masked selects on the symbolic
rank, one ring shift per step.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, List, Sequence

import torch

from ..comm import JoinDummies
from ..utils.tree import tree_leaves, tree_unflatten, value_and_grad


def send_activation(comm, x, dest: int, tag: int):
    """Ship activation ``x`` to the next stage; returns the dependency
    token that must be joined onto the rank's differentiated output (with
    ``JoinDummies``), which keeps the transfer on the backward path, where
    its adjoint receives the downstream cotangent."""
    return comm.Wait(comm.Isend(x, dest, tag))


def recv_activation(comm, like, source: int, tag: int, deps: Sequence = ()):
    """Receive an activation shaped and typed like ``like`` from the
    previous stage.  ``deps`` are joined onto the receive buffer; they
    must include something that depends on the differentiated parameters,
    or the receive is not on the backward path, its adjoint (which sends
    this activation's cotangent back to ``source``) never runs, and the
    peer's backward waits forever."""
    buf = torch.zeros_like(like)
    if deps:
        buf = JoinDummies(buf, list(deps))
    return comm.Recv(buf, source, tag)


def _zero_loss(params):
    leaf = tree_leaves(params)[0]
    return torch.zeros((), dtype=torch.float64, device=leaf.device)


def pipeline_step(comm, apply_stage: Callable[[Any, Any], Any], params,
                  microbatches: List, loss_fn: Callable[[Any, int], Any],
                  recv_like=None, tag: int = 0):
    """One training step of a GPipe fill-drain pipeline; returns
    ``(loss, grads)`` on every rank.

    ``apply_stage(params, x) -> y`` is this rank's stage with its
    ``params``; ``microbatches`` feed rank 0 (other ranks may pass the same
    list: only its length is read); ``loss_fn(y, i)`` reduces the last
    stage's output for microbatch ``i`` to a scalar; ``recv_like``, a
    tensor shaped like this rank's incoming activation, is required on
    ranks > 0.  ``loss`` is the total over microbatches, on every rank;
    ``grads`` the gradient of that total with respect to this rank's
    ``params``, produced by the reverse pipeline."""
    rank, size = int(comm.rank), comm.size
    n_mb = len(microbatches)
    if size == 1:
        def solo(p):
            return sum(loss_fn(apply_stage(p, mb), i)
                       for i, mb in enumerate(microbatches))
        return value_and_grad(solo, params)
    if rank > 0 and recv_like is None:
        raise ValueError("ranks > 0 need recv_like (incoming activation "
                         "shape/dtype)")

    def surrogate(p):
        tokens = []
        total = _zero_loss(p)
        # Ties every receive to the differentiated parameters, so the
        # reverse-pipeline sends run in this rank's backward.
        p_dep = tree_leaves(p)[0]
        for i in range(n_mb):
            t = tag + i
            if rank == 0:
                x = microbatches[i]
            else:
                x = recv_activation(comm, recv_like, rank - 1, t,
                                    deps=[p_dep] + tokens[-1:])
            y = apply_stage(p, x)
            if rank < size - 1:
                tokens.append(send_activation(comm, y, rank + 1, t))
            else:
                total = total + loss_fn(y, i)
        # Joining the send tokens keeps every transfer on a path from the
        # parameters to the output, or the backward would skip it.
        return JoinDummies(total, tokens) if tokens else total

    loss, grads = value_and_grad(surrogate, params)
    # Only the last stage holds the real loss.
    return comm.Bcast_(loss, size - 1), grads


def pipeline_spmd(comm, apply_stage: Callable[[Any, Any], Any],
                  stage_params, microbatches: List,
                  loss_fn: Callable[[Any, Any], Any]):
    """Single-program GPipe under :func:`~mpi4torch_tpu_torch.ops.spmd.
    run_spmd`: returns the total pipeline loss, the same on every rank.

    The fill-drain schedule of :func:`pipeline_step` as one uniform
    program: every rank holds its stage's params (``stage_params``, already
    this rank's, e.g. a stacked ``(size, ...)`` tree indexed by
    ``comm.rank``), activations advance one hop a step over the
    differentiable ring (one :func:`~.ring.ring_shift` a step, the only
    traffic), rank 0 injects the microbatches, and the last rank's masked
    contributions sum into the loss.  The JAX package's ``lax.scan`` of
    ``n_mb + size - 1`` steps is a Python loop here, with the same masked
    selects (``torch.where`` on the symbolic rank): every rank computes
    its stage once a step, masked lanes included, so each rank keeps
    ``n_mb + size - 1`` stage passes for autograd.

    ``loss_fn(y, i)`` receives the microbatch index as a 0-d int32
    tensor, as the JAX package passes a traced i32, so it must use ``i``
    arithmetically (a weight, a gather), not as a list index.  Gradients
    need no token plumbing: the ring's adjoint is the reverse ring.  Take
    them from outside ``run_spmd`` or with ``torch.autograd.grad`` inside
    the body."""
    from ..constants import MPI_SUM
    from .ring import ring_shift

    size = comm.size
    n_mb = len(microbatches)
    mbs = torch.stack(list(microbatches))               # (n_mb, ...)
    dev = mbs.device
    first = torch.as_tensor(comm.rank == 0, device=dev)
    last = torch.as_tensor(comm.rank == size - 1, device=dev)
    x = torch.zeros_like(mbs[0])
    total = torch.zeros((), dtype=torch.get_default_dtype(), device=dev)
    for step in range(n_mb + size - 1):
        x = torch.where(first & (step < n_mb), mbs[min(step, n_mb - 1)], x)
        y = apply_stage(stage_params, x)
        mb_idx = step - (size - 1)
        i = torch.full((), max(mb_idx, 0), dtype=torch.int32, device=dev)
        total = total + torch.where(last & (mb_idx >= 0), loss_fn(y, i),
                                    0.0)
        # The last step's shift carries no live data but keeps the body
        # uniform: one ring shift a step.
        x = ring_shift(comm, y, 1, tag=0)
    if size > 1:
        # compression=False: the loss total is internal (exact parity).
        total = comm.Allreduce(total, MPI_SUM, compression=False)
    return total


def _pullback(out, leaves, x, ct):
    """``(d params, d x)`` of one microbatch's stashed graph ``out`` with
    the cotangent ``ct`` (None: the scalar loss, seeded with 1).  ``x`` is
    the stage's received input (None on the first stage)."""
    inputs = list(leaves) + ([x] if x is not None else [])
    got = torch.autograd.grad(out, inputs, grad_outputs=ct,
                              allow_unused=True)
    got = [torch.zeros_like(t) if g is None else g
           for t, g in zip(inputs, got)]
    return got[:len(leaves)], (got[-1] if x is not None else None)


def _received(comm, like, source: int, tag: int):
    """A received activation as a leaf of this stage's graph."""
    return comm.Recv(torch.zeros_like(like), source, tag).requires_grad_()


def pipeline_step_interleaved(comm, apply_stage: Callable[[Any, Any], Any],
                              chunk_params: List, microbatches: List,
                              loss_fn: Callable[[Any, int], Any],
                              recv_like=None, tag: int = 0):
    """One training step with interleaved virtual pipeline stages: rank
    ``r`` owns ``v = len(chunk_params)`` chunks — global stage ``s`` of
    ``v * size`` lives on rank ``s % size``, chunk ``s // size``.  Returns
    ``(loss, grads)``, ``grads`` a list shaped like ``chunk_params``.

    The schedule is breadth-first (every microbatch clears stage ``s``
    before stage ``s + 1``), then every backward in exact reverse; each
    rank's fill idles one chunk, 1/v of a stage.  ``recv_like`` is
    required when ``size > 1``, and every chunk boundary keeps the
    activation's shape and dtype.  Forward messages of (microbatch ``i``,
    stage ``s``) travel on ``tag + s * n_mb + i``, their cotangents on
    ``tag + v * size * n_mb`` plus the same."""
    rank, size = int(comm.rank), comm.size
    v = len(chunk_params)
    n_mb = len(microbatches)
    n_stages = v * size
    if size == 1:
        def solo(ps):
            total = None
            for i, mb in enumerate(microbatches):
                x = mb
                for p in ps:
                    x = apply_stage(p, x)
                li = loss_fn(x, i)
                total = li if total is None else total + li
            return total
        return value_and_grad(solo, chunk_params)
    if recv_like is None:
        raise ValueError("size > 1 needs recv_like (stage boundary "
                         "activation shape/dtype)")

    bwd_base = tag + n_stages * n_mb
    last_stage = n_stages - 1
    leaves = [[t.detach().requires_grad_() for t in tree_leaves(p)]
              for p in chunk_params]
    trees = [tree_unflatten(p, lv) for p, lv in zip(chunk_params, leaves)]
    grads = [[torch.zeros_like(t) for t in lv] for lv in leaves]
    stash = {}                     # (i, chunk) -> (output, received input)
    total = _zero_loss(chunk_params)

    for s in range(n_stages):
        if s % size != rank:
            continue
        c = s // size
        for i in range(n_mb):
            x = microbatches[i] if s == 0 else _received(
                comm, recv_like, (s - 1) % size, tag + s * n_mb + i)
            if s == last_stage:
                out = loss_fn(apply_stage(trees[c], x), i)
                total = total + out.detach()
            else:
                out = apply_stage(trees[c], x)
                comm.Send(out.detach(), (s + 1) % size,
                          tag + (s + 1) * n_mb + i)
            stash[(i, c)] = (out, x if s > 0 else None)

    for s in reversed(range(n_stages)):
        if s % size != rank:
            continue
        c = s // size
        for i in reversed(range(n_mb)):
            out, x = stash.pop((i, c))
            ct = None if s == last_stage else comm.Recv(
                torch.zeros_like(out), (s + 1) % size,
                bwd_base + (s + 1) * n_mb + i)
            dp, dx = _pullback(out, leaves[c], x, ct)
            grads[c] = [g + d for g, d in zip(grads[c], dp)]
            if s > 0:
                comm.Send(dx, (s - 1) % size, bwd_base + s * n_mb + i)

    loss = comm.Bcast_(total, last_stage % size)
    return loss, [tree_unflatten(p, g) for p, g in zip(chunk_params, grads)]


def schedule_1f1b(rank: int, size: int, n_mb: int):
    """The 1F1B order for one stage: ``[("F", i) | ("B", i)]``.

    ``size - 1 - rank`` warmup forwards, then one-forward/one-backward
    pairs, then the backward drain.  At most ``min(size - rank, n_mb)``
    microbatches ever await their backward on this stage — the 1F1B memory
    bound (GPipe's is ``n_mb``)."""
    warmup = min(size - 1 - rank, n_mb)
    ops = [("F", i) for i in range(warmup)]
    for j in range(n_mb - warmup):
        ops.append(("F", warmup + j))
        ops.append(("B", j))
    for j in range(max(n_mb - warmup, 0), n_mb):
        ops.append(("B", j))
    return ops


def pipeline_step_1f1b(comm, apply_stage: Callable[[Any, Any], Any], params,
                       microbatches: List,
                       loss_fn: Callable[[Any, int], Any],
                       recv_like=None, tag: int = 0, overlap=None):
    """One training step of a 1F1B (PipeDream-flush) pipeline; returns
    ``(loss, grads)`` on every rank, with :func:`pipeline_step`'s contract
    (and the same numbers).  Each microbatch's backward runs as soon as
    its downstream cotangent can exist (:func:`schedule_1f1b`), so at most
    ``min(size - rank, n_mb)`` activation graphs are alive per stage.
    Activations travel on ``tag + i``, cotangents on ``tag + n_mb + i``.

    ``overlap`` (None: the :func:`~mpi4torch_tpu_torch.config.
    overlap_scope` / process default) truthy turns every stage-boundary
    send into an ``Isend`` whose ``Wait`` is deferred in a window of depth
    2 (or the given int).  Only the bookkeeping moves; the loss and the
    gradients are the same bits as the blocking schedule's."""
    rank, size = int(comm.rank), comm.size
    n_mb = len(microbatches)
    if size == 1:
        return pipeline_step(comm, apply_stage, params, microbatches,
                             loss_fn, tag=tag)
    if rank > 0 and recv_like is None:
        raise ValueError("ranks > 0 need recv_like (incoming activation "
                         "shape/dtype)")
    from ..overlap import overlap_depth, resolve_overlap
    overlap = resolve_overlap(overlap)
    depth = overlap_depth(overlap) if overlap else 0
    fwd_tag, bwd_tag = tag, tag + n_mb
    is_last = rank == size - 1

    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    tree = tree_unflatten(params, leaves)
    grads = [torch.zeros_like(t) for t in leaves]
    stash = collections.deque()       # (output, received input) per mb
    pending = collections.deque()     # deferred Waits of split-phase sends
    total = _zero_loss(params)

    def ship(x, dest, t):
        if not depth:
            comm.Send(x, dest, t)
            return
        pending.append(comm.Isend(x, dest, t))
        while len(pending) > depth:
            comm.Wait(pending.popleft())

    for op, i in schedule_1f1b(rank, size, n_mb):
        if op == "F":
            x = microbatches[i] if rank == 0 else _received(
                comm, recv_like, rank - 1, fwd_tag + i)
            if is_last:
                out = loss_fn(apply_stage(tree, x), i)
                total = total + out.detach()
            else:
                out = apply_stage(tree, x)
                ship(out.detach(), rank + 1, fwd_tag + i)
            stash.append((out, x if rank > 0 else None))
        else:
            out, x = stash.popleft()
            ct = None if is_last else comm.Recv(torch.zeros_like(out),
                                                rank + 1, bwd_tag + i)
            dp, dx = _pullback(out, leaves, x, ct)
            grads = [g + d for g, d in zip(grads, dp)]
            if rank > 0:
                ship(dx, rank - 1, bwd_tag + i)
    while pending:
        comm.Wait(pending.popleft())

    loss = comm.Bcast_(total, size - 1)
    return loss, tree_unflatten(params, grads)


__all__ = ["send_activation", "recv_activation", "pipeline_step",
           "pipeline_spmd", "pipeline_step_interleaved", "schedule_1f1b",
           "pipeline_step_1f1b"]
