"""The overlap scheduler: windowed split-phase bucket collectives.

Port of ``mpi4torch_tpu/overlap/scheduler.py``.  It consumes the bucket
layouts of :mod:`mpi4torch_tpu_torch.fuse` and replaces the blocking
per-bucket collectives with *start/wait pairs* held in a sliding window
of ``depth`` buckets: bucket ``i``'s collective starts as soon as its
flat buffer exists, and its Wait is issued only after bucket
``i + depth - 1``'s start, with every bucket's completion tied (through
:func:`~mpi4torch_tpu_torch.JoinDummiesHandle`) onto the youngest start.
The backward needs no extra scheduling: each phase is a differentiable
collective glued by ``JoinDummies``, so the adjoint is the same window
with the wait chain reversed.

* :func:`overlap_allreduce_tree` — the DP gradient primitive;
* :func:`overlap_reduce_scatter_tree` — the ZeRO-1/3 gradient shards;
* :func:`prefetch_allgather_tree` — the ZeRO-3 parameter prefetch;
* :func:`overlap_split_allreduce` — one payload as a window of chunks,
  the serving decode collective.

On the rank threads every start runs its collective at once (see
:mod:`mpi4torch_tpu_torch.overlap`), so each of these gives the same
bits as its blocking form.  A bucket whose resolved codec cannot split
takes the blocking compressed path at its start slot.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..constants import divide
from ..utils.profiling import bucket_scope
from ..utils.tree import tree_map


def _windowed(nb: int, depth: int, start, finish) -> None:
    """Run ``start(i)`` / ``finish(i)`` over ``nb`` buckets with up to
    ``depth`` starts ahead of the oldest unfinished bucket."""
    depth = max(int(depth), 1)
    for i in range(nb):
        start(i)
        j = i - (depth - 1)
        if j >= 0:
            finish(j)
    for j in range(max(nb - depth + 1, 0), nb):
        finish(j)


class _Window:
    """Shared start/wait bookkeeping: handles per bucket, plus the
    youngest started handle so each Wait can be order-tied after it.
    ``label_base``/``label_total`` offset the bucket span labels when
    several windows run in one step (one per decode collective site)."""

    def __init__(self, comm, op: str, nb: int, label_base: int = 0,
                 label_total: int = None):
        self.comm = comm
        self.op = op
        self.label_base = label_base
        self.label_total = nb if label_total is None else label_total
        self.handles = {}
        self.results = [None] * nb
        self.youngest = None

    def started(self, i: int, handle) -> None:
        self.handles[i] = handle
        self.youngest = handle

    def finish(self, i: int) -> None:
        h = self.handles.pop(i, None)
        if h is None:
            return  # blocking bucket (codec path): completed at start
        if self.youngest is not None and self.youngest is not h:
            # Pin the window: bucket i's completion follows the youngest
            # start (and, reversed in the backward, orders that chain).
            from ..comm import JoinDummiesHandle
            h = JoinDummiesHandle(h, [self.youngest.dummy])
        with bucket_scope(self.op, self.label_base + i, self.label_total,
                          phase="wait"):
            self.results[i] = self.comm.Wait(h)


def overlap_split_allreduce(comm, x, op: int, *, nsplits: int = 2,
                            index_base: int = 0, index_total: int = None,
                            op_name: str = "Allreduce_split",
                            algorithm=None):
    """Split-phase allreduce of one payload as ``nsplits`` windowed chunk
    buckets — the decode-collective primitive of
    :mod:`mpi4torch_tpu_torch.serve`.  Every chunk's collective starts
    before any is waited on.  An elementwise SUM is unchanged by
    chunking, so the result is bitwise the blocking ``comm.Allreduce``.
    ``index_base``/``index_total`` make this call's span labels unique
    when several sites run in one step; ``algorithm`` follows the
    ``Allreduce`` contract per chunk.  Exact (a codec scope degrades)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    nsplits = max(min(int(nsplits), max(n, 1)), 1)
    bounds = [n * i // nsplits for i in range(nsplits + 1)]
    chunks = [flat[bounds[i]:bounds[i + 1]] for i in range(nsplits)]
    total = nsplits if index_total is None else index_total
    win = _Window(comm, op_name, nsplits, label_base=index_base,
                  label_total=total)

    def start(i):
        with bucket_scope(op_name, index_base + i, total, phase="start"):
            win.started(i, comm.Allreduce_start(
                chunks[i], op, compression=False, algorithm=algorithm))

    # Full-depth window: all starts issued, then the waits.
    _windowed(nsplits, nsplits, start, win.finish)
    return torch.cat(win.results).reshape(x.shape)


def overlap_allreduce_tree(comm, buckets: Sequence, layout, op: int, *,
                           depth: int = 2, mean: bool = False, plan=None,
                           tier_window=None):
    """Windowed split-phase allreduce over pre-flattened buckets.
    ``plan(i, bucket) -> (codec, algorithm)`` is the per-bucket
    resolution of the fused tree path; compressed buckets take the
    blocking codec pipeline in their start slot, exact buckets ride
    start/wait pairs.  Returns the reduced tree (``mean`` folds the
    rank-mean into one post-wait scale per bucket).

    ``tier_window`` is the tier-stack widening (a slow outer tier keeps a
    bucket's collective in flight for longer): a truthy value widens the
    window to ``min(tier_window, nb)`` buckets, never below ``depth``."""
    from ..fuse.bucketing import unflatten_buckets

    nb = len(buckets)
    if tier_window:
        depth = max(int(depth), min(int(tier_window), nb))
    size = comm.size
    win = _Window(comm, "Allreduce_tree", nb)

    def start(i):
        b = buckets[i]
        bcodec, balgo = plan(i, b) if plan is not None else (None, None)
        if bcodec is not None:
            with bucket_scope("Allreduce_tree", i, nb, codec=bcodec):
                win.results[i] = comm.Allreduce(b, op, compression=bcodec,
                                                algorithm=balgo)
            return
        with bucket_scope("Allreduce_tree", i, nb, phase="start"):
            win.started(i, comm.Allreduce_start(b, op, compression=False,
                                                algorithm=balgo))

    _windowed(nb, depth, start, win.finish)
    reduced = [divide(r, size) if mean else r for r in win.results]
    return unflatten_buckets(reduced, layout)


def overlap_reduce_scatter_tree(comm, tree, op: int, *, bucket_bytes: int,
                                depth: int = 2, mean: bool = False):
    """Windowed split-phase block-bucket reduce-scatter — the ZeRO
    gradient sharding of :func:`~mpi4torch_tpu_torch.fuse.
    fused_reduce_scatter_tree` with up to ``depth`` reduce-scatters in
    flight.  Exact; bit-identical to the blocking form."""
    from ..fuse.bucketing import flatten_shard_buckets, unflatten_shard_rows

    size = comm.size
    buckets, layout = flatten_shard_buckets(tree, size, bucket_bytes)
    nb = layout.num_buckets
    win = _Window(comm, "Reduce_scatter_tree", nb)

    def start(i):
        with bucket_scope("Reduce_scatter_tree", i, nb, phase="start"):
            win.started(i, comm.Reduce_scatter_start(buckets[i], op, 0))

    _windowed(nb, depth, start, win.finish)
    rows = [divide(r.reshape(-1), size) if mean else r.reshape(-1)
            for r in win.results]
    return unflatten_shard_rows(rows, layout)


def prefetch_allgather_tree(comm, shard_tree, template, *,
                            bucket_bytes: int, depth: int = 2):
    """Double-buffered ZeRO-3 parameter all-gather prefetch: bucket
    ``k+1``'s ``Allgather_start`` is issued before bucket ``k``'s Wait.
    The adjoint is the same window of reduce-scatters in reverse.  Exact;
    bit-identical to the blocking :func:`~mpi4torch_tpu_torch.fuse.
    fused_allgather_tree`."""
    from ..fuse.bucketing import (flatten_shard_rows, shard_layout,
                                  unflatten_gathered)

    size = comm.size
    layout = shard_layout(template, size, bucket_bytes)
    rows = flatten_shard_rows(shard_tree, layout)
    nb = layout.num_buckets
    win = _Window(comm, "Allgather_tree", nb)

    def start(i):
        with bucket_scope("Allgather_tree", i, nb, phase="start"):
            win.started(i, comm.Allgather_start(rows[i], 0))

    _windowed(nb, depth, start, win.finish)
    blocks = [full.reshape(size, -1) for full in win.results]
    out = unflatten_gathered(blocks, layout)
    return tree_map(lambda x, t: x.to(t.dtype), out, template)
