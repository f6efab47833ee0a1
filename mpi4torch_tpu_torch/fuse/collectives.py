"""Fused bucketed tree collectives.

Port of the eager (rank-thread) path of
``mpi4torch_tpu/fuse/collectives.py``: one collective per *bucket*
instead of one per leaf.

* :func:`fused_allreduce_tree` — the DP primitive: one facade
  ``Allreduce`` per bucket (bit-identical to the per-leaf ascending-rank
  fold on the exact wire), or — with ``overlap=True`` — the
  :func:`_pipeline_allreduce` schedule of nonblocking per-bucket
  gather-fold collectives built from ``Isend``/``Irecv``/``Wait``, which
  issues bucket ``i+1``'s transfers before waiting on bucket ``i``.
* :func:`fused_reduce_scatter_tree` / :func:`fused_allgather_tree` — the
  ZeRO pair: block buckets whose row ``r`` concatenates every member
  leaf's ``r``-th padded segment, so one axis-0 ``Reduce_scatter`` or
  one ``Allgather`` moves every leaf's shard at once.

Bucketing is differentiable ``cat``/``split`` glue around the facade's
differentiable collectives, so the backward of a fused collective is
itself fused bucketed communication.  Compression composes per bucket:
``compression="q8"`` (or a compression scope) sends each float bucket
through the quantized ring of :mod:`mpi4torch_tpu_torch.compress`, whose
hops run on the CUDA kernel K1 for CUDA tensors, with the facade's
degrade/raise dtype rules applied per bucket.  A compressed bucket
quantizes other 256-element blocks than a compressed leaf does, so it is
the JAX package's fused form, not its per-leaf form, that it matches.

Under Mode A (``run_spmd``) :func:`fused_allreduce_tree` takes the JAX
package's SPMD form: outside deterministic mode an exact ring (or auto)
SUM bucket becomes the ``Reduce_scatter`` + ``Allgather`` pair, padded
to the rank count, with the mean applied once per bucket; every other
bucket is one ``Allreduce``; ``overlap`` truthy runs the split-phase
scheduler (:mod:`mpi4torch_tpu_torch.overlap`), its window widened on
a tier stack with a slow outer tier (``tier_window``).  With auto
selection each bucket takes the selector's pick for its own byte size,
so a small tail bucket can ride the latency algorithm while the body
buckets keep the ring pair or, past the bandwidth crossover, ``bidir``.

The finite guard (``config.comm_finite_guard``) runs on the pipeline's
per-peer contributions, as in the JAX package: each rank checks the list
it received, so a corrupt bucket is named by its sender.
"""

from __future__ import annotations

import collections
import math
from typing import Optional, Sequence

import torch

from .. import config as _config
from .. import constants as C
from ..resilience import guards as _guards
from ..runtime import CommError
from ..utils.profiling import bucket_scope
from ..utils.tree import tree_map
from .bucketing import (flatten_buckets, flatten_shard_buckets,
                        flatten_shard_rows, shard_layout,
                        unflatten_buckets, unflatten_gathered,
                        unflatten_shard_rows)

# Tag block reserved for the overlap pipeline: high enough to stay clear
# of user p2p tags; each bucket consumes a stride of
# (size + GRAD_TAG_OFFSET + 1) tags so a bucket's gradient tags
# (tag + 10, ops/eager.py) can never collide with another bucket's
# forward tags.
FUSE_TAG_BASE = 1 << 20


def _ring_table(n: int, k: int):
    """Send-permutation table of the ring shift ``+k`` on ``n`` ranks."""
    return tuple((r + k) % n for r in range(n))


def _resolve_bucket_bytes(bucket_bytes) -> int:
    if bucket_bytes is None:
        return _config.default_bucket_bytes()
    # Same validation as the config setters: a negative size is a caller
    # bug, not a request for the per-leaf path.
    return _config._validated_bucket_bytes(bucket_bytes)


def _plan_bucket(bucket, op: int, codec, algo, *, explicit: bool,
                 algo_explicit: bool, owns_resolution: bool, size: int,
                 mode_a: bool):
    """Per-bucket codec/algorithm resolution, shared by the blocking path
    and the overlap scheduler: the facade's per-tensor compression rules
    on this bucket's dtype (a scope default degrades non-float buckets
    and non-SUM ops to exact; an explicit codec on a non-float bucket
    raises), the codec/algorithm reconcile (explicit conflicts raise,
    scope halves yield), the backend's degrades for a default algorithm
    (a tier stack yields what it does not lower to its native schedule;
    a ``config.hier_group_size`` that does not split this world sends
    ``hier``/``torus`` to ``ring``), then under Mode A the selector's
    pick for this bucket's byte size on ``size`` ranks."""
    from ..comm import _codec_for, _reconcile_codec_algorithm

    bcodec = _codec_for(bucket, codec, explicit)
    if bcodec is not None and op != C.MPI_SUM and not explicit:
        bcodec = None
    bcodec, balgo = _reconcile_codec_algorithm(
        bcodec, algo, codec_explicit=explicit, algo_explicit=algo_explicit)
    if not algo_explicit:
        if owns_resolution:
            if balgo not in (None, "ring", "hier", "torus"):
                balgo = None
        elif balgo in ("hier", "torus"):
            from ..tune import resolve_hier_group
            try:
                resolve_hier_group(size)
            except CommError:
                balgo = "ring"
    if balgo is None and mode_a:
        from ..tune import select_auto
        balgo = select_auto(
            collective="allreduce",
            nbytes=bucket.numel() * bucket.element_size(),
            dtype=bucket.dtype, nranks=size,
            deterministic=_config.deterministic_reductions(), codec=bcodec)
    return bcodec, balgo


def _pipeline_allreduce(comm, buckets: Sequence, op: int, *,
                        depth: int = 2):
    """The overlap schedule: nonblocking per-bucket sum-allreduce.

    Each bucket's collective is the gather + ascending-rank-fold form
    posted through the ``WaitHandle`` machinery — ``size-1`` buffered
    ``Isend``/``Irecv`` pairs per bucket (payloads land in the
    destination mailboxes at once; nothing blocks until ``Wait``).  Up to
    ``depth`` buckets are in flight: bucket ``i+1``'s transfers are
    issued before bucket ``i``'s ``Wait``s, and ``JoinDummiesHandle``
    chains each bucket's receives onto the previous bucket's send
    descriptor so the issue order is explicit in the graph.  The fold is
    the rendezvous path's ascending-rank association, so the results are
    bit-identical to it (and to the per-leaf path).  The backward needs
    no extra code: the ``Isend``/``Irecv``/``Wait`` adjoints route each
    peer's cotangent back over ``tag + 10``."""
    from ..comm import JoinDummies, JoinDummiesHandle
    from ..ops.eager import GRAD_TAG_OFFSET

    if op != C.MPI_SUM:
        raise CommError(
            "the fused overlap pipeline supports MPI_SUM only; pass "
            "overlap=False (per-bucket rendezvous collectives) for other "
            "reductions")
    n, rank = comm.size, comm.rank
    nb = len(buckets)
    if n == 1 or nb == 0:
        return list(buckets)
    # Per-bucket tag block: n-1 forward tags plus their tag+10 gradient
    # shadow — the next bucket's block starts past both, so a slow rank's
    # forward receive can never swallow a fast rank's backward gradient.
    stride = n + GRAD_TAG_OFFSET + 1
    outs: list = [None] * nb
    pending: collections.deque = collections.deque()
    prev_send = [None]

    def start(i: int) -> None:
        b = buckets[i]
        tag0 = FUSE_TAG_BASE + i * stride
        sends, recvs = [], []
        for off in range(1, n):
            sends.append(comm.Isend(b, _ring_table(n, off), tag0 + off))
            recvs.append(comm.Irecv(b.new_zeros(b.shape),
                                    _ring_table(n, n - off), tag0 + off))
        # Chain every receive onto this bucket's sends (and the previous
        # bucket's last send, pinning issue order across buckets).  The
        # forward edge send -> recv-Wait is what keeps the backward free
        # of deadlock: it reverses into recvWait-bwd -> isend-bwd, so each
        # rank posts its (buffered) gradient sends before it blocks in an
        # Isend adjoint's gradient receive.
        dummies = [h.dummy for h in sends]
        if prev_send[0] is not None:
            dummies.append(prev_send[0].dummy)
        recvs = [JoinDummiesHandle(r, dummies) for r in recvs]
        prev_send[0] = sends[-1]
        pending.append((i, b, sends, recvs))

    def finish() -> None:
        i, b, sends, recvs = pending.popleft()
        vals: list = [None] * n
        vals[rank] = b
        for off, r in enumerate(recvs, start=1):
            vals[(rank - off) % n] = comm.Wait(r)
        _guards.check_contributions(vals, "Iallreduce_tree")
        out = C.reduce_ordered(op, vals)
        # Completing the sends through JoinDummies keeps every Isend on
        # the differentiation path even though its Wait output is a pure
        # dependency token — the backward's remote-gradient receives must
        # run on all ranks symmetrically.
        outs[i] = JoinDummies(out, [comm.Wait(h) for h in sends])

    for i in range(nb):
        with bucket_scope("Iallreduce_tree", i, nb):
            start(i)
        if len(pending) >= max(int(depth), 1):
            finish()
    while pending:
        finish()
    return outs


def fused_allreduce_tree(comm, tree, op: int = C.MPI_SUM, *,
                         compression=None, bucket_bytes=None,
                         mean: bool = False,
                         overlap: Optional[bool] = None, algorithm=None,
                         tier_window=None):
    """Allreduce every leaf of ``tree`` through dtype-homogeneous flat
    buckets — one collective per bucket instead of per leaf.

    ``bucket_bytes``: target bucket size (None → the ``fusion_scope`` /
    process default, 4 MiB; 0/False → per-leaf ops).  ``mean=True``
    divides each reduced bucket by ``comm.size`` once (MPI_SUM only).
    ``compression`` follows the facade's Allreduce contract, applied per
    bucket.  ``overlap``: None defers to the ``overlap_scope`` / process
    default; a truthy value switches to the nonblocking Isend/Irecv
    pipeline (:func:`_pipeline_allreduce`, exact MPI_SUM on the ring
    association only).  An explicit ``overlap=`` with a codec, another
    reduction or another algorithm raises; a scope default degrades to
    the blocking path.  ``algorithm`` follows the facade's Allreduce
    contract, applied per bucket: an explicit name pins every bucket;
    with auto selection each bucket takes the selector's pick for its
    byte size.  ``tier_window`` widens the split-phase window on a tier
    stack (:func:`~mpi4torch_tpu_torch.overlap.overlap_allreduce_tree`);
    ``None`` derives it from ``config.tier_bandwidths``
    (:func:`~mpi4torch_tpu_torch.overlap.tier_window_depth`)."""
    from ..comm import (_mesh_algorithm, _resolve_algorithm,
                        _resolve_compression)
    from ..overlap import overlap_depth, resolve_overlap

    if mean and op != C.MPI_SUM:
        raise CommError(
            f"mean=True is the rank-mean of an MPI_SUM reduction; got "
            f"{C.op_name(op)}")
    from ..ops.spmd import SpmdBackend

    bb = _resolve_bucket_bytes(bucket_bytes)
    size = comm.size
    explicit = compression is not None
    overlap_explicit = overlap is not None
    overlap = resolve_overlap(overlap)
    codec = _resolve_compression(compression)
    backend = comm._spmd()
    mode_a = isinstance(backend, SpmdBackend)
    algo_explicit = algorithm not in (None, False, "auto")
    owns_resolution = getattr(backend, "owns_algorithm_resolution", False)
    if owns_resolution:
        algo = _mesh_algorithm(algorithm)
    else:
        algo = _resolve_algorithm(algorithm, size)

    if overlap and backend is None:
        # The pipeline is exact-SUM on the ring association only.  An
        # explicit overlap= fails loudly on a conflict (a silent blocking
        # fallback would leave the caller believing they got the
        # nonblocking schedule); a scope/process default degrades.
        # Checked before the fusion-off return so the argument check
        # does not depend on the ambient fusion scope.
        if not overlap_explicit:
            if (op != C.MPI_SUM or codec is not None
                    or algo not in (None, "ring")):
                overlap = False
        else:
            if op != C.MPI_SUM:
                raise CommError(
                    "the fused overlap pipeline supports MPI_SUM only; "
                    "pass overlap=False (per-bucket rendezvous "
                    f"collectives) for {C.op_name(op)} reductions")
            if codec is not None:
                raise CommError(
                    "the fused overlap pipeline is exact-only; compressed "
                    f"buckets (codec {codec.name!r}"
                    + ("" if explicit else ", from the active "
                       "compression_scope/process default") +
                    ") take the per-bucket rendezvous path — pass "
                    "overlap=False, or compression=False to pipeline exact")
            if algo not in (None, "ring"):
                raise CommError(
                    "the fused overlap pipeline's gather-fold IS the ring "
                    f"association; algorithm={algo!r}"
                    + ("" if algorithm is not None else " (from the active "
                       "algorithm_scope/process default)") +
                    " cannot ride it — pass overlap=False for per-bucket "
                    "rendezvous collectives on that algorithm")

    if bb <= 0:
        out = tree_map(lambda p: comm.Allreduce(
            p, op, compression=compression, algorithm=algorithm), tree)
        if mean:
            out = tree_map(lambda p: C.divide(p, size), out)
        return out

    buckets, layout = flatten_buckets(tree, bb)
    nb = layout.num_buckets
    if backend is not None:
        return _mode_a_allreduce(comm, buckets, layout, op, codec, algo,
                                 explicit=explicit,
                                 algo_explicit=algo_explicit,
                                 owns_resolution=owns_resolution,
                                 mean=mean, overlap=overlap,
                                 size=size if mode_a else 0,
                                 tier_window=tier_window)

    if overlap:
        reduced = _pipeline_allreduce(comm, buckets, op,
                                      depth=overlap_depth(overlap))
        if mean:
            reduced = [C.divide(b, size) for b in reduced]
        return unflatten_buckets(reduced, layout)

    reduced = []
    for i, b in enumerate(buckets):
        bcodec, balgo = _plan_bucket(
            b, op, codec, algo, explicit=explicit,
            algo_explicit=algo_explicit, owns_resolution=False, size=size,
            mode_a=False)
        # Re-resolution guard: the degrade decision was made here, so the
        # facade gets the resolved codec, or False to pin exact
        # (compression=None would re-read the scope default and re-apply
        # a codec this bucket — or an explicit compression=False — just
        # opted out of).
        arg = bcodec if bcodec is not None else (
            False if (codec is not None or explicit) else None)
        with bucket_scope("Allreduce_tree", i, nb, codec=bcodec):
            out = comm.Allreduce(b, op, compression=arg, algorithm=balgo)
        reduced.append(C.divide(out, size) if mean else out)
    return unflatten_buckets(reduced, layout)


def _mode_a_allreduce(comm, buckets, layout, op: int, codec, algo, *,
                      explicit: bool, algo_explicit: bool,
                      owns_resolution: bool, mean: bool, overlap, size: int,
                      tier_window=None):
    """The SPMD form of the fused Allreduce.  ``size`` is the rank count
    on a single-axis communicator, 0 on a tier stack (whose buckets are
    each one Allreduce).  A compressed bucket is one Allreduce through the
    facade, which runs the compressed SPMD collective
    (``compress/spmd.py``)."""
    from ..overlap import (overlap_allreduce_tree, overlap_depth,
                           tier_window_depth)

    nb = len(buckets)
    n = comm.size

    def plan(i, b):
        return _plan_bucket(b, op, codec, algo, explicit=explicit,
                            algo_explicit=algo_explicit,
                            owns_resolution=owns_resolution,
                            size=n, mode_a=size > 0)

    if overlap:
        return overlap_allreduce_tree(
            comm, buckets, layout, op, depth=overlap_depth(overlap),
            mean=mean, plan=plan,
            tier_window=(tier_window_depth() if tier_window is None
                         else tier_window))
    # Phase 1: every bucket's reduction.  Exact SUM buckets outside
    # deterministic mode take the reduce-scatter half of the ring pair
    # (the all-gather half is phase 2); everything else is one Allreduce.
    use_pair = (size > 1 and op == C.MPI_SUM
                and not _config.deterministic_reductions())
    stage = []
    for i, b in enumerate(buckets):
        bcodec, balgo = plan(i, b)
        with bucket_scope("Allreduce_tree", i, nb, codec=bcodec):
            if bcodec is not None or not (use_pair
                                          and balgo in (None, "ring")):
                arg = bcodec if bcodec is not None else (
                    False if (codec is not None or explicit) else None)
                stage.append(("whole", i, comm.Allreduce(
                    b, op, compression=arg, algorithm=balgo), None))
            else:
                seg = -(-b.numel() // n)
                padded = b
                if seg * n != b.numel():
                    padded = torch.cat([b, b.new_zeros(seg * n
                                                       - b.numel())])
                stage.append(("part", i, comm.Reduce_scatter(
                    padded.reshape(n, seg), op, 0), b.numel()))
    # The JAX package ties each bucket's part to the next bucket's with an
    # optimization barrier, which only orders the compiler's schedule; on
    # eager rank threads the program order already is that order, so the
    # staging is the identity here.
    # Phase 2: all-gather the scattered parts, unpad, scale.
    reduced = [None] * nb
    for kind, i, val, nelem in stage:
        if kind == "part":
            with bucket_scope("Allreduce_tree", i, nb):
                val = comm.Allgather(val, 0, compression=False) \
                    .reshape(-1)[:nelem]
        reduced[i] = C.divide(val, n) if mean else val
    return unflatten_buckets(reduced, layout)


def fused_reduce_scatter_tree(comm, tree, op: int = C.MPI_SUM, *,
                              bucket_bytes=None, mean: bool = False,
                              overlap=None):
    """Reduce-scatter every leaf of ``tree`` in block buckets: returns
    the tree of this rank's flat per-leaf shards (length
    ``ceil(leaf.size / size)`` each, zero-padded — the ZeRO gradient
    representation of ``parallel/zero.py``), with one ``Reduce_scatter``
    per bucket.  ``mean=True`` divides each shard bucket by ``comm.size``
    once (MPI_SUM only).  Always exact.  ``overlap`` (None → the
    ``overlap_scope`` / process default) truthy runs the split-phase
    window (:func:`~mpi4torch_tpu_torch.overlap.
    overlap_reduce_scatter_tree`), bit-identical to the blocking form."""
    from ..overlap import (overlap_depth, overlap_reduce_scatter_tree,
                           resolve_overlap)

    if mean and op != C.MPI_SUM:
        raise CommError(
            f"mean=True is the rank-mean of an MPI_SUM reduction; got "
            f"{C.op_name(op)}")
    bb = _resolve_bucket_bytes(bucket_bytes)
    size = comm.size
    overlap = resolve_overlap(overlap)
    if bb <= 0:
        def per_leaf(g):
            flat = g.reshape(-1)
            per = -(-flat.shape[0] // size)
            pad = per * size - flat.shape[0]
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            rs = comm.Reduce_scatter(flat, op, 0)
            return C.divide(rs, size) if mean else rs
        return tree_map(per_leaf, tree)
    if overlap:
        return overlap_reduce_scatter_tree(
            comm, tree, op, bucket_bytes=bb, depth=overlap_depth(overlap),
            mean=mean)

    buckets, layout = flatten_shard_buckets(tree, size, bb)
    rows = []
    for i, b in enumerate(buckets):
        with bucket_scope("Reduce_scatter_tree", i, layout.num_buckets):
            row = comm.Reduce_scatter(b, op, 0).reshape(-1)
        rows.append(C.divide(row, size) if mean else row)
    return unflatten_shard_rows(rows, layout)


def fused_allgather_tree(comm, shard_tree, template, *, bucket_bytes=None,
                         overlap=None):
    """Gather a tree of flat per-leaf shards (the output shape of
    :func:`fused_reduce_scatter_tree` /
    :func:`~mpi4torch_tpu_torch.parallel.zero.zero3_shard_params`) back
    into full leaves shaped like ``template`` (a tree of tensors, or of
    anything with ``.shape`` and ``.dtype``), with one ``Allgather`` per
    bucket.  Differentiable: the adjoint is the fused per-bucket
    reduce-scatter of the cotangents (the ZeRO-3 wire pattern).  Always
    exact.  ``overlap`` (None → the ``overlap_scope`` / process default)
    truthy runs the double-buffered prefetch
    (:func:`~mpi4torch_tpu_torch.overlap.prefetch_allgather_tree`),
    bit-identical to the blocking form."""
    from ..overlap import (overlap_depth, prefetch_allgather_tree,
                           resolve_overlap)

    bb = _resolve_bucket_bytes(bucket_bytes)
    size = comm.size
    overlap = resolve_overlap(overlap)
    if bb <= 0:
        def per_leaf(shard, t):
            full = comm.Allgather(shard, 0, compression=False)
            return full[:math.prod(t.shape)].reshape(t.shape).to(t.dtype)
        return tree_map(per_leaf, shard_tree, template)
    if overlap:
        return prefetch_allgather_tree(
            comm, shard_tree, template, bucket_bytes=bb,
            depth=overlap_depth(overlap))

    layout = shard_layout(template, size, bb)
    rows = flatten_shard_rows(shard_tree, layout)
    blocks = []
    for i, row in enumerate(rows):
        with bucket_scope("Allgather_tree", i, layout.num_buckets):
            full = comm.Allgather(row, 0, compression=False)
        blocks.append(full.reshape(size, -1))
    out = unflatten_gathered(blocks, layout)
    return tree_map(lambda x, t: x.to(t.dtype), out, template)

