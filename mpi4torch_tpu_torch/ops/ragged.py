"""Ragged (per-rank-varying) collectives over capacity-padded buffers.

Port of ``mpi4torch_tpu/ops/ragged.py``, with the paged KV cache's two
device primitives :func:`block_gather` and :func:`block_scatter`.  The
reference's Gather/Scatter/Alltoall accept per-rank-varying segment
sizes (MPI_Gatherv-style derived datatypes); the JAX package expresses
them as **capacity-padded buffers + validity counts + masks**, which
carry exactly the information of their MPI_*v counterparts — (payload,
counts) in, (payload, counts) out.  They are built on the facade's
dense collectives, so they are differentiable: cotangents route back
through the same exchange, and padding slots never receive or leak
gradient.

:func:`position_onehot` is the per-slot KV-cache write mask of the
continuous-batching decode step.
"""

from __future__ import annotations

from typing import Tuple

import torch


def segment_mask(counts, capacity: int):
    """``(...,)`` (or scalar) int counts → ``(..., capacity)`` validity
    mask of 0/1 int32 (a scalar count yields a ``(capacity,)`` mask)."""
    counts = torch.as_tensor(counts)
    pos = torch.arange(capacity, device=counts.device)
    return (pos < counts[..., None]).to(torch.int32)


def position_onehot(pos, capacity: int):
    """``(...,)`` (or scalar) int positions → ``(..., capacity)`` one-hot
    0/1 int32 mask selecting exactly slot ``pos``.  An out-of-range
    position gives an all-zero row (no write)."""
    pos = torch.as_tensor(pos)
    p = torch.arange(capacity, device=pos.device)
    return (p == pos[..., None]).to(torch.int32)


def block_gather(pool, table):
    """Gather of a paged KV pool through a block table.

    ``pool``: ``(num_blocks, block_size, *feat)``, the page pool (one
    block-id space shared by every layer).  ``table``: ``(rows, n_blk)``
    int block ids, ``-1`` (any negative) marking an unmapped entry.
    Returns ``(rows, n_blk * block_size, *feat)``: each row's pages
    concatenated in table order, unmapped entries as all-zero pages (the
    inert tail behind the serving decode's per-row causal frontier).
    Values move by one gather (ids clamped into the pool, then the
    unmapped pages zeroed by ``where``), so mapped pages come back
    bit-identical in ``pool``'s dtype, as in the JAX package."""
    if pool.dim() < 2:
        raise ValueError(
            f"block_gather expects pool of shape (num_blocks, "
            f"block_size, *feat); got {tuple(pool.shape)}")
    t = torch.as_tensor(table, device=pool.device).to(torch.int64)
    if t.dim() != 2:
        raise ValueError(
            f"block_gather expects a (rows, n_blk) table; got shape "
            f"{tuple(t.shape)}")
    nb, bs = pool.shape[0], pool.shape[1]
    g = pool[t.clamp(0, nb - 1)]                  # (rows, n_blk, bs, *f)
    valid = (t >= 0).reshape(t.shape + (1,) * (g.dim() - 2))
    g = torch.where(valid, g, torch.zeros((), dtype=pool.dtype,
                                          device=pool.device))
    return g.reshape((t.shape[0], t.shape[1] * bs) + tuple(pool.shape[2:]))


def block_scatter(pool, block_ids, offsets, values, active=None):
    """Write one row per writer into a paged pool, in place; returns
    ``pool``.  The JAX package's semantics in another form.

    ``pool``: ``(num_blocks, block_size, *feat)``.  ``block_ids`` /
    ``offsets``: ``(writers,)`` ints — writer ``w`` writes ``values[w]``
    (``(writers, *feat)``, cast to ``pool``'s dtype) into
    ``pool[block_ids[w], offsets[w]]``.  ``active`` (``(writers,)``
    bool/int, optional) masks writers out; out-of-range ids or offsets
    (the engine's ``-1`` free-slot convention among them) write nothing.
    Writers must target distinct cells (the copy-on-write rule of
    ``serve/paging.py``); under it the result is exact and deterministic.

    The JAX package writes the pool as a one-hot ``where`` over every page
    (its arrays are immutable); that would rewrite the whole pool on every
    layer and every decode step, so the port writes the live cells in
    place with one ``index_put_``, as its dense KV cache is updated in
    place.  Which writers are live is decided on the host: pass the ids,
    offsets and ``active`` as host arrays (numpy or CPU tensors), as the
    engine does, and no device value is read back."""
    if pool.dim() < 2:
        raise ValueError(
            f"block_scatter expects pool of shape (num_blocks, "
            f"block_size, *feat); got {tuple(pool.shape)}")
    if tuple(values.shape[1:]) != tuple(pool.shape[2:]):
        raise ValueError(
            f"block_scatter values feature shape {tuple(values.shape[1:])} "
            f"must match pool feature shape {tuple(pool.shape[2:])}")
    return write_cells(pool, live_cells(block_ids, offsets, pool, active),
                       values)


def live_cells(block_ids, offsets, pool, active=None):
    """The live writers of a :func:`block_scatter` into ``pool``, picked
    on the host: ``(writer rows, block ids, offsets)`` as int64 tensors on
    ``pool``'s device, or None when no writer is live.  A caller that
    writes the same cells into several pools (every layer's K and V of a
    decode step) picks them once and passes them to :func:`write_cells`
    for each."""
    nb, bs = pool.shape[0], pool.shape[1]
    b = torch.as_tensor(block_ids).to("cpu", torch.int64)
    o = torch.as_tensor(offsets).to("cpu", torch.int64)
    live = (b >= 0) & (b < nb) & (o >= 0) & (o < bs)
    if active is not None:
        live &= torch.as_tensor(active).to("cpu", torch.bool)
    rows = torch.nonzero(live).flatten()
    if not rows.numel():
        return None
    return rows.to(pool.device), b[rows].to(pool.device), \
        o[rows].to(pool.device)


def write_cells(pool, cells, values):
    """Write ``values`` (``(writers, *feat)``) of the writers
    :func:`live_cells` picked into their cells of ``pool``, in place with
    one ``index_put_``; returns ``pool``."""
    if cells is not None:
        rows, b, o = cells
        pool.index_put_((b, o), values[rows].to(pool.dtype))
    return pool


def _masked(x, counts, capacity: int):
    m = segment_mask(counts, capacity)
    m = m.reshape(m.shape + (1,) * (x.dim() - m.dim()))
    # where, not multiply: padding slots may hold NaN/inf and NaN * 0
    # would survive as NaN.
    return torch.where(m != 0, x, torch.zeros((), dtype=x.dtype,
                                              device=x.device))


def _validated_rowblock(opname: str, x, size: int) -> int:
    """Check a ``(size, capacity, *feat)`` per-destination block; return
    the capacity."""
    if x.dim() < 2 or x.shape[0] != size:
        raise ValueError(
            f"{opname} expects x of shape (size={size}, capacity, *feat); "
            f"got {tuple(x.shape)}")
    return x.shape[1]


def _validated_counts_vector(opname: str, counts, size: int, capacity: int,
                             device):
    """Check a ``(size,)`` counts vector; clamp to [0, capacity] so the
    transmitted counts always agree with what the mask lets through."""
    counts = torch.as_tensor(counts, device=device)
    if tuple(counts.shape) != (size,):
        raise ValueError(
            f"{opname}: counts must have shape ({size},); got "
            f"{tuple(counts.shape)}")
    return counts.clamp(0, capacity)


def _validated_scalar_count(opname: str, x, count):
    """Check a ``(capacity, *feat)`` payload + scalar count; return
    ``(capacity, clamped count)``."""
    if x.dim() < 1:
        raise ValueError(
            f"{opname} expects x of shape (capacity, *feat); got "
            f"{tuple(x.shape)}")
    capacity = x.shape[0]
    count = torch.as_tensor(count, device=x.device)
    if count.dim() != 0:
        raise ValueError(
            f"{opname}: count must be a scalar (this rank's valid length); "
            f"got shape {tuple(count.shape)} — per-destination counts "
            "belong to ragged_alltoall")
    return capacity, count.clamp(0, capacity)


def ragged_alltoall(comm, x, send_counts, recv_counts=None) -> Tuple:
    """All-to-all with per-destination-varying segment sizes (the
    MPI_Alltoallv analogue).

    ``x``: ``(size, capacity, *feat)`` — row block ``i`` is destined for
    rank ``i``, of which the first ``send_counts[i]`` entries are valid.
    ``send_counts``: ``(size,)`` integers, each ``<= capacity``.

    Returns ``(recv, recv_counts)``: ``recv[s]`` is the block rank ``s``
    sent here (``(size, capacity, *feat)``), with invalid slots zeroed;
    ``recv_counts[s]`` its valid length.  Differentiable in ``x``; padding
    slots get zero gradient.  A caller that already knows what every rank
    sends here (the MoE dispatch, which exchanged its counts to size
    ``capacity``) passes ``recv_counts``, and vouches that ``x``'s slots
    past ``send_counts`` hold zeros and that its receivers read no slot
    past ``recv_counts``: the counts' own exchange and the masking copy
    are then left out, and the padding carries its zeros both ways."""
    size = comm.size
    capacity = _validated_rowblock("ragged_alltoall", x, size)
    send_counts = _validated_counts_vector("ragged_alltoall send_counts",
                                           send_counts, size, capacity,
                                           x.device)
    xz = x if recv_counts is not None else _masked(x, send_counts,
                                                     capacity)
    # Gather sources along a fresh axis, keep my destination block:
    # (size, cap, *feat) -> my (1, size*cap, *feat), source-major.
    recv = comm.Alltoall(xz, gatheraxis=1, scatteraxis=0, numelem=1)
    recv = recv.reshape((size, capacity) + tuple(x.shape[2:]))
    if recv_counts is not None:
        return recv, _validated_counts_vector(
            "ragged_alltoall recv_counts", recv_counts, size, capacity,
            x.device)
    rc = comm.Alltoall(send_counts.reshape(size, 1), gatheraxis=1,
                       scatteraxis=0, numelem=1)
    return recv, rc.reshape(size)


def ragged_allgather(comm, x, count) -> Tuple:
    """Allgather with per-rank-varying valid lengths (the MPI_Allgatherv
    analogue).

    ``x``: ``(capacity, *feat)`` with the first ``count`` rows valid.
    Returns ``(gathered, counts)``: ``gathered`` is ``(size, capacity,
    *feat)`` — rank ``s``'s padded block at index ``s``, invalid slots
    zeroed — and ``counts`` is ``(size,)``."""
    capacity, count = _validated_scalar_count("ragged_allgather", x, count)
    xz = _masked(x, count, capacity)
    # compression=False: ragged reassembly slices exact padded values; a
    # scope-level codec must not quantize them.
    gathered = comm.Allgather(xz[None], gatheraxis=0, compression=False)
    counts = comm.Allgather(count[None], gatheraxis=0)
    return gathered, counts


def ragged_gather(comm, x, count, root: int = 0) -> Tuple:
    """Gather-to-root with per-rank-varying valid lengths (the MPI_Gatherv
    analogue).

    ``x``: ``(capacity, *feat)`` with the first ``count`` rows valid.
    Returns ``(gathered, counts)``: on the root, ``gathered`` is ``(size,
    capacity, *feat)`` — rank ``s``'s padded block at index ``s``,
    invalid slots zeroed — and ``counts`` is ``(size,)``; on non-roots
    both are zeros of the same shapes.  Differentiable in ``x``: the
    adjoint routes cotangents back through the scatter, and padding slots
    get zero gradient."""
    capacity, count = _validated_scalar_count("ragged_gather", x, count)
    xz = _masked(x, count, capacity)
    gathered = comm.Gather(xz[None], gatheraxis=0, root=root)
    counts = comm.Gather(count[None], gatheraxis=0, root=root)
    return gathered, counts


def ragged_scatter(comm, x, counts, root: int = 0) -> Tuple:
    """Scatter-from-root with per-receiver-varying valid lengths (the
    MPI_Scatterv analogue).

    ``x`` (meaningful on the root): ``(size, capacity, *feat)`` — row
    block ``i`` goes to rank ``i``.  ``counts`` (meaningful on the root):
    ``(size,)`` valid lengths, one per receiver; non-root values are
    ignored and learned from the root.  Returns ``(recv, my_count)``:
    this rank's ``(capacity, *feat)`` block with slots beyond
    ``my_count`` zeroed.  Inverse of :func:`ragged_gather` on the valid
    prefixes.  Differentiable in ``x``; padding slots never leak
    gradient."""
    size = comm.size
    capacity = _validated_rowblock("ragged_scatter", x, size)
    counts = _validated_counts_vector("ragged_scatter", counts, size,
                                      capacity, x.device)
    # Receivers learn their count from the root: the whole counts row
    # rides one small Bcast_ (int32 on the wire only; my_count comes back
    # in the caller's count dtype).
    wire = comm.Bcast_(counts.to(torch.int32), root=root)
    my_count = wire[comm.rank].to(counts.dtype)
    recv = comm.Scatter(x, scatteraxis=0, numelem=1, root=root)
    recv = recv.reshape((capacity,) + tuple(x.shape[2:]))
    return _masked(recv, my_count, capacity), my_count
