"""Ragged (per-rank-varying) collectives over capacity-padded buffers.

Port of ``mpi4torch_tpu/ops/ragged.py`` without its paging helpers
(``block_gather``/``block_scatter`` come with the paged KV cache,
ROADMAP.md Queue 1 item 2).  The reference's Gather/Scatter/Alltoall
accept per-rank-varying segment sizes (MPI_Gatherv-style derived
datatypes); the JAX package expresses them as **capacity-padded buffers
+ validity counts + masks**, which carry exactly the information of
their MPI_*v counterparts — (payload, counts) in, (payload, counts) out.
They are built on the facade's dense collectives, so they are
differentiable: cotangents route back through the same exchange, and
padding slots never receive or leak gradient.

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


def ragged_alltoall(comm, x, send_counts) -> Tuple:
    """All-to-all with per-destination-varying segment sizes (the
    MPI_Alltoallv analogue).

    ``x``: ``(size, capacity, *feat)`` — row block ``i`` is destined for
    rank ``i``, of which the first ``send_counts[i]`` entries are valid.
    ``send_counts``: ``(size,)`` integers, each ``<= capacity``.

    Returns ``(recv, recv_counts)``: ``recv[s]`` is the block rank ``s``
    sent here (``(size, capacity, *feat)``), with invalid slots zeroed;
    ``recv_counts[s]`` its valid length.  Differentiable in ``x``; padding
    slots get zero gradient."""
    size = comm.size
    capacity = _validated_rowblock("ragged_alltoall", x, size)
    send_counts = _validated_counts_vector("ragged_alltoall send_counts",
                                           send_counts, size, capacity,
                                           x.device)
    xz = _masked(x, send_counts, capacity)
    # Gather sources along a fresh axis, keep my destination block:
    # (size, cap, *feat) -> my (1, size*cap, *feat), source-major.
    recv = comm.Alltoall(xz, gatheraxis=1, scatteraxis=0, numelem=1)
    recv = recv.reshape((size, capacity) + tuple(x.shape[2:]))
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
