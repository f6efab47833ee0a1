"""Long-context attention: ring attention (context parallel), its zigzag
load-balanced layout, and Ulysses (sequence parallel).

Port of ``mpi4torch_tpu/parallel/attention.py``.  Both algorithms are
built from the communicator's op surface alone: the differentiable
Isend/Irecv ring (:func:`~mpi4torch_tpu_torch.parallel.ring.ring_shift`)
carries K/V blocks around the ring, and the axis-generic ``Alltoall``
with ``gatheraxis != scatteraxis`` is the Ulysses head<->sequence
reshuffle.  Gradients ride the adjoint transport automatically.

Conventions: tensors are ``(batch, seq, heads, head_dim)``; each rank
holds a contiguous equal shard of the sequence axis in rank order (or
the zigzag shard, for :func:`zigzag_ring_attention`).  The per-block
compute is :func:`~mpi4torch_tpu_torch.ops.flash.flash_block_attention`:
on a CUDA tensor the hand-written kernels (forward K2, backward K3/K4),
on a CPU tensor their plain versions.  Rank threads share one CUDA
stream, so issuing the next ring hop before a block's compute keeps the
JAX package's program order but buys no overlap on one card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.flash import NEG_BIG, flash_attention, flash_block_attention, \
    merge_partials
from .ring import ring_shift


def dense_attention(q, k, v, causal: bool = False, q_offset: int = 0,
                    kv_offset: int = 0):
    """Reference single-device scaled-dot-product attention in the input
    dtype: the test oracle.  ``q_offset``/``kv_offset`` are the global
    positions of the first query / key, so shards of a longer sequence
    mask correctly.  ``k``/``v`` carry as many heads as ``q``."""
    dtype = q.dtype
    scale = 1.0 / torch.sqrt(torch.tensor(q.shape[-1], dtype=dtype,
                                          device=q.device))
    scores = torch.einsum("bqhd,bkhd->bqhk", q, k) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        kv_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
        bias = torch.where(mask, torch.zeros((), dtype=dtype,
                                             device=q.device),
                           torch.full((), NEG_BIG, dtype=dtype,
                                      device=q.device))
        scores = scores + bias[:, None, :]
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bqhk,bkhd->bqhd", probs, v)


def ring_attention(comm, q, k, v, causal: bool = False, tag: int = 0,
                   impl: str = "auto", window: int = 0):
    """Blockwise ring attention over the sequence axis (context parallel).

    Each rank holds one sequence block of q/k/v.  K/V blocks circulate the
    ring; the local result accumulates by merging normalised block
    partials (:func:`~mpi4torch_tpu_torch.ops.flash.merge_partials`), so
    it equals dense attention over the full sequence while no rank holds
    more than two K/V blocks.  Gradients ride the reverse ring.

    With a causal sliding ``window`` the loop stops after the last
    rotation that can deliver a visible key, ``min(size, ceil((window -
    1) / s_local) + 1)`` steps, identically on every rank.  Step ``s``
    issues the next block's hops (tags ``tag + 2*s`` for K and ``tag +
    2*s + 1`` for V) before computing its own block."""
    size = comm.size
    s_local = q.shape[1]
    my_rank = comm.rank
    q_off = my_rank * s_local
    if causal and window:
        n_steps = min(size, -(-(window - 1) // s_local) + 1)
    else:
        n_steps = size

    out = lse = None
    for step in range(n_steps):
        if step + 1 < n_steps:
            k_next = ring_shift(comm, k, 1, tag + 2 * step)
            v_next = ring_shift(comm, v, 1, tag + 2 * step + 1)
        # After `step` +1-shifts the local K/V block came from rank
        # (my_rank - step) % size.
        owner = (my_rank - step) % size
        o_b, lse_b = flash_block_attention(
            q, k, v, causal=causal, q_offset=q_off,
            kv_offset=owner * s_local, impl=impl, window=window)
        if out is None:
            out, lse = o_b, lse_b
        else:
            out, lse = merge_partials(out, lse, o_b, lse_b)
        if step + 1 < n_steps:
            k, v = k_next, v_next
    return out


def zigzag_positions(size: int, s_local: int):
    """Global positions of rank ``r``'s zigzag shard, as a numpy index
    array of shape ``(size, s_local)``: chunk ``r`` followed by the
    mirror chunk ``2*size - 1 - r``.  ``np.concatenate`` of the rows in
    rank order is the permutation that re-assembles the global sequence
    from stacked per-rank outputs."""
    c = s_local // 2
    return np.stack([
        np.concatenate([np.arange(r * c, (r + 1) * c),
                        np.arange((2 * size - 1 - r) * c,
                                  (2 * size - r) * c)])
        for r in range(size)])


def zigzag_slice(comm, x, axis: int = 1):
    """This rank's zigzag shard of a replicated global-sequence tensor:
    chunk ``rank`` and chunk ``2*size - 1 - rank`` of ``2*size`` equal
    chunks along ``axis``, concatenated."""
    size = comm.size
    s_global = x.shape[axis]
    if s_global % (2 * size) != 0:
        raise ValueError(
            f"zigzag layout needs the sequence ({s_global}) divisible "
            f"into 2*size ({2 * size}) equal chunks")
    c = s_global // (2 * size)
    r = comm.rank
    lo = x.narrow(axis, r * c, c)
    hi = x.narrow(axis, (2 * size - 1 - r) * c, c)
    return torch.cat([lo, hi], dim=axis)


def zigzag_ring_attention(comm, q, k, v, tag: int = 0, impl: str = "auto"):
    """Load-balanced causal ring attention (the zigzag layout).

    Rank ``r`` owns global chunk ``r`` and the mirror chunk ``2*size - 1
    - r`` (each ``s_local / 2`` long), so every rank's visible-key total
    is the same.  Inputs are the per-rank zigzag shards
    (:func:`zigzag_slice`); the output is in the same layout.  K/V
    circulate the differentiable ring as in :func:`ring_attention`; each
    arriving block contributes up to three live (q-half, kv-half) pairs —
    the lo-query / hi-key pair is always wholly in the future and is
    skipped statically (no launch)."""
    size = comm.size
    s_local = q.shape[1]
    if s_local % 2:
        raise ValueError(
            f"zigzag shards hold two equal chunks; got odd s_local "
            f"{s_local}")
    c = s_local // 2
    my_rank = comm.rank
    q_halves = (q[:, :c], q[:, c:])

    def offs(owner):
        return (owner * c, (2 * size - 1 - owner) * c)

    q_offs = offs(my_rank)
    acc = [None, None]   # (out, lse) per q half
    for step in range(size):
        if step + 1 < size:
            k_next = ring_shift(comm, k, 1, tag + 2 * step)
            v_next = ring_shift(comm, v, 1, tag + 2 * step + 1)
        owner = (my_rank - step) % size
        kv_offs = offs(owner)
        kv_halves = ((k[:, :c], v[:, :c]), (k[:, c:], v[:, c:]))
        for qi in range(2):
            for ki in range(2):
                if qi == 0 and ki == 1:
                    # lo queries (< size*c) never see hi keys (>= size*c).
                    continue
                kb, vb = kv_halves[ki]
                o_b, lse_b = flash_block_attention(
                    q_halves[qi], kb, vb, causal=True,
                    q_offset=q_offs[qi], kv_offset=kv_offs[ki], impl=impl)
                if acc[qi] is None:
                    acc[qi] = (o_b, lse_b)
                else:
                    acc[qi] = merge_partials(*acc[qi], o_b, lse_b)
        if step + 1 < size:
            k, v = k_next, v_next
    return torch.cat([acc[0][0], acc[1][0]], dim=1)


def ulysses_attention(comm, q, k, v, causal: bool = False,
                      impl: str = "auto", window: int = 0):
    """Ulysses sequence parallelism: each rank trades its sequence shard
    of all heads for the full sequence of ``heads / size`` heads (one
    ``Alltoall`` per tensor), runs attention on its head group
    (:func:`~mpi4torch_tpu_torch.ops.flash.flash_attention`), and
    reshuffles back.  Both the q head count and the KV head count must
    divide by the communicator size, so each rank keeps whole q-head
    groups with their shared KV heads."""
    size = comm.size
    b, s_local, h, d = q.shape
    h_kv = k.shape[2]
    if h % size != 0 or h_kv % size != 0:
        raise ValueError(
            f"ulysses_attention needs q heads ({h}) and KV heads "
            f"({h_kv}) divisible by the communicator size ({size})")

    def to_heads(x):
        # (b, s_local, nh, d) -> (b, s_global, nh/size, d)
        return comm.Alltoall(x, gatheraxis=1, scatteraxis=2,
                             numelem=x.shape[2] // size)

    def to_seq(x):
        return comm.Alltoall(x, gatheraxis=2, scatteraxis=1,
                             numelem=s_local)

    out = flash_attention(to_heads(q), to_heads(k), to_heads(v),
                          causal=causal, impl=impl, window=window)
    return to_seq(out)
