"""Per-rank-varying ``numelem`` on the dense collectives.

Port of ``mpi4torch_tpu/ops/packed.py``.  The mpi4torch reference's
Gather/Scatter/Alltoall take per-rank-varying segment sizes (MPI_Gatherv
derived datatypes); the JAX package expresses them as static per-rank
count tuples over capacity-padded buffers, so that one program serves
every backend, and the port keeps that contract:

* inputs with a per-rank-varying axis are **capacity-padded**: the axis
  has one length (>= every rank's count) and rank ``r``'s first
  ``numelem[r]`` entries are valid;
* outputs that concatenate varying segments are **packed** to the exact
  ``sum(numelem)`` length;
* outputs that *are* a varying segment are capacity-padded to
  ``max(numelem)`` with invalid slots zeroed.

Everything is composed from the facade's dense differentiable
collectives, index maps (``index_select`` with cached index tensors)
and masks, so the adjoints route through the same exchanges and padding
slots never send or receive gradient.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _counts(opname: str, numelem, size: int) -> Tuple[int, ...]:
    counts = tuple(int(c) for c in numelem)
    if len(counts) != size:
        raise ValueError(
            f"{opname}: per-rank numelem has {len(counts)} entries for "
            f"communicator size {size}")
    if any(c < 0 for c in counts):
        raise ValueError(f"{opname}: negative count in numelem {counts}")
    return counts


def _axis(opname: str, axis: int, ndim: int) -> int:
    if not (-ndim <= axis < ndim):
        raise ValueError(f"{opname}: axis {axis} out of range for {ndim}-d")
    return axis % ndim


def _mask_valid(x, axis: int, count: int):
    """Zero slots >= count along ``axis``."""
    pos = torch.arange(x.shape[axis], device=x.device)
    pos = pos.reshape((-1,) + (1,) * (x.dim() - axis - 1))
    return torch.where(pos < count, x, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


@functools.lru_cache(maxsize=64)
def _table_tensor(values: Tuple[int, ...], device: torch.device
                  ) -> torch.Tensor:
    """A per-rank table as an int64 tensor on ``device``, built once."""
    return torch.tensor(values, dtype=torch.int64, device=device)


def _rank_entry(comm, values: Sequence[int], device: torch.device):
    """``values[comm.rank]``: a Python int on the rank threads' eager
    runtime, a 0-d tensor under Mode A, where the rank is symbolic."""
    rank = comm.rank
    if isinstance(rank, int):
        return values[rank]
    return _table_tensor(tuple(values), device)[rank]


def _frozen(a: np.ndarray) -> np.ndarray:
    # lru_cache hands the same ndarray to every caller; the index maps are
    # read-only by contract (index_select operands), so freeze them.
    a.flags.writeable = False
    return a


@functools.lru_cache(maxsize=512)
def _pack_index(counts: Tuple[int, ...], capacity: int) -> np.ndarray:
    """Index map from the (size*capacity) block layout to the packed
    sum(counts) layout: packed slot offsets[r]+i <- r*capacity+i."""
    return _frozen(np.concatenate(
        [np.arange(r * capacity, r * capacity + c, dtype=np.int64)
         for r, c in enumerate(counts)]
        or [np.zeros(0, np.int64)]))


@functools.lru_cache(maxsize=512)
def _pad_index(counts: Tuple[int, ...], capacity: int) -> np.ndarray:
    """Index map from the packed sum(counts) layout to the (size*capacity)
    block layout; padding slots re-read a valid element (receivers mask
    them, and the masked cotangent is zero, so the duplicate read leaks
    neither data nor gradient)."""
    offsets = np.concatenate([[0], np.cumsum(counts)])
    total = int(offsets[-1])
    out = []
    for r, c in enumerate(counts):
        base = int(offsets[r])
        idx = base + np.minimum(np.arange(capacity, dtype=np.int64),
                                max(c - 1, 0))
        out.append(np.minimum(idx, max(total - 1, 0)))
    return _frozen(np.concatenate(out) if out
                   else np.zeros(0, np.int64))


@functools.lru_cache(maxsize=16)
def _index_tensor(which: str, counts: Tuple[int, ...], capacity: int,
                  device: torch.device) -> torch.Tensor:
    """The map of :func:`_pack_index` / :func:`_pad_index` as an int64
    tensor on ``device``, built once per (map, device).  Only ever an
    ``index_select`` operand, never handed to a caller."""
    fn = _pack_index if which == "pack" else _pad_index
    return torch.tensor(fn(counts, capacity), device=device)


def _take(x, which: str, counts, capacity: int, axis: int):
    return x.index_select(axis, _index_tensor(which, counts, capacity,
                                              x.device))


def _empty_along(x, axis: int):
    return x.narrow(axis, 0, 0)


def packed_gather(comm, x, gatheraxis: int, numelem, root: int):
    """Gather with per-rank-varying valid lengths, packed result.

    ``x``: the ``gatheraxis`` is capacity-padded; this rank's first
    ``numelem[rank]`` entries are valid.  Returns the packed concatenation
    (axis length ``sum(numelem)``) on the root, zeros elsewhere."""
    ax = _axis("Gather", gatheraxis, x.dim())
    counts = _counts("Gather", numelem, comm.size)
    cap = x.shape[ax]
    if counts and max(counts) > cap:
        raise ValueError(
            f"Gather: numelem {counts} exceeds the padded axis length "
            f"{cap} (axis {gatheraxis})")
    xz = _mask_valid(x, ax, _rank_entry(comm, counts, x.device))
    full = comm.Gather(xz, ax, root)
    return _take(full, "pack", counts, cap, ax)


def packed_allgather(comm, x, gatheraxis: int, numelem):
    """Allgather with per-rank-varying valid lengths, packed result on
    every rank."""
    ax = _axis("Allgather", gatheraxis, x.dim())
    counts = _counts("Allgather", numelem, comm.size)
    cap = x.shape[ax]
    if counts and max(counts) > cap:
        raise ValueError(
            f"Allgather: numelem {counts} exceeds the padded axis length "
            f"{cap} (axis {gatheraxis})")
    xz = _mask_valid(x, ax, _rank_entry(comm, counts, x.device))
    # compression=False: the packed contract reassembles exact padded
    # values; a scope-level codec must not quantize them.
    full = comm.Allgather(xz, ax, compression=False)
    return _take(full, "pack", counts, cap, ax)


def packed_scatter(comm, x, scatteraxis: int, numelem, root: int):
    """Scatter with per-receiver-varying segment sizes.

    ``x`` (root's data wins): the ``scatteraxis`` length must be
    ``sum(numelem)``, the packed concatenation.  Returns this rank's
    segment, capacity-padded to ``max(numelem)`` with slots >=
    ``numelem[rank]`` zeroed."""
    ax = _axis("Scatter", scatteraxis, x.dim())
    counts = _counts("Scatter", numelem, comm.size)
    total = sum(counts)
    if x.shape[ax] != total:
        raise ValueError(
            f"Scatter: sum(numelem) ({total}) must equal the scatter axis "
            f"length ({x.shape[ax]}); numelem={counts}")
    cap = max(counts) if counts else 0
    if cap == 0:
        return _empty_along(x, ax)
    padded = _take(x, "pad", counts, cap, ax)
    recv = comm.Scatter(padded, ax, cap, root)
    return _mask_valid(recv, ax, _rank_entry(comm, counts, x.device))


def packed_alltoall(comm, x, gatheraxis: int, scatteraxis: int, numelem,
                    current_numelem: Optional[Sequence[int]] = None):
    """All-to-all with per-rank-varying segment sizes.

    ``gatheraxis != scatteraxis`` (the Scatter∘Gather composition): the
    ``gatheraxis`` is capacity-padded input (this rank's first
    ``numelem[rank]`` valid) and comes back packed (length
    ``sum(numelem)``); the ``scatteraxis`` must be the packed
    ``sum(numelem)`` and comes back capacity-padded and masked.

    ``gatheraxis == scatteraxis`` (the reference's interval-overlap
    redistribution): repartitions the global packed axis from the
    ``current_numelem`` partition to the ``numelem`` partition;
    ``current_numelem`` is required.  It runs as a packed allgather and
    a per-rank slice."""
    nd = x.dim()
    ga = _axis("Alltoall", gatheraxis, nd)
    sa = _axis("Alltoall", scatteraxis, nd)
    counts = _counts("Alltoall", numelem, comm.size)
    size = comm.size
    total = sum(counts)
    cap = max(counts) if counts else 0

    if ga == sa:
        if current_numelem is None:
            raise ValueError(
                "Alltoall with gatheraxis == scatteraxis and per-rank "
                "numelem redistributes a packed axis; pass "
                "current_numelem (the present per-rank partition) — it "
                "cannot be inferred from the padded shape")
        old = _counts("Alltoall current_numelem", current_numelem, size)
        if sum(old) != total:
            raise ValueError(
                f"Alltoall: current_numelem {old} and numelem {counts} "
                f"partition different totals ({sum(old)} vs {total})")
        glob = packed_allgather(comm, x, ga, old)
        if cap == 0:
            return _empty_along(glob, ga)
        # Per-rank interval [offsets[r], +numelem[r]), capacity-padded.
        pad_shape = list(glob.shape)
        pad_shape[ga] = cap
        glob = torch.cat([glob, glob.new_zeros(pad_shape)], dim=ga)
        start = _rank_entry(comm, [sum(counts[:r]) for r in range(size)],
                            x.device)
        if isinstance(start, int):
            seg = glob.narrow(ga, start, cap)
        else:
            seg = glob.index_select(ga, start + torch.arange(
                cap, device=glob.device))
        return _mask_valid(seg, ga, _rank_entry(comm, counts, x.device))

    if current_numelem is not None:
        raise ValueError(
            "current_numelem only applies to gatheraxis == scatteraxis "
            "(the packed-axis redistribution); with distinct axes the "
            "gather axis's valid lengths ARE numelem")
    if x.shape[sa] != total:
        raise ValueError(
            f"Alltoall: sum(numelem) ({total}) must equal the scatter "
            f"axis length ({x.shape[sa]}); numelem={counts}")
    cap_g = x.shape[ga]
    if counts and max(counts) > cap_g:
        raise ValueError(
            f"Alltoall: numelem {counts} exceeds the padded gather axis "
            f"length ({cap_g})")
    if cap == 0:
        return _empty_along(x, ga)
    padded = _take(x, "pad", counts, cap, sa)
    ex = comm.Alltoall(padded, ga, sa, cap)
    # Receiver block r on the gather axis holds sender r's capacity rows;
    # the pack keeps each sender's first numelem[r] (dropping the
    # senders' padding rows outright).
    out = _take(ex, "pack", counts, cap_g, ga)
    return _mask_valid(out, sa, _rank_entry(comm, counts, x.device))
