"""Deterministic per-rank input pipeline.

Port of ``mpi4torch_tpu/utils/data.py``:

* :func:`shard_batches` — a seeded global shuffle cut into equal per-rank,
  equal-per-step batch shards.  The permutation is numpy's, seeded by
  ``(seed, epoch)``, so the order is bitwise the JAX package's, and every
  rank derives the same global order from its own call.  Remainders are
  dropped, so every step of every rank has the same shapes.
* :func:`shard_batches_comm` — the same with rank and size taken from a
  communicator.
* :func:`prefetch_to_device` — up to ``size`` batches staged on the device
  ahead of the one in use: each is copied into pinned host memory and
  sent with ``non_blocking=True``, so the host-to-device copy of batch
  ``i + 1`` overlaps the computation on batch ``i``.
"""

from __future__ import annotations

import collections
import itertools
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

from ..runtime import resolve_device
from .tree import tree_map


def shard_batches(data, batch_size: int, *, rank: int = 0, size: int = 1,
                  seed: int = 0, epoch: int = 0, shuffle: bool = True):
    """Yield this rank's batches for one epoch, deterministically.

    ``data`` is an array or a tuple/list of arrays (numpy arrays or
    tensors; a device tensor is copied to the host once, up front)
    sharing a leading axis.  Each yielded element mirrors that
    structure with leading axis ``batch_size``: numpy arrays for numpy
    input, CPU tensors (any dtype) for tensor input.  The
    global order is ``np.random.default_rng((seed, epoch)).permutation``;
    rank ``r`` takes batches ``r, r + size, r + 2 * size, ...`` of the
    permuted stream (``DistributedSampler(shuffle=True,
    drop_last=True)``).  Examples that do not fill ``size`` whole batches
    are dropped; an epoch with no step raises."""
    single = not isinstance(data, (tuple, list))
    arrays = tuple(a.cpu() if isinstance(a, torch.Tensor) else np.asarray(a)
                   for a in ((data,) if single else data))
    n = int(np.shape(arrays[0])[0])
    for a in arrays[1:]:
        if int(np.shape(a)[0]) != n:
            raise ValueError(
                f"leading axes disagree: {np.shape(a)[0]} vs {n}")
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    if not (0 <= rank < size):
        raise ValueError(f"rank {rank} out of range for size {size}")

    if shuffle:
        order = np.random.default_rng((seed, epoch)).permutation(n)
    else:
        order = np.arange(n)
    steps = n // (batch_size * size)
    if steps == 0:
        raise ValueError(
            f"dataset of {n} examples yields zero steps at "
            f"batch_size={batch_size} x size={size}")
    for step in range(steps):
        lo = (step * size + rank) * batch_size
        idx = order[lo:lo + batch_size]
        batch = tuple(a[torch.from_numpy(idx)] if isinstance(a, torch.Tensor)
                      else a[idx] for a in arrays)
        yield batch[0] if single else batch


def shard_batches_comm(data, batch_size: int, comm, **kw):
    """:func:`shard_batches` with rank and size taken from ``comm``."""
    rank = comm.rank
    if not isinstance(rank, int):
        raise TypeError(
            f"shard_batches_comm needs an integer rank; got {rank!r}")
    return shard_batches(data, batch_size, rank=rank, size=comm.size, **kw)


def _stage(batch, device: torch.device):
    """``batch`` (a tree of numpy arrays or tensors) on ``device``: each
    leaf through a pinned host buffer and a non-blocking copy when the
    device is CUDA, a plain copy otherwise."""
    def leaf(a):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        if device.type == "cuda":
            if t.device.type == "cpu":
                t = t.pin_memory()
            return t.to(device, non_blocking=True)
        return t.to(device)

    return tree_map(leaf, batch)


def prefetch_to_device(batches: Iterable[Any], size: int = 2,
                       device: Optional[Any] = None) -> Iterator[Any]:
    """Iterate ``batches`` with up to ``size`` of them already on
    ``device`` (CUDA unless another device is named; see
    :func:`~mpi4torch_tpu_torch.runtime.resolve_device`).  On CUDA each
    leaf goes through pinned host memory with a non-blocking copy on the
    current stream, so it is ordered before any later kernel that reads
    it and overlaps the host's work in between; the queue bounds the
    device memory the staged batches take.  ``size=1`` stages each batch
    when it is taken."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    dev = resolve_device(device)
    it = iter(batches)
    queue: collections.deque = collections.deque()
    for b in itertools.islice(it, size):
        queue.append(_stage(b, dev))
    while queue:
        nxt = queue.popleft()
        for b in itertools.islice(it, 1):
            queue.append(_stage(b, dev))
        yield nxt
