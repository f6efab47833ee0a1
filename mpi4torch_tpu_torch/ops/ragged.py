"""Static-shape position masks.

Port of ``position_onehot`` from ``mpi4torch_tpu/ops/ragged.py``: the
per-slot KV-cache write mask of the continuous-batching decode step.  The
varying-count collectives of that module (``ragged_alltoall``,
``ragged_allgather``, ``ragged_gather``, ``ragged_scatter``) are not
ported yet and raise.
"""

from __future__ import annotations

import torch


def position_onehot(pos, capacity: int):
    """``(...,)`` (or scalar) int positions → ``(..., capacity)`` one-hot
    0/1 int32 mask selecting exactly slot ``pos``.  An out-of-range
    position gives an all-zero row (no write)."""
    pos = torch.as_tensor(pos)
    p = torch.arange(capacity, device=pos.device)
    return (p == pos[..., None]).to(torch.int32)


def _not_ported(name: str):
    def fn(comm, x, *args, **kwargs):
        raise NotImplementedError(
            f"{name}: the varying-count collectives are not ported yet "
            "(ROADMAP.md, Queue 1 item 1)")

    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = f"``{name}`` of the JAX package: not ported yet (raises)."
    return fn


ragged_alltoall = _not_ported("ragged_alltoall")
ragged_allgather = _not_ported("ragged_allgather")
ragged_gather = _not_ported("ragged_gather")
ragged_scatter = _not_ported("ragged_scatter")
