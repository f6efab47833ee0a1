"""Static-shape position masks.

Port of ``position_onehot`` from ``mpi4torch_tpu/ops/ragged.py``: the
per-slot KV-cache write mask of the continuous-batching decode step.
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
