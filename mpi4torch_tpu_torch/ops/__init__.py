"""Operators: collectives, attention (CUDA kernel and plain version)
and static-shape masks."""

from .flash import flash_attention, flash_block_attention, merge_partials
from .ragged import (block_gather, block_scatter, ragged_allgather,
                     ragged_alltoall, ragged_gather, ragged_scatter,
                     segment_mask)

__all__ = [
    "flash_attention",
    "flash_block_attention",
    "merge_partials",
    "block_gather",
    "block_scatter",
    "ragged_allgather",
    "ragged_alltoall",
    "ragged_gather",
    "ragged_scatter",
    "segment_mask",
]
