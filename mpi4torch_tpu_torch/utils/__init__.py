"""Utilities: parameter trees, threefry random bits, functional
optimizers, L-BFGS, training-state checkpoints, profiling helpers and
the per-rank input pipeline."""

from .checkpoint import (CheckpointManager, restore_checkpoint,
                         restore_resharded, save_checkpoint)
from .data import prefetch_to_device, shard_batches, shard_batches_comm
from .lbfgs import LBFGS, minimize_lbfgs
from .profiling import bucket_scope, profiler_trace

__all__ = ["LBFGS", "minimize_lbfgs", "CheckpointManager",
           "restore_checkpoint", "restore_resharded", "save_checkpoint",
           "profiler_trace", "bucket_scope", "shard_batches",
           "shard_batches_comm", "prefetch_to_device"]
