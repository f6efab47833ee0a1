"""Utilities: parameter trees, threefry random bits, functional
optimizers, L-BFGS, profiling helpers and the per-rank input pipeline."""

from .data import prefetch_to_device, shard_batches, shard_batches_comm
from .lbfgs import LBFGS, minimize_lbfgs
from .profiling import bucket_scope, profiler_trace

__all__ = ["LBFGS", "minimize_lbfgs", "profiler_trace", "bucket_scope",
           "shard_batches", "shard_batches_comm", "prefetch_to_device"]
