"""Utilities: parameter trees, threefry random bits, functional
optimizers, L-BFGS, profiling helpers and the per-rank input pipeline."""

from .data import prefetch_to_device, shard_batches, shard_batches_comm

__all__ = ["prefetch_to_device", "shard_batches", "shard_batches_comm"]
