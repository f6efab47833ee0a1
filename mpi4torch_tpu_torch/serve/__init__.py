"""Inference serving: the continuous-batching engine over TP-sharded
KV-cache prefill and decode, dense or paged (port of
``mpi4torch_tpu.serve``, without the compiled SPMD mode)."""

from ..utils.profiling import ServeStats, reset_serve_stats, serve_stats
from .engine import (POLICIES, SHED_POLICIES, STATUS_EXPIRED, STATUS_OK,
                     STATUS_SHED, Engine, QueueFullError, Request,
                     ServeConfig)
from .kv import (admit_zero3, decode_step_paged, decode_step_tp,
                 init_kv_cache_tp, init_kv_pool_tp, prefill_chunk_tp,
                 prefill_tp, shard_params_tp, validate_tp)
from .paging import BlockManager

__all__ = [
    "Engine", "ServeConfig", "Request", "POLICIES", "SHED_POLICIES",
    "STATUS_OK", "STATUS_EXPIRED", "STATUS_SHED", "QueueFullError",
    "ServeStats", "decode_step_tp", "prefill_tp", "shard_params_tp",
    "init_kv_cache_tp", "validate_tp", "decode_step_paged",
    "prefill_chunk_tp", "init_kv_pool_tp", "BlockManager", "stats",
    "reset_stats", "admit_zero3",
]

def decode_message_bytes(cfg, serve_cfg, dtype=None):
    """Bytes of one decode collective payload: not ported yet (raises)."""
    raise NotImplementedError(
        "decode_message_bytes: latency-tier selection comes with the "
        "autotuner (ROADMAP.md, Queue 1 item 5)")


def latency_report(cfg, serve_cfg, nranks, dtype=None):
    """Latency-tier evidence for an engine's decode traffic: not ported
    yet (raises)."""
    raise NotImplementedError(
        "latency_report: latency-tier selection comes with the autotuner "
        "(ROADMAP.md, Queue 1 item 5)")


# Process-wide aggregate of every live engine's ServeStats, and its reset.
stats = serve_stats
reset_stats = reset_serve_stats
