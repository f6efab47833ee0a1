"""Inference serving: the continuous-batching engine over TP-sharded
KV-cache prefill and decode, dense or paged (port of
``mpi4torch_tpu.serve``, without the compiled SPMD mode), and the
latency-tier evidence of its decode collectives (:func:`latency_report`:
decode messages are a few KiB, and auto selection keys on the real chunk
sizes)."""

import torch

from .. import config as _config
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
    "reset_stats", "admit_zero3", "latency_report", "decode_message_bytes",
]


def decode_message_bytes(cfg, serve_cfg, dtype=torch.float32) -> int:
    """Bytes of one decode collective payload: the ``(slots, d_model)``
    row-parallel partial sum every layer allreduces twice a step, the
    per-token message size latency-tier selection keys on."""
    return int(serve_cfg.slots) * int(cfg.d_model) \
        * torch.empty((), dtype=dtype).element_size()


def latency_report(cfg, serve_cfg, nranks: int,
                   dtype=torch.float32) -> dict:
    """Latency-tier evidence for an engine's decode traffic: the payload
    and chunk message sizes, the autotuner cache bucket they key into
    (:func:`~mpi4torch_tpu_torch.tune.bucket_nbytes`, which a training
    tail of the same power-of-two size shares), the selector's pick per
    chunk, and whether that pick sits in the latency tier.  A pure
    function of the config and the tune state (the cache is keyed on the
    platform of the calling thread's world, the card's outside one)."""
    from .. import tune as _tune

    payload = decode_message_bytes(cfg, serve_cfg, dtype)
    k = _config.serve_decode_buckets()
    chunk = max(payload // k, 1)
    algo = _tune.select_auto(nbytes=chunk, dtype=dtype, nranks=int(nranks))
    spec = _tune.get_algorithm(algo)
    crossover = _config.latency_crossover_bytes()
    return {
        "nranks": int(nranks),
        "message_bytes": payload,
        "decode_buckets": k,
        "chunk_bytes": chunk,
        "cache_bucket_bytes": _tune.bucket_nbytes(chunk),
        "latency_crossover_bytes": crossover,
        "algorithm": algo,
        "latency_optimal": bool(spec.latency_optimal),
        "bandwidth_optimal": bool(spec.bandwidth_optimal),
        # With a measured crossover above the decode chunk size,
        # selection sits in the latency tier (never on a bandwidth-tier
        # schedule).
        "latency_tier": bool(
            crossover is not None and chunk <= crossover
            and not spec.bandwidth_optimal),
    }


# Process-wide aggregate of every live engine's ServeStats, and its reset.
stats = serve_stats
reset_stats = reset_serve_stats
