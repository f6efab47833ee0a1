"""Inference serving: the continuous-batching engine over TP-sharded
KV-cache prefill and decode (port of ``mpi4torch_tpu.serve``, dense
slot-table path)."""

from ..utils.profiling import ServeStats
from .engine import (POLICIES, SHED_POLICIES, STATUS_EXPIRED, STATUS_OK,
                     STATUS_SHED, Engine, QueueFullError, Request,
                     ServeConfig)
from .kv import (decode_step_tp, init_kv_cache_tp, prefill_tp,
                 shard_params_tp, validate_tp)

__all__ = [
    "Engine", "ServeConfig", "Request", "POLICIES", "SHED_POLICIES",
    "STATUS_OK", "STATUS_EXPIRED", "STATUS_SHED", "QueueFullError",
    "ServeStats", "decode_step_tp", "prefill_tp", "shard_params_tp",
    "init_kv_cache_tp", "validate_tp",
]
