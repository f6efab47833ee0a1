"""Parallelism strategies built on the differentiable op surface.

Port of ``mpi4torch_tpu/parallel``:

    dp         — data parallelism (the reference's two-Allreduce recipe)
    ring       — differentiable ring shifts and halo exchange (Isend/Irecv)
    attention  — long-context attention: ring attention (CP), its zigzag
                 layout, and Ulysses all-to-all attention (SP)
    tp         — tensor parallelism: sharding helpers, column/row-parallel
                 layers, the TP MLP and attention
    moe        — expert parallelism: capacity-based top-1 MoE over
                 Alltoall, and the dropless top-k form over the ragged
                 Alltoall with sharded expert leaves
    pp         — pipeline parallelism: GPipe, interleaved and 1F1B over
                 Isend/Irecv/Wait
    zero       — ZeRO-1/3 sharded optimizer steps

``pp.pipeline_spmd`` is the single-program GPipe under ``run_spmd``.
"""

from . import attention, dp, moe, pp, ring, tp, zero

from .attention import (dense_attention, ring_attention,
                        ulysses_attention, zigzag_positions, zigzag_slice,
                        zigzag_ring_attention)
from .dp import all_average_tree, dp_value_and_grad
from .moe import (balanced_assignment, expert_shard, init_moe,
                  init_moe_topk, moe_ffn, moe_ffn_dense, moe_topk_ffn,
                  moe_topk_ffn_dense, rebalance_experts, top1_route,
                  topk_route)
from .pp import (pipeline_spmd, pipeline_step, pipeline_step_1f1b,
                 pipeline_step_interleaved, recv_activation, schedule_1f1b,
                 send_activation)
from .ring import halo_exchange, ring_shift
from .tp import (column_parallel_linear, row_parallel_linear, shard_axis,
                 shard_heads, tp_attention, tp_mlp)
from .zero import (shard_global_norm, zero3_init, zero3_params,
                   zero3_shard_params, zero3_step, zero3_to_tp, zero_init,
                   zero_step)

__all__ = [
    "attention", "dp", "moe", "pp", "ring", "tp", "zero",
    "all_average_tree", "dp_value_and_grad",
    "halo_exchange", "ring_shift",
    "pipeline_spmd", "pipeline_step", "pipeline_step_1f1b",
    "pipeline_step_interleaved", "recv_activation", "schedule_1f1b",
    "send_activation",
    "dense_attention", "ring_attention", "ulysses_attention",
    "zigzag_positions", "zigzag_slice", "zigzag_ring_attention",
    "column_parallel_linear", "row_parallel_linear", "shard_axis",
    "shard_heads", "tp_attention", "tp_mlp",
    "init_moe", "moe_ffn", "moe_ffn_dense", "balanced_assignment",
    "rebalance_experts", "top1_route",
    "expert_shard", "init_moe_topk", "moe_topk_ffn", "moe_topk_ffn_dense",
    "topk_route",
    "shard_global_norm", "zero_init", "zero_step", "zero3_init",
    "zero3_params", "zero3_shard_params", "zero3_step", "zero3_to_tp",
]
