"""mpi4torch_tpu_torch.reshard — differentiable sharding -> sharding
redistribution with memory-bounded plans of portable collectives.

Port of ``mpi4torch_tpu.reshard`` on the rank-thread world.  The
transitions production hits — train on ``(8,)`` and serve on ``(2, 4)``;
ZeRO shard -> TP shard at the train/serve boundary; MoE expert
rebalancing; a checkpoint restored onto another topology — are one
facade call::

    y = comm.Reshard(tree, from_spec, to_spec)

The planner (:mod:`.plan`) decomposes a (mesh, spec) -> (mesh', spec')
pair into a short program of all-gather / all-to-all / permute / slice
steps whose peak live bytes stay ``O(shard + chunk)``; the executor
(:mod:`.executor`) replays it through the rendezvous; the backward runs
the reverse plan, so cotangents redistribute spec' -> spec.

Under :func:`~mpi4torch_tpu_torch.ops.spmd.run_spmd` (Mode A) the same
plans run on the SPMD exchange primitives, bitwise the rank-thread
replay; ``python -m mpi4torch_tpu_torch.reshard --smoke`` sweeps them.
The census of a recorded reshard (:mod:`.census`: ``peak_live_bytes``,
``tensor_bytes``) delegates to :mod:`mpi4torch_tpu_torch.analyze`.
"""

from .executor import (apply_plan, execute_plan, gather_then_slice,
                       global_template, reshard_blocks, reshard_tree,
                       reshard_value, shard_of, shard_template,
                       slice_shard)
from .plan import (STEP_KINDS, STRATEGIES, Layout, ReshardPlan, layout,
                   plan_permutation, plan_reshard, plan_resize)
from .census import peak_live_bytes, tensor_bytes
from .rules import match_partition_rules, tree_paths

__all__ = [
    "Layout",
    "layout",
    "ReshardPlan",
    "STEP_KINDS",
    "STRATEGIES",
    "plan_reshard",
    "plan_permutation",
    "plan_resize",
    "apply_plan",
    "execute_plan",
    "reshard_value",
    "reshard_tree",
    "reshard_blocks",
    "gather_then_slice",
    "slice_shard",
    "shard_of",
    "shard_template",
    "global_template",
    "match_partition_rules",
    "tree_paths",
    "peak_live_bytes",
    "tensor_bytes",
]

