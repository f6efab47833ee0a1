"""mpi4torch_tpu_torch.elastic — live world resize: shrink, grow, takeover.

Port of ``mpi4torch_tpu.elastic``.  Failures are already attributed
(``RankFailedError.ranks``, ``check_health`` probes) and state already
re-lays onto any topology through the reshard planner; this package
wires them into a runtime that survives membership changes without a
full-job restart:

* :mod:`.membership` — ``WorldView(epoch, alive, mesh_shape)`` and the
  probe-then-ratify consensus (``agree_world_view``): survivors agree
  on the next membership, a monotonically increasing epoch fences
  stale traffic (consensus tags, checkpoint stamps, caller-side
  :class:`~.membership.StaleEpochError`), and disagreement or a second
  failure mid-round ends in a typed, rank-attributed raise — never a
  hang.
* :mod:`.replan` — replan-as-reshard: every state kind re-lays through
  :func:`mpi4torch_tpu_torch.reshard.plan_resize`, ZeRO shards, TP
  heads and MoE expert stacks alike; serve traffic drains to tickets
  and re-admits through the engine's admission policies with token
  streams equal to ``generate()``'s.
* :mod:`.spare` — hot-spare ranks riding the existing collectives to
  keep full replicas of the sharded state current at zero extra wire,
  for zero-reshard takeover (fallback: the planned drain).
* :mod:`.runtime` — :class:`~.runtime.ElasticRuntime`, the phase
  loop (run phase → observe failure/notice → consensus → replan →
  resume), on the device it is given (CUDA unless ``"cpu"``).
* :mod:`.matrix` — the censused (failure kind × subsystem × action)
  matrix: every cell recovered-and-bitwise vs the fresh-start oracle
  on the new world or a typed attributed raise, fired-fault-ledger
  proven (``python -m mpi4torch_tpu_torch.elastic --smoke``).
"""

from .membership import (ConsensusError, ElasticError, StaleEpochError,
                         WorldView, agree_world_view, fence_tag,
                         initial_view)
from .replan import (ServeTicket, drain_tickets, readmit, replan_axis0,
                     replan_axis0_tree, replan_zero, resize_embeds,
                     stitched_results)
from .runtime import ElasticRuntime
from .spare import (bank_spare_step, is_spare, takeover_bank_slot,
                    takeover_shard, zero_spare_init, zero_spare_step)

__all__ = [
    "WorldView",
    "ElasticError",
    "ConsensusError",
    "StaleEpochError",
    "agree_world_view",
    "fence_tag",
    "initial_view",
    "ElasticRuntime",
    "resize_embeds",
    "replan_axis0",
    "replan_axis0_tree",
    "replan_zero",
    "ServeTicket",
    "drain_tickets",
    "readmit",
    "stitched_results",
    "is_spare",
    "zero_spare_init",
    "zero_spare_step",
    "takeover_shard",
    "bank_spare_step",
    "takeover_bank_slot",
]
