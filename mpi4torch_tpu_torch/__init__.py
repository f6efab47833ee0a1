"""mpi4torch_tpu_torch — the PyTorch/CUDA port of mpi4torch_tpu.

The JAX package ``mpi4torch_tpu`` is the reference; this package is its
port to PyTorch on an NVIDIA H100, slice by slice (ROADMAP.md).  It
carries the mpi4torch op table, the serving path, the data-parallel
training path and the compressed gradient Allreduce: the differentiable
collective facade (``COMM_WORLD`` with ``Allreduce``, ``Bcast_``,
``Reduce_``, ``Gather``, ``Allgather``, ``Reduce_scatter``, ``Scatter``,
``Alltoall`` — per-rank ``numelem`` tuples take the packed path —,
``Isend``/``Irecv``/``Wait``/``Send``/``Recv``, the split-phase
``*_start`` collectives, the fused bucketed ``Allreduce_tree``;
``JoinDummies``, ``JoinDummiesHandle``, ``WaitHandle``) on the
rank-thread runtime (``run_ranks``), the ragged collectives
(``ops.ragged``), the bucket fusion and overlap machinery (``fuse``,
``overlap``), the ring shift and halo exchange (``parallel.ring``), an
eager L-BFGS (``utils.lbfgs``), the block-q8 codecs on ``ring``/
``bidir``/``torus``, the bf16 codecs on ``ring`` and the compressed
``Allgather``, with cross-step error feedback (``compress``), the
flagship transformer with its continuous-batching engine
(``serve.Engine``), its SGD ``train_step`` and its ZeRO-1/3 steps
(``parallel.zero`` with the functional optimizers of ``utils.optim``),
``parallel.dp``, pipeline parallelism (``parallel.pp``), the MLP,
ResNet-18 and ViT models (``models``) and the per-rank input pipeline
(``utils.data``).  Its attention runs through
hand-written CUDA kernels, forward and backward: on the tensor cores for
bf16 with head dim <= 128 (``ops/csrc/flash_fwd_tc.cu``,
``ops/csrc/flash_bwd_tc.cu``), on the CUDA cores otherwise
(``ops/csrc/flash_fwd.cu``, ``ops/csrc/flash_bwd.cu``), and every hop of
a quantized ring through another (``ops/csrc/quant_hop.cu``).  The
runtime's chokepoints carry the observability layer (``obs``: comm
tracing, metrics, the flight recorder, Chrome-trace export) and the core
of fault tolerance (``resilience``: fault injection, retries with
backoff, the integrity guards, gray-failure detection, preemption-safe
resume), the reshard planner (``reshard``, ``comm.Reshard``: the
(mesh, spec) -> (mesh', spec') moves of state between layouts, the
ZeRO-3 -> TP serving handoff, the planned MoE rebalance) and
training-state checkpoints (``utils.checkpoint``).  ``run_ranks`` runs
its ranks on threads of this process or, with ``backend="process"``, in
pooled worker processes (``transport``).  ``init_distributed`` joins N
OS processes over ``torch.distributed`` (gloo), after which ``run_spmd``
spans them, each process running its block of global ranks
(``distributed``, ``transport/dist.py``; ``local_values`` names a
process's rows, and ``comm_from_mpi4py`` bootstraps the same from an
mpi4py world).  ``run_spmd`` runs one
program on every rank thread under the JAX package's Mode A contract
(``ops/spmd.py``: a symbolic ``comm.rank``, static p2p permutations,
every Allreduce algorithm as its explicit schedule, the stacked outputs
differentiable from outside), with ``device_mesh``/``hybrid_mesh`` and
the mesh communicators of ``comm_from_mesh``; its Allreduce, Bcast_,
Reduce_ and block-q8 Allreduce build and lower programs of the
collective-schedule IR (``csched``: programs, transposition, the fold
interpreter, the census).  ``elastic`` resizes a live world (membership
consensus with epoch fencing, the planned drain and grow, hot-spare
takeover), ``resilience.degrade`` adapts the configuration to a gray
failure, and ``ctl`` is the online controller that measures, retunes and
switches, every switch ratified by one consensus round.  ``analyze`` is
the static schedule verifier: ``analyze.lower`` records a ``run_spmd``
program as it runs once (every exchange a typed collective, every aten
op and kernel launch an event), and its lints, wire/liveness/exposure
accounting, seeded-defect corpus and registry-wide sweep read the
record.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with
no CUDA device and no such request they raise.  The package imports
neither JAX nor anything of ``mpi4torch_tpu``.
"""

from .constants import (
    MPI_BAND,
    MPI_BOR,
    MPI_BXOR,
    MPI_LAND,
    MPI_LOR,
    MPI_LXOR,
    MPI_MAX,
    MPI_MAXLOC,
    MPI_MIN,
    MPI_MINLOC,
    MPI_PROD,
    MPI_SUM,
)
from .comm import (
    COMM_WORLD,
    JoinDummies,
    JoinDummiesHandle,
    MPI_Communicator,
    WaitHandle,
    comm_from_mesh,
    comm_from_mpi4py,
    deactivate_cuda_aware_mpi_support,
)
from .runtime import (
    BifurcationError,
    CollectiveMismatchError,
    CommError,
    DeadlockError,
    HealthReport,
    InPlaceReuseError,
    IntegrityError,
    RankFailedError,
    resolve_device,
    run_ranks,
)
from . import (compress, config, csched, fuse, obs, overlap, reshard,
               resilience, serve, transport, tune)
from . import analyze, ctl, elastic
from .config import (algorithm_scope, compression_scope, fusion_scope,
                     overlap_scope)
from .distributed import (DistributedInfo, distributed_info,
                          finalize_distributed, init_distributed,
                          is_distributed, local_values)
from .mesh import device_mesh, hybrid_mesh
from .ops.spmd import PermRank, RankExpr, p2p_scope, run_spmd
from .overlap import SpmdWaitHandle
from .resilience import FaultPlan, FaultSpec, fault_scope

__all__ = [
    "MPI_MAX", "MPI_MIN", "MPI_SUM", "MPI_PROD", "MPI_LAND", "MPI_BAND",
    "MPI_LOR", "MPI_BOR", "MPI_LXOR", "MPI_BXOR", "MPI_MINLOC",
    "MPI_MAXLOC",
    "COMM_WORLD", "MPI_Communicator", "WaitHandle", "JoinDummies",
    "JoinDummiesHandle", "comm_from_mesh", "comm_from_mpi4py",
    "deactivate_cuda_aware_mpi_support",
    "CommError", "CollectiveMismatchError", "DeadlockError",
    "RankFailedError", "InPlaceReuseError", "BifurcationError",
    "IntegrityError", "HealthReport", "resolve_device", "run_ranks",
    "config", "compress", "csched", "fuse", "tune", "overlap",
    "resilience",
    "reshard", "serve", "obs", "transport", "elastic", "ctl", "analyze",
    "device_mesh", "hybrid_mesh",
    "DistributedInfo", "init_distributed", "finalize_distributed",
    "is_distributed", "distributed_info", "local_values",
    "FaultPlan", "FaultSpec", "fault_scope", "algorithm_scope",
    "compression_scope",
    "fusion_scope", "overlap_scope", "run_spmd", "p2p_scope", "RankExpr",
    "PermRank", "SpmdWaitHandle",
]
