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
``bidir``/``torus`` with cross-step error feedback (``compress``), the
flagship transformer with its continuous-batching engine
(``serve.Engine``), its SGD ``train_step`` and its ZeRO-1/3 steps
(``parallel.zero`` with the functional optimizers of ``utils.optim``),
and ``parallel.dp``.  Its attention runs through
hand-written CUDA kernels, forward and backward: on the tensor cores for
bf16 with head dim <= 128 (``ops/csrc/flash_fwd_tc.cu``,
``ops/csrc/flash_bwd_tc.cu``), on the CUDA cores otherwise
(``ops/csrc/flash_fwd.cu``, ``ops/csrc/flash_bwd.cu``), and every hop of
a quantized ring through another (``ops/csrc/quant_hop.cu``).

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
)
from .runtime import (
    BifurcationError,
    CollectiveMismatchError,
    CommError,
    DeadlockError,
    HealthReport,
    InPlaceReuseError,
    RankFailedError,
    resolve_device,
    run_ranks,
)
from . import compress, config

__all__ = [
    "MPI_MAX", "MPI_MIN", "MPI_SUM", "MPI_PROD", "MPI_LAND", "MPI_BAND",
    "MPI_LOR", "MPI_BOR", "MPI_LXOR", "MPI_BXOR", "MPI_MINLOC",
    "MPI_MAXLOC",
    "COMM_WORLD", "MPI_Communicator", "WaitHandle", "JoinDummies",
    "JoinDummiesHandle",
    "CommError", "CollectiveMismatchError", "DeadlockError",
    "RankFailedError", "InPlaceReuseError", "BifurcationError",
    "HealthReport", "resolve_device", "run_ranks", "compress", "config",
]
