"""Multi-process runtime: the ``mpirun`` / ``MPI_Init`` analogue.

Port of ``mpi4torch_tpu/distributed.py``.  The reference's deployment
model is N OS processes under a launcher whose rendezvous is
``MPI_Init_thread``.  Here N Python processes rendezvous through
``torch.distributed`` (``init_process_group("gloo")`` over TCP); after
that :func:`~mpi4torch_tpu_torch.run_spmd` spans every process: its
default world is the global one, each process runs its own block of
global ranks on rank threads, and every collective's exchange crosses
the processes through the distributed world of ``transport/dist.py``.

Initialization is explicit, as in the JAX package: every process calls
:func:`init_distributed` with its own ``process_id`` (or runs under
``torchrun``, whose environment fills in what is not passed), then runs
the same SPMD program.

Two choices of the port:

* the wire is gloo, never NCCL.  NCCL refuses two ranks of one
  communicator on one device, and rank threads share a card everywhere
  in the port; gloo carries host buffers, so payloads are staged
  through the host (``transport/dist.py``);
* ``local_device_ids`` names the device index of each rank this process
  hosts, repeats allowed (the rank threads of a process share its one
  device).  With ``device="cpu"`` only its length counts, which is how a
  CPU launch makes "2 processes x 4 ranks".
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import config as _cfg
from .runtime import CommError, resolve_device

__all__ = ["DistributedInfo", "init_distributed", "finalize_distributed",
           "is_distributed", "distributed_info", "local_values"]

# "info": the DistributedInfo of the rendezvous; "counts": the number of
# local ranks of every process (fixing each process's contiguous block
# of global ranks); "device": this process's device.
_STATE = {"info": None, "counts": None, "device": None}


@dataclass(frozen=True)
class DistributedInfo:
    """What the rendezvous established (returned by
    :func:`init_distributed`)."""
    process_id: int
    process_count: int
    n_devices: int          # global rank count == COMM_WORLD size in SPMD
    n_local_devices: int
    coordinator_address: Optional[str]


def _from_env(coordinator_address, num_processes, process_id):
    """Fill what the caller left out from torchrun's environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``): the
    counterpart of JAX's managed-cluster auto-detection."""
    env = os.environ
    if (coordinator_address is None and env.get("MASTER_ADDR")
            and env.get("MASTER_PORT")):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    missing = [name for name, v in (
        ("coordinator_address (or MASTER_ADDR and MASTER_PORT)",
         coordinator_address),
        ("num_processes (or WORLD_SIZE)", num_processes),
        ("process_id (or RANK)", process_id)) if v is None]
    if missing:
        raise CommError(
            "init_distributed cannot rendezvous without "
            + ", ".join(missing) + ": pass them, or launch under torchrun")
    return coordinator_address, int(num_processes), int(process_id)


def _local_device(local_device_ids, device) -> tuple:
    """``(device, number of local ranks)``: CUDA unless ``device="cpu"``;
    the default is one rank on ``LOCAL_RANK``'s card, else card 0."""
    dev = resolve_device(device)
    if local_device_ids is None:
        local_device_ids = [int(os.environ.get("LOCAL_RANK", "0"))
                            if dev.type == "cuda" else 0]
    ids = [int(i) for i in local_device_ids]
    if not ids:
        raise CommError("local_device_ids names no rank")
    if dev.type == "cuda":
        if len(set(ids)) != 1:
            raise CommError(
                f"local_device_ids {ids} name several cards; the rank "
                "threads of one process share one card — launch one "
                "process per card instead")
        dev = torch.device("cuda", ids[0])
        torch.cuda.set_device(dev)
    return dev, len(ids)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids=None, device=None) -> DistributedInfo:
    """Join the multi-process world (reference init rendezvous,
    csrc/extension.cpp:1313-1394).

    An explicit launcher passes ``coordinator_address="host:port"``,
    ``num_processes`` and this process's ``process_id``; under
    ``torchrun`` they come from its environment.  The rendezvous is
    ``torch.distributed.init_process_group("gloo")`` with the world
    timeout (``MPI4TORCH_TPU_WORLD_TIMEOUT``) as its timeout; then the
    processes all-gather their local rank counts.  ``device`` is this
    process's device (CUDA unless the caller passes ``"cpu"``).
    Idempotent per process: a second call returns the existing
    :class:`DistributedInfo` (and raises if its arguments disagree with
    the established layout)."""
    if _STATE["info"] is not None:
        info = _STATE["info"]
        if ((num_processes is not None
             and num_processes != info.process_count)
                or (process_id is not None
                    and process_id != info.process_id)):
            raise CommError(
                f"init_distributed was already called with "
                f"process_id={info.process_id}/"
                f"num_processes={info.process_count}; cannot re-initialize "
                f"as process_id={process_id}/num_processes={num_processes}")
        return info

    addr, n, pid = _from_env(coordinator_address, num_processes, process_id)
    dev, n_local = _local_device(local_device_ids, device)
    import torch.distributed as tdist

    try:
        tdist.init_process_group(
            "gloo", init_method=f"tcp://{addr}", world_size=n, rank=pid,
            timeout=datetime.timedelta(seconds=_cfg.world_timeout()))
        gathered = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
        tdist.all_gather(gathered, torch.tensor([n_local]))
        counts = tuple(int(c) for c in torch.cat(gathered))
    except Exception as e:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        raise CommError(
            f"multi-process rendezvous failed: {e}\n"
            "every process of the launch must call init_distributed with "
            "the same coordinator_address and num_processes") from e

    info = DistributedInfo(
        process_id=pid, process_count=n, n_devices=sum(counts),
        n_local_devices=n_local, coordinator_address=addr)
    _STATE.update(info=info, counts=counts, device=dev)
    return info


def finalize_distributed() -> None:
    """Leave the multi-process world (the reference's ``MPI_Finalize``
    static-destructor analogue).  No-op if not initialized."""
    if _STATE["info"] is None:
        return
    import torch.distributed as tdist

    if tdist.is_initialized():
        tdist.destroy_process_group()
    _STATE.update(info=None, counts=None, device=None)


def is_distributed() -> bool:
    """True between :func:`init_distributed` and
    :func:`finalize_distributed`."""
    return _STATE["info"] is not None


def distributed_info() -> Optional[DistributedInfo]:
    """The established layout, or None outside a distributed run."""
    return _STATE["info"]


def layout():
    """``(process_id, local rank counts of every process, device)`` of
    the established world, or None (not initialized, or a layout that
    was set without a rendezvous)."""
    if _STATE["info"] is None or _STATE["counts"] is None:
        return None
    return _STATE["info"].process_id, _STATE["counts"], _STATE["device"]


def local_ranks() -> range:
    """This process's contiguous block of global ranks."""
    pid, counts, _ = layout()
    lo = sum(counts[:pid])
    return range(lo, lo + counts[pid])


def process_of_ranks() -> np.ndarray:
    """The process that hosts each global rank."""
    _, counts, _ = layout()
    return np.repeat(np.arange(len(counts)), counts)


def local_values(stacked):
    """This process's rows of a ``run_spmd`` output.

    Under :func:`init_distributed` each process's ``run_spmd`` outputs
    stack only the rows of the ranks it runs.  Returns ``(ranks, rows)``:
    the global rank of each row (an ndarray) and the rows themselves::

        ranks, vals = local_values(out)   # vals[i] is rank ranks[i]'s row

    An ndarray passes through with ``arange`` ranks, as does a tensor
    outside a distributed run."""
    if isinstance(stacked, np.ndarray):            # already host-local
        return np.arange(stacked.shape[0]), stacked
    if not isinstance(stacked, torch.Tensor):
        raise TypeError(
            f"local_values expects a run_spmd output (torch.Tensor or "
            f"ndarray); got {type(stacked).__name__} — apply it per leaf "
            "for pytree outputs")
    if layout() is None:
        return np.arange(stacked.shape[0]), stacked
    ranks = local_ranks()
    if stacked.shape[0] != len(ranks):
        raise ValueError(
            f"a run_spmd output of this process stacks {len(ranks)} rows "
            f"(its ranks {ranks.start}..{ranks.stop - 1}); this one has "
            f"{stacked.shape[0]}")
    return np.arange(ranks.start, ranks.stop), stacked
