"""Crash-safe data-parallel training with checkpoint and resume.

The torch version of the JAX package's ``checkpoint_resume`` example, on
the DP recipe of the canonical regression example:

* ``utils.CheckpointManager`` saves the whole training state (parameters,
  SGD momentum, step counter) after every step, atomically; only rank 0
  touches the disk;
* resume: a fresh start finds ``latest_step()``, rank 0 restores it and
  ``Bcast_`` hands the state to every rank; the resumed run is bitwise the
  uninterrupted one (checked below).

Run:  python -m mpi4torch_tpu_torch.examples.checkpoint_resume [nranks]
      [workdir] [--cpu]
"""

import shutil
import sys
import tempfile

import numpy as np
import torch

import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu_torch.constants import divide
from mpi4torch_tpu_torch.utils import CheckpointManager
from mpi4torch_tpu_torch.utils.tree import tree_map, value_and_grad

comm = mpi.COMM_WORLD

N_STEPS = 8
CRASH_AFTER = 3          # the simulated preemption point
LR, MOMENTUM = 0.002, 0.9


def _dtype(device):
    return torch.float64 if device.type == "cpu" else torch.float32


def make_data(rank: int, size: int, device):
    xs = torch.from_numpy(np.linspace(0.0, 1.0, 64 * size)).to(
        device, _dtype(device))
    ys = 3.0 * xs + 0.5
    lo = rank * 64
    return xs[lo:lo + 64], ys[lo:lo + 64]


def loss_fn(params, x, y):
    params = divide(comm.Allreduce(params, mpi.MPI_SUM), comm.size)
    pred = params[0] * x + params[1]
    local = torch.sum((pred - y) ** 2)
    return comm.Allreduce(local, mpi.MPI_SUM)


def train_step(state, x, y):
    loss, g = value_and_grad(lambda p: loss_fn(p, x, y), state["params"])
    vel = MOMENTUM * state["vel"] + g
    return {"params": state["params"] - LR * vel, "vel": vel,
            "step": state["step"] + 1}, loss


def init_state(device):
    return {"params": torch.zeros(2, dtype=_dtype(device), device=device),
            "vel": torch.zeros(2, dtype=_dtype(device), device=device),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def train(workdir, stop_after=None):
    """Train, checkpointing every step, from the latest step when there
    is one; returns ``(state, losses)``.  Only rank 0 reads and writes
    ``workdir`` (the other rank threads may pass None)."""
    rank, device = comm.rank, comm.device
    x, y = make_data(rank, comm.size, device)
    state = init_state(device)
    mgr = CheckpointManager(workdir, max_to_keep=2) if rank == 0 else None
    start = 0
    if rank == 0 and mgr.latest_step() is not None:
        start = mgr.latest_step() + 1
        state = mgr.restore(mgr.latest_step(), template=state)
    # Every rank resumes from rank 0's state.
    state = tree_map(lambda a: comm.Bcast_(a, 0), state)
    start = int(comm.Bcast_(torch.tensor(start, device=device), 0))

    losses = []
    for step in range(start, N_STEPS):
        state, loss = train_step(state, x, y)
        losses.append(float(loss))
        if rank == 0:
            mgr.save(step, state)
        if stop_after is not None and step + 1 - start >= stop_after:
            break
    if rank == 0:
        mgr.close()
    return state, losses


def main(workdir=None):
    """The uninterrupted run, then a run preempted after
    ``CRASH_AFTER`` steps and resumed: the final parameters are bitwise
    equal.  Returns ``(params, uninterrupted losses, resumed losses)``."""
    ref_state, ref_losses = train(f"{workdir}_ref" if workdir else None)
    train(workdir, stop_after=CRASH_AFTER)
    state, tail = train(workdir)
    if not torch.equal(state["params"], ref_state["params"]):
        raise AssertionError("the resumed run left the uninterrupted one")
    if int(state["step"]) != N_STEPS:
        raise AssertionError(f"resumed to step {int(state['step'])}, not "
                             f"{N_STEPS}")
    return state["params"], ref_losses, tail


def run(nranks: int = 4, device=None, workdir=None):
    """:func:`main` on ``nranks`` rank threads in ``workdir`` (a fresh
    temporary directory, removed afterwards, when None); every rank's
    parameters must agree.  Returns rank 0's result."""
    dev = mpi.resolve_device(device)
    cleanup = workdir is None
    if cleanup:
        workdir = tempfile.mkdtemp(prefix="mpi4torch_tpu_torch_ckpt_")
    try:
        outs = mpi.run_ranks(
            lambda r: main(workdir if r == 0 else None), nranks, device=dev)
    finally:
        if cleanup:
            shutil.rmtree(workdir, ignore_errors=True)
            shutil.rmtree(f"{workdir}_ref", ignore_errors=True)
    if not all(torch.equal(outs[0][0], o[0]) for o in outs):
        raise AssertionError("the ranks' parameters differ")
    return outs[0]


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    n = int(args[0]) if args else 4
    params, losses, tail = run(
        n, device="cpu" if "--cpu" in sys.argv else None,
        workdir=args[1] if len(args) > 1 else None)
    last = f"final loss {tail[-1]:.6f}" if tail else \
        "checkpointed run already complete"
    print(f"{n} ranks: the resumed run matches the uninterrupted run "
          f"bit for bit at step {N_STEPS}; {last}; params "
          f"{params.cpu().numpy()}")
