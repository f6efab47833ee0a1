"""Pipeline-parallel training: GPipe and 1F1B over the p2p substrate.

The torch version of the JAX package's pipeline example.  Stage ``r`` of
a small MLP chain lives on rank ``r``; microbatch activations travel rank
to rank over the differentiable ``Isend/Irecv/Wait`` transport.  Two
schedules, the same gradients:

* ``pipeline_step`` (GPipe fill-drain) — one backward over the whole rank
  program; the reverse pipeline (cotangents hopping rank r+1 -> r) is the
  adjoint of the transport;
* ``pipeline_step_1f1b`` (PipeDream-flush) — per-microbatch pullbacks by
  hand, at most ``size - rank`` activation graphs alive per stage.

The script checks that the two schedules give the same loss and
gradients on step 1, then trains with 1F1B and checks that the loss
drops.  float64, on the CUDA device unless ``--cpu`` is given.

Run:  python -m mpi4torch_tpu_torch.examples.pipeline_training [nranks]
      [--cpu]
"""

import sys

import numpy as np
import torch

import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu_torch.parallel import pipeline_step, pipeline_step_1f1b

comm = mpi.COMM_WORLD

D, B, N_MB, N_STEPS, LR = 8, 4, 6, 30, 0.05


def make_problem(size: int, device, seed=0):
    """Per-stage parameters, microbatches and regression targets (the
    last stage's loss pulls the chain's output toward a fixed random
    map); the same numpy draws as the JAX package's example."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a).to(device)

    stages = [{"w": t(rng.standard_normal((D, D)) / np.sqrt(D)),
               "b": t(np.zeros(D))} for _ in range(size)]
    mbs = [t(rng.standard_normal((B, D))) for _ in range(N_MB)]
    targets = [t(np.tanh(rng.standard_normal((B, D)))) for _ in range(N_MB)]
    return stages, mbs, targets


def apply_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def main():
    rank, size = comm.rank, comm.size
    stages, mbs, targets = make_problem(size, comm.device)

    def loss_fn(y, i):
        return torch.mean((y - targets[i]) ** 2)

    recv_like = torch.zeros_like(mbs[0]) if rank > 0 else None
    p = stages[rank]

    # Step 1 under both schedules: the same loss and gradients.
    l_g, g_g = pipeline_step(comm, apply_stage, p, mbs, loss_fn,
                             recv_like=recv_like)
    l_f, g_f = pipeline_step_1f1b(comm, apply_stage, p, mbs, loss_fn,
                                  recv_like=recv_like)
    np.testing.assert_allclose(l_g.item(), l_f.item(), rtol=1e-12)
    for k in ("w", "b"):
        np.testing.assert_allclose(g_g[k].cpu().numpy(),
                                   g_f[k].cpu().numpy(), rtol=1e-9,
                                   atol=1e-12)

    # Train with the memory-bounded schedule.
    losses = []
    for _ in range(N_STEPS):
        loss, g = pipeline_step_1f1b(comm, apply_stage, p, mbs, loss_fn,
                                     recv_like=recv_like)
        p = {k: p[k] - LR * g[k] for k in p}
        losses.append(loss.item())
    assert losses[-1] < 0.7 * losses[0], (losses[0], losses[-1])
    if rank == 0:
        print(f"rank 0: schedules agree; 1F1B training "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} over {N_STEPS} steps")
    return losses


def run(nranks: int = 4, device=None):
    """Run :func:`main` on ``nranks`` rank threads; every rank must see
    the same loss trajectory."""
    outs = mpi.run_ranks(main, nranks, device=device)
    assert all(o == outs[0] for o in outs), "ranks diverged"
    return outs[0]


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    n = int(args[0]) if args else 4
    losses = run(n, device="cpu" if "--cpu" in sys.argv else None)
    print(f"OK: {n} ranks, loss {losses[0]:.4f} -> {losses[-1]:.4f}")
