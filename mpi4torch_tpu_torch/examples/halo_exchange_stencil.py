"""Distributed 2D stencil loss via differentiable halo exchange
(BASELINE config 5).

A 5-point-Laplacian residual loss on a 2D periodic grid, row-partitioned
across ranks.  Each evaluation exchanges one-row halos with both
neighbours over the differentiable Isend/Irecv/Wait ring
(:func:`mpi4torch_tpu_torch.parallel.ring.halo_exchange`), applies the
stencil locally, and Allreduces the squared residual.  L-BFGS on the
field then drives ``lap(u) = g``; boundary-row gradients travel the
reverse ring.  The globally reduced line-search scalars keep N ranks on
the single-rank trajectory, up to the summation order of the loss.

Run:  python -m mpi4torch_tpu_torch.examples.halo_exchange_stencil
      [nranks] [steps] [--cpu]
"""

import math
import sys

import torch

import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu_torch.parallel.ring import halo_exchange
from mpi4torch_tpu_torch.utils.lbfgs import LBFGS

comm = mpi.COMM_WORLD

GRID_N = 32  # global rows (divisible by any nranks used here)
GRID_M = 16  # columns


def source_term(n=GRID_N, m=GRID_M, dtype=torch.float64, device=None):
    """A smooth zero-mean right-hand side g with periodic structure."""
    i = torch.arange(n, dtype=torch.float64, device=device)[:, None]
    j = torch.arange(m, dtype=torch.float64, device=device)[None, :]
    g = (torch.sin(2 * math.pi * i / n) * torch.cos(2 * math.pi * j / m)
         + 0.5 * torch.sin(4 * math.pi * (i / n + j / m)))
    return g.to(dtype)


def local_laplacian(u_local):
    """5-point periodic Laplacian of this rank's row block: the row
    neighbours come from the halo exchange, the column neighbours from a
    local roll."""
    padded = halo_exchange(comm, u_local, halo=1, axis=0)
    up, center, down = padded[:-2], padded[1:-1], padded[2:]
    left = torch.roll(u_local, 1, dims=1)
    right = torch.roll(u_local, -1, dims=1)
    return up + down + left + right - 4.0 * center


def residual_loss(u_local, g_local):
    res = local_laplacian(u_local) - g_local
    return comm.Allreduce(torch.sum(res * res), mpi.MPI_SUM)


def main(steps: int = 80, n: int = GRID_N, m: int = GRID_M,
         dtype=torch.float64, history_size: int = 10, callback=None):
    """Solve ``lap(u) = g`` on an ``n x m`` grid by L-BFGS on the
    distributed residual loss, from ``u = 0``.  Returns ``([loss before,
    loss after], u_local)``."""
    if n % comm.size != 0:
        raise ValueError(
            f"{n} rows must divide evenly over {comm.size} ranks (an "
            "uneven split would silently solve a truncated grid)")
    rows = n // comm.size
    g_local = source_term(n, m, dtype, comm.device)[
        comm.rank * rows:(comm.rank + 1) * rows]
    u = torch.zeros((rows, m), dtype=dtype, device=comm.device)

    loss0 = float(residual_loss(u, g_local))
    # comm: u is domain-decomposed (each rank owns its row block), so the
    # line-search scalars must be global reductions to stay in lock-step.
    opt = LBFGS(max_iter=steps, history_size=history_size, comm=comm)
    u, loss = opt.step(lambda v: residual_loss(v, g_local), u,
                       callback=callback)
    if comm.rank == 0:
        print(f"residual^2: {loss0:.6f} -> {loss:.3e} (<= {steps} L-BFGS "
              f"iters on {comm.size} rank(s))")
    return [loss0, loss], u


def run(nranks: int = 4, steps: int = 80, device=None):
    """Run :func:`main` on ``nranks`` rank threads; check convergence and
    that the zero-mean source kept the field's mean at 0."""
    results = mpi.run_ranks(lambda: main(steps), nranks, device=device)
    losses0 = results[0][0]
    full = torch.cat([u for _, u in results], dim=0)
    assert losses0[-1] < 1e-2 * losses0[0], losses0[-1]
    # The solution of lap(u) = g is unique only up to a constant on a
    # periodic domain; the zero-init gradient flow keeps the mean at 0.
    assert abs(float(full.mean())) < 1e-8
    return results


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    n = int(args[0]) if args else 4
    steps = int(args[1]) if len(args) > 1 else 80
    run(n, steps, device="cpu" if "--cpu" in sys.argv else None)
    print(f"OK: {n}-rank stencil converged")
