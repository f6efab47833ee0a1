"""Data-parallel polynomial regression with L-BFGS (BASELINE config 1).

The torch version of the mpi4torch reference's canonical example: each
rank holds a chunk of the data, and the loss contains exactly two
communication calls:

  1. ``Allreduce(params, MPI_SUM) / size`` averages the (replicated)
     parameters so every rank's optimizer stays arithmetically identical;
     its adjoint divides by size again, so the total gradients are pure
     sums and the run does not depend on the rank count;
  2. ``Allreduce(localloss, MPI_SUM)``, the global loss.

Run:  python -m mpi4torch_tpu_torch.examples.simple_linear_regression
      [nranks] [--cpu]
"""

import sys

import numpy as np
import torch

import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu_torch.constants import divide
from mpi4torch_tpu_torch.utils.lbfgs import LBFGS

comm = mpi.COMM_WORLD


def some_parametrized_function(inp, params):
    return (params[2] * inp + params[1]) * inp + params[0]


def main():
    rng = np.random.default_rng(42)
    device = comm.device

    num_points = 10000
    chunk_size = num_points // comm.size
    rest = num_points % comm.size
    if comm.rank < rest:
        chunk_size += 1
        offset = chunk_size * comm.rank
    else:
        offset = chunk_size * comm.rank + rest

    xinput = torch.from_numpy(
        2.0 * rng.random(num_points)[offset:offset + chunk_size]).to(device)

    gen_params = torch.tensor([0.1, 1.0, -2.0], dtype=torch.float64,
                              device=device)
    youtput = some_parametrized_function(xinput, gen_params)

    def lossfunction(params):
        # average initial params to bring all ranks on the same page
        params = divide(comm.Allreduce(params, mpi.MPI_SUM), comm.size)

        # compute local loss
        localloss = torch.sum(torch.square(
            youtput - some_parametrized_function(xinput, params)))

        # sum up the loss among all ranks
        return comm.Allreduce(localloss, mpi.MPI_SUM)

    params = torch.arange(3, dtype=torch.float64, device=device)

    # L-BFGS needs only one outer step for so few parameters
    optimizer = LBFGS(max_iter=30)
    params, loss = optimizer.step(lossfunction, params)

    # only print output on rank 0
    if comm.rank == 0:
        print("Loss  : ", loss)
        print("Final parameters: ", params.cpu().numpy())
    return params.cpu().numpy(), loss


def run(nranks: int = 4, device=None):
    """Run :func:`main` on ``nranks`` rank threads and check that the
    ranks converged identically to the generating parameters."""
    results = mpi.run_ranks(main, nranks, device=device)
    params0, _ = results[0]
    assert all(np.array_equal(params0, p) for p, _ in results), \
        "ranks diverged"
    assert np.allclose(params0, [0.1, 1.0, -2.0], atol=1e-5), params0
    return results


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    n = int(args[0]) if args else 4
    run(n, device="cpu" if "--cpu" in sys.argv else None)
    print(f"OK: {n} ranks converged identically to the generating "
          "parameters")
