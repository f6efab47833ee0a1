"""Data-parallel training with compressed gradient sync.

The torch version of the JAX package's compressed data-parallel example:
the linear-regression recipe with the gradient Allreduce on the quantized
wire, three runs of the same SGD loop —

  1. exact gradient sync (the baseline),
  2. ``compression="q8_ef"`` — block-scaled int8 with an in-call
     error-feedback round,
  3. single-round ``q8`` with the residual carried across steps
     (``compress.ef_init``/``ef_allreduce``, EF-SGD).

The compressed runs land within 2% of the exact loss; rank 0 prints the
final losses and each codec's wire reduction at a 1 Mi-element f32
gradient (``Codec.wire_bytes``).  float64, on the CUDA device unless
``--cpu`` is given (the q8 encodes then run on the hop kernel).

Run:  python -m mpi4torch_tpu_torch.examples.compressed_data_parallel
      [nranks] [--cpu]
"""

import sys

import numpy as np
import torch

import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu_torch.compress import ef_allreduce, ef_init, get_codec
from mpi4torch_tpu_torch.constants import divide

comm = mpi.COMM_WORLD

NUM_POINTS = 512
STEPS = 150
LR = 0.1


def some_parametrized_function(inp, params):
    return (params[2] * inp + params[1]) * inp + params[0]


def _shard(rank, size, device):
    rng = np.random.default_rng(42)
    x = 2.0 * rng.random(NUM_POINTS)
    gen = np.asarray([0.1, 1.0, -2.0])
    y = some_parametrized_function(x, gen) \
        + 0.05 * rng.standard_normal(NUM_POINTS)
    n = NUM_POINTS // size
    lo = rank * n
    return (torch.from_numpy(x[lo:lo + n]).to(device),
            torch.from_numpy(y[lo:lo + n]).to(device))


def train(compression=False, stateful_ef=False):
    """One SGD run; returns ``(final global loss, params)``."""
    xs, ys = _shard(comm.rank, comm.size, comm.device)

    def local_loss(p):
        pred = some_parametrized_function(xs, p)
        return divide(torch.mean((ys - pred) ** 2), comm.size)

    params = torch.zeros(3, dtype=torch.float64, device=xs.device)
    resid = ef_init(params)
    for _ in range(STEPS):
        p = params.detach().requires_grad_()
        (g,) = torch.autograd.grad(local_loss(p), p)
        if stateful_ef:
            # The residual is carried across steps: single-round q8 wire,
            # the untransmitted error joins the next step's gradient.
            g, resid = ef_allreduce(comm, g, resid, compression=compression)
        else:
            g = comm.Allreduce(g, mpi.MPI_SUM, compression=compression)
        params = params - LR * g
    final = comm.Allreduce(local_loss(params), mpi.MPI_SUM)
    return final.item(), params


def main():
    fp32_loss, fp32_params = train(compression=False)
    ef_loss, _ = train(compression="q8_ef")
    st_loss, _ = train(compression="q8", stateful_ef=True)
    if comm.rank == 0:
        # Wire accounting at a model-scale gradient (1 Mi f32 elements):
        # this example's 3-entry gradient is all block padding.
        nelem = 1 << 20
        fp32_bytes = nelem * 4
        rows = [("fp32 (exact)", fp32_loss, 1.0)] + [
            (label, loss, fp32_bytes / get_codec(name).wire_bytes(
                (nelem,), torch.float32))
            for label, loss, name in (("q8_ef (in-call EF)", ef_loss,
                                       "q8_ef"),
                                      ("q8 + carried EF", st_loss, "q8"))]
        print(f"{'gradient sync':<22} {'final loss':>12} "
              f"{'wire reduction':>15}")
        for name, loss, ratio in rows:
            print(f"{name:<22} {loss:>12.6f} {ratio:>14.2f}x")
        print("params (fp32 run):", fp32_params.cpu().numpy())
    return fp32_loss, ef_loss, st_loss


def run(nranks: int = 2, device=None):
    """Run :func:`main` on ``nranks`` rank threads; every rank must see the
    same losses, and the compressed ones within 2% of the exact one."""
    outs = mpi.run_ranks(main, nranks, device=device)
    assert all(o == outs[0] for o in outs), "ranks diverged"
    fp32, ef, st = outs[0]
    assert abs(ef - fp32) <= 0.02 * fp32 and abs(st - fp32) <= 0.02 * fp32
    return outs[0]


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    n = int(args[0]) if args else 2
    run(n, device="cpu" if "--cpu" in sys.argv else None)
    print(f"OK: {n} ranks, compressed runs within 2% of the exact loss")
