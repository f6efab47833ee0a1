"""ZeRO-1 and ZeRO-3: data-parallel training with sharded state.

The torch version of the JAX package's ``zero_sharded_optimizer``
example, with the port's functional ``utils.optim.adam`` in place of
optax.  Plain DP replicates Adam's two moments on every rank.  ZeRO-1
shards them: each rank's un-reduced local gradients are reduce-scattered,
each rank updates its 1/N parameter shard, and an Allgather
re-replicates the parameters; the optimizer is element-wise, so the
final parameters equal the replicated-DP result, checked here against a
single-process Adam oracle on every rank and leaf.  ZeRO-3 also shards
the parameters between steps: the forward gathers them on use and the
gradient comes back sharded through the Allgather's adjoint.

Run:  python -m mpi4torch_tpu_torch.examples.zero_sharded_optimizer
      [nranks] [--cpu]
"""

import sys

import numpy as np
import torch

import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu_torch.constants import divide
from mpi4torch_tpu_torch.parallel import (zero3_init, zero3_params,
                                          zero3_step, zero_init, zero_step)
from mpi4torch_tpu_torch.utils.optim import adam
from mpi4torch_tpu_torch.utils.tree import tree_map, value_and_grad

N, D, STEPS, LR = 64, 8, 30, 1e-1
# Every rank against the oracle: float64 on the CPU, float32 on a GPU.
RTOL = {torch.float64: 1e-9, torch.float32: 1e-5}


def make_problem(device):
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D))
    w_true = rng.standard_normal((D,))
    y = x @ w_true + 0.05 * rng.standard_normal((N,))
    return (torch.from_numpy(x).to(device, dtype),
            torch.from_numpy(y).to(device, dtype))


def local_loss(p, xl, yl):
    return torch.sum((yl - xl @ p["w"] - p["b"]) ** 2)


def oracle(x, y, nranks: int):
    """Single-process Adam on the rank-mean loss."""
    p = {"w": x.new_zeros(D), "b": x.new_zeros(())}
    opt = adam(LR)
    state = opt.init(p)
    for _ in range(STEPS):
        _, g = value_and_grad(
            lambda q: divide(local_loss(q, x, y), nranks), p)
        u, state = opt.update(g, state, p)
        p = tree_map(torch.add, p, u)
    return p


def zero1():
    comm = mpi.COMM_WORLD
    x, y = make_problem(comm.device)
    shard = N // comm.size
    xl, yl = (t[comm.rank * shard:(comm.rank + 1) * shard] for t in (x, y))
    opt = adam(LR)
    params = {"w": x.new_zeros(D), "b": x.new_zeros(())}
    state = zero_init(comm, opt, params)   # 1/N of the Adam moments
    for _ in range(STEPS):
        _, g = value_and_grad(lambda p: local_loss(p, xl, yl), params)
        params, state = zero_step(comm, opt, params, g, state)
    return params


def zero3():
    # No collective in this loop besides the gather inside zero3_step:
    # the reduction is its adjoint.
    comm = mpi.COMM_WORLD
    x, y = make_problem(comm.device)
    shard = N // comm.size
    xl, yl = (t[comm.rank * shard:(comm.rank + 1) * shard] for t in (x, y))
    opt = adam(LR)
    template = {"w": x.new_zeros(D), "b": x.new_zeros(())}
    p_shards, state = zero3_init(comm, opt, template)
    for _ in range(STEPS):
        _, p_shards, state = zero3_step(
            comm, opt, p_shards, template,
            lambda p: local_loss(p, xl, yl), state)
    return zero3_params(comm, p_shards, template)


def run(nranks: int = 4, device=None):
    """ZeRO-1 and ZeRO-3 on ``nranks`` rank threads, each rank's final
    parameters against the oracle; returns ``(ZeRO-1 params of rank 0,
    ZeRO-3 params of rank 0, oracle params)``."""
    if N % nranks != 0:
        raise SystemExit(
            f"nranks must divide the dataset size {N}, got {nranks}")
    dev = mpi.resolve_device(device)
    x, y = make_problem(dev)
    ref = oracle(x, y, nranks)
    rtol = RTOL[x.dtype]
    outs1 = mpi.run_ranks(zero1, nranks, device=dev)
    outs3 = mpi.run_ranks(zero3, nranks, device=dev)
    for name, outs in (("zero1", outs1), ("zero3", outs3)):
        for r, got in enumerate(outs):
            # Every leaf, every rank: "b" is the scalar leaf that takes
            # the shard's zero padding.
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    got[k].cpu().numpy(), ref[k].cpu().numpy(), rtol=rtol,
                    err_msg=f"{name}: rank {r} leaf {k} left the oracle")
    return outs1[0], outs3[0], ref


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    n = int(args[0]) if args else 4
    p1, _, _ = run(n, device="cpu" if "--cpu" in sys.argv else None)
    print(f"{n} ranks, Adam state sharded 1/{n} (ZeRO-1) and parameters "
          f"too (ZeRO-3): every rank matches the replicated-DP oracle")
    print(f"w = {p1['w'].cpu().numpy().round(3)}")
