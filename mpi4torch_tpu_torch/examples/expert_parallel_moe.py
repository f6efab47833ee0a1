"""Expert-parallel MoE training over the differentiable Alltoall.

The torch version of the JAX package's expert-parallel example: each rank
owns ``n_experts / size`` experts and a shard of the tokens; ``moe_ffn``
sends tokens to their routed expert's rank over the differentiable
``Alltoall``, computes the local experts and combines the outputs back,
with gradients riding the reverse ``Alltoall``.

The script trains a one-layer MoE regressor and checks at every step
that the distributed loss and gradient equal the single-device oracle
(``moe_ffn_dense``: the same routing and capacity, all experts local)
on the full batch, while the router itself learns.  float64 on the CPU,
float32 on a GPU.

Two forms.  :func:`main` is the JAX package's: top-1 routing with a
capacity (tokens past it are dropped), gelu experts with biases, and
every rank holding every expert's leaves, which ``moe_ffn`` slices.
:func:`main_topk` is the dropless top-k form (``moe_topk_ffn``): each
token goes to its ``K`` most probable SwiGLU experts with renormalised
gates and none is dropped, and each rank holds only its own experts'
leaves (``expert_shard``).  Those leaves are not averaged: their
gradient, from every rank's tokens, arrives whole over the ragged
``Alltoall``'s adjoint, while the replicated router's gradient is the
rank mean.

Run:  python -m mpi4torch_tpu_torch.examples.expert_parallel_moe
      [nranks] [--cpu]
"""

import sys

import numpy as np
import torch

import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu_torch.parallel import (expert_shard, init_moe,
                                          init_moe_topk, moe_ffn,
                                          moe_ffn_dense, moe_topk_ffn,
                                          moe_topk_ffn_dense)
from mpi4torch_tpu_torch.utils.tree import tree_map, value_and_grad

comm = mpi.COMM_WORLD

D, D_FF, T_LOCAL, N_EXP_PER_RANK = 8, 16, 16, 2
CAPACITY, N_STEPS, LR, AUX = 24, 25, 0.05, 0.01
# EP vs dense oracle: float64 on the CPU, float32 on a GPU.
RTOL = {torch.float64: 1e-10, torch.float32: 1e-5}


def make_problem(size: int, device, seed=0):
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    params = init_moe(seed, N_EXP_PER_RANK * size, D, D_FF, dtype=dtype,
                      device=device)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((size * T_LOCAL, D)))
    y = torch.from_numpy(np.tanh(rng.standard_normal((size * T_LOCAL, D))))
    return params, x.to(device, dtype), y.to(device, dtype)


def main():
    rank, size = comm.rank, comm.size
    params, x, y = make_problem(size, comm.device)
    rtol = RTOL[x.dtype]
    xs, ys = (t[rank * T_LOCAL:(rank + 1) * T_LOCAL] for t in (x, y))

    def dense_loss(p):
        # The capacity is per source rank (each rank's shard routes into
        # its own C slots per expert), so the oracle applies the dense
        # layer to each shard and averages the per-shard aux losses.
        total = aux_sum = 0.0
        for r in range(size):
            xr = x[r * T_LOCAL:(r + 1) * T_LOCAL]
            yr = y[r * T_LOCAL:(r + 1) * T_LOCAL]
            out, aux = moe_ffn_dense(xr, p, CAPACITY)
            total = total + torch.sum((out + xr - yr) ** 2)
            aux_sum = aux_sum + aux
        return total / x.shape[0] + AUX * aux_sum / size

    def ep_loss(p):
        out, aux = moe_ffn(comm, xs, p, CAPACITY)
        local = torch.sum((out + xs - ys) ** 2)
        total = comm.Allreduce(local, mpi.MPI_SUM) / x.shape[0]
        return total + AUX * comm.Allreduce(aux, mpi.MPI_SUM) / size

    losses = []
    for _ in range(N_STEPS):
        ref_l, ref_g = value_and_grad(dense_loss, params)
        loss, g = value_and_grad(ep_loss, params)
        np.testing.assert_allclose(loss.item(), ref_l.item(), rtol=rtol)
        # Every rank seeds 1, so the program differentiates size x loss,
        # and expert leaves are sliced inside moe_ffn: summing the raw
        # gradients over ranks gives size x the oracle gradient for every
        # leaf, so one Allreduce / size is the dense gradient.
        g = tree_map(lambda a: comm.Allreduce(a, mpi.MPI_SUM) / size, g)
        tree_map(lambda a, b: np.testing.assert_allclose(
            a.cpu().numpy(), b.cpu().numpy(), rtol=rtol * 100,
            atol=rtol), g, ref_g)
        params = tree_map(lambda a, b: a - LR * b, params, g)
        losses.append(loss.item())
    assert losses[-1] < 0.9 * losses[0], (losses[0], losses[-1])
    return losses


K = 2   # experts a token in the dropless form


def main_topk():
    """The dropless top-k form: the same regressor, each rank holding
    ``N_EXP_PER_RANK`` experts' leaves of its own."""
    rank, size = comm.rank, comm.size
    _, x, y = make_problem(size, comm.device)
    full = init_moe_topk(1, N_EXP_PER_RANK * size, D, D_FF, dtype=x.dtype,
                         device=comm.device)
    rtol = RTOL[x.dtype]
    xs, ys = (t[rank * T_LOCAL:(rank + 1) * T_LOCAL] for t in (x, y))
    mine = expert_shard(comm, full)
    lo, hi = rank * N_EXP_PER_RANK, (rank + 1) * N_EXP_PER_RANK

    def dense_loss(p):
        return torch.sum((moe_topk_ffn_dense(x, p, K) + x - y) ** 2) \
            / x.shape[0]

    def ep_loss(p):
        local = torch.sum((moe_topk_ffn(comm, xs, p, K) + xs - ys) ** 2)
        return comm.Allreduce(local, mpi.MPI_SUM) / x.shape[0]

    losses = []
    for _ in range(N_STEPS):
        ref_l, ref_g = value_and_grad(dense_loss, full)
        loss, g = value_and_grad(ep_loss, mine)
        np.testing.assert_allclose(loss.item(), ref_l.item(), rtol=rtol)
        # Every rank seeds 1, so each gradient comes out size x the
        # oracle's: the replicated router is averaged over the ranks
        # (the sum / size), the rank's own experts are divided by size.
        g["router"] = comm.Allreduce(g["router"], mpi.MPI_SUM) / size
        g["w1"], g["w2"] = g["w1"] / size, g["w2"] / size
        for name in ("w1", "w2"):
            np.testing.assert_allclose(
                g[name].cpu().numpy(), ref_g[name][lo:hi].cpu().numpy(),
                rtol=rtol * 100, atol=rtol)
        np.testing.assert_allclose(g["router"].cpu().numpy(),
                                   ref_g["router"].cpu().numpy(),
                                   rtol=rtol * 100, atol=rtol)
        mine = tree_map(lambda a, b: a - LR * b, mine, g)
        full = tree_map(lambda a, b: a - LR * b, full, ref_g)
        losses.append(loss.item())
    assert losses[-1] < 0.9 * losses[0], (losses[0], losses[-1])
    return losses


def run_topk(nranks: int = 4, device=None):
    """Run :func:`main_topk` on ``nranks`` rank threads."""
    outs = mpi.run_ranks(main_topk, nranks, device=device)
    assert all(o == outs[0] for o in outs), "ranks diverged"
    return outs[0]


def run(nranks: int = 4, device=None):
    """Run :func:`main` on ``nranks`` rank threads; every rank must see
    the same loss trajectory."""
    outs = mpi.run_ranks(main, nranks, device=device)
    assert all(o == outs[0] for o in outs), "ranks diverged"
    return outs[0]


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    n = int(args[0]) if args else 4
    dev = "cpu" if "--cpu" in sys.argv else None
    losses = run(n, device=dev)
    print(f"OK: {n} ranks, EP == dense oracle each step, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    losses = run_topk(n, device=dev)
    print(f"OK: {n} ranks, dropless top-{K} EP with sharded experts == "
          f"dense oracle each step, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")
