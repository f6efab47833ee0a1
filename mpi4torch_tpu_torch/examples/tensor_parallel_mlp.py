"""Tensor-parallel MLP training: Megatron column -> row sharding.

The torch version of the JAX package's tensor-parallel example:

* ``w1`` column-sharded, ``w2`` row-sharded (``shard_axis``);
* one ``Allreduce`` forward per MLP (``tp_mlp``), its adjoint the one
  backward collective;
* each rank's gradients are its shards' exact gradients (times the rank
  count: every rank seeds its backward), so a plain SGD step per rank
  trains the sharded model in lock-step with the single-device oracle,
  checked at every step.  float64 on the CPU, float32 on a GPU.

Run:  python -m mpi4torch_tpu_torch.examples.tensor_parallel_mlp
      [nranks] [--cpu]
"""

import sys

import numpy as np
import torch
import torch.nn.functional as F

import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu_torch.parallel import shard_axis, tp_mlp
from mpi4torch_tpu_torch.utils.tree import tree_map, value_and_grad

comm = mpi.COMM_WORLD

D_IN, D_FF, B, N_STEPS, LR = 8, 32, 16, 15, 0.1
# TP vs the single-device oracle: float64 on the CPU, float32 on a GPU.
RTOL = {torch.float64: 1e-10, torch.float32: 1e-5}


def make_problem(device, seed=0):
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a).to(device, dtype)

    params = {
        "w1": t(rng.standard_normal((D_IN, D_FF)) / np.sqrt(D_IN)),
        "b1": t(np.zeros(D_FF)),
        "w2": t(rng.standard_normal((D_FF, D_IN)) / np.sqrt(D_FF)),
        "b2": t(np.zeros(D_IN)),
    }
    x = t(rng.standard_normal((B, D_IN)))
    y = t(np.tanh(rng.standard_normal((B, D_IN))))
    return params, x, y


def dense_loss(params, x, y):
    h = F.gelu(x @ params["w1"] + params["b1"], approximate="tanh")
    return torch.mean((h @ params["w2"] + params["b2"] - y) ** 2)


def main():
    params, x, y = make_problem(comm.device)
    rtol = RTOL[x.dtype]

    ref, ref_losses = params, []
    for _ in range(N_STEPS):
        loss, g = value_and_grad(dense_loss, ref, x, y)
        ref = tree_map(lambda a, b: a - LR * b, ref, g)
        ref_losses.append(loss.item())

    # Every rank owns a feature shard of w1/b1/w2 and the replicated b2.
    local = {"w1": shard_axis(comm, params["w1"], 1),
             "b1": shard_axis(comm, params["b1"], 0),
             "w2": shard_axis(comm, params["w2"], 0),
             "b2": params["b2"]}

    def tp_loss(p):
        out = tp_mlp(comm, x, p["w1"], p["b1"], p["w2"], p["b2"])
        return torch.mean((out - y) ** 2)

    n = comm.size
    losses = []
    for step in range(N_STEPS):
        loss, g = value_and_grad(tp_loss, local)
        # The shards sit before the row-parallel Allreduce, whose adjoint
        # sums the n seeded cotangents: their gradients arrive n x.  The
        # replicated b2 sits after it, so its n replica gradients are
        # summed here.  One lr / n then follows the oracle.
        g = dict(g, b2=comm.Allreduce(g["b2"], mpi.MPI_SUM))
        local = tree_map(lambda a, b: a - (LR / n) * b, local, g)
        losses.append(loss.item())
        np.testing.assert_allclose(loss.item(), ref_losses[step],
                                   rtol=rtol)

    sl = slice(comm.rank * (D_FF // n), (comm.rank + 1) * (D_FF // n))
    for got, want in ((local["w1"], ref["w1"][:, sl]),
                      (local["b1"], ref["b1"][sl]),
                      (local["w2"], ref["w2"][sl, :]),
                      (local["b2"], ref["b2"])):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=rtol, atol=rtol * 1e-2)
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
    print(f"OK: {n} ranks, TP trajectory == single-device oracle, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
