"""Data-parallel ResNet-18 on CIFAR-10-shaped data (BASELINE.md config 4).

The torch version of the JAX package's ResNet example: the classic DDP
recipe over the differentiable Allreduce.  Each rank computes a local
backward on its batch shard, then every parameter gradient is averaged
with one ``Allreduce(g, MPI_SUM) / size`` (``models.resnet.
dp_grad_train_step``).  The batches come through the input pipeline: one
seeded permutation per epoch shared by construction
(``utils.shard_batches_comm``), static per-step shapes, and the next
shard's host-to-device copy staged behind the current step
(``utils.prefetch_to_device``).

The data is synthetic CIFAR-10-shaped (32 x 32 x 3, 10 classes, drawn
from a numpy seed), so the example runs without the dataset; real numpy
CIFAR batches drop in for ``make_synthetic_cifar``.  float32, on the CUDA
device unless ``--cpu`` is given.

Run:  python -m mpi4torch_tpu_torch.examples.resnet_cifar_dp [nranks]
      [steps] [--cpu]
"""

import sys

import numpy as np

import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu_torch.models import resnet as R
from mpi4torch_tpu_torch.utils import prefetch_to_device, shard_batches_comm

comm = mpi.COMM_WORLD

CFG = R.ResNetConfig(num_classes=10)
BATCH_PER_RANK = 8
IMAGE_HW = 32


def make_synthetic_cifar(seed, n, hw, num_classes):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, hw, hw, 3)).astype(np.float32)
    labels = rng.integers(0, num_classes, n).astype(np.int32)
    return images, labels


def main(steps: int = 3, cfg: R.ResNetConfig = CFG, hw: int = IMAGE_HW,
         batch_per_rank: int = BATCH_PER_RANK, params=None):
    """``steps`` DP steps from ``params`` (``(params, state)``; None: the
    port's own init from seed 0); returns ``(losses, head weight)``."""
    if params is None:
        params = R.init_resnet(0, cfg, device=comm.device)
    params, state = params
    data = make_synthetic_cifar(7, comm.size * batch_per_rank, hw,
                                cfg.num_classes)

    def epochs():
        # One global batch per epoch: each epoch revisits the same
        # examples under a fresh (seed, epoch) permutation.
        for epoch in range(steps):
            yield from shard_batches_comm(data, batch_per_rank, comm,
                                          seed=7, epoch=epoch)

    losses = []
    for batch in prefetch_to_device(epochs(), device=comm.device):
        loss, params, state = R.dp_grad_train_step(
            comm, cfg, params, state, batch, lr=0.05)
        losses.append(loss.item())
    if comm.rank == 0:
        for i, loss in enumerate(losses):
            print(f"step {i}: global loss {loss:.4f}")
    return losses, params["head"]["w"].cpu().numpy()


def run(nranks: int = 4, device=None, **kw):
    """Run :func:`main` on ``nranks`` rank threads: the ranks stay in
    lock-step (bitwise equal heads) and the loss falls."""
    outs = mpi.run_ranks(lambda: main(**kw), nranks, device=device)
    losses0, head0 = outs[0]
    assert all(np.array_equal(head0, h) for _, h in outs), "ranks diverged"
    assert losses0[-1] < losses0[0], losses0
    return outs[0]


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    n = int(args[0]) if args else 4
    steps = int(args[1]) if len(args) > 1 else 3
    losses, _ = run(n, device="cpu" if "--cpu" in sys.argv else None,
                    steps=steps)
    print(f"OK: {n}-rank DP ResNet-18 stayed in lock-step and the loss "
          f"fell {losses[0]:.4f} -> {losses[-1]:.4f}")
