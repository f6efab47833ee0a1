"""ViT with DP training, then patch-parallel inference.

The torch version of the JAX package's ViT example, two phases over the
communicator:

1. **DP training** — each rank trains the ViT on its batch shard with the
   per-gradient ``Allreduce(g, MPI_SUM) / size`` recipe
   (``models.vit.dp_grad_train_step``), fed by ``utils.shard_batches_comm``
   and ``utils.prefetch_to_device``;
2. **patch-parallel inference** — the trained model classifies a batch
   with its patch axis sharded over the same ranks: every block's
   attention is non-causal ring attention, and the logits must match the
   single-device forward.

float32, on the CUDA device unless ``--cpu`` is given.

Run:  python -m mpi4torch_tpu_torch.examples.vit_patch_parallel [nranks]
      [steps] [--cpu]
"""

import sys

import numpy as np
import torch

import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu_torch.models import vit as V
from mpi4torch_tpu_torch.utils import prefetch_to_device, shard_batches_comm

comm = mpi.COMM_WORLD

CFG = V.ViTConfig(image_hw=16, patch=4, d_model=32, n_heads=4,
                  n_layers=2, d_ff=64, num_classes=10)


def synthetic_images(seed, n, cfg):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(
        (n, cfg.image_hw, cfg.image_hw, cfg.channels)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, n).astype(np.int32)
    return x, y


def main(steps: int = 3, cfg: V.ViTConfig = CFG, batch_per_rank: int = 2,
         params=None):
    """``steps`` DP steps from ``params`` (None: the port's own init from
    seed 0), then the patch-parallel forward; returns ``(losses, head,
    sharded logits, single-device logits)``."""
    if params is None:
        params = V.init_vit(0, cfg, device=comm.device)
    data = synthetic_images(7, comm.size * batch_per_rank, cfg)

    def epochs():
        for epoch in range(steps):
            yield from shard_batches_comm(data, batch_per_rank, comm,
                                          seed=7, epoch=epoch)

    losses = []
    for batch in prefetch_to_device(epochs(), device=comm.device):
        loss, params = V.dp_grad_train_step(comm, cfg, params, batch,
                                            lr=0.05)
        losses.append(loss.item())

    # Phase 2: classify with the patch axis sharded over the ranks.
    if cfg.n_patches % comm.size != 0:
        raise ValueError(
            f"patch parallelism needs the {cfg.n_patches} patches to split "
            f"evenly over {comm.size} ranks — run with a divisor rank count")
    images = torch.from_numpy(data[0][:batch_per_rank]).to(comm.device)
    patches = V.patchify(cfg, images)
    sl = cfg.n_patches // comm.size
    local = patches[:, comm.rank * sl:(comm.rank + 1) * sl]
    sharded = V.forward_patches(cfg, params, local, comm_sp=comm)
    single = V.forward(cfg, params, images)
    if comm.rank == 0:
        for i, loss in enumerate(losses):
            print(f"step {i}: global loss {loss:.4f}")
    return (losses, params["head"].cpu().numpy(),
            sharded.detach().cpu().numpy(), single.detach().cpu().numpy())


def run(nranks: int = 4, device=None, **kw):
    """Run :func:`main` on ``nranks`` rank threads: the ranks stay in
    lock-step, the loss falls, and every rank's patch-parallel logits
    match the single-device ones (rtol 1e-5)."""
    outs = mpi.run_ranks(lambda: main(**kw), nranks, device=device)
    losses0, head0, _, _ = outs[0]
    assert all(np.array_equal(head0, h) for _, h, _, _ in outs), \
        "ranks diverged"
    assert losses0[-1] < losses0[0], losses0
    for _, _, sharded, single in outs:
        np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-6)
    return outs[0]


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    n = int(args[0]) if args else 4
    steps = int(args[1]) if len(args) > 1 else 3
    losses = run(n, device="cpu" if "--cpu" in sys.argv else None,
                 steps=steps)[0]
    print(f"OK: {n}-rank DP ViT trained in lock-step ({losses[0]:.3f} -> "
          f"{losses[-1]:.3f}) and patch-parallel ring-attention inference "
          "matched the single-device forward")
