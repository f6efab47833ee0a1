"""Train a tiny character LM data-parallel, then decode with a KV cache.

The torch version of the JAX package's ``generate_kv_cache`` example: the
flagship transformer (GQA, a sliding attention window) trains for a few
steps with the reference's two-Allreduce DP recipe (parameter averaging
through ``all_average_tree`` and the Allreduce'd mean loss, whose
adjoints keep every rank's SGD in lock-step) on a memorizable pattern,
next token = (token + 1) % 8; then text is generated two ways:

* ``models.transformer.generate``: one batched prefill, then one KV-cache
  ``decode_step`` per token (the cache holds the ``n_kv_heads`` heads);
* a greedy loop of full forwards (the oracle).

Both must emit the same tokens.  float64 on the CPU; on a GPU float32,
where attention runs the ``simt`` CUDA kernels (no float64 attention
kernel exists).

Run:  python -m mpi4torch_tpu_torch.examples.generate_kv_cache [nranks]
      [--cpu]
"""

import sys

import numpy as np
import torch

import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu_torch.constants import divide
from mpi4torch_tpu_torch.models import transformer as T
from mpi4torch_tpu_torch.parallel import all_average_tree
from mpi4torch_tpu_torch.utils.tree import tree_map, value_and_grad

CFG = T.TransformerConfig(vocab=16, d_model=32, n_heads=4, n_layers=2,
                          d_ff=64, max_seq=32, n_kv_heads=2, attn_window=8)
STEPS, BATCH, LR = 150, 8, 3e-2
PROMPT, N_NEW = (3, 4, 5, 6), 12


def dtype_for(device) -> torch.dtype:
    return torch.float64 if device.type == "cpu" else torch.float32


def make_data(seed: int = 1) -> np.ndarray:
    """A repeating pattern, next token = (token + 1) % 8, from random
    starts: (BATCH, max_seq) int64."""
    start = np.random.default_rng(seed).integers(0, 8, (BATCH, 1))
    return (start + np.arange(CFG.max_seq)[None, :]) % 8


def train(params0, tokens, steps: int = STEPS):
    """DP SGD on this rank's shard of ``tokens``; returns ``(final global
    loss, params)``."""
    comm = mpi.COMM_WORLD
    shard = tokens.shape[0] // comm.size
    local = tokens[comm.rank * shard:(comm.rank + 1) * shard]

    def loss_fn(p):
        if comm.size == 1:
            return T.lm_loss(CFG, p, local)
        p = all_average_tree(comm, p)
        return divide(comm.Allreduce(T.lm_loss(CFG, p, local), mpi.MPI_SUM),
                      comm.size)

    params, loss = params0, None
    for _ in range(steps):
        loss, grads = value_and_grad(loss_fn, params)
        params = tree_map(lambda p, g: p - LR * g, params, grads)
    return loss.item(), params


def decode(params, device):
    """``generate()``'s tokens and the full-forward oracle's, for the
    prompt; they must be equal."""
    prompt = torch.tensor([PROMPT], dtype=torch.int64, device=device)
    out = T.generate(CFG, params, prompt, N_NEW)
    seq = prompt
    for _ in range(N_NEW):
        nxt = torch.argmax(T.forward(CFG, params, seq)[:, -1], dim=-1)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    assert torch.equal(out, seq), \
        "KV-cache decode diverged from the full-forward oracle"
    return out[0, len(PROMPT):].cpu().numpy()


def run(nranks: int = 4, device=None, params=None, tokens=None,
        steps: int = STEPS):
    """Train on ``nranks`` rank threads (every rank must end on the same
    loss), then decode on rank 0's parameters.  ``params`` and ``tokens``
    default to ``init_transformer(0)`` and :func:`make_data`.  Returns
    ``(loss, params, generated tokens, the pattern's continuation)``."""
    dev = mpi.resolve_device(device)
    dtype = dtype_for(dev)
    if params is None:
        params = T.init_transformer(0, CFG, dtype, device=dev)
    tokens = torch.from_numpy(make_data() if tokens is None
                              else np.array(tokens, np.int64)).to(dev)
    outs = mpi.run_ranks(lambda: train(params, tokens, steps), nranks,
                         device=dev)
    loss, trained = outs[0]
    assert all(o[0] == loss for o in outs), "DP ranks diverged"
    gen = decode(trained, dev)
    want = (PROMPT[-1] + 1 + np.arange(N_NEW)) % 8
    return loss, trained, gen, want


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    n = int(args[0]) if args else 4
    loss, _, gen, want = run(n, device="cpu" if "--cpu" in sys.argv
                             else None)
    print(f"trained {STEPS} steps on {n} ranks: loss {loss:.4f}")
    print(f"prompt {list(PROMPT)} -> generated {gen}; pattern "
          f"continuation accuracy {(gen == want).mean():.0%}")
