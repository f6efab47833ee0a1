"""Long-context attention via ring (context parallel) and Ulysses
(sequence parallel) attention.

The torch version of the JAX package's sequence-parallel example: a
sequence is sharded across ranks, and each strategy computes exact causal
attention over the full context from the op table alone:

* **ring** — K/V blocks circulate the differentiable Isend/Irecv ring and
  merge by the online-softmax rule; per-rank memory is O(seq / ranks).
* **ulysses** — two ``Alltoall`` calls reshuffle sequence <-> head shards
  around attention over the whole sequence of each rank's heads.

Both match the single-device oracle (``dense_attention``) in values and
gradients; gradients travel the reverse ring / inverse reshuffle.  The
per-block compute is the CUDA attention kernels on a GPU (in float32:
the kernels take no float64) and their plain versions on the CPU (in
float64).

Run:  python -m mpi4torch_tpu_torch.examples.ring_attention_longcontext
      [nranks] [seq_per_rank] [--cpu]
"""

import sys

import numpy as np
import torch

import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu_torch.parallel import (dense_attention, ring_attention,
                                          ulysses_attention)

comm = mpi.COMM_WORLD

BATCH, HEADS, HEAD_DIM = 2, 4, 16
# Oracle tolerance: float64 on the CPU; float32 kernels on a GPU.
RTOL = {torch.float64: 1e-9, torch.float32: 1e-4}


def _dtype(device) -> torch.dtype:
    return torch.float64 if torch.device(device).type == "cpu" \
        else torch.float32


def make_qkv(seq_total, device, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(
            (BATCH, seq_total, HEADS, HEAD_DIM))).to(device, _dtype(device))
        for _ in range(3))


def main(seq_per_rank: int = 16, attn: str = "ring"):
    """Each rank attends its sequence shard against the full context;
    returns (local output, local dq) for reassembly by the caller."""
    q, k, v = make_qkv(comm.size * seq_per_rank, comm.device)
    sl = slice(comm.rank * seq_per_rank, (comm.rank + 1) * seq_per_rank)
    ql = q[:, sl].clone().requires_grad_()
    fn = ring_attention if attn == "ring" else ulysses_attention
    out = fn(comm, ql, k[:, sl], v[:, sl], causal=True)
    (dq,) = torch.autograd.grad(torch.sum(out ** 2), ql)
    return out.detach().cpu().numpy(), dq.cpu().numpy()


def run(nranks: int = 4, seq_per_rank: int = 16, device=None):
    """Run both strategies on ``nranks`` rank threads and check values
    and gradients against the dense oracle over the full sequence."""
    device = mpi.resolve_device(device)
    q, k, v = make_qkv(nranks * seq_per_rank, device)
    q.requires_grad_()
    ref = dense_attention(q, k, v, causal=True)
    (ref_dq,) = torch.autograd.grad(torch.sum(ref ** 2), q)
    ref, ref_dq = ref.detach().cpu().numpy(), ref_dq.cpu().numpy()
    rtol = RTOL[_dtype(device)]
    done = []
    for attn in ("ring", "ulysses"):
        if attn == "ulysses" and HEADS % nranks != 0:
            print(f"skip ulysses: {HEADS} heads not divisible by {nranks}")
            continue
        results = mpi.run_ranks(lambda: main(seq_per_rank, attn), nranks,
                                device=device)
        out = np.concatenate([o for o, _ in results], axis=1)
        dq = np.concatenate([g for _, g in results], axis=1)
        np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * 1e-2)
        np.testing.assert_allclose(dq, ref_dq, rtol=rtol, atol=rtol * 1e-2)
        done.append(attn)
    return done


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    n = int(args[0]) if args else 4
    spr = int(args[1]) if len(args) > 1 else 16
    for attn in run(n, spr, device="cpu" if "--cpu" in sys.argv else None):
        print(f"OK: {attn} attention on {n} ranks x {spr} tokens == dense "
              f"oracle over {n * spr} tokens (values + gradients)")
