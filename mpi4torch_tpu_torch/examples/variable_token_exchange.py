"""Variable-length token exchange: butterfly p2p + ragged Alltoall under
``run_spmd``.

The torch version of the JAX package's example of the same name.  Two
capabilities of the mpi4torch reference, under ONE SPMD program:

1. **Arbitrary static p2p permutations**: a butterfly exchange
   ``dest = rank ^ 1`` (the recursive-doubling building block) written
   with the Isend/JoinDummies/Recv/Wait token discipline of the ring
   example; the matched pair is one permute.
2. **Per-rank-varying segment sizes on the dense collectives**: every
   rank holds a *different* number of valid tokens (static per-rank
   counts over a capacity-padded buffer) and redistributes them into
   equal-ish contiguous spans with ``Alltoall(..., numelem=new_counts,
   current_numelem=old_counts)``, the load-balancing step of an
   expert-parallel dispatch.

Differentiability is checked end to end: the loss pulls gradients back
through the redistribution AND the butterfly (padding slots get zero
gradient).

Run:  python -m mpi4torch_tpu_torch.examples.variable_token_exchange
      [nranks] [--cpu]
      (nranks must be even: the ``rank ^ 1`` butterfly pairs ranks)
"""

import sys

import numpy as np
import torch

import mpi4torch_tpu_torch as mpi

comm = mpi.COMM_WORLD

D = 4  # token feature width


def balanced_counts(old):
    """Rebalance a lopsided partition into spans differing by <= 1."""
    total, n = sum(old), len(old)
    base, extra = divmod(total, n)
    return tuple(base + (1 if r < extra else 0) for r in range(n))


def lopsided_counts(n):
    """The example's per-rank valid-token counts before the exchange."""
    return tuple(((3 * r + 1) % (n + 2)) + 1 for r in range(n))


def exchange(x0, old_counts, new_counts, cap):
    """One step: butterfly-mix each rank's valid tokens with its partner,
    then repartition the global token axis to ``new_counts``."""
    # Rank-stamped tokens: row i of rank r = (global token id, ...).
    offs = np.concatenate([[0], np.cumsum(old_counts)])
    starts = torch.tensor(offs[:-1], dtype=torch.float64, device=x0.device)
    gids = starts[comm.rank + 0] + torch.arange(
        cap, dtype=torch.float64, device=x0.device)
    tokens = (gids[:, None] + x0.new_zeros(cap, D)) * x0

    # 1. Butterfly: swap token blocks with partner rank ^ 1 (capacity-
    #    uniform on the wire; validity travels with the counts below).
    h = comm.Isend(tokens, comm.rank ^ 1, 0)
    mixed = comm.Recv(mpi.JoinDummies(torch.empty_like(tokens), [h.dummy]),
                      comm.rank ^ 1, 0)
    mixed = mpi.JoinDummies(mixed, [comm.Wait(h)])
    # After the swap, rank r holds its PARTNER's tokens, and therefore
    # the partner's valid count.
    swapped = tuple(old_counts[r ^ 1] for r in range(len(old_counts)))

    # 2. Ragged repartition of the global token axis to the balanced
    #    spans (the MPI_Alltoallv analogue; static count tuples).
    spans = comm.Alltoall(mixed, 0, 0, new_counts,
                          current_numelem=swapped)
    return tokens, spans


def main(x0):
    n = comm.size
    old = lopsided_counts(n)
    new = balanced_counts(old)
    cap = max(max(old), max(new))
    x0 = x0.detach().requires_grad_()
    tokens, spans = exchange(x0, old, new, cap)
    # Gradient through butterfly + repartition: every VALID token of the
    # global axis contributes exactly once to sum(spans); padding never.
    (g,) = torch.autograd.grad(spans.sum(), x0)
    return tokens.detach(), spans.detach(), g


def run(nranks: int = 8, device=None):
    """Run :func:`main` under ``run_spmd`` on ``nranks`` rank threads and
    check the spans against the token-id oracle and each rank's
    gradient."""
    if nranks % 2:
        raise ValueError(f"nranks must be even (the rank ^ 1 butterfly "
                         f"pairs ranks); got {nranks}")
    dev = mpi.resolve_device(device)
    tokens, spans, grads = mpi.run_spmd(main, nranks=nranks, device=dev)(
        torch.ones((), dtype=torch.float64, device=dev))
    old = lopsided_counts(nranks)
    new = balanced_counts(old)
    offs = np.concatenate([[0], np.cumsum(new)])
    oo = np.concatenate([[0], np.cumsum(old)])
    swapped_order = []   # global ids in post-butterfly axis order
    for r in range(nranks):
        p = r ^ 1
        swapped_order.extend(range(oo[p], oo[p] + old[p]))
    sp, gr = spans.cpu().numpy(), grads.cpu().numpy()
    for r in range(nranks):
        want = np.asarray(swapped_order[offs[r]:offs[r + 1]], float)
        np.testing.assert_array_equal(sp[r, :new[r], 0], want)
        assert (sp[r, new[r]:] == 0).all()
        # Rank r's x0 feeds its own valid tokens (ids oo[r] ..
        # oo[r]+old[r]-1), each reaching exactly one valid span slot, so
        # dL/dx0_r = D * sum(those ids); padding contributes nothing.
        ids = range(oo[r], oo[r] + old[r])
        np.testing.assert_allclose(gr[r], D * sum(ids))
    return tokens, spans, grads


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    n = int(args[0]) if args else 8
    run(n, device="cpu" if "--cpu" in sys.argv else None)
    old = lopsided_counts(n)
    print(f"OK: {n} ranks, counts {old} -> {balanced_counts(old)}, "
          "butterfly+ragged repartition verified; per-rank grads match "
          "the token-id oracle")
