"""Nonblocking ring exchange with differentiable dependency tokens
(BASELINE config 3).

The torch version of the mpi4torch reference's second example: each rank
sends a value to its right neighbour and receives from its left one, with
the JoinDummies/JoinDummiesHandle tokens encoding the orderings autograd
cannot see on its own.  The backward pass routes each gradient over the
ring in the reverse direction.

Run:  python -m mpi4torch_tpu_torch.examples.isend_recv_wait [nranks]
      [--cpu]
"""

import sys

import torch

import mpi4torch_tpu_torch as mpi

comm = mpi.COMM_WORLD


def main():
    a = torch.tensor([1.0 + comm.rank], dtype=torch.float64,
                     device=comm.device).requires_grad_()
    handle = comm.Isend(a, (comm.rank + 1) % comm.size, 0)
    recvbuffer = mpi.JoinDummies(torch.empty_like(a), [handle.dummy])
    b = comm.Recv(recvbuffer, (comm.rank - 1 + comm.size) % comm.size, 0)
    wait_ret = comm.Wait(mpi.JoinDummiesHandle(handle, [b]))
    res = mpi.JoinDummies(a + b, [wait_ret])
    res.sum().backward()
    res, grad = res.detach().cpu().numpy(), a.grad.cpu().numpy()
    print(f"rank {comm.rank}: res = {res}, a.grad = {grad}")
    return res, grad


def run(nranks: int = 4, device=None):
    """Run :func:`main` on ``nranks`` rank threads and check the ring's
    values and its ring-routed gradients."""
    results = mpi.run_ranks(main, nranks, device=device)
    for r, (res, grad) in enumerate(results):
        left = (r - 1 + nranks) % nranks
        assert res[0] == (1.0 + r) + (1.0 + left)
        # a_r reaches its own output and the right neighbour's output
        assert grad[0] == 2.0
    return results


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    n = int(args[0]) if args else 4
    run(n, device="cpu" if "--cpu" in sys.argv else None)
    print(f"OK: ring values and ring-routed gradients correct on {n} ranks")
