"""Differentiable ring transport: ring shift and halo exchange.

Port of ``mpi4torch_tpu/parallel/ring.py``: the nonblocking trio composed
into the ring of the mpi4torch reference's own example, with the
JoinDummies/WaitHandle token discipline applied inside, so that a ring
shift is one AD-transparent call.  The backward is the mirror ring in
the opposite direction: gradients travel the reverse ring.
"""

from __future__ import annotations

import torch

from ..comm import JoinDummies, JoinDummiesHandle


def ring_shift(comm, x, shift: int = 1, tag: int = 0):
    """Send ``x`` to rank ``(rank + shift) % size``; return the tensor
    received from ``(rank - shift) % size``.  Differentiable: the adjoint
    is a ring shift by ``-shift`` of the gradient.  ``shift`` is a Python
    int."""
    size = comm.size
    if size == 1 or shift % size == 0:
        return x
    dest = (comm.rank + shift) % size
    source = (comm.rank - shift) % size
    handle = comm.Isend(x, dest, tag)
    # The receive buffer only gives the message's shape and dtype.
    buf = JoinDummies(torch.empty_like(x), [handle.dummy])
    received = comm.Recv(buf, source, tag)
    ret = comm.Wait(JoinDummiesHandle(handle, [received]))
    return JoinDummies(received, [ret])


def halo_exchange(comm, x, halo: int, axis: int = 0, tag: int = 0):
    """Periodic halo exchange along ``axis``: ``x`` padded with its
    neighbours' boundary slices, ``2 * halo`` longer on ``axis``.  Rank
    r's result is ``[right edge of rank r-1 | x | left edge of rank
    r+1]``.  Differentiable: boundary gradients flow back to the rank
    that owns them over the reverse ring.  Uses tags ``tag`` and
    ``tag + 1``."""
    if halo <= 0:
        raise ValueError(f"halo must be positive, got {halo}")
    n = x.shape[axis]
    if halo > n:
        raise ValueError(
            f"halo {halo} exceeds local axis length {n} (axis {axis})")
    if comm.size == 1:
        left = x.narrow(axis, n - halo, halo)
        right = x.narrow(axis, 0, halo)
    else:
        # The left neighbour's last rows arrive by a +1 shift, the right
        # neighbour's first rows by a -1 shift.
        left = ring_shift(comm, x.narrow(axis, n - halo, halo), 1, tag)
        right = ring_shift(comm, x.narrow(axis, 0, halo), -1, tag + 1)
    return torch.cat([left, x, right], dim=axis)
