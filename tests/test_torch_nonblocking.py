"""The port's nonblocking point-to-point ops and JoinDummies, on the CPU.

Re-expresses the JAX package's ``tests/test_nonblocking.py`` (the
mpi4torch reference's three ring orderings with JoinDummies /
JoinDummiesHandle tokens) and ``tests/test_joindummies.py`` against the
port on worlds of 2, 5 and 7 ranks, with the same float64 numpy inputs
and the JAX package's Mode B ``run_ranks`` as the oracle: values and
gradients bitwise equal.  The gradient oracle ``grad == right neighbour's
rank`` shows that the gradient travelled the ring backwards.  Also: the
handle guards (double Wait, spliced handles), the tag range, a Recv
buffer that does not match, FIFO order per (src, dst, tag), and that a
ring's backward finishes well inside a short world timeout (the
descriptor edges order each rank's gradient send before its receive).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P

N = 4096
SIZES = [2, 5, 7]


def _bitwise(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def _isendirecv(m, comm, empty_like):
    def loss(t):
        req = comm.Isend(t, (comm.rank + 1) % comm.size, 0)
        req2 = comm.Irecv(m.JoinDummies(empty_like(t), [req.dummy]),
                          (comm.rank + comm.size - 1) % comm.size, 0)
        res = comm.Wait(m.JoinDummiesHandle(req, [req2.dummy]))
        res2 = comm.Wait(m.JoinDummiesHandle(req2, [res]))
        return res2 * comm.rank
    return loss


def _isendrecv(m, comm, empty_like):
    def loss(t):
        req = comm.Isend(t, (comm.rank + 1) % comm.size, 0)
        res = comm.Recv(m.JoinDummies(empty_like(t), [req.dummy]),
                        (comm.rank + comm.size - 1) % comm.size, 0)
        res2 = comm.Wait(m.JoinDummiesHandle(req, [res]))
        return m.JoinDummies(res, [res2]) * comm.rank
    return loss


def _irecvsend(m, comm, empty_like):
    def loss(t):
        req = comm.Irecv(m.JoinDummies(empty_like(t), [t]),
                         (comm.rank + comm.size - 1) % comm.size, 0)
        res = comm.Send(t, (comm.rank + 1) % comm.size, 0)
        res2 = comm.Wait(m.JoinDummiesHandle(req, [res]))
        return res2 * comm.rank
    return loss


RINGS = {"isendirecv": _isendirecv, "isendrecv": _isendrecv,
         "irecvsend": _irecvsend}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("ring", sorted(RINGS))
def test_ring_value_and_grad_bitwise_vs_jax(ring, n):
    xs = [np.random.default_rng(r).random(N) for r in range(n)]
    make = RINGS[ring]

    def jax_body(r):
        loss = make(mpi, mpi.COMM_WORLD, jnp.empty_like)
        t = jnp.asarray(xs[r])
        out = loss(t)
        g = jax.grad(lambda v: loss(v).sum())(t)
        return np.asarray(out), np.asarray(g)

    def torch_body(r):
        loss = make(P, P.COMM_WORLD, torch.empty_like)
        t = torch.from_numpy(xs[r]).requires_grad_()
        out = loss(t)
        (g,) = torch.autograd.grad(out.sum(), t)
        return out.detach().numpy(), g.numpy()

    ref = mpi.run_ranks(jax_body, n)
    got = P.run_ranks(torch_body, n, device="cpu", timeout=20.0)
    for r in range(n):
        assert _bitwise(got[r][0], ref[r][0]) and _bitwise(got[r][1],
                                                           ref[r][1])
        assert bool((got[r][1] == (r + 1) % n).all())
        assert np.array_equal(got[r][0], xs[(r - 1) % n] * r)


def test_forward_ring_values():
    def body():
        comm = P.COMM_WORLD
        a = torch.tensor([1.0 + comm.rank])
        handle = comm.Isend(a, (comm.rank + 1) % comm.size, 0)
        recvbuf = P.JoinDummies(torch.empty_like(a), [handle.dummy])
        b = comm.Recv(recvbuf, (comm.rank - 1 + comm.size) % comm.size, 0)
        wait_ret = comm.Wait(P.JoinDummiesHandle(handle, [b]))
        res = P.JoinDummies(a + b, [wait_ret])
        left = (comm.rank - 1 + comm.size) % comm.size
        assert res[0] == (1.0 + comm.rank) + (1.0 + left)

    P.run_ranks(body, 5, device="cpu")


@pytest.mark.parametrize("n", SIZES)
def test_joindummies_simple_allreduce_bitwise_vs_jax(n):
    xs = [[np.random.default_rng(3 * r + i).random(10) for i in range(3)]
          for r in range(n)]

    def jax_body(r):
        def loss(t, t2, t3):
            return mpi.JoinDummies(mpi.COMM_WORLD.Allreduce(t, mpi.MPI_SUM),
                                   [t2, t3]).sum()
        return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
            *(jnp.asarray(x) for x in xs[r]))]

    def torch_body(r):
        ts = [torch.from_numpy(x).requires_grad_() for x in xs[r]]
        res = P.JoinDummies(P.COMM_WORLD.Allreduce(ts[0], P.MPI_SUM),
                            ts[1:])
        return [g.numpy() for g in torch.autograd.grad(res.sum(), ts)]

    ref = mpi.run_ranks(jax_body, n)
    got = P.run_ranks(torch_body, n, device="cpu")
    for r in range(n):
        assert all(_bitwise(a, b) for a, b in zip(got[r], ref[r]))
        assert bool((got[r][0] == n).all())
        assert not got[r][1].any() and not got[r][2].any()


def test_joindummies_without_dummies_is_identity_and_mixed_dtypes():
    x = torch.ones(3)
    assert P.JoinDummies(x, []) is x

    def body():
        x = torch.from_numpy(np.random.rand(4)).requires_grad_()
        d = torch.zeros(8, dtype=torch.float32, requires_grad=True)
        g1, g2 = torch.autograd.grad(P.JoinDummies(x, [d]).sum(), (x, d))
        assert bool((g1 == 1).all())
        assert g2.dtype == torch.float32 and not g2.any()

    P.run_ranks(body, 2, device="cpu")


def test_joindummies_result_refuses_in_place_edits():
    # JoinDummies returns its input with no copy: torch treats the result
    # as a view made inside a custom Function and refuses to modify it in
    # place.  A copy can be modified.
    x = torch.ones(3, requires_grad=True) * 2
    y = P.JoinDummies(x, [torch.zeros(2, requires_grad=True)])
    with pytest.raises(RuntimeError, match="view"):
        y.add_(1)
    z = y.clone()
    z.add_(1)
    assert torch.equal(z, torch.full((3,), 3.0))


def test_double_wait_and_spliced_handles_raise_bifurcation():
    def body():
        comm = P.COMM_WORLD
        peer = 1 - comm.rank
        h = comm.Isend(torch.ones(3), peer, 0)
        comm.Wait(h)
        with pytest.raises(P.BifurcationError):
            comm.Wait(h)
        h1 = comm.Isend(torch.ones(3), peer, 1)
        h2 = comm.Irecv(torch.ones(5), peer, 2)
        # h1's descriptor with h2's buffer: the posted request does not
        # match, and h1 stays pending.
        spliced = P.WaitHandle([h1.dummy, h2._handle[1], h2._handle[2]])
        with pytest.raises(P.BifurcationError):
            comm.Wait(spliced)
        comm.Wait(h1)
        comm.Send(torch.ones(5), peer, 2)    # buffered: never blocks
        comm.Wait(h2)
        comm.Recv(torch.ones(3), peer, 0)
        comm.Recv(torch.ones(3), peer, 1)
        return True

    assert all(P.run_ranks(body, 2, device="cpu", timeout=10.0))


def test_tag_range_and_mismatched_recv_buffer_raise():
    def body():
        comm = P.COMM_WORLD
        peer = 1 - comm.rank
        for tag in (-1, (1 << 24) - 10):
            with pytest.raises(P.CommError, match="tag"):
                comm.Isend(torch.ones(2), peer, tag)
        comm.Send(torch.ones(4, dtype=torch.float64), peer, 3)
        with pytest.raises(P.CommError, match="does not match"):
            comm.Recv(torch.ones(4, dtype=torch.float32), peer, 3)
        return True

    assert all(P.run_ranks(body, 2, device="cpu"))


def test_fifo_order_per_source_destination_and_tag():
    def body():
        comm = P.COMM_WORLD
        peer = 1 - comm.rank
        for i in range(5):
            comm.Send(torch.full((2,), float(i)), peer, 7)
            comm.Send(torch.full((2,), 100.0 + i), peer, 8)
        got7 = [comm.Recv(torch.empty(2), peer, 7)[0].item()
                for _ in range(5)]
        got8 = [comm.Recv(torch.empty(2), peer, 8)[0].item()
                for _ in range(5)]
        return got7, got8

    for got7, got8 in P.run_ranks(body, 2, device="cpu"):
        assert got7 == [0.0, 1.0, 2.0, 3.0, 4.0]
        assert got8 == [100.0, 101.0, 102.0, 103.0, 104.0]


def test_received_message_is_the_receivers_own():
    # A buffered send copies its payload: the sender may overwrite its
    # tensor after the send, and the receiver may overwrite what it got.
    def body():
        comm = P.COMM_WORLD
        peer = 1 - comm.rank
        x = torch.full((4,), float(comm.rank))
        comm.Send(x, peer, 0)
        x.fill_(-1.0)
        got = comm.Recv(torch.empty(4), peer, 0)
        got.add_(10.0)
        return got, x

    for r, (got, x) in enumerate(P.run_ranks(body, 2, device="cpu")):
        assert torch.equal(got, torch.full((4,), 10.0 + (1 - r)))
        assert torch.equal(x, torch.full((4,), -1.0))


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6, 7, 8])
def test_ring_backward_finishes_inside_a_short_timeout(n):
    def body(r):
        t = torch.full((64,), float(r), requires_grad=True)
        out = _isendrecv(P, P.COMM_WORLD, torch.empty_like)(t)
        (g,) = torch.autograd.grad(out.sum(), t)
        return g

    t0 = time.perf_counter()
    grads = P.run_ranks(body, n, device="cpu", timeout=5.0)
    assert time.perf_counter() - t0 < 5.0
    for r, g in enumerate(grads):
        assert bool((g == (r + 1) % n).all())


def test_missing_send_raises_deadlock():
    def body():
        comm = P.COMM_WORLD
        if comm.rank == 0:
            with pytest.raises(P.DeadlockError, match="never posted"):
                comm.Recv(torch.empty(2), 1, 0)
        return True

    assert all(P.run_ranks(body, 2, device="cpu", timeout=0.3))
