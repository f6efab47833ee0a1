"""The port's packed collectives (a per-rank ``numelem`` on ``Gather``,
``Allgather``, ``Scatter`` and ``Alltoall``) against the JAX package's
Mode B, on the CPU.

The same float64 numpy inputs go through both packages on rank-thread
worlds of 2, 3 and 8 ranks.  Values, and the gradients of ``sum(out *
w_r)`` with a random rank-varying ``w_r``, are bitwise equal (the packed
ops move bits and mask; nothing is summed), every padding slot's
gradient is exactly zero, and the contracts of ``tests/test_packed.py``
(packed concatenations, capacity-padded masked segments, the
interval-overlap redistribution) are re-expressed against the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu_torch.ops import packed as ppacked

SIZES = [2, 3, 8]


def _counts(n):
    """Per-rank counts with a zero among them (rank 1) on every world."""
    return tuple(0 if r == 1 else r + 2 for r in range(n))


def _bitwise(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(np.ascontiguousarray(a).reshape(-1)
                               .view(np.uint8),
                               np.ascontiguousarray(b).reshape(-1)
                               .view(np.uint8)))


# name -> (op(comm, x, rank, n), input shape(n)); the ops call the facade
# methods both packages share.
def _cap(n):
    return max(_counts(n))


def _total(n):
    return sum(_counts(n))


def _new(n):
    """Another partition of the same total, for the redistribution."""
    c = list(reversed(_counts(n)))
    return tuple(c)


CASES = {
    "gather_root_last": (
        lambda c, x, r, n: c.Gather(x, 0, n - 1, numelem=_counts(n)),
        lambda n: (_cap(n), 2)),
    "gather_axis1": (
        lambda c, x, r, n: c.Gather(x, 1, 0, numelem=_counts(n)),
        lambda n: (2, _cap(n), 3)),
    "gather_uniform_prefix": (
        lambda c, x, r, n: c.Gather(x, 0, 0, numelem=2),
        lambda n: (4, 2)),
    "allgather": (
        lambda c, x, r, n: c.Allgather(x, 0, numelem=_counts(n)),
        lambda n: (_cap(n), 2)),
    "allgather_uniform_prefix": (
        lambda c, x, r, n: c.Allgather(x, 1, numelem=3),
        lambda n: (2, 5)),
    "scatter": (
        lambda c, x, r, n: c.Scatter(x, 0, _counts(n), 0),
        lambda n: (_total(n), 3)),
    "scatter_axis1_root_last": (
        lambda c, x, r, n: c.Scatter(x, 1, _counts(n), n - 1),
        lambda n: (2, _total(n))),
    "alltoall_distinct_axes": (
        lambda c, x, r, n: c.Alltoall(x, 1, 2, _counts(n)),
        lambda n: (2, _cap(n), _total(n))),
    "alltoall_same_axis": (
        lambda c, x, r, n: c.Alltoall(x, 0, 0, _new(n),
                                      current_numelem=_counts(n)),
        lambda n: (_cap(n), 2)),
}


def _inputs(n, shape, seed):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(shape) for _ in range(n)]
    return xs, rng


def _jax_run(n, op, xs, ws):
    def body(r):
        t = jnp.asarray(xs[r])
        out = op(mpi.COMM_WORLD, t, r, n)
        g = jax.grad(lambda v: jnp.sum(op(mpi.COMM_WORLD, v, r, n)
                                       * jnp.asarray(ws[r])))(t)
        return np.asarray(out), np.asarray(g)

    return mpi.run_ranks(body, n)


def _torch_run(n, op, xs, ws):
    def body(r):
        t = torch.from_numpy(xs[r]).requires_grad_()
        out = op(P.COMM_WORLD, t, r, n)
        (g,) = torch.autograd.grad((out * torch.from_numpy(ws[r])).sum(), t)
        return out.detach().numpy(), g.numpy()

    return P.run_ranks(body, n, device="cpu")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_values_and_grads_bitwise_vs_jax(name, n):
    op, shape_of = CASES[name]
    xs, rng = _inputs(n, shape_of(n), seed=len(name) + n)
    # Every rank's output has one shape (zeros off the root, padded
    # segments): read it off a forward of the port.
    out_shape = P.run_ranks(
        lambda r: op(P.COMM_WORLD, torch.from_numpy(xs[r]), r, n).shape,
        n, device="cpu")[0]
    ws = [rng.standard_normal(tuple(out_shape)) for _ in range(n)]
    want = _jax_run(n, op, xs, ws)
    got = _torch_run(n, op, xs, ws)
    for (yg, gg), (yw, gw) in zip(got, want):
        assert _bitwise(yg, yw)
        assert _bitwise(gg, gw)


@pytest.mark.parametrize("n", SIZES)
def test_padding_slots_get_zero_gradient(n):
    counts, cap = _counts(n), _cap(n)
    xs, _ = _inputs(n, (cap, 2), seed=3)

    def body(r):
        c = P.COMM_WORLD
        out = []
        for op in (lambda v: c.Gather(v, 0, 0, numelem=counts),
                   lambda v: c.Allgather(v, 0, numelem=counts),
                   lambda v: c.Alltoall(v, 0, 0, _new(n),
                                        current_numelem=counts)):
            t = torch.from_numpy(xs[r]).requires_grad_()
            (g,) = torch.autograd.grad(op(t).sum(), t)
            out.append(g)
        return out

    for r, grads in enumerate(P.run_ranks(body, n, device="cpu")):
        for g in grads:
            assert (g[counts[r]:] == 0).all()
    # The Allgather's valid slots are read by every rank once.
    assert (P.run_ranks(body, n, device="cpu")[0][1][:counts[0]] == n).all()


def test_gather_and_scatter_contracts():
    n = 8
    counts, cap, total = _counts(n), _cap(n), _total(n)
    offs = np.concatenate([[0], np.cumsum(counts)])

    def body(r):
        c = P.COMM_WORLD
        rows = (torch.arange(cap, dtype=torch.float64)[:, None]
                + 10.0 * (1 + r)) * torch.ones(cap, 2, dtype=torch.float64)
        g = c.Gather(rows, 0, 0, numelem=counts)
        packed = torch.arange(total, dtype=torch.float64)[:, None] \
            * torch.ones(total, 3, dtype=torch.float64)
        s = c.Scatter(packed, 0, counts, 0)
        return g, s

    outs = P.run_ranks(body, n, device="cpu")
    g0 = outs[0][0]
    assert tuple(g0.shape) == (total, 2)
    for r in range(n):
        want = (np.arange(counts[r])[:, None] + 10.0 * (1 + r)) \
            * np.ones((counts[r], 2))
        assert np.array_equal(g0[offs[r]:offs[r + 1]].numpy(), want)
        assert (outs[r][0] == 0).all() or r == 0          # non-root zeros
        s = np.zeros((cap, 3))
        s[:counts[r]] = np.arange(offs[r], offs[r + 1])[:, None]
        assert np.array_equal(outs[r][1].numpy(), s)


def test_alltoall_matches_scatter_of_gather():
    # The reference's Scatter∘Gather identity with varying numelem.
    n = 3
    counts, cap, total = _counts(n), _cap(n), _total(n)

    def body(r):
        c = P.COMM_WORLD
        t = torch.arange(3 * cap * 2 * total, dtype=torch.float64).reshape(
            3, cap, 2, total) * (1.0 + r)
        a = c.Scatter(c.Gather(t, 1, 0, numelem=counts), 3, counts, 0)
        b = c.Alltoall(t, 1, 3, counts)
        return a, b

    for a, b in P.run_ranks(body, n, device="cpu"):
        assert tuple(b.shape) == (3, total, 2, cap)
        assert torch.equal(a, b)


def test_error_paths_match_jax():
    n = 3
    counts, cap, total = _counts(n), _cap(n), _total(n)
    calls = [
        ("exceeds", lambda c, m: c.Gather(m.ones((cap, 2)), 0, 0,
                                          numelem=(cap + 1, 1, 1))),
        ("sum", lambda c, m: c.Scatter(m.ones((total + 1,)), 0, counts, 0)),
        ("current_numelem", lambda c, m: c.Alltoall(m.ones((cap, 2)), 0, 0,
                                                    counts)),
        ("partition different totals",
         lambda c, m: c.Alltoall(m.ones((cap, 2)), 0, 0, counts,
                                 current_numelem=(total + 1, 0, 0))),
        ("only applies", lambda c, m: c.Alltoall(
            m.ones((cap, total)), 0, 1, counts, current_numelem=counts)),
        ("entries", lambda c, m: c.Allgather(m.ones((cap, 2)), 0,
                                             numelem=(1, 1))),
        ("negative", lambda c, m: c.Allgather(m.ones((cap, 2)), 0,
                                              numelem=(1, -1, 1))),
        ("not supported", lambda c, m: c.Allgather(
            m.ones((cap, 2)), 0, numelem=counts, compression="q8")),
    ]

    def jbody():
        for msg, call in calls:
            with pytest.raises(ValueError, match=msg):
                call(mpi.COMM_WORLD, jnp)
        return True

    def pbody():
        for msg, call in calls:
            with pytest.raises(ValueError, match=msg):
                call(P.COMM_WORLD, torch)
        return True

    assert all(mpi.run_ranks(jbody, n))
    assert all(P.run_ranks(pbody, n, device="cpu"))


def test_dense_dispatch_and_exact_under_a_codec_scope():
    # An integer numelem (numpy's too) on Scatter/Alltoall stays on the
    # dense path; the packed Allgather stays exact inside a compression
    # scope, and compression=False is accepted there.
    n = 2

    def body(r):
        c = P.COMM_WORLD
        s = c.Scatter(torch.arange(4.), 0, np.int64(2), 0)
        a = c.Alltoall(torch.arange(1.) + r, 0, 0, np.int64(1))
        x = torch.arange(6, dtype=torch.float32) * 0.1 + r
        with P.config.compression_scope("q8"):
            g = c.Allgather(x, 0, numelem=(4, 6))
        g2 = c.Allgather(x, 0, numelem=(4, 6), compression=False)
        return s, a, g, g2, x

    outs = P.run_ranks(body, n, device="cpu")
    assert outs[1][0].tolist() == [2.0, 3.0]
    assert outs[1][1].tolist() == [1.0]
    x0, x1 = outs[0][4], outs[1][4]
    want = torch.cat([x0[:4], x1])
    for o in outs:
        assert torch.equal(o[2], want) and torch.equal(o[3], want)


def test_index_maps_are_frozen_and_cached():
    a = ppacked._pack_index((1, 2), 3)
    assert a is ppacked._pack_index((1, 2), 3)
    assert a.tolist() == [0, 3, 4]
    assert ppacked._pad_index((1, 2), 2).tolist() == [0, 0, 1, 2]
    for m in (a, ppacked._pad_index((1, 2), 2)):
        with pytest.raises(ValueError):
            m[0] = 7
