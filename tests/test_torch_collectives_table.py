"""The port's op table against the JAX package, on the CPU.

Every collective of ``COMM_WORLD`` (``Allreduce`` on every algorithm,
``Bcast_``, ``Reduce_``, ``Gather``, ``Allgather``, ``Reduce_scatter``,
``Scatter``, ``Alltoall``) runs in both packages on the same float64
numpy inputs, on rank-thread worlds of 2, 5 and 7 ranks (the mpi4torch
reference's CI matrix), with the JAX package's Mode B ``run_ranks`` as
the oracle.  Values, and gradients of ``vdot(out, w_r)`` with a random,
rank-varying ``w_r``, are bitwise equal: both packages fold in the same
association and move the same bits.  The reference's own assertions
(``tests/test_collectives.py``) are re-expressed against the port, and
the error paths, the in-place reuse guard, private outputs per rank and
the health probe are covered.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu_torch.ops import eager as peager

SIZES = [2, 5, 7]


def _bitwise(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def _inputs(seed, n, shape_of):
    """Per-rank (x, w) float64 arrays: the op's input and the random
    cotangent its output is dotted with."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape_of(r)) for r in range(n)]


def _jax_value_and_grad(n, op, xs, ws):
    def body(r):
        t = jnp.asarray(xs[r])
        out = op(mpi.COMM_WORLD, t, r)
        g = jax.grad(lambda v: jnp.vdot(op(mpi.COMM_WORLD, v, r),
                                        jnp.asarray(ws[r])))(t)
        return np.asarray(out), np.asarray(g)

    return mpi.run_ranks(body, n)


def _torch_value_and_grad(n, op, xs, ws):
    def body(r):
        t = torch.from_numpy(xs[r]).requires_grad_()
        out = op(P.COMM_WORLD, t, r)
        (g,) = torch.autograd.grad(
            torch.vdot(out.reshape(-1), torch.from_numpy(ws[r]).reshape(-1)),
            t)
        return out.detach().numpy(), g.numpy()

    return P.run_ranks(body, n, device="cpu")


def _tri(n):
    return n * (n + 1) // 2


# name -> (op(comm, t, rank) for both packages, input shape(rank, n),
#          output shape(rank, n)); the ops take MPI op codes, which the
# two packages share.
OPS = {
    "allreduce": (lambda c, t, r: c.Allreduce(t, 3),
                  lambda r, n: (10,), lambda r, n: (10,)),
    "bcast_root0": (lambda c, t, r: c.Bcast_(t, 0),
                    lambda r, n: (4, 3), lambda r, n: (4, 3)),
    "bcast_rootlast_tree": (
        lambda c, t, r: c.Bcast_(t, c.size - 1, algorithm="tree"),
        lambda r, n: (6,), lambda r, n: (6,)),
    "reduce_root1_ring": (lambda c, t, r: c.Reduce_(t, 3, 1),
                          lambda r, n: (9,), lambda r, n: (9,)),
    "reduce_root1_tree": (
        lambda c, t, r: c.Reduce_(t, 3, 1, algorithm="tree"),
        lambda r, n: (9,), lambda r, n: (9,)),
    "gather_uneven_root2": (
        lambda c, t, r: c.Gather(t, 2, 2 % c.size),
        lambda r, n: (2, 3, r + 1, 2), lambda r, n: (2, 3, _tri(n), 2)),
    "allgather_uneven": (
        lambda c, t, r: c.Allgather(t, -2),
        lambda r, n: (3, r + 2, 2), lambda r, n: (3, _tri(n) + n, 2)),
    "reduce_scatter": (lambda c, t, r: c.Reduce_scatter(t, 3, 1),
                       lambda r, n: (2, 3 * n), lambda r, n: (2, 3)),
    "scatter_uneven_root2": (
        lambda c, t, r: c.Scatter(t, 1, r + 1, 2 % c.size),
        lambda r, n: (2, _tri(n), 3) if r == 2 % n else (1,),
        lambda r, n: (2, r + 1, 3)),
    "alltoall_uneven": (
        lambda c, t, r: c.Alltoall(t, 2, 4, r + 1),
        lambda r, n: (3, 2, r + 1, 2, _tri(n), 2),
        lambda r, n: (3, 2, _tri(n), 2, r + 1, 2)),
    "alltoall_same_axis": (
        lambda c, t, r: c.Alltoall(t, 2, 2, c.size - r),
        lambda r, n: (3, 4, r + 1, 2), lambda r, n: (3, 4, n - r, 2)),
}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", sorted(OPS))
def test_value_and_grad_bitwise_vs_jax(name, n):
    op, in_shape, out_shape = OPS[name]
    xs = _inputs(n, n, lambda r: in_shape(r, n))
    ws = _inputs(100 + n, n, lambda r: out_shape(r, n))
    ref = _jax_value_and_grad(n, op, xs, ws)
    got = _torch_value_and_grad(n, op, xs, ws)
    for r in range(n):
        assert _bitwise(got[r][0], ref[r][0]), (name, r, "value")
        assert _bitwise(got[r][1], ref[r][1]), (name, r, "grad")


ALGOS = ["ring", "rhd", "tree", "hier", "bidir", "torus"]


@pytest.mark.parametrize("n", [3, 4, 6, 8])
@pytest.mark.parametrize("algo", ALGOS)
def test_allreduce_algorithms_bitwise_vs_jax(algo, n):
    # Each algorithm folds in its schedule's association in both
    # packages; on a world it cannot serve, both raise CommError.  A
    # payload above the fold-once threshold takes the shared-result path.
    numel = peager._FOLD_ONCE_MIN + 3 if n == 4 else 13
    xs = _inputs(7 * n, n, lambda r: (numel,))
    ws = _inputs(8 * n, n, lambda r: (numel,))

    def op(c, t, r):
        return c.Allreduce(t, 3, algorithm=algo)

    try:
        ref = _jax_value_and_grad(n, op, xs, ws)
    except mpi.CommError:
        with pytest.raises(P.CommError):
            _torch_value_and_grad(n, op, xs, ws)
        return
    got = _torch_value_and_grad(n, op, xs, ws)
    for r in range(n):
        assert _bitwise(got[r][0], ref[r][0]) and _bitwise(got[r][1],
                                                           ref[r][1])
        assert _bitwise(got[r][0], got[0][0])


@pytest.mark.parametrize("algo", ["rhd", "tree", "hier", "torus"])
def test_other_algorithms_change_bits_not_values(algo):
    # The associations differ from the ascending-rank ring's, so on
    # general data some bits differ, while the sums agree to rounding.
    xs = _inputs(3, 8, lambda r: (257,))

    def body(r):
        t = torch.from_numpy(xs[r])
        return (P.COMM_WORLD.Allreduce(t, P.MPI_SUM).numpy(),
                P.COMM_WORLD.Allreduce(t, P.MPI_SUM, algorithm=algo).numpy())

    ring, other = P.run_ranks(body, 8, device="cpu")[0]
    assert not _bitwise(ring, other)
    np.testing.assert_allclose(other, ring, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("root", [0, 1, 3])
def test_tree_reduce_with_nonzero_root_bitwise_vs_jax(root):
    xs = _inputs(root, 5, lambda r: (33,))
    ws = _inputs(root + 50, 5, lambda r: (33,))
    for op in (lambda c, t, r: c.Reduce_(t, 3, root, algorithm="tree"),
               lambda c, t, r: c.Bcast_(t, root, algorithm="tree")):
        ref = _jax_value_and_grad(5, op, xs, ws)
        got = _torch_value_and_grad(5, op, xs, ws)
        for (a, ga), (b, gb) in zip(got, ref):
            assert _bitwise(a, b) and _bitwise(ga, gb)


@pytest.mark.parametrize("op", [P.MPI_MAX, P.MPI_MIN, P.MPI_PROD])
def test_reduce_and_reduce_scatter_other_ops_bitwise_vs_jax(op):
    xs = _inputs(op, 5, lambda r: (10,))
    ref = mpi.run_ranks(lambda r: (
        np.asarray(mpi.COMM_WORLD.Reduce_(jnp.asarray(xs[r]), op, 3)),
        np.asarray(mpi.COMM_WORLD.Reduce_scatter(jnp.asarray(xs[r]), op,
                                                 0))), 5)
    got = P.run_ranks(lambda r: (
        P.COMM_WORLD.Reduce_(torch.from_numpy(xs[r]), op, 3).numpy(),
        P.COMM_WORLD.Reduce_scatter(torch.from_numpy(xs[r]), op,
                                    0).numpy()), 5, device="cpu")
    for (a, b), (c, d) in zip(got, ref):
        assert _bitwise(a, c) and _bitwise(b, d)


# --------------------------------------------------------------------------
# The reference's own assertions (tests/test_collectives.py), re-expressed.
# --------------------------------------------------------------------------


def _run(n, body):
    return P.run_ranks(body, n, device="cpu")


comm = P.COMM_WORLD


def _grad(fn, x):
    x = x.detach().requires_grad_()
    (g,) = torch.autograd.grad(fn(x), x)
    return g


@pytest.mark.parametrize("n", SIZES)
def test_reduce_simple_inplace_and_zeroed_nonroot(n):
    def body():
        tmp = torch.from_numpy(np.random.rand(10))
        assert torch.equal(_grad(lambda t: comm.Reduce_(t, P.MPI_SUM, 0)
                                 .sum(), tmp), torch.ones(10,
                                                          dtype=tmp.dtype))
        res = comm.Reduce_(torch.ones(10) * (comm.rank + 1), P.MPI_SUM, 0)
        want = n * (n + 1) / 2 if comm.rank == 0 else 0.0
        assert bool((res == want).all())

    _run(n, body)


@pytest.mark.parametrize("n", SIZES)
def test_reduce_noinplace_exception(n):
    def body():
        tmp = torch.from_numpy(np.random.rand(10))
        comm.Reduce_(tmp, P.MPI_SUM, 0)
        with pytest.raises(P.InPlaceReuseError):
            comm.Allreduce(tmp, P.MPI_SUM)
        # The guard is per rank and per tensor: a fresh tensor is fine.
        comm.Allreduce(tmp.clone(), P.MPI_SUM)

    _run(n, body)


@pytest.mark.parametrize("n", SIZES)
def test_bcast_simple_inplace(n):
    def body():
        tmp = torch.from_numpy(np.random.rand(10))
        g = _grad(lambda t: comm.Bcast_(t, 0).sum(), tmp)
        want = n if comm.rank == 0 else 0.0
        assert bool((g == want).all())
        res = comm.Bcast_(torch.ones(10) * (comm.rank + 1), 0)
        assert bool((res == 1.0).all())

    _run(n, body)


@pytest.mark.parametrize("n", SIZES)
def test_gather_and_allgather_basic(n):
    def body():
        numdim = 4
        tmp = torch.from_numpy(np.random.rand(2, 5, numdim, 2, 3))
        tmp[0, 0, :, 0, 0] = comm.rank
        res = comm.Gather(tmp, 2, 0)
        if comm.rank == 0:
            assert res[0, 0, :, 0, 0].sum() == numdim * (n - 1) * n // 2
        res = comm.Allgather(tmp, 2)
        assert res[0, 0, :, 0, 0].sum() == numdim * (n - 1) * n // 2
        assert bool((_grad(lambda t: comm.Gather(t, 2, 0).sum(), tmp)
                     == 1.0).all())
        assert bool((_grad(lambda t: comm.Allgather(t, 2).sum(), tmp)
                     == n).all())
        # The correct Allgather adjoint: rank-varying upstream gradients.
        g = _grad(lambda t: ((comm.rank + 1.0) * comm.Allgather(t, 0))
                  .sum(), torch.from_numpy(np.random.rand(3)))
        assert bool((g == n * (n + 1) / 2).all())

    _run(n, body)


@pytest.mark.parametrize("n", SIZES)
def test_reduce_scatter_reference_identities(n):
    def body():
        x = torch.ones(n * 3, dtype=torch.float64) * (comm.rank + 1)
        out = comm.Reduce_scatter(x, P.MPI_SUM, 0)
        assert out.shape == (3,) and bool((out == n * (n + 1) / 2).all())
        rng = np.random.default_rng(comm.rank)
        x = torch.from_numpy(rng.standard_normal((n * 2, 3)))
        ag = comm.Allgather(comm.Reduce_scatter(x, P.MPI_SUM, 0), 0)
        torch.testing.assert_close(ag, comm.Allreduce(x, P.MPI_SUM),
                                   rtol=1e-12, atol=1e-12)
        w = float(comm.rank + 1)
        g = _grad(lambda t: torch.sum(w * comm.Reduce_scatter(
            t, P.MPI_SUM, 0)), torch.ones(n * 2, dtype=torch.float64))
        want = np.repeat(np.arange(1, n + 1, dtype=float), 2)
        assert np.array_equal(g.numpy(), want)

    _run(n, body)


@pytest.mark.parametrize("n", SIZES)
def test_scatter_reference_identities(n):
    def body():
        if comm.rank == 0:
            tmp = torch.from_numpy(np.random.rand(2, 5, n, 2, 3))
            for i in range(n):
                tmp[0, 0, i, 0, 0] = i
        else:
            tmp = torch.from_numpy(np.random.rand(1))
        res = comm.Scatter(tmp, 2, 1, 0)
        assert bool((res[0, 0, :, 0, 0] == comm.rank).all())
        res2 = comm.Gather(res, 2, 0)
        if comm.rank == 0:
            assert torch.equal(res2, tmp)
        g = _grad(lambda t: comm.Scatter(t, 2, 1, 0).sum(), tmp)
        assert bool((g == (1.0 if comm.rank == 0 else 0.0)).all())

    _run(n, body)


@pytest.mark.parametrize("n", SIZES)
def test_alltoall_reference_identities(n):
    def body():
        r = comm.rank
        tmp = torch.from_numpy(np.random.rand(3, 4, 1, 4, n, 2))
        res1 = comm.Scatter(comm.Gather(tmp, 2, 0), 4, 1, 0)
        assert torch.equal(comm.Alltoall(tmp, 2, 4, 1), res1)
        tmp = torch.from_numpy(np.random.rand(3, 4, r + 1, 4, _tri(n), 2))
        res1 = comm.Scatter(comm.Gather(tmp, 2, 0), 4, r + 1, 0)
        assert torch.equal(comm.Alltoall(tmp, 2, 4, r + 1), res1)
        tmp = torch.from_numpy(np.random.rand(3, 4, 2, 4, 3 * n, 2))
        back = comm.Alltoall(comm.Alltoall(tmp, 2, 4, 3), 4, 2, 2)
        assert torch.equal(back, tmp)
        tmp = torch.from_numpy(np.random.rand(3, 4, r + 1, 2))
        tmp[0, 0, :, 0] = torch.arange(r * (r + 1) // 2,
                                       (r + 1) * (r + 2) // 2,
                                       dtype=tmp.dtype)
        res = comm.Alltoall(tmp, 2, 2, n - r)
        lo = _tri(n) - (n - r) * (n - r + 1) // 2
        hi = _tri(n) - (n - r - 1) * (n - r) // 2
        assert torch.equal(res[0, 0, :, 0],
                           torch.arange(lo, hi, dtype=tmp.dtype))
        g = _grad(lambda t: comm.Alltoall(t, 2, 4, 1).sum(),
                  torch.from_numpy(np.random.rand(3, 4, 2, 4, n, 2)))
        assert bool((g == 1.0).all())

    _run(n, body)


def test_allreduce_bit_exact_vs_ordered_oracle_run_to_run():
    data = np.random.default_rng(0).standard_normal((5, 1000)).astype(
        np.float32)

    def body(rank):
        return comm.Allreduce(torch.from_numpy(data[rank]),
                              P.MPI_SUM).numpy()

    out1, out2 = _run(5, body), _run(5, body)
    oracle = data[0].copy()
    for r in range(1, 5):
        oracle = oracle + data[r]
    for r in range(5):
        assert _bitwise(out1[r], oracle) and _bitwise(out1[r], out2[r])


def test_reduce_band_on_floats_raises_on_every_rank():
    def body():
        with pytest.raises(TypeError):
            comm.Reduce_(torch.ones(8), P.MPI_BAND, 0)
        return "raised"

    assert _run(3, body) == ["raised"] * 3


# --------------------------------------------------------------------------
# Error paths
# --------------------------------------------------------------------------


@pytest.mark.parametrize("call", [
    lambda t: comm.Bcast_(t, 5),
    lambda t: comm.Reduce_(t, P.MPI_SUM, -1),
    lambda t: comm.Gather(t, 0, 2),
    lambda t: comm.Scatter(t, 0, 1, 9),
    lambda t: comm.Isend(t, 7, 0),
    lambda t: comm.Irecv(t, -3, 0),
], ids=["bcast", "reduce", "gather", "scatter", "isend", "irecv"])
def test_invalid_root_or_peer_raises_commerror(call):
    def body():
        with pytest.raises(P.CommError, match="invalid"):
            call(torch.ones(2))
        return True

    assert all(_run(2, body))


@pytest.mark.parametrize("op", [
    lambda t: comm.Allreduce(t, P.MPI_MAX),
    lambda t: comm.Reduce_scatter(t, P.MPI_MAX, 0),
    lambda t: comm.Reduce_(t, P.MPI_MAX, 0),
], ids=["allreduce", "reduce_scatter", "reduce"])
def test_non_sum_backward_raises(op):
    def body():
        x = torch.ones(4, requires_grad=True) * (comm.rank + 1)
        out = op(x)
        with pytest.raises(RuntimeError, match="MPI_MAX"):
            out.sum().backward()
        return True

    assert all(_run(2, body))


def test_indivisible_reduce_scatter_and_numelem_mismatch_raise():
    def body():
        with pytest.raises(P.CommError, match="divisible"):
            comm.Reduce_scatter(torch.ones(5), P.MPI_SUM, 0)
        with pytest.raises(ValueError, match="numelem"):
            comm.Scatter(torch.ones(2, 3, 4), 1, 1, 0)
        return True

    assert all(_run(2, body))


def test_unported_options_raise_naming_roadmap():
    def body():
        t = torch.ones(4)
        # A synthesized schedule not installed for this world raises
        # when named explicitly (the JAX package's rule).
        with pytest.raises(P.CommError, match="not installed"):
            comm.Allreduce(t, P.MPI_SUM, algorithm="synth:deadbeef")
        # The compressed Allgather is ported: q8 carries integer-valued
        # blocks exactly.
        assert torch.equal(comm.Allgather(t, 0, compression="q8"),
                           torch.ones(8))
        # The packed numelem and the split-phase forms are ported: on two
        # ranks they give the dense and blocking answers.
        r = comm.rank
        x = torch.arange(4.) + 10 * r
        assert comm.Allgather(x, 0, numelem=2).tolist() == \
            [0.0, 1.0, 10.0, 11.0]
        assert comm.Gather(x, 0, 0, numelem=(2, 2)).tolist() == \
            ([0.0, 1.0, 10.0, 11.0] if r == 0 else [0.0] * 4)
        assert torch.equal(comm.Scatter(torch.arange(4.), 0, (2, 2), 0),
                           torch.arange(2.) + 2 * r)
        assert torch.equal(comm.Alltoall(t, 0, 0, (4, 4),
                                         current_numelem=(4, 4)), t)
        assert torch.equal(comm.Wait(comm.Allreduce_start(x, P.MPI_SUM)),
                           comm.Allreduce(x, P.MPI_SUM))
        assert torch.equal(
            comm.Wait(comm.Reduce_scatter_start(x, P.MPI_SUM, 0)),
            comm.Reduce_scatter(x, P.MPI_SUM, 0))
        assert torch.equal(comm.Wait(comm.Allgather_start(x, 0)),
                           comm.Allgather(x, 0))
        # A scope codec compresses a floating Allgather, as in the JAX
        # package; an integer payload stays exact in both.
        third = x / 3
        with P.config.compression_scope("q8"):
            scoped = comm.Allgather(third, 0)
            ints = comm.Allgather(torch.ones(2, dtype=torch.int32), 0)
        assert torch.equal(scoped, comm.Allgather(third, 0,
                                                  compression="q8"))
        assert not torch.equal(scoped, comm.Allgather(third, 0))
        assert ints.tolist() == [1] * 4
        return True

    assert all(_run(2, body))
    from mpi4torch_tpu_torch import comm as pcomm
    # comm_from_mesh is ported (Mode A, tests/test_torch_spmd.py): a
    # mesh axis adopts as a communicator of the axis's static size, and
    # an unknown axis is refused; comm_from_mpi4py is ported too
    # (tests/test_torch_distributed.py) and, without mpi4py, raises the
    # JAX package's RuntimeError.
    mesh = P.device_mesh({"dp": 2, "tp": 3},
                         devices=[torch.device("cpu")] * 6)
    assert pcomm.comm_from_mesh(mesh, "tp").size == 3
    assert pcomm.comm_from_mesh(mesh, ("dp", "tp")).size == 6
    with pytest.raises(P.CommError, match="not in mesh axes"):
        pcomm.comm_from_mesh(mesh, "x")
    import importlib.util
    if importlib.util.find_spec("mpi4py") is None:
        with pytest.raises(RuntimeError, match="mpi4py is not available"):
            pcomm.comm_from_mpi4py(None)


@pytest.mark.parametrize("name", ["ragged_alltoall", "ragged_allgather",
                                  "ragged_gather", "ragged_scatter"])
def test_ragged_collectives_raise_naming_roadmap(name):
    # The ragged collectives are ported (tests/test_torch_ragged.py holds
    # them against the JAX package); what raises now is a malformed
    # call, with the JAX package's ValueError, while a well-formed one
    # on the size-1 world returns (payload, counts).
    from mpi4torch_tpu_torch.ops import ragged

    fn = getattr(ragged, name)
    with pytest.raises(ValueError):
        fn(comm, torch.ones(2, 3), torch.ones(2, 2, dtype=torch.int64))
    block = name in ("ragged_alltoall", "ragged_scatter")
    x = torch.ones(1, 3, 2) if block else torch.ones(3, 2)
    count = torch.tensor([2]) if block else torch.tensor(2)
    out, counts = fn(comm, x, count)
    assert int(counts.reshape(-1)[0]) == 2
    assert out.reshape(3, 2)[2].eq(0).all() and out.reshape(3, 2)[:2].eq(1) \
        .all()


def test_algorithm_requests_follow_the_registry():
    # An explicit algorithm that cannot serve the collective or the world
    # raises; unknown names raise ValueError.
    def body():
        t = torch.ones(4)
        with pytest.raises(P.CommError, match="serves"):
            comm.Bcast_(t, 0, algorithm="rhd")
        with pytest.raises(P.CommError, match="power-of-two"):
            comm.Allreduce(t, P.MPI_SUM, algorithm="rhd")
        with pytest.raises(P.CommError, match="factorization"):
            comm.Allreduce(t, P.MPI_SUM, algorithm="hier")
        with pytest.raises(ValueError, match="unknown"):
            comm.Reduce_(t, P.MPI_SUM, 0, algorithm="nope")
        return True

    assert all(_run(3, body))


# --------------------------------------------------------------------------
# Private outputs, spans and the health probe
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["bcast", "allreduce_fold_once", "scatter",
                                  "alltoall", "reduce_bwd", "gather"])
def test_an_in_place_edit_stays_on_its_rank(name):
    n, big = 3, peager._FOLD_ONCE_MIN + 1

    def op(t):
        return {
            "bcast": lambda: comm.Bcast_(t, 0),
            "allreduce_fold_once": lambda: comm.Allreduce(t, P.MPI_SUM),
            "scatter": lambda: comm.Scatter(t, 0, big // n, 0),
            "alltoall": lambda: comm.Alltoall(t, 0, 0, t.shape[0]),
            "reduce_bwd": lambda: _grad(
                lambda v: comm.Reduce_(v, P.MPI_SUM, 0).sum(), t),
            "gather": lambda: comm.Gather(t, 0, 1),
        }[name]()

    def body(rank):
        t = torch.ones(big // n * n, dtype=torch.float64)
        out = op(t)
        before = out.clone()
        comm.Allreduce(torch.zeros(1), P.MPI_SUM)      # everyone has out
        if rank == 1:
            out.add_(100.0)                           # rank 1 edits its own
        comm.Allreduce(torch.zeros(1), P.MPI_SUM)
        return out, before, t

    res = _run(n, body)
    for r, (out, before, t) in enumerate(res):
        if r != 1:
            assert torch.equal(out, before), r
        assert torch.equal(t, torch.ones_like(t))
    ptrs = [out.data_ptr() for out, _, _ in res]
    assert len(set(ptrs)) == n


def test_ops_run_under_their_profiler_spans():
    # A one-rank world: the profiler records the thread that starts it.
    def body():
        with torch.profiler.profile() as prof:
            comm.Bcast_(torch.ones(2), 0)
            comm.Reduce_scatter(torch.ones(2), P.MPI_SUM, 0)
            comm.Allreduce(torch.ones(2), P.MPI_SUM, algorithm="tree")
            comm.Allgather(torch.ones(2), 0)
        return {e.key for e in prof.key_averages()}

    keys = _run(1, body)[0]
    for span in ("mpi4torch.Bcast", "mpi4torch.Reduce_scatter",
                 "mpi4torch.Allreduce.tree", "mpi4torch.Allgather"):
        assert span in keys


def test_check_health_names_the_missing_rank_then_recovers():
    def body(rank):
        if rank == 2:
            time.sleep(0.6)              # late for the first probe
            first = None
        else:
            first = comm.check_health(timeout=0.3)
        second = comm.check_health(timeout=10.0)
        return first, second

    res = _run(3, body)
    for rank, (first, second) in enumerate(res):
        if rank != 2:
            assert not first.ok and first.missing == frozenset({2})
            assert first.arrived == frozenset({0, 1})
        assert second.ok and second.missing == frozenset()
        assert set(second.arrival_s) == {0, 1, 2}
    assert bool(res[0][1]) and not bool(res[0][0])
