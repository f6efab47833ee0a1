"""The port's rank-thread runtime and Allreduce against the JAX package.

Both packages fold per-rank values in ascending rank order, so on the
same float64 inputs the Allreduce values are bitwise equal to the JAX
package's Mode B (its rank-thread runtime).  Gradients of the
linear-regression example's loss (two Allreduces) agree with ``jax.grad``
to 1e-12 relative, and within each package every rank ends bitwise
identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu_torch import config as pconfig
from mpi4torch_tpu_torch.ops import eager as peager

SIZES = (1, 3, 4)
# A small payload, one above the port's fold-once threshold, and one
# above the JAX package's native-fold threshold as well.
NUMELS = (7, peager._FOLD_ONCE_MIN + 4464, 140000)


def _inputs(n, numel, seed=0):
    rng = np.random.default_rng(seed + 101 * n + numel)
    return [rng.standard_normal(numel) for _ in range(n)]


@pytest.mark.parametrize("numel", NUMELS)
@pytest.mark.parametrize("n", SIZES)
def test_allreduce_bitwise_vs_jax(n, numel):
    xs = _inputs(n, numel)
    ref = mpi.run_ranks(
        lambda r: np.asarray(mpi.COMM_WORLD.Allreduce(
            jnp.asarray(xs[r]), mpi.MPI_SUM)), n)
    got = P.run_ranks(
        lambda r: P.COMM_WORLD.Allreduce(
            torch.from_numpy(xs[r]), P.MPI_SUM).numpy(), n, device="cpu")
    for r in range(n):
        assert np.array_equal(got[r], ref[r])
        assert np.array_equal(got[r], got[0])


@pytest.mark.parametrize("op", [P.MPI_MAX, P.MPI_MIN, P.MPI_PROD])
def test_other_ops_bitwise_vs_jax(op):
    xs = _inputs(3, 11, seed=op)
    ref = mpi.run_ranks(
        lambda r: np.asarray(mpi.COMM_WORLD.Allreduce(jnp.asarray(xs[r]),
                                                      op)), 3)
    got = P.run_ranks(
        lambda r: P.COMM_WORLD.Allreduce(torch.from_numpy(xs[r]),
                                         op).numpy(), 3, device="cpu")
    for r in range(3):
        assert np.array_equal(got[r], ref[r])


def test_fold_once_results_are_private_per_rank():
    # Above the threshold rank 0 folds once and shares; an in-place edit
    # on one rank must not reach another rank's result.
    numel = peager._FOLD_ONCE_MIN

    def fn(r):
        y = P.COMM_WORLD.Allreduce(torch.ones(numel, dtype=torch.float64),
                                   P.MPI_SUM)
        P.COMM_WORLD.Allreduce(torch.zeros(1, dtype=torch.float64),
                               P.MPI_SUM)        # everyone has y now
        y.add_(r)
        P.COMM_WORLD.Allreduce(torch.zeros(1, dtype=torch.float64),
                               P.MPI_SUM)        # every edit is done
        return float(y[0])

    assert P.run_ranks(fn, 3, device="cpu") == [3.0, 4.0, 5.0]


# --- linear regression (examples/simple_linear_regression.py) -------------

NUM_POINTS = 1000


def _chunk(size, rank):
    chunk, rest = NUM_POINTS // size, NUM_POINTS % size
    if rank < rest:
        chunk += 1
        return chunk * rank, chunk
    return chunk * rank + rest, chunk


def _data():
    rng = np.random.default_rng(42)
    x = 2.0 * rng.random(NUM_POINTS)
    gen = np.array([0.1, 1.0, -2.0])
    return x, (gen[2] * x + gen[1]) * x + gen[0]


def _jax_grad(size):
    xall, yall = _data()

    def body(rank):
        comm = mpi.COMM_WORLD
        off, n = _chunk(size, rank)
        x, y = jnp.asarray(xall[off:off + n]), jnp.asarray(yall[off:off + n])

        def loss(p):
            p = comm.Allreduce(p, mpi.MPI_SUM) / comm.size
            local = jnp.sum(jnp.square(y - ((p[2] * x + p[1]) * x + p[0])))
            return comm.Allreduce(local, mpi.MPI_SUM)

        val, g = jax.value_and_grad(loss)(jnp.arange(3, dtype=jnp.float64))
        return float(val), np.asarray(g)

    return mpi.run_ranks(body, size)


def _torch_grad(size):
    xall, yall = _data()

    def body(rank):
        comm = P.COMM_WORLD
        off, n = _chunk(size, rank)
        x = torch.from_numpy(xall[off:off + n])
        y = torch.from_numpy(yall[off:off + n])
        p0 = torch.arange(3, dtype=torch.float64, requires_grad=True)
        p = comm.Allreduce(p0, P.MPI_SUM) / comm.size
        local = torch.sum((y - ((p[2] * x + p[1]) * x + p[0])) ** 2)
        loss = comm.Allreduce(local, P.MPI_SUM)
        loss.backward()
        return loss.item(), p0.grad.numpy()

    return P.run_ranks(body, size, device="cpu")


@pytest.mark.parametrize("n", SIZES)
def test_linear_regression_grad_vs_jax(n):
    ref = _jax_grad(n)
    got = _torch_grad(n)
    for r in range(n):
        np.testing.assert_allclose(got[r][1], ref[r][1], rtol=1e-12,
                                   atol=0)
        np.testing.assert_allclose(got[r][0], ref[r][0], rtol=1e-12)
        # Ranks end bitwise identical to each other.
        assert np.array_equal(got[r][1], got[0][1])
        assert got[r][0] == got[0][0]


# --- negative cases ---------------------------------------------------------


def test_mismatched_collective_raises_on_every_rank():
    def fn(r):
        try:
            P.COMM_WORLD.Allreduce(torch.zeros(3 + r, dtype=torch.float64),
                                   P.MPI_SUM)
        except P.CollectiveMismatchError as e:
            return e
        return None

    errs = P.run_ranks(fn, 3, device="cpu")
    assert all(isinstance(e, P.CollectiveMismatchError) for e in errs)


def test_size_zero_world_raises():
    with pytest.raises(ValueError):
        P.run_ranks(lambda: None, 0, device="cpu")


def test_missing_rank_raises_deadlock_naming_it():
    def fn(r):
        if r == 1:
            return None                 # never reaches the collective
        return P.COMM_WORLD.Allreduce(torch.ones(2), P.MPI_SUM)

    with pytest.raises(P.DeadlockError) as ei:
        P.run_ranks(fn, 3, timeout=0.5, device="cpu")
    assert ei.value.missing == frozenset({1})
    assert ei.value.arrived == frozenset({0, 2})


def test_dead_rank_is_attributed_to_survivors():
    from mpi4torch_tpu_torch.runtime import current_rank_context

    def fn(r):
        if r == 2:
            current_rank_context().world.mark_dead(
                2, RuntimeError("preempted"))
            return None
        try:
            P.COMM_WORLD.Allreduce(torch.ones(2), P.MPI_SUM)
        except P.RankFailedError as e:
            return set(e.ranks)
        return None

    out = P.run_ranks(fn, 3, timeout=5.0, device="cpu")
    assert out[:2] == [{2}, {2}]


def test_max_backward_raises():
    x = torch.ones(3, dtype=torch.float64, requires_grad=True)
    y = P.COMM_WORLD.Allreduce(x, P.MPI_MAX)
    with pytest.raises(RuntimeError, match="only MPI_SUM"):
        y.sum().backward()


@pytest.mark.parametrize("numel", [3, peager._FOLD_ONCE_MIN])
def test_bitwise_op_on_floats_raises_on_every_rank(numel):
    def fn():
        try:
            P.COMM_WORLD.Allreduce(torch.ones(numel), P.MPI_BAND)
        except TypeError as e:
            return e
        return None

    errs = P.run_ranks(fn, 2, device="cpu")
    assert all(isinstance(e, TypeError) for e in errs)


@pytest.mark.parametrize("kw", [{"compression": "bf16"},
                                {"algorithm": "synth:deadbeef00"}])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        P.COMM_WORLD.Allreduce(torch.ones(3), P.MPI_SUM, **kw)


def test_unported_backend_and_overlap_raise():
    # The multi-process backend is not ported (it raises, naming the
    # ROADMAP item); the overlap policy is: True and window depths are
    # accepted, and only malformed values raise.
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        P.run_ranks(lambda: None, 2, backend="process", device="cpu")
    try:
        for value in (True, 2, False):
            pconfig.set_default_overlap(value)
            assert pconfig.default_overlap() is value or \
                pconfig.default_overlap() == value
        for bad in (0, "x"):
            with pytest.raises(ValueError):
                pconfig.set_default_overlap(bad)
    finally:
        pconfig.set_default_overlap(None)


def test_payload_off_the_world_device_raises():
    meta = torch.empty(3, device="meta")
    with pytest.raises(P.CommError, match="runs on cpu"):
        P.run_ranks(lambda: P.COMM_WORLD.Allreduce(meta, P.MPI_SUM), 1,
                    device="cpu")


def test_run_ranks_without_cuda_needs_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.run_ranks(lambda: None, 2)


def test_world_timeout_env(monkeypatch):
    from mpi4torch_tpu_torch.runtime import World

    monkeypatch.setenv(pconfig.WORLD_TIMEOUT_ENV, "7.5")
    assert World(2).timeout == 7.5


def test_deterministic_mode_is_thread_local_flag():
    assert not pconfig.deterministic_reductions()
    with pconfig.deterministic_mode():
        assert pconfig.deterministic_reductions()
    assert not pconfig.deterministic_reductions()


def test_rendezvous_stress_more_ranks_than_cores():
    # Many rank threads, a short switch interval, many back-to-back
    # collectives: a lost update in the rendezvous would show as a wrong
    # sum or a mismatch on some rank.
    import sys

    nranks, rounds = 16, 40
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def fn(r):
            out = []
            for i in range(rounds):
                x = torch.full((3,), float(r * rounds + i),
                               dtype=torch.float64)
                out.append(P.COMM_WORLD.Allreduce(x, P.MPI_SUM)[0].item())
            return out

        res = P.run_ranks(fn, nranks, timeout=60.0, device="cpu")
    finally:
        sys.setswitchinterval(old)
    want = [float(sum(r * rounds + i for r in range(nranks)))
            for i in range(rounds)]
    assert all(r == want for r in res)
