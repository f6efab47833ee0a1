"""The port's ring transport, L-BFGS and the three BASELINE examples, on
the CPU.

``ring_shift`` and ``halo_exchange`` (``parallel/ring.py``) are bitwise
equal to the JAX package's in value and gradient on the same float64
numpy inputs, on worlds of 2 to 8 ranks (every send and receive moves
the same bits, and the backward is the reverse ring).  The eager L-BFGS
(``utils/lbfgs.py``) follows the JAX package's iterates: on the linear
regression (BASELINE config 1) the parameters and loss agree to 1e-8,
and on the 32 x 16 halo-exchange stencil (config 5) the field agrees to
1e-8 of its largest entry and the loss to 1e-8 of the initial loss (the
two packages sum the loss in other orders, which moves its last bits).
The torch examples (configs 1, 3 and 5) run with ``device="cpu"``.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu.parallel import ring as jring
from mpi4torch_tpu_torch.examples import halo_exchange_stencil as tstencil
from mpi4torch_tpu_torch.examples import isend_recv_wait as tisend
from mpi4torch_tpu_torch.examples import simple_linear_regression as treg
from mpi4torch_tpu_torch.parallel import ring as pring
from mpi4torch_tpu_torch.utils import lbfgs as plbfgs

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bitwise(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def _both(n, jax_op, torch_op, xs, ws):
    """(value, gradient of vdot(out, w_r)) per rank, JAX then port."""
    def jax_body(r):
        t = jnp.asarray(xs[r])
        out = jax_op(mpi.COMM_WORLD, t)
        g = jax.grad(lambda v: jnp.vdot(jax_op(mpi.COMM_WORLD, v),
                                        jnp.asarray(ws[r])))(t)
        return np.asarray(out), np.asarray(g)

    def torch_body(r):
        t = torch.from_numpy(xs[r]).requires_grad_()
        out = torch_op(P.COMM_WORLD, t)
        (g,) = torch.autograd.grad(
            torch.vdot(out.reshape(-1), torch.from_numpy(ws[r]).reshape(-1)),
            t)
        return out.detach().numpy(), g.numpy()

    return (mpi.run_ranks(jax_body, n),
            P.run_ranks(torch_body, n, device="cpu", timeout=20.0))


@pytest.mark.parametrize("shift", [1, -1, 2])
@pytest.mark.parametrize("n", [2, 3, 4, 5, 6, 7, 8])
def test_ring_shift_bitwise_vs_jax(n, shift):
    rng = np.random.default_rng(10 * n + shift)
    xs = [rng.standard_normal((3, 5)) for _ in range(n)]
    ws = [rng.standard_normal((3, 5)) for _ in range(n)]
    ref, got = _both(n, lambda c, t: jring.ring_shift(c, t, shift, tag=3),
                     lambda c, t: pring.ring_shift(c, t, shift, tag=3),
                     xs, ws)
    for r in range(n):
        assert _bitwise(got[r][0], ref[r][0]) and _bitwise(got[r][1],
                                                           ref[r][1])
        assert np.array_equal(got[r][0], xs[(r - shift) % n])
        assert np.array_equal(got[r][1], ws[(r + shift) % n])


@pytest.mark.parametrize("halo, axis", [(1, 0), (2, 0), (1, 1)])
@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_halo_exchange_bitwise_vs_jax(n, halo, axis):
    rng = np.random.default_rng(n + 7 * halo + axis)
    xs = [rng.standard_normal((4, 6)) for _ in range(n)]
    out_shape = (4 + 2 * halo, 6) if axis == 0 else (4, 6 + 2 * halo)
    ws = [rng.standard_normal(out_shape) for _ in range(n)]
    ref, got = _both(
        n, lambda c, t: jring.halo_exchange(c, t, halo, axis=axis, tag=5),
        lambda c, t: pring.halo_exchange(c, t, halo, axis=axis, tag=5),
        xs, ws)
    for r in range(n):
        assert _bitwise(got[r][0], ref[r][0]) and _bitwise(got[r][1],
                                                           ref[r][1])


def test_halo_exchange_one_rank_is_periodic_and_checks_its_halo():
    x = torch.arange(12.0).reshape(4, 3)
    out = pring.halo_exchange(P.COMM_WORLD, x, 1)
    assert torch.equal(out, torch.cat([x[-1:], x, x[:1]]))
    assert pring.ring_shift(P.COMM_WORLD, x) is x
    for bad in (0, 5):
        with pytest.raises(ValueError, match="halo"):
            pring.halo_exchange(P.COMM_WORLD, x, bad)


def test_regression_lbfgs_matches_jax():
    ref = mpi.run_ranks(_jax_example("simple_linear_regression").main, 4)
    got = treg.run(4, device="cpu")
    for (pj, lj), (pt, lt) in zip(ref, got):
        np.testing.assert_allclose(pt, pj, rtol=1e-8, atol=0)
        assert abs(lt - lj) <= 1e-8 * max(abs(lj), 1e-300)


@pytest.mark.parametrize("steps", [5, 40])
def test_stencil_lbfgs_matches_jax(steps):
    jmod = _jax_example("halo_exchange_stencil")
    ref = mpi.run_ranks(lambda: jmod.main(steps), 4)
    got = P.run_ranks(lambda: tstencil.main(steps), 4, device="cpu")
    uj = np.concatenate([u for _, u in ref])
    ut = torch.cat([u for _, u in got]).numpy()
    assert np.abs(ut - uj).max() <= 1e-8 * np.abs(uj).max()
    (j0, j1), (t0, t1) = ref[0][0], got[0][0]
    assert abs(t0 - j0) <= 1e-8 * j0 and abs(t1 - j1) <= 1e-8 * j0
    # every rank followed the same trajectory
    assert all(losses == got[0][0] for losses, _ in got)


def test_stencil_does_not_depend_on_the_rank_count():
    u1 = P.run_ranks(lambda: tstencil.main(60), 1, device="cpu")[0][1]
    r4 = P.run_ranks(lambda: tstencil.main(60), 4, device="cpu")
    u4 = torch.cat([u for _, u in r4])
    torch.testing.assert_close(u4, u1, rtol=0, atol=1e-8)


def test_lbfgs_value_and_grad_callback_and_monotone_losses():
    # A convex quadratic in one process: the autograd path and the
    # value_and_grad path take the same steps, the callback sees every
    # iteration, and the loss never rises.
    a = torch.linspace(1.0, 4.0, 6, dtype=torch.float64)

    def loss(x):
        return (a * (x - 1.0) ** 2).sum()

    def vg(x):
        return loss(x), 2 * a * (x - 1.0)

    seen = []
    x1, f1 = plbfgs.LBFGS(max_iter=15).step(
        loss, torch.zeros(6, dtype=torch.float64),
        callback=lambda it, f: seen.append((it, f)))
    x2, f2 = plbfgs.minimize_lbfgs(vg, torch.zeros(6, dtype=torch.float64),
                                   max_iter=15, value_and_grad=True)
    assert torch.equal(x1, x2) and f1 == f2
    torch.testing.assert_close(x1, torch.ones(6, dtype=torch.float64))
    assert [it for it, _ in seen] == list(range(len(seen)))
    fs = [f for _, f in seen]
    assert all(b <= a for a, b in zip(fs, fs[1:]))


@pytest.mark.parametrize("n", [2, 5])
def test_isend_recv_wait_example_runs_on_the_cpu(n):
    tisend.run(n, device="cpu")


@pytest.mark.parametrize("n", [2, 5])
def test_linear_regression_example_runs_on_the_cpu(n):
    treg.run(n, device="cpu")


def test_halo_exchange_example_runs_on_the_cpu():
    tstencil.run(4, 80, device="cpu")
