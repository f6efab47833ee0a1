"""The port's tensor-parallel layers against the JAX package.

``column_parallel_linear``, ``row_parallel_linear``, ``tp_mlp`` and
``tp_attention`` (with its default ``dense_attention`` and with
``flash_attention``) run on 2 and 4 rank threads in both packages (the
JAX side on its own rank threads, op by op), on the same float64 numpy
inputs: each rank's shards cut from the full weights with ``shard_axis``.
Values and the gradients of ``vdot(out, w_r)`` with respect to the
input and every shard agree with the JAX package's to 1e-12, and the
values with the unsharded composition to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu.ops import flash as jflash
from mpi4torch_tpu.parallel import tp as JTP
from mpi4torch_tpu_torch.ops import flash as pflash
from mpi4torch_tpu_torch.parallel import attention as PA
from mpi4torch_tpu_torch.parallel import tp as PTP

TOL = 1e-12
B, S, D, FF, H = 2, 6, 8, 16, 4


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _shard(x, axis, r, n):
    m = x.shape[axis] // n
    return np.ascontiguousarray(np.take(x, range(r * m, (r + 1) * m),
                                        axis=axis))


def _both(n, jfn, pfn, inputs, out_shape):
    """Run ``jfn``/``pfn`` (comm, *arrays) on ``n`` rank threads of each
    package on ``inputs(r)``, a list of numpy arrays; compare values and
    the gradients of vdot(out, w_r) with respect to every input."""
    def jbody(r):
        xs = [jnp.asarray(a) for a in inputs(r)]
        w = _rand(out_shape, 100 + r)

        def f(*xs):
            out = jfn(mpi.COMM_WORLD, *xs)
            return jnp.vdot(out, w), out

        (_, out), g = jax.value_and_grad(
            f, argnums=tuple(range(len(xs))), has_aux=True)(*xs)
        return np.asarray(out), [np.asarray(x) for x in g]

    def pbody(r):
        xs = [torch.from_numpy(a).requires_grad_() for a in inputs(r)]
        out = pfn(P.COMM_WORLD, *xs)
        w = torch.from_numpy(_rand(out_shape, 100 + r))
        g = torch.autograd.grad((out * w).sum(), xs)
        return out.detach().numpy(), [x.numpy() for x in g]

    ref = mpi.run_ranks(jbody, n)
    got = P.run_ranks(pbody, n, device="cpu")
    for (go, gg), (ro, rg) in zip(got, ref):
        np.testing.assert_allclose(go, ro, atol=TOL, rtol=TOL)
        for a, b in zip(gg, rg):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
    return [o for o, _ in got]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("gather, bias", [(True, True), (True, False),
                                          (False, True)])
def test_column_parallel_linear_matches_jax(n, gather, bias):
    x, W, b = _rand((B, S, D), 0), _rand((D, FF), 1), _rand(FF, 2)

    def inputs(r):
        return [x, _shard(W, 1, r, n)] + ([_shard(b, 0, r, n)] if bias
                                          else [])

    shape = (B, S, FF if gather else FF // n)
    outs = _both(
        n, lambda c, *a: JTP.column_parallel_linear(
            c, *a, gather_output=gather),
        lambda c, *a: PTP.column_parallel_linear(c, *a,
                                                 gather_output=gather),
        inputs, shape)
    full = x @ W + (b if bias else 0.0)
    for r, o in enumerate(outs):
        want = full if gather else _shard(full, 2, r, n)
        np.testing.assert_allclose(o, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("reduce, bias", [(True, True), (True, False),
                                          (False, False)])
def test_row_parallel_linear_matches_jax(n, reduce, bias):
    x, W, b = _rand((B, S, FF), 0), _rand((FF, D), 1), _rand(D, 2)

    def inputs(r):
        return [_shard(x, 2, r, n), _shard(W, 0, r, n)] + ([b] if bias
                                                           else [])

    outs = _both(
        n, lambda c, *a: JTP.row_parallel_linear(c, *a,
                                                 reduce_output=reduce),
        lambda c, *a: PTP.row_parallel_linear(c, *a, reduce_output=reduce),
        inputs, (B, S, D))
    if reduce:
        for o in outs:
            np.testing.assert_allclose(o, x @ W + (b if bias else 0.0),
                                       atol=TOL, rtol=TOL)
    else:
        np.testing.assert_allclose(sum(outs), x @ W, atol=TOL, rtol=TOL)


def test_row_parallel_refuses_a_bias_on_partial_sums():
    def body():
        t = torch.ones((2, 4), dtype=torch.float64)
        with pytest.raises(ValueError, match="size times"):
            PTP.row_parallel_linear(P.COMM_WORLD, t, torch.ones((4, 3)).to(
                t), torch.ones(3).to(t), reduce_output=False)

    P.run_ranks(body, 2, device="cpu")


@pytest.mark.parametrize("n", [2, 4])
def test_tp_mlp_matches_jax_and_the_unsharded_mlp(n):
    x = _rand((B, S, D), 0)
    w1, b1, w2, b2 = (_rand((D, FF), 1), _rand(FF, 2), _rand((FF, D), 3),
                      _rand(D, 4))

    def inputs(r):
        return [x, _shard(w1, 1, r, n), _shard(b1, 0, r, n),
                _shard(w2, 0, r, n), b2]

    outs = _both(n, JTP.tp_mlp, PTP.tp_mlp, inputs, (B, S, D))
    t = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2)]
    want = F.gelu(t[0] @ t[1] + t[2], approximate="tanh") @ t[3] + t[4]
    for o in outs:
        np.testing.assert_allclose(o, want.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_tp_attention_matches_jax_and_the_unsharded_layer(n, attention):
    x = _rand((B, S, D), 0)
    wq, wk, wv, wo = (_rand((D, D), s) / np.sqrt(D) for s in (1, 2, 3, 4))
    jfn = {"dense": None, "flash": jflash.flash_attention}[attention]
    pfn = {"dense": None, "flash": pflash.flash_attention}[attention]

    def inputs(r):
        return [_shard(w, 1, r, n) for w in (wq, wk, wv)] + [
            _shard(wo, 0, r, n), x]

    outs = _both(
        n, lambda c, *a: JTP.tp_attention(c, *a, n_heads=H,
                                          attention_fn=jfn),
        lambda c, *a: PTP.tp_attention(c, *a, n_heads=H, attention_fn=pfn),
        inputs, (B, S, D))
    t = [torch.from_numpy(a) for a in (x, wq, wk, wv, wo)]
    q, k, v = ((t[0] @ w).reshape(B, S, H, D // H) for w in t[1:4])
    want = PA.dense_attention(q, k, v, causal=True).reshape(B, S, D) @ t[4]
    for o in outs:
        np.testing.assert_allclose(o, want.numpy(), atol=TOL, rtol=TOL)


def test_tp_attention_refuses_heads_off_the_communicator():
    def body():
        w = torch.zeros((6, 2), dtype=torch.float64)
        with pytest.raises(ValueError, match="not divisible"):
            PTP.tp_attention(P.COMM_WORLD, w, w, w, w.T,
                             torch.zeros((1, 2, 6), dtype=torch.float64),
                             n_heads=3)

    P.run_ranks(body, 2, device="cpu")
