"""The port's expert-parallel MoE against the JAX package.

The same numpy inputs (router logits, tokens, and ``init_moe`` parameters
drawn with ``jax.random`` and carried across as numpy) go through both
packages in float64.  ``top1_route``'s dispatch is bitwise the JAX
package's; its combine and aux, which come from the router softmax, are
within 4 ulps: XLA's CPU ``exp`` rounds about one float64 input in seven
differently from torch's (and numpy's and libm's), by one ulp, and the
softmax's sum adds up to two more (3 ulps measured over 300 routings).
In bf16 at 1024 tokens (an expert's slots past 256) the dispatch is
bitwise a float64 routing oracle counted in integers.
``moe_ffn`` on 2 and 4 rank threads (the JAX
side on its own rank threads) agrees with JAX's ``moe_ffn`` and with
``moe_ffn_dense`` in values, aux and the gradients of ``vdot(y, w_r) +
aux`` with respect to the tokens and every parameter, to 1e-12, with a
capacity that binds and one that does not.  ``balanced_assignment`` is
equal, and ``rebalance_experts`` moves every expert bitwise and returns
the gradient to its old owner.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu.parallel import moe as JM
from mpi4torch_tpu_torch.parallel import moe as PM
from mpi4torch_tpu_torch.runtime import CommError
from mpi4torch_tpu_torch.utils.tree import value_and_grad

TOL = 1e-12
T, DM, FF = 12, 8, 16


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _params(E, seed=3):
    jp = JM.init_moe(jax.random.PRNGKey(seed), E, DM, FF, dtype=jnp.float64)
    # Non-zero biases, so a bias reaching an empty slot would show.
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v) + (0.1 * rng.standard_normal(v.shape)
                                if k.startswith("b") else 0.0)
            for k, v in jp.items()}


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("capacity", [2, 3, 12])
@pytest.mark.parametrize("skewed", [False, True])
def test_top1_route_bitwise(capacity, skewed):
    logits = _rand((20, 8), 5)
    if skewed:
        logits[:, 2] += 2.0     # most tokens to expert 2: capacity binds
    jd, jc, ja = JM.top1_route(jnp.asarray(logits), capacity)
    pd, pc, pa = PM.top1_route(torch.from_numpy(logits), capacity)
    assert np.array_equal(pd.numpy(), np.asarray(jd))
    for got, want in ((pc, jc), (pa, ja)):
        want = np.asarray(want)
        assert np.all(np.abs(got.numpy() - want)
                      <= 4 * np.spacing(np.abs(want)))
    kept = pd.sum(dim=(1, 2))
    assert torch.all(pd.sum(dim=0) <= 1) and torch.all(kept <= 1)
    assert torch.all(pd.sum(dim=(0, 2)) <= capacity)


def test_top1_route_drops_in_token_order():
    logits = torch.zeros((10, 4), dtype=torch.float64)
    logits[:, 0] = 10.0
    dispatch, _, _ = PM.top1_route(logits, 4)
    kept = dispatch.sum(dim=(1, 2))
    assert torch.equal(kept, torch.tensor([1.0] * 4 + [0.0] * 6,
                                          dtype=torch.float64))


def _route_oracle(expert, E, capacity):
    """float64 dispatch of top-1 choices ``expert``, counted in Python:
    slots in token order, tokens past an expert's capacity dropped."""
    T = len(expert)
    d = np.zeros((T, E, capacity))
    seen = [0] * E
    for t, e in enumerate(expert):
        if seen[e] < capacity:
            d[t, e, seen[e]] = 1.0
        seen[e] += 1
    return d


@pytest.mark.parametrize("capacity", [320, 1024])
def test_top1_route_bf16_counts_past_256(capacity):
    # 1024 tokens, ~60% to expert 0: its slots run past 256, which a bf16
    # count cannot hold.  Margins of 4 make the bf16 argmax the chosen
    # expert, so the float64 oracle routes the same choices.
    rng = np.random.default_rng(7)
    T, E = 1024, 4
    expert = rng.choice(E, size=T, p=[0.6, 0.2, 0.1, 0.1])
    logits = 0.1 * rng.standard_normal((T, E))
    logits[np.arange(T), expert] += 4.0
    want = _route_oracle(expert, E, capacity)
    d, c, aux = PM.top1_route(
        torch.from_numpy(logits).to(torch.bfloat16), capacity)
    assert d.dtype == torch.bfloat16 and c.dtype == torch.bfloat16
    assert np.array_equal(d.double().numpy(), want)
    counts = np.bincount(expert, minlength=E)
    assert counts[0] > 256
    assert float(d.double().sum()) == np.minimum(counts, capacity).sum()
    assert torch.all(d.double().sum(dim=0) <= 1)
    assert torch.equal(c != 0, d != 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_init_moe_shapes(dtype):
    p = PM.init_moe(0, 4, DM, FF, dtype=dtype, device="cpu")
    want = {"gate": (DM, 4), "w1": (4, DM, FF), "b1": (4, FF),
            "w2": (4, FF, DM), "b2": (4, DM)}
    assert {k: tuple(v.shape) for k, v in p.items()} == want
    assert all(v.dtype == dtype for v in p.values())
    assert not p["b1"].any() and not p["b2"].any()
    again = PM.init_moe(0, 4, DM, FF, dtype=dtype, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    # The JAX package's scalings: gate and w1 over sqrt(d), w2 over
    # sqrt(f) (loose: sample standard deviations).
    big = PM.init_moe(1, 8, 64, 256, dtype=torch.float64, device="cpu")
    assert abs(big["w1"].std().item() - 64 ** -0.5) < 0.01
    assert abs(big["w2"].std().item() - 256 ** -0.5) < 0.01


def _grad_all(fn, x, params, w):
    """Value, aux and the gradients of vdot(y, w) + aux w.r.t. x and every
    parameter (port side)."""
    tree = {"x": x, "p": params}

    def loss(t):
        y, aux = fn(t["x"], t["p"])
        loss.out = (y.detach(), aux.detach())
        return (y * w).sum() + aux

    _, g = value_and_grad(loss, tree)
    return loss.out, g


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("capacity", [2, 12])
def test_moe_ffn_matches_jax_and_dense(n, capacity):
    E = 2 * n
    params = _params(E)
    xs = [_rand((T, DM), 10 + r) for r in range(n)]
    ws = [_rand((T, DM), 20 + r) for r in range(n)]

    def jbody(r):
        def f(x, p):
            y, aux = JM.moe_ffn(mpi.COMM_WORLD, x, p, capacity)
            return jnp.vdot(y, ws[r]) + aux, (y, aux)

        (_, (y, aux)), g = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(
            jnp.asarray(xs[r]), {k: jnp.asarray(v)
                                 for k, v in params.items()})
        return np.asarray(y), float(aux), jax.tree.map(np.asarray, g)

    def pbody(r):
        (y, aux), g = _grad_all(
            lambda x, p: PM.moe_ffn(P.COMM_WORLD, x, p, capacity),
            torch.from_numpy(xs[r]), _torch_tree(params),
            torch.from_numpy(ws[r]))
        return y.numpy(), aux.item(), g

    ref = mpi.run_ranks(jbody, n)
    got = P.run_ranks(pbody, n, device="cpu")
    dropped = 0
    for r in range(n):
        y, aux, g = got[r]
        np.testing.assert_allclose(y, ref[r][0], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(aux, ref[r][1], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(g["x"].numpy(), ref[r][2][0], atol=TOL,
                                   rtol=TOL)
        for k in params:
            np.testing.assert_allclose(g["p"][k].numpy(), ref[r][2][1][k],
                                       atol=TOL, rtol=TOL)
        # The distributed layer routes each shard as the dense oracle
        # routes it.
        (dy, daux), _ = _grad_all(
            lambda x, p: PM.moe_ffn_dense(x, p, capacity),
            torch.from_numpy(xs[r]), _torch_tree(params),
            torch.from_numpy(ws[r]))
        np.testing.assert_allclose(y, dy.numpy(), atol=TOL, rtol=TOL)
        assert aux == daux.item()
        dropped += int((np.abs(y).sum(axis=1) == 0).sum())
    # capacity 2 of 12 tokens over 2n experts drops tokens; 12 drops none.
    assert (dropped > 0) == (capacity == 2)


def test_moe_ffn_dense_matches_jax():
    params = _params(4)
    x = _rand((T, DM), 1)
    jy, jaux = JM.moe_ffn_dense(jnp.asarray(x), {
        k: jnp.asarray(v) for k, v in params.items()}, 3)
    py, paux = PM.moe_ffn_dense(torch.from_numpy(x), _torch_tree(params), 3)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(paux.item(), float(jaux), atol=TOL, rtol=TOL)


def test_moe_ffn_refuses_experts_off_the_communicator():
    params = _torch_tree(_params(3))

    def body():
        with pytest.raises(ValueError, match="not divisible"):
            PM.moe_ffn(P.COMM_WORLD, torch.zeros((T, DM),
                                                 dtype=torch.float64),
                       params, 2)

    P.run_ranks(body, 2, device="cpu")


@pytest.mark.parametrize("loads, size", [
    (list(range(16)), 4), ([5, 1, 9, 3], 2), ([2.0, 2.0, 1.0, 7.0, 0.5, 3.0],
                                              3), ([1, 1, 1, 1], 4)])
def test_balanced_assignment_matches_jax(loads, size):
    want = JM.balanced_assignment(loads, size)
    assert PM.balanced_assignment(loads, size) == want
    assert PM.balanced_assignment(torch.tensor(loads), size) == want
    assert sorted(want) == list(range(len(loads)))


def test_balanced_assignment_refuses_uneven():
    with pytest.raises(ValueError, match="not divisible"):
        PM.balanced_assignment(list(range(9)), 4)


@pytest.mark.parametrize("n", [2, 4])
def test_rebalance_experts_moves_and_differentiates(n):
    epr = 2
    E = n * epr
    stack = _rand((E, 3), 4)
    wts = _rand((E, 3), 5)
    perm = PM.balanced_assignment(list(range(E)), n)

    def body(r):
        mine = torch.from_numpy(stack[r * epr:(r + 1) * epr].copy())
        mine.requires_grad_()
        out = PM.rebalance_experts(P.COMM_WORLD, {"w": mine}, perm)["w"]
        # The new owner's cotangent returns to the old owner.
        w = torch.from_numpy(wts[r * epr:(r + 1) * epr])
        (g,) = torch.autograd.grad((out * w).sum(), mine)
        return out.detach().numpy(), g.numpy()

    got = P.run_ranks(body, n, device="cpu")
    want = stack[list(perm)]
    grad = np.zeros_like(stack)
    grad[list(perm)] = wts
    for r in range(n):
        assert np.array_equal(got[r][0], want[r * epr:(r + 1) * epr])
        assert np.array_equal(got[r][1], grad[r * epr:(r + 1) * epr])


def test_rebalance_experts_refusals():
    def body():
        c = P.COMM_WORLD
        x = {"w": torch.zeros((2, 3))}
        with pytest.raises(ValueError, match="permutation"):
            PM.rebalance_experts(c, x, (0, 0, 1, 2))
        with pytest.raises(ValueError, match="expected 2 per rank"):
            PM.rebalance_experts(c, {"w": torch.zeros((3, 3))},
                                 (0, 1, 2, 3))
        # The planned route never gathers: "gather" cannot serve a block
        # permutation.
        with pytest.raises(CommError, match="cannot serve"):
            PM.rebalance_experts(c, x, (0, 1, 2, 3), strategy="gather")

    P.run_ranks(body, 2, device="cpu")


def test_parallel_exports_match_jax():
    import mpi4torch_tpu.parallel as jpar
    import mpi4torch_tpu_torch.parallel as ppar

    ported = {"dense_attention", "ring_attention", "ulysses_attention",
              "zigzag_positions", "zigzag_slice", "zigzag_ring_attention",
              "column_parallel_linear", "row_parallel_linear", "shard_axis",
              "tp_attention", "tp_mlp", "init_moe", "moe_ffn",
              "moe_ffn_dense", "balanced_assignment", "rebalance_experts",
              "top1_route", "all_average_tree", "dp_value_and_grad",
              "halo_exchange", "ring_shift"}
    assert ported <= set(jpar.__all__)
    assert ported <= set(ppar.__all__)
    assert all(callable(getattr(ppar, name)) for name in ported)
