"""The port's ZeRO-1/3 and its functional optimizers against the port's
own replicated-DP trajectory and against the JAX package with optax, on
the CPU.

* **Bitwise** against the port's replicated DP (every rank
  Allreduce-averages the gradient and runs the same optimizer on the
  full parameters): ``zero_step`` and ``zero3_step`` with ``sgd``,
  momentum ``sgd`` and ``adam``, in float32 and float64, on (2,), (3,)
  and (4,) worlds, leaves whose sizes do not divide the world included
  (zero padding); ``overlap=True`` gives the blocking step's bits.
  Global-norm clipping through ``shard_global_norm`` is held within rtol
  1e-12 of the replicated trajectory clipped by the full-gradient norm:
  the two norms sum their squares in other orders (per shard and across
  ranks, against per leaf), as in the JAX package's own test (rtol
  1e-9).
* **Against the JAX package** (``zero_step``/``zero3_step`` with optax
  0.2.6) on the same per-rank gradients: ``sgd`` without momentum is
  bitwise; ``adam`` and momentum ``sgd`` are held within rtol 1e-6 after
  5 float32 steps (on the CPU they come out bitwise, which the test
  does not require).
* ``zero_train_step`` / ``zero3_train_step`` of a small transformer (2
  layers, d_model 64, 4 heads) bitwise against the port's replicated
  Adam and within 1e-10 of the JAX package's steps in float64 (the
  forwards differ in their matmul sums, as ``test_torch_train.py``
  records).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu.models import transformer as JT
from mpi4torch_tpu.parallel import zero as JZ
from mpi4torch_tpu_torch.models import transformer as PT
from mpi4torch_tpu_torch.parallel import zero as PZ
from mpi4torch_tpu_torch.runtime import CommError
from mpi4torch_tpu_torch.utils import optim
from mpi4torch_tpu_torch.utils.tree import (tree_leaves, tree_map,
                                            value_and_grad)

STEPS = 5
OPTS = {
    "sgd": (lambda: optim.sgd(1e-2), lambda: optax.sgd(1e-2)),
    "sgd_momentum": (lambda: optim.sgd(1e-2, momentum=0.9),
                     lambda: optax.sgd(1e-2, momentum=0.9)),
    "adam": (lambda: optim.adam(1e-1), lambda: optax.adam(1e-1)),
}


def _params(dtype):
    """A tree whose leaf sizes (5, 15, 1) do not divide 2, 3 or 4."""
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal(5).astype(dtype),
            "m": rng.standard_normal((3, 5)).astype(dtype),
            "s": np.asarray(rng.standard_normal(), dtype)}


def _grads(n, dtype):
    """Per-rank, per-step local gradients made from a seed."""
    rng = np.random.default_rng(1)
    p = _params(dtype)
    return [[{k: rng.standard_normal(np.shape(v)).astype(dtype)
              for k, v in p.items()} for _ in range(STEPS)]
            for _ in range(n)]


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _replicated(comm, opt, params, grads_of_step):
    """The port's replicated-DP trajectory: mean gradient by Allreduce,
    the optimizer on the full parameters."""
    state = opt.init(params)
    for g in grads_of_step:
        g = comm.Allreduce_tree(g, P.MPI_SUM, mean=True)
        upd, state = opt.update(g, state, params)
        params = tree_map(torch.add, params, upd)
    return params


def _same(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(tree_leaves(a), tree_leaves(b), strict=True))


@pytest.mark.parametrize("dtype", ["f4", "f8"])
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_zero1_bitwise_vs_replicated(name, n, dtype):
    grads = _grads(n, dtype)

    def body(r):
        c = P.COMM_WORLD
        opt = OPTS[name][0]()
        params = _t(_params(dtype))
        ref = _replicated(c, opt, params, [_t(g) for g in grads[r]])
        state = PZ.zero_init(c, opt, params)
        for g in grads[r]:
            params, state = PZ.zero_step(c, opt, params, _t(g), state)
        return _same(params, ref)

    assert all(P.run_ranks(body, n, device="cpu"))


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_zero3_bitwise_vs_replicated(name, n):
    # loss(p) = sum(p * a_r + p^2 / 2): the local gradient a_r + p is
    # computed the same way on both paths.
    coefs = _grads(n, "f4")

    def loss(p, a):
        return sum(torch.sum(p[k] * a[k] + p[k] * p[k] / 2) for k in p)

    def body(r):
        c = P.COMM_WORLD
        opt = OPTS[name][0]()
        template = _t(_params("f4"))
        params, state = template, opt.init(template)
        for a in coefs[r]:
            _, g = value_and_grad(lambda p: loss(p, _t(a)), params)
            g = c.Allreduce_tree(g, P.MPI_SUM, mean=True)
            upd, state = opt.update(g, state, params)
            params = tree_map(torch.add, params, upd)
        shards, zstate = PZ.zero3_init(c, opt, template)
        for a in coefs[r]:
            _, shards, zstate = PZ.zero3_step(
                c, opt, shards, template, lambda p: loss(p, _t(a)), zstate)
        return _same(PZ.zero3_params(c, shards, template), params)

    assert all(P.run_ranks(body, n, device="cpu"))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_zero_steps_vs_jax_optax(name, n):
    grads = _grads(n, "f4")
    coefs = _grads(n, "f4")

    def jbody(r):
        c = mpi.COMM_WORLD
        opt = OPTS[name][1]()
        params = jax.tree.map(jnp.asarray, _params("f4"))
        state = JZ.zero_init(c, opt, params)
        for g in grads[r]:
            params, state = JZ.zero_step(c, opt, params,
                                         jax.tree.map(jnp.asarray, g),
                                         state)
        template = jax.tree.map(jnp.asarray, _params("f4"))
        shards, zs = JZ.zero3_init(c, opt, template)
        for a in coefs[r]:
            aa = jax.tree.map(jnp.asarray, a)
            _, shards, zs = JZ.zero3_step(
                c, opt, shards, template,
                lambda p: sum(jnp.sum(p[k] * aa[k] + p[k] * p[k] / 2)
                              for k in p), zs)
        return params, JZ.zero3_params(c, shards, template)

    def pbody(r):
        c = P.COMM_WORLD
        opt = OPTS[name][0]()
        params = _t(_params("f4"))
        state = PZ.zero_init(c, opt, params)
        for g in grads[r]:
            params, state = PZ.zero_step(c, opt, params, _t(g), state)
        template = _t(_params("f4"))
        shards, zs = PZ.zero3_init(c, opt, template)
        for a in coefs[r]:
            aa = _t(a)
            _, shards, zs = PZ.zero3_step(
                c, opt, shards, template,
                lambda p: sum(torch.sum(p[k] * aa[k] + p[k] * p[k] / 2)
                              for k in p), zs)
        return params, PZ.zero3_params(c, shards, template)

    want = mpi.run_ranks(jbody, n)
    got = P.run_ranks(pbody, n, device="cpu")
    for g, w in zip(got, want):
        pl = [x.numpy() for x in tree_leaves(g)]
        jl = [np.asarray(x) for x in jax.tree.leaves(w)]
        for a, b in zip(pl, jl, strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape
            if name == "sgd":
                assert np.array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


def test_optimizers_match_optax_update_by_update():
    rng = np.random.default_rng(4)
    p = {"a": rng.standard_normal(7).astype(np.float32),
         "b": rng.standard_normal((2, 3))}
    gs = [{k: rng.standard_normal(np.shape(v)).astype(v.dtype)
           for k, v in p.items()} for _ in range(STEPS)]
    for name, (mine, theirs) in OPTS.items():
        po, jo = mine(), theirs()
        ps, js = po.init(_t(p)), jo.init(jax.tree.map(jnp.asarray, p))
        for g in gs:
            pu, ps = po.update(_t(g), ps, _t(p))
            ju, js = jo.update(jax.tree.map(jnp.asarray, g), js)
            for a, b in zip(tree_leaves(pu), jax.tree.leaves(ju),
                            strict=True):
                assert a.numpy().dtype == np.asarray(b).dtype
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=0, err_msg=name)
    state = optim.adam(1e-3).init(_t(p))
    assert state.count == 0
    assert [x.dtype for x in tree_leaves(state.mu)] == \
        [torch.float32, torch.float64]
    assert optim.sgd(0.1).init(_t(p)) is None


def test_state_and_parameters_are_sharded_with_zero_padding():
    def body(r):
        c = P.COMM_WORLD
        opt = optim.adam(1e-1)
        p = {"w": torch.zeros(4 * 6), "m": torch.ones(3, 5)}
        shards, state = PZ.zero3_init(c, opt, p)
        assert tuple(shards["w"].shape) == (6,)
        assert tuple(shards["m"].shape) == (4,)          # ceil(15 / 4)
        assert tuple(state.mu["w"].shape) == (6,)
        assert tuple(state.nu["m"].shape) == (4,)
        # Padding slots hold zeros; after a step their state stays zero.
        g = {"w": torch.ones(24), "m": torch.ones(3, 5)}
        new_p, st = PZ.zero_step(c, opt, p, g, PZ.zero_init(c, opt, p))
        if r == 3:
            assert shards["m"].tolist() == [1.0, 1.0, 1.0, 0.0]
            assert st.mu["m"][3] == 0 and st.nu["m"][3] == 0
        assert tuple(new_p["m"].shape) == (3, 5)
        return True

    assert all(P.run_ranks(body, 4, device="cpu"))


def test_overlap_and_clipping_keep_the_bits():
    n = 3
    grads = _grads(n, "f8")
    max_norm = 0.5

    def body(r):
        c = P.COMM_WORLD
        opt = optim.adam(1e-1)

        def clip(gs):
            norm = PZ.shard_global_norm(c, gs)
            scale = max_norm / torch.maximum(norm, torch.tensor(max_norm))
            return tree_map(lambda g: g * scale, gs)

        out = []
        for kw in (dict(), dict(overlap=True), dict(overlap=3)):
            params = _t(_params("f8"))
            state = PZ.zero_init(c, opt, params)
            for g in grads[r]:
                params, state = PZ.zero_step(c, opt, params, _t(g), state,
                                             grad_transform=clip, **kw)
            out.append(params)
        # The replicated oracle clips by the full-gradient norm.
        params, state = _t(_params("f8")), opt.init(_t(_params("f8")))
        for g in grads[r]:
            g = c.Allreduce_tree(_t(g), P.MPI_SUM, mean=True)
            norm = torch.sqrt(sum(torch.sum(v * v) for v in tree_leaves(g)))
            g = tree_map(lambda v: v * (max_norm / torch.maximum(
                norm, torch.tensor(max_norm))), g)
            upd, state = opt.update(g, state, params)
            params = tree_map(torch.add, params, upd)
        return out, params

    for out, ref in P.run_ranks(body, n, device="cpu"):
        assert _same(out[0], out[1]) and _same(out[0], out[2])
        for a, b in zip(tree_leaves(out[0]), tree_leaves(ref)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)


def test_shard_global_norm_equals_full_norm_and_handoff_raises():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal(13), "b": rng.standard_normal((3, 5))}
    want = np.sqrt(sum(np.sum(v * v) for v in tree.values()))

    def body(r):
        c = P.COMM_WORLD
        norm = PZ.shard_global_norm(c, PZ.zero3_shard_params(c, _t(tree)))
        # The handoff raises on a TP spec that is not a Layout.
        with pytest.raises(CommError, match="Layout"):
            PZ.zero3_to_tp(c, None, None, None)
        return float(norm)

    for got in P.run_ranks(body, 4, device="cpu"):
        np.testing.assert_allclose(got, want, rtol=1e-14)


# ------------------------------------------------- transformer steps

CFG = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
           max_seq=16)
B, S, DP = 4, 16, 2


@pytest.fixture(scope="module")
def model():
    jcfg, pcfg = JT.TransformerConfig(**CFG), PT.TransformerConfig(**CFG)
    jparams = JT.init_transformer(jax.random.PRNGKey(0), jcfg,
                                  dtype=jnp.float64)
    tokens = np.random.default_rng(1).integers(0, CFG["vocab"], (B, S))
    return jcfg, jparams, pcfg, tokens


def test_zero_train_steps_vs_replicated_and_jax(model):
    jcfg, jparams, pcfg, tokens = model
    np_params = jax.tree.map(np.asarray, jparams)
    rows = B // DP

    def pbody(r):
        c = P.COMM_WORLD
        local = torch.from_numpy(tokens[r * rows:(r + 1) * rows])
        opt = optim.adam(1e-2)
        params = PT.params_from_jax(np_params, "cpu")
        ref, rstate = params, opt.init(params)
        for _ in range(2):
            _, g = value_and_grad(lambda p: PT.lm_loss(pcfg, p, local), ref)
            g = c.Allreduce_tree(g, P.MPI_SUM, mean=True)
            upd, rstate = opt.update(g, rstate, ref)
            ref = tree_map(torch.add, ref, upd)
        z1, state = params, PZ.zero_init(c, opt, params)
        for _ in range(2):
            loss1, z1, state = PT.zero_train_step(pcfg, z1, local, opt,
                                                  state, c)
        shards, state3 = PZ.zero3_init(c, opt, params)
        for _ in range(2):
            loss3, shards, state3 = PT.zero3_train_step(
                pcfg, shards, params, local, opt, state3, c)
        z3 = PZ.zero3_params(c, shards, params)
        return _same(z1, ref), _same(z3, ref), z1, z3, float(loss1), \
            float(loss3)

    def jbody(r):
        c = mpi.COMM_WORLD
        local = jnp.asarray(tokens[r * rows:(r + 1) * rows])
        opt = optax.adam(1e-2)
        z1, state = jparams, JZ.zero_init(c, opt, jparams)
        for _ in range(2):
            loss1, z1, state = JT.zero_train_step(jcfg, z1, local, opt,
                                                  state, c)
        shards, state3 = JZ.zero3_init(c, opt, jparams)
        for _ in range(2):
            loss3, shards, state3 = JT.zero3_train_step(
                jcfg, shards, jparams, local, opt, state3, c)
        return z1, JZ.zero3_params(c, shards, jparams), float(loss1), \
            float(loss3)

    got = P.run_ranks(pbody, DP, device="cpu")
    want = mpi.run_ranks(jbody, DP)
    for (same1, same3, z1, z3, l1, l3), (j1, j3, m1, m3) in zip(got, want):
        assert same1 and same3
        for mine, theirs in ((z1, j1), (z3, j3)):
            for a, b in zip(tree_leaves(mine), jax.tree.leaves(theirs),
                            strict=True):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=1e-10, rtol=0)
        np.testing.assert_allclose([l1, l3], [m1, m3], atol=1e-10, rtol=0)
    assert _same(got[0][2], got[1][2]) and _same(got[0][3], got[1][3])
