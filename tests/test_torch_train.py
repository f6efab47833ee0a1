"""The port's training path against the JAX package, on the same weights.

A small configuration is initialised with ``jax.random`` and carried
across with ``params_from_jax``; both packages run in float64 on the
CPU.  The training forward, ``lm_loss`` (dense and chunked vocabulary)
and their gradients agree to 1e-10; a single-rank ``train_step`` gives
the same updated parameters to 1e-10; data-parallel ``train_step`` on
(2,) and (4,) rank-thread worlds agrees with the JAX package's Mode B
(its rank-thread runtime) to 1e-12, every rank ends bitwise identical,
and the result agrees with the single-process full-batch step to the
JAX package's own bound (rtol 1e-9).  ``Allreduce_tree`` and its
gradient are bitwise equal to the JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu.models import transformer as JT
from mpi4torch_tpu.parallel import dp as jdp
from mpi4torch_tpu_torch.models import transformer as PT
from mpi4torch_tpu_torch.parallel import dp as pdp
from mpi4torch_tpu_torch.utils.tree import tree_leaves, value_and_grad

BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=16)
CONFIGS = {
    "layernorm_gelu_mha": BASE,
    "rmsnorm_swiglu_rope_gqa_window": dict(
        BASE, norm="rmsnorm", ffn="swiglu", rope=True, n_kv_heads=2,
        attn_window=5),
}
B, S = 4, 16


def _pair(name, seed=0):
    kw = CONFIGS[name]
    jcfg, pcfg = JT.TransformerConfig(**kw), PT.TransformerConfig(**kw)
    jparams = JT.init_transformer(jax.random.PRNGKey(seed), jcfg,
                                  dtype=jnp.float64)
    pparams = PT.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, pcfg, pparams


def _tokens(seed=1, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


def _close(got, want, tol):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                                   rtol=0)


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_logits_match(name):
    jcfg, jparams, pcfg, pparams = _pair(name)
    tok = _tokens()
    want = JT.forward(jcfg, jparams, jnp.asarray(tok))
    got = PT.forward(pcfg, pparams, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10,
                               rtol=0)
    hid = PT.forward(pcfg, pparams, torch.from_numpy(tok),
                     return_hidden=True)
    assert hid.shape == (B, S, pcfg.d_model)


@pytest.mark.parametrize("vocab_chunk", [0, 16])
@pytest.mark.parametrize("name", CONFIGS)
def test_lm_loss_and_grads_match(name, vocab_chunk):
    jcfg, jparams, pcfg, pparams = _pair(name)
    tok = _tokens()
    jloss, jgrads = jax.value_and_grad(
        lambda p: JT.lm_loss(jcfg, p, jnp.asarray(tok),
                             vocab_chunk=vocab_chunk))(jparams)
    ploss, pgrads = value_and_grad(
        lambda p: PT.lm_loss(pcfg, p, torch.from_numpy(tok),
                             vocab_chunk=vocab_chunk), pparams)
    assert abs(ploss.item() - float(jloss)) <= 1e-10
    _close(PT.params_to_numpy(pgrads), jgrads, 1e-10)


def test_chunked_loss_equals_dense_loss():
    _, _, pcfg, pparams = _pair("layernorm_gelu_mha")
    tok = torch.from_numpy(_tokens())
    dense = PT.lm_loss(pcfg, pparams, tok)
    for chunk in (8, 32, 64):
        assert abs(PT.lm_loss(pcfg, pparams, tok, vocab_chunk=chunk).item()
                   - dense.item()) <= 1e-12


@pytest.mark.parametrize("name", CONFIGS)
def test_remat_grads_equal_non_remat(name):
    _, _, pcfg, pparams = _pair(name)
    tok = torch.from_numpy(_tokens())
    loss, grads = value_and_grad(
        lambda p: PT.lm_loss(pcfg, p, tok), pparams)
    rcfg = dataclasses.replace(pcfg, remat=True)
    rloss, rgrads = value_and_grad(
        lambda p: PT.lm_loss(rcfg, p, tok), pparams)
    assert torch.equal(loss, rloss)
    for a, b in zip(tree_leaves(grads), tree_leaves(rgrads)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", CONFIGS)
def test_single_rank_train_step_matches(name):
    jcfg, jparams, pcfg, pparams = _pair(name)
    tok = _tokens()
    jloss, jnew = JT.train_step(jcfg, jparams, jnp.asarray(tok), lr=0.1)
    ploss, pnew = PT.train_step(pcfg, pparams, torch.from_numpy(tok),
                                lr=0.1)
    assert abs(ploss.item() - float(jloss)) <= 1e-10
    _close(PT.params_to_numpy(pnew), jnew, 1e-10)


@pytest.mark.parametrize("n", [2, 4])
def test_dp_train_step_matches_jax_mode_b(n):
    jcfg, jparams, pcfg, pparams = _pair("layernorm_gelu_mha", seed=2)
    tok = _tokens(seed=3)
    rows = B // n

    def jbody(r):
        loss, new = JT.train_step(
            jcfg, jparams, jnp.asarray(tok[r * rows:(r + 1) * rows]),
            comm_dp=mpi.COMM_WORLD, lr=0.1)
        return float(loss), jax.tree.map(np.asarray, new)

    def pbody(r):
        loss, new = PT.train_step(
            pcfg, pparams, torch.from_numpy(tok[r * rows:(r + 1) * rows]),
            comm_dp=P.COMM_WORLD, lr=0.1)
        return loss.item(), PT.params_to_numpy(new)

    ref = mpi.run_ranks(jbody, n)
    got = P.run_ranks(pbody, n, device="cpu")
    for r in range(n):
        assert abs(got[r][0] - ref[r][0]) <= 1e-12
        _close(got[r][1], ref[r][1], 1e-12)
        # Every rank ends bitwise identical.
        assert got[r][0] == got[0][0]
        for a, b in zip(tree_leaves(got[r][1]), tree_leaves(got[0][1])):
            assert np.array_equal(a, b)
    # The DP step is the full-batch step, up to the order of the sums.
    full_loss, full = PT.train_step(pcfg, pparams, torch.from_numpy(tok),
                                    lr=0.1)
    np.testing.assert_allclose(got[0][0], full_loss.item(), rtol=1e-12)
    for a, b in zip(tree_leaves(got[0][1]),
                    tree_leaves(PT.params_to_numpy(full))):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-11)


def _tree_inputs(r):
    rng = np.random.default_rng(10 + r)
    return {"w": rng.standard_normal((5, 3)),
            "blocks": [rng.standard_normal(7), rng.standard_normal((2, 2))]}


def test_allreduce_tree_mean_and_grad_bitwise_vs_jax():
    def jbody(r):
        tree = jax.tree.map(jnp.asarray, _tree_inputs(r))
        wts = jax.tree.map(jnp.asarray, _tree_inputs(r + 5))

        def f(t):
            out = mpi.COMM_WORLD.Allreduce_tree(t, mpi.MPI_SUM, mean=True)
            return sum(jnp.vdot(o, w) for o, w in
                       zip(jax.tree.leaves(out), jax.tree.leaves(wts))), out

        (_, out), g = jax.value_and_grad(f, has_aux=True)(tree)
        return jax.tree.map(np.asarray, (out, g))

    def pbody(r):
        wts = _tree_inputs(r + 5)

        def f(t):
            out = P.COMM_WORLD.Allreduce_tree(t, P.MPI_SUM, mean=True)
            f.out = out
            return sum((o * torch.from_numpy(w)).sum() for o, w in
                       zip(tree_leaves(out), tree_leaves(wts)))

        tree = {"w": torch.from_numpy(_tree_inputs(r)["w"]),
                "blocks": [torch.from_numpy(x)
                           for x in _tree_inputs(r)["blocks"]]}
        _, g = value_and_grad(f, tree)
        return PT.params_to_numpy(f.out), PT.params_to_numpy(g)

    ref = mpi.run_ranks(jbody, 3)
    got = P.run_ranks(pbody, 3, device="cpu")
    for r in range(3):
        for a, b in zip(jax.tree.leaves(got[r]), jax.tree.leaves(ref[r])):
            assert np.array_equal(a, b)


def test_dp_value_and_grad_matches_jax():
    xs = [np.random.default_rng(20 + r).standard_normal(6) for r in range(3)]

    def jbody(r):
        vg = jdp.dp_value_and_grad(
            mpi.COMM_WORLD, lambda p, x: jnp.sum((p["a"] * x - 1.0) ** 2))
        loss, g = vg({"a": jnp.arange(6.0)}, jnp.asarray(xs[r]))
        return float(loss), np.asarray(g["a"])

    def pbody(r):
        vg = pdp.dp_value_and_grad(
            P.COMM_WORLD, lambda p, x: torch.sum((p["a"] * x - 1.0) ** 2))
        loss, g = vg({"a": torch.arange(6.0, dtype=torch.float64)},
                     torch.from_numpy(xs[r]))
        return loss.item(), g["a"].numpy()

    ref = mpi.run_ranks(jbody, 3)
    got = P.run_ranks(pbody, 3, device="cpu")
    for r in range(3):
        # The local losses sum six terms in each framework's own order;
        # the collectives and the gradients agree bitwise.
        np.testing.assert_allclose(got[r][0], ref[r][0], rtol=1e-15)
        assert np.array_equal(got[r][1], ref[r][1])


def test_rank_threads_run_backward_on_their_own_thread():
    before = torch._C._is_multithreading_enabled()
    flags = P.run_ranks(lambda: torch._C._is_multithreading_enabled(), 2,
                        device="cpu")
    assert flags == [False, False]
    assert torch._C._is_multithreading_enabled() == before


def test_rank_that_skips_its_backward_is_a_named_deadlock():
    # Rank 1 never runs the backward, so rank 0's backward Allreduce has
    # no partner: it ends at the world timeout, naming the missing rank.
    def body(r):
        x = torch.ones(3, dtype=torch.float64, requires_grad=True)
        y = P.COMM_WORLD.Allreduce(x, P.MPI_SUM).sum()
        if r == 0:
            torch.autograd.grad(y, x)

    with pytest.raises(P.DeadlockError) as ei:
        P.run_ranks(body, 2, timeout=0.5, device="cpu")
    assert ei.value.missing == frozenset({1})


def test_params_to_numpy_round_trips():
    _, jparams, _, pparams = _pair("layernorm_gelu_mha")
    back = PT.params_to_numpy(pparams)
    for a, b in zip(tree_leaves(back), jax.tree.leaves(jparams)):
        assert np.array_equal(a, np.asarray(b))
    bf = PT.params_to_numpy({"x": torch.ones(2, dtype=torch.bfloat16)})
    assert bf["x"].dtype == np.float32


@pytest.mark.parametrize("kw, err", [
    ({"overlap": True}, None),
    ({"compression": "q8"}, None),
    ({"algorithm": "synth:deadbeef00"}, P.CommError),
    ({"bucket_bytes": -1}, ValueError),
])
def test_allreduce_tree_unported_options_raise(kw, err):
    # overlap and compression are ported (err None): on the size-1 world
    # the fused tree returns the leaf's value; the rest still raise.
    if err is None:
        out = P.COMM_WORLD.Allreduce_tree([torch.ones(2)], P.MPI_SUM, **kw)
        assert torch.equal(out[0], torch.ones(2))
        return
    with pytest.raises(err):
        P.COMM_WORLD.Allreduce_tree([torch.ones(2)], P.MPI_SUM, **kw)


def test_allreduce_tree_mean_needs_sum():
    with pytest.raises(P.CommError, match="MPI_SUM"):
        P.COMM_WORLD.Allreduce_tree([torch.ones(2)], P.MPI_MAX, mean=True)


def test_unported_training_paths_raise():
    # Sequence parallelism and the MoE are ported
    # (tests/test_torch_transformer.py, tests/test_torch_moe.py); what
    # still raises is what the JAX package refuses too: attention that
    # cannot see across sequence shards, and the zigzag layout under a
    # sliding window.
    _, _, pcfg, pparams = _pair("layernorm_gelu_mha")
    wcfg = dataclasses.replace(pcfg, attn_window=5)
    tok = torch.from_numpy(_tokens())

    def body():
        c = P.COMM_WORLD
        local = tok[:, c.rank * (S // 2):(c.rank + 1) * (S // 2)]
        with pytest.raises(ValueError, match="cannot see across"):
            PT.train_step(pcfg, pparams, local, comm_sp=c, attn="dense")
        with pytest.raises(ValueError, match="does not compose"):
            PT.lm_loss(wcfg, pparams, local, comm_sp=c, attn="zigzag")

    P.run_ranks(body, 2, device="cpu")
    with pytest.raises(ValueError, match="unknown attention"):
        PT.forward(pcfg, pparams, tok, attn="flash")
    with pytest.raises(ValueError, match="must divide"):
        PT.lm_loss(pcfg, pparams, tok, vocab_chunk=7)
