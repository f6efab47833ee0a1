"""The flagship's steps on a 2-D (and 3-D) mesh under ``run_spmd(mesh=)``.

Ports JAX ``tests/test_transformer.py``'s mesh cases at their bounds
(float64: loss rtol 1e-12 / atol 1e-14, parameters rtol 1e-9 / atol
1e-11): ``train_step``, ``zero_train_step`` and ``zero3_train_step`` of
the port's transformer run on every position of a ``dp x sp`` (or
``dp x ep``, or ``dp x sp x ep``) mesh at once, each axis its own
communicator from ``comm_from_mesh(mesh, axis)``, and every rank takes
its token slice by the axes' symbolic ranks (``narrow`` with the
materialized rank, the counterpart of JAX's ``dynamic_slice``; the
zigzag layout takes rows by the dp rank, then ``zigzag_slice`` over sp).

The oracles are JAX's single-process ``train_step`` on the same weights
and tokens (and the port's one-rank step), and for ZeRO the replicated
optax Adam trajectory over the dp shards' mean loss: cheap, no JAX mesh
(JAX's own mesh tests are ``slow``).  Every mesh position ends with
bitwise the same loss and parameters.  The configuration is the tiny
``CFG`` of the JAX tests; each JAX oracle is computed once per
configuration.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mpi4torch_tpu_torch as P
from mpi4torch_tpu.models import transformer as JT
from mpi4torch_tpu_torch.models import transformer as PT
from mpi4torch_tpu_torch.parallel import zigzag_slice
from mpi4torch_tpu_torch.parallel.zero import (zero3_init, zero3_params,
                                               zero_init)
from mpi4torch_tpu_torch.utils import optim
from mpi4torch_tpu_torch.utils.tree import tree_leaves

BASE = dict(vocab=31, d_model=16, n_heads=8, n_layers=2, d_ff=32,
            max_seq=16)
B, S = 8, 16
CONFIGS = {
    "base": BASE,
    "gqa": dict(BASE, n_kv_heads=2),
    "window": dict(BASE, attn_window=5),
    "rope": dict(BASE, rope=True),
    "rope_gqa": dict(BASE, rope=True, n_kv_heads=2),
    "llama": dict(BASE, norm="rmsnorm", ffn="swiglu", rope=True,
                  n_kv_heads=2),
    "moe": dict(BASE, n_experts=4, capacity=B * S, aux_coef=0.0),
    "moe_cap": dict(BASE, n_experts=4, capacity=32, aux_coef=0.0),
}
LOSS_TOL = dict(rtol=1e-12, atol=1e-14)
PARAM_TOL = dict(rtol=1e-9, atol=1e-11)
ADAM_LR = 1e-2


class _Oracles:
    """JAX params, tokens and oracles, computed once per configuration."""

    def __init__(self):
        self._cache = {}

    def _memo(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    def setup(self, name):
        def make():
            cfg = JT.TransformerConfig(**CONFIGS[name])
            params = JT.init_transformer(jax.random.PRNGKey(0), cfg,
                                         dtype=jnp.float64)
            tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
            return cfg, params, tokens
        return self._memo(("setup", name), make)

    def train_step(self, name):
        def make():
            cfg, params, tokens = self.setup(name)
            loss, new = JT.train_step(cfg, params, jnp.asarray(tokens))
            return float(loss), [np.asarray(x) for x in jax.tree.leaves(new)]
        return self._memo(("train", name), make)

    def adam(self, name, shards, steps):
        """The replicated optax Adam trajectory on the mean loss over
        ``shards`` equal batch shards."""
        def make():
            cfg, params, tokens = self.setup(name)
            opt = optax.adam(ADAM_LR)
            bl = B // shards
            tok = jnp.asarray(tokens)

            def mean_loss(p):
                return sum(JT.lm_loss(cfg, p, tok[r * bl:(r + 1) * bl])
                           for r in range(shards)) / shards

            p, st = params, opt.init(params)
            grad = jax.jit(jax.value_and_grad(mean_loss))
            for _ in range(steps):
                _, g = grad(p)
                u, st = opt.update(g, st, p)
                p = jax.tree.map(jnp.add, p, u)
            return [np.asarray(x) for x in jax.tree.leaves(p)]
        return self._memo(("adam", name, shards, steps), make)


@pytest.fixture(scope="module")
def oracles():
    return _Oracles()


def _port(oracles, name):
    jcfg, jparams, tokens = oracles.setup(name)
    pcfg = PT.TransformerConfig(**CONFIGS[name])
    pparams = PT.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return pcfg, pparams, torch.from_numpy(tokens)


def _mesh(**axes):
    return P.device_mesh(axes, devices=["cpu"] * int(np.prod(
        list(axes.values()))))


def _positions_identical(loss, params):
    """Every mesh position's loss and parameters are bitwise alike."""
    n = loss.shape[0]
    assert all(torch.equal(loss[i], loss[0]) for i in range(n))
    for leaf in tree_leaves(params):
        assert all(torch.equal(leaf[i], leaf[0]) for i in range(n))


def _check_params(got, want_leaves):
    got = [t[0].numpy() for t in tree_leaves(got)]
    assert len(got) == len(want_leaves)
    for a, b in zip(got, want_leaves):
        np.testing.assert_allclose(a, b, **PARAM_TOL)


def _mesh_step(cfg, params, tokens, dp, sp, attn, ep=1, layout="block"):
    """The SGD ``train_step`` on every position of a dp x sp (x ep) mesh;
    returns the stacked ``(loss, new_params)``."""
    axes = {"dp": dp, "sp": sp}
    if ep > 1:
        axes["ep"] = ep
    mesh = _mesh(**axes)
    cd = P.comm_from_mesh(mesh, "dp")
    cs = P.comm_from_mesh(mesh, "sp")
    ce = P.comm_from_mesh(mesh, "ep") if ep > 1 else None
    bl, sl = B // (dp * ep), S // sp

    def body(p, toks):
        r_b = cd.rank * ep + ce.rank if ce is not None else cd.rank
        rows = toks.narrow(0, r_b * bl, bl)
        if layout == "zigzag":
            local = zigzag_slice(cs, rows, axis=1)
        else:
            local = rows.narrow(1, cs.rank * sl, sl)
        return PT.train_step(cfg, p, local, comm_sp=cs, comm_dp=cd,
                             comm_ep=ce, attn=attn)

    return P.run_spmd(body, mesh=mesh, axis_name="dp")(params, tokens)


def _check_train(oracles, name, loss, new, pcfg, pparams, tokens):
    _positions_identical(loss, new)
    ref_loss, ref_leaves = oracles.train_step(name)
    np.testing.assert_allclose(loss[0].item(), ref_loss, **LOSS_TOL)
    _check_params(new, ref_leaves)
    # And the port's own one-rank step.
    one_loss, one = PT.train_step(pcfg, pparams, tokens)
    np.testing.assert_allclose(loss[0].item(), one_loss.item(), **LOSS_TOL)
    _check_params(new, [t.numpy() for t in tree_leaves(one)])


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
@pytest.mark.parametrize("dp,sp", [(2, 4), (4, 2), (1, 8), (8, 1)])
def test_2d_mesh_matches_single_process(oracles, attn, dp, sp):
    pcfg, pparams, tokens = _port(oracles, "base")
    loss, new = _mesh_step(pcfg, pparams, tokens, dp, sp, attn)
    _check_train(oracles, "base", loss, new, pcfg, pparams, tokens)


class TestZigzagFlagship:
    @pytest.mark.parametrize("name,dp,sp", [
        ("base", 2, 4), ("base", 1, 8), ("rope", 2, 4), ("gqa", 2, 4)])
    def test_2d_mesh_matches_single_process(self, oracles, name, dp, sp):
        pcfg, pparams, tokens = _port(oracles, name)
        loss, new = _mesh_step(pcfg, pparams, tokens, dp, sp, "zigzag",
                               layout="zigzag")
        _check_train(oracles, name, loss, new, pcfg, pparams, tokens)

    def test_window_rejected(self, oracles):
        pcfg, pparams, tokens = _port(oracles, "window")
        with pytest.raises(ValueError, match="does not compose"):
            _mesh_step(pcfg, pparams, tokens, 1, 8, "zigzag",
                       layout="zigzag")


@pytest.mark.parametrize("name,attn,dp,sp", [
    ("gqa", "ring", 2, 4), ("gqa", "ulysses", 4, 2),
    ("window", "ring", 1, 8), ("window", "ulysses", 2, 2),
    ("rope_gqa", "ring", 2, 4), ("rope_gqa", "ulysses", 4, 2),
    ("llama", "ring", 2, 4), ("llama", "ulysses", 4, 2)])
def test_variants_2d_mesh_match_single_process(oracles, name, attn, dp,
                                               sp):
    pcfg, pparams, tokens = _port(oracles, name)
    if name == "window":
        # The window really changes the model.
        base_loss, _ = oracles.train_step("base")
        assert abs(oracles.train_step("window")[0] - base_loss) > 1e-9
    loss, new = _mesh_step(pcfg, pparams, tokens, dp, sp, attn)
    _check_train(oracles, name, loss, new, pcfg, pparams, tokens)


@pytest.mark.parametrize("moe", [False, True])
def test_remat_preserves_values_and_grads_on_mesh(oracles, moe):
    # With moe=True the expert-dispatch Alltoall is re-executed too, on a
    # 3-D dp x sp x ep mesh.
    name, (dp, sp, ep) = (("moe_cap", (2, 2, 2)) if moe
                          else ("base", (2, 4, 1)))
    pcfg, pparams, tokens = _port(oracles, name)
    loss0, p0 = _mesh_step(pcfg, pparams, tokens, dp, sp, "ring", ep)
    rcfg = dataclasses.replace(pcfg, remat=True)
    loss1, p1 = _mesh_step(rcfg, pparams, tokens, dp, sp, "ring", ep)
    _positions_identical(loss0, p0)
    _positions_identical(loss1, p1)
    np.testing.assert_allclose(loss1[0].item(), loss0[0].item(),
                               rtol=1e-12)
    for a, b in zip(tree_leaves(p1), tree_leaves(p0)):
        np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=1e-10,
                                   atol=1e-12)
    if not moe:
        _check_train(oracles, name, loss0, p0, pcfg, pparams, tokens)


def _zero_run(pcfg, pparams, tokens, dp, sp, steps, stage, ep=1):
    axes = {"dp": dp, "sp": sp} if ep == 1 else {"dp": dp, "ep": ep}
    mesh = _mesh(**axes)
    cd = P.comm_from_mesh(mesh, "dp")
    cs = P.comm_from_mesh(mesh, "sp") if ep == 1 else None
    ce = P.comm_from_mesh(mesh, "ep") if ep > 1 else None
    bl, sl = B // (dp * ep), S // sp
    opt = optim.adam(ADAM_LR)

    def local_tokens(toks):
        if ce is not None:
            return toks.narrow(0, (cd.rank * ep + ce.rank) * bl, bl)
        rows = toks.narrow(0, cd.rank * bl, bl)
        return rows.narrow(1, cs.rank * sl, sl)

    def zero1(p, toks):
        state = zero_init(cd, opt, p)
        for _ in range(steps):
            loss, p, state = PT.zero_train_step(
                pcfg, p, local_tokens(toks), opt, state, cd, comm_sp=cs,
                attn="ring", comm_ep=ce)
        return loss, p

    def zero3(p, toks):
        shards, state = zero3_init(cd, opt, p)
        for _ in range(steps):
            loss, shards, state = PT.zero3_train_step(
                pcfg, shards, p, local_tokens(toks), opt, state, cd,
                comm_sp=cs, attn="ring")
        return loss, zero3_params(cd, shards, p)

    body = zero1 if stage == 1 else zero3
    return P.run_spmd(body, mesh=mesh, axis_name="dp")(pparams, tokens)


class TestZeroTrainStep:
    @pytest.mark.parametrize("dp,sp", [(4, 1), (2, 2)])
    def test_matches_replicated_adam(self, oracles, dp, sp):
        pcfg, pparams, tokens = _port(oracles, "base")
        loss, new = _zero_run(pcfg, pparams, tokens, dp, sp, 3, stage=1)
        _positions_identical(loss, new)
        _check_params(new, oracles.adam("base", dp, 3))

    def test_moe_ep_axis_matches_replicated(self, oracles):
        # ep composes as a data axis: ZeRO over dp with the experts
        # sharded over ep matches replicated Adam on the dense-expert
        # model over all dp x ep data shards.
        pcfg, pparams, tokens = _port(oracles, "moe")
        loss, new = _zero_run(pcfg, pparams, tokens, 2, 1, 2, stage=1,
                              ep=2)
        _positions_identical(loss, new)
        _check_params(new, oracles.adam("moe", 4, 2))


class TestZero3TrainStep:
    @pytest.mark.parametrize("dp,sp", [(4, 1), (2, 2)])
    def test_matches_replicated_adam(self, oracles, dp, sp):
        pcfg, pparams, tokens = _port(oracles, "base")
        loss, new = _zero_run(pcfg, pparams, tokens, dp, sp, 3, stage=3)
        _positions_identical(loss, new)
        _check_params(new, oracles.adam("base", dp, 3))
