"""The port's Vision Transformer against the JAX package's.

The same weights (``params_from_jax``) and the same numpy images at the
JAX tests' small size: ``patchify`` bitwise; logits, the loss and every
gradient within 1e-10 in f64 and 1e-5 norm-relative in f32; the
patch-parallel forward (``forward_patches(comm_sp=)``, non-causal ring
attention over 2 and 4 rank threads) and its gradients against one
device and against the JAX package's patch-parallel run; the DP step
against JAX's Mode B and the one-process global batch, ranks bitwise
identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu.models import vit as JV
from mpi4torch_tpu_torch.models import vit as PV
from mpi4torch_tpu_torch.utils.tree import (tree_leaves, tree_unflatten,
                                            value_and_grad)

KW = dict(image_hw=8, patch=4, d_model=16, n_heads=2, n_layers=2, d_ff=32,
          num_classes=5)
TOL = {np.float64: 1e-10, np.float32: 1e-5}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def models(dtype, seed=2, **over):
    kw = {**KW, **over}
    jcfg, pcfg = JV.ViTConfig(**kw), PV.ViTConfig(**kw)
    params = JV.init_vit(jax.random.PRNGKey(seed), jcfg,
                         dtype=jnp.dtype(dtype))
    tp = PV.params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    return jcfg, pcfg, params, tp


def images_labels(n, cfg, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, cfg.image_hw, cfg.image_hw,
                             cfg.channels)).astype(dtype)
    return x, rng.integers(0, cfg.num_classes, n).astype(np.int32)


def test_patchify_bitwise_and_config_validation():
    jcfg, pcfg, _, _ = models(np.float64, patch=2)
    x, _ = images_labels(3, jcfg, np.float64)
    want = JV.patchify(jcfg, jnp.asarray(x))
    got = PV.patchify(pcfg, torch.from_numpy(x))
    assert got.shape == (3, 16, 12) and np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="divisible"):
        PV.ViTConfig(**{**KW, "patch": 3})
    with pytest.raises(ValueError, match="divisible"):
        PV.ViTConfig(**{**KW, "n_heads": 3})
    assert PV.ViTConfig(**KW).n_patches == 4
    own = PV.init_vit(0, pcfg, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(own)] == \
        [a.shape for a in jax.tree.leaves(JV.init_vit(
            jax.random.PRNGKey(0), jcfg))]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_forward_loss_and_grads_match_jax(dtype):
    jcfg, pcfg, params, tp = models(dtype)
    x, y = images_labels(4, jcfg, dtype, seed=1)
    want = JV.forward(jcfg, params, jnp.asarray(x))
    got = PV.forward(pcfg, tp, torch.from_numpy(x))
    assert got.shape == (4, 5) and rel(got.numpy(), want) <= TOL[dtype]
    wl, wg = jax.value_and_grad(lambda p: JV.local_loss(
        jcfg, p, (jnp.asarray(x), jnp.asarray(y))))(params)
    gl, gg = value_and_grad(lambda p: PV.local_loss(
        pcfg, p, (torch.from_numpy(x), torch.from_numpy(y))), tp)
    assert rel(gl.numpy(), wl) <= TOL[dtype]
    for a, b in zip(jax.tree.leaves(wg), tree_leaves(gg)):
        assert rel(b.numpy(), a) <= TOL[dtype]


@pytest.mark.parametrize("n", [2, 4])
def test_patch_parallel_forward_and_grads_match_one_device_and_jax(n):
    jcfg, pcfg, params, tp = models(np.float64, seed=4, patch=2)
    x, _ = images_labels(2, jcfg, np.float64, seed=9)
    patches = PV.patchify(pcfg, torch.from_numpy(x))
    sl = pcfg.n_patches // n
    one = PV.forward(pcfg, tp, torch.from_numpy(x))
    _, one_g = value_and_grad(
        lambda p: (PV.forward(pcfg, p, torch.from_numpy(x)) ** 2).sum(), tp)

    def torch_body(r):
        local = patches[:, r * sl:(r + 1) * sl]
        out = PV.forward_patches(pcfg, tp, local, comm_sp=P.COMM_WORLD)
        # Every rank seeds its own copy of the replicated loss, so the
        # sharded gradient is n times the one-device one after the
        # parameter Allreduce.
        _, g = value_and_grad(lambda p: (PV.forward_patches(
            pcfg, p, local, comm_sp=P.COMM_WORLD) ** 2).sum(), tp)
        g = [P.COMM_WORLD.Allreduce(t, P.MPI_SUM) / n
             for t in tree_leaves(g)]
        return out.numpy(), g

    def jax_body():
        r = mpi.COMM_WORLD.rank
        local = jnp.asarray(patches.numpy())[:, r * sl:(r + 1) * sl]
        return np.asarray(JV.forward_patches(jcfg, params, local,
                                             comm_sp=mpi.COMM_WORLD))

    got = P.run_ranks(torch_body, n, device="cpu")
    want = mpi.run_ranks(jax_body, n)
    for r in range(n):
        assert rel(got[r][0], one.numpy()) <= 1e-10
        assert rel(got[r][0], want[r]) <= 1e-10
        for a, b in zip(got[r][1], tree_leaves(one_g)):
            assert rel(a.numpy(), b.numpy()) <= 1e-10


@pytest.mark.parametrize("n", [2, 4])
def test_dp_grad_train_step_matches_jax_and_global_batch(n):
    jcfg, pcfg, params, tp = models(np.float64)
    x, y = images_labels(2 * n, jcfg, np.float64, seed=5)
    bl = 2

    def jax_body():
        r = mpi.COMM_WORLD.rank
        p = params
        batch = (jnp.asarray(x[r * bl:(r + 1) * bl]),
                 jnp.asarray(y[r * bl:(r + 1) * bl]))
        for _ in range(2):
            loss, p = JV.dp_grad_train_step(mpi.COMM_WORLD, jcfg, p, batch)
        return np.asarray(loss), jax.tree.map(np.asarray, p)

    def torch_body(r):
        p = tp
        batch = (torch.from_numpy(x[r * bl:(r + 1) * bl]),
                 torch.from_numpy(y[r * bl:(r + 1) * bl]))
        for _ in range(2):
            loss, p = PV.dp_grad_train_step(P.COMM_WORLD, pcfg, p, batch)
        return loss.numpy(), p

    want = mpi.run_ranks(jax_body, n)
    got = P.run_ranks(torch_body, n, device="cpu")
    ref = tp
    for _ in range(2):
        _, g = value_and_grad(lambda p: PV.local_loss(
            pcfg, p, (torch.from_numpy(x), torch.from_numpy(y))), ref)
        ref = tree_unflatten(ref, [a - 0.1 * b for a, b in zip(
            tree_leaves(ref), tree_leaves(g))])
    for r in range(n):
        assert rel(got[r][0], want[r][0]) <= 1e-10
        for a, b, c, r0 in zip(jax.tree.leaves(want[r][1]),
                               tree_leaves(got[r][1]), tree_leaves(ref),
                               tree_leaves(got[0][1])):
            assert rel(b.numpy(), a) <= 1e-10
            assert rel(b.numpy(), c.numpy()) <= 1e-9
            assert torch.equal(b, r0)
