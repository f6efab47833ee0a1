"""The port's ResNet-18 (BASELINE config 4) and MLP against the JAX
package's.

The same weights go through ``params_from_jax`` (HWIO filters carried to
OIHW) and the same numpy images through both packages, at the JAX tests'
small size (two stages of one block, widths 8 and 16, 8 x 8 images):
logits, new BN state, the loss and every gradient within 1e-10 in f64
and 1e-5 norm-relative in f32, in train and eval mode; ``SAME`` padding
against XLA's convolution for odd and even inputs and both strides; both
DP recipes on two and four rank threads against the JAX package's Mode B
within 1e-10, ranks bitwise identical, and the DP gradient against the
mean of one-device per-shard gradients (BN normalises per shard).  The
MLP: forward, loss and the DP train step against JAX within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu.models import mlp as JM
from mpi4torch_tpu.models import resnet as JR
from mpi4torch_tpu_torch.models import mlp as PM
from mpi4torch_tpu_torch.models import resnet as PR
from mpi4torch_tpu_torch.utils.tree import tree_leaves, value_and_grad

CFG_J = JR.ResNetConfig(num_classes=10, stage_sizes=(1, 1), widths=(8, 16))
CFG_P = PR.ResNetConfig(num_classes=10, stage_sizes=(1, 1), widths=(8, 16))
B, HW = 8, 8
TOL = {np.float64: 1e-10, np.float32: 1e-5}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_model(dtype):
    params, state = JR.init_resnet(jax.random.PRNGKey(0), CFG_J,
                                   dtype=jnp.dtype(dtype))
    return params, state


def torch_model(params, state):
    return PR.params_from_jax(_np_tree(params), _np_tree(state), "cpu")


def data(dtype, n=B, hw=HW, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, hw, hw, 3)).astype(dtype),
            rng.integers(0, 10, n).astype(np.int32))


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def _hwio(t):
    return t.permute(2, 3, 1, 0).numpy() if t.dim() == 4 else t.numpy()


def test_params_from_jax_carries_hwio_to_oihw():
    params, state = jax_model(np.float32)
    tp, ts = torch_model(params, state)
    assert tp["stem"]["conv"].shape == (8, 3, 3, 3)
    assert tp["stages"][1][0]["proj"].shape == (16, 8, 1, 1)
    for a, b in zip(jax.tree.leaves(params), tree_leaves(tp)):
        assert np.array_equal(np.asarray(a), _hwio(b))
    for a, b in zip(jax.tree.leaves(state), tree_leaves(ts)):
        assert np.array_equal(np.asarray(a), b.numpy())
    # the port's own init: the same tree, filters OIHW, the JAX scalings
    mine, mstate = PR.init_resnet(0, CFG_P, device="cpu")
    assert [tuple(_hwio(t).shape) for t in tree_leaves(mine)] == \
        [a.shape for a in jax.tree.leaves(params)]
    assert len(tree_leaves(mstate)) == len(jax.tree.leaves(state))


@pytest.mark.parametrize("hw", [8, 7])
@pytest.mark.parametrize("k, stride", [(3, 1), (3, 2), (1, 2)])
def test_same_padding_matches_xla(hw, k, stride):
    rng = np.random.default_rng(hw + k + stride)
    x = rng.standard_normal((2, hw, hw, 3))
    w = rng.standard_normal((k, k, 3, 4))
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = PR._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(w).permute(3, 2, 0, 1), stride)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - np.asarray(want)).max() < 1e-12


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("train", [True, False])
def test_forward_and_state_match_jax(dtype, train):
    params, state = jax_model(dtype)
    if not train:
        # non-trivial running statistics
        state = jax.tree.map(lambda s: s + 0.25, state)
    tp, ts = torch_model(params, state)
    images, _ = data(dtype)
    want, wstate = JR.forward(CFG_J, params, state, jnp.asarray(images),
                              train=train)
    got, gstate = PR.forward(CFG_P, tp, ts, torch.from_numpy(images),
                             train=train)
    assert got.dtype == torch.from_numpy(images).dtype
    assert rel(got.numpy(), want) <= TOL[dtype]
    for a, b in zip(jax.tree.leaves(wstate), tree_leaves(gstate)):
        assert rel(b.numpy(), a) <= TOL[dtype]
    if train:
        assert not np.allclose(gstate["stem"]["bn"]["mean"].numpy(), 0.0)
    else:
        assert all(a is b for a, b in zip(tree_leaves(ts),
                                          tree_leaves(gstate)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_loss_and_grads_match_jax(dtype):
    params, state = jax_model(dtype)
    tp, ts = torch_model(params, state)
    batch = data(dtype, seed=1)
    (wl, _), wg = jax.value_and_grad(
        lambda p: JR.local_loss(CFG_J, p, state, tuple(
            jnp.asarray(a) for a in batch)), has_aux=True)(params)
    gl, gg = value_and_grad(
        lambda p: PR.local_loss(CFG_P, p, ts, tuple(
            torch.from_numpy(a) for a in batch))[0], tp)
    assert rel(gl.numpy(), wl) <= TOL[dtype]
    for a, b in zip(jax.tree.leaves(wg), tree_leaves(gg)):
        assert rel(_hwio(b), a) <= TOL[dtype]


def _jax_steps(recipe, params, state, images, labels, n, steps):
    b = len(labels) // n

    def body():
        r = mpi.COMM_WORLD.rank
        p, s = params, state
        batch = (jnp.asarray(images[r * b:(r + 1) * b]),
                 jnp.asarray(labels[r * b:(r + 1) * b]))
        for _ in range(steps):
            loss, p, s = recipe(mpi.COMM_WORLD, CFG_J, p, s, batch, lr=0.05)
        return np.asarray(loss), _np_tree(p), _np_tree(s)

    return mpi.run_ranks(body, n)


def _torch_steps(recipe, params, state, images, labels, n, steps):
    b = len(labels) // n

    def body(r):
        p, s = torch_model(params, state)
        batch = (torch.from_numpy(images[r * b:(r + 1) * b]),
                 torch.from_numpy(labels[r * b:(r + 1) * b]))
        for _ in range(steps):
            loss, p, s = recipe(P.COMM_WORLD, CFG_P, p, s, batch, lr=0.05)
        return loss.numpy(), p, s

    return P.run_ranks(body, n, device="cpu")


@pytest.mark.parametrize("recipe", ["dp_grad_train_step",
                                    "dp_loss_train_step"])
@pytest.mark.parametrize("n", [2, 4])
def test_dp_steps_match_jax_mode_b(recipe, n):
    params, state = jax_model(np.float64)
    images, labels = data(np.float64, seed=2)
    want = _jax_steps(getattr(JR, recipe), params, state, images, labels,
                      n, 2)
    got = _torch_steps(getattr(PR, recipe), params, state, images, labels,
                       n, 2)
    for r in range(n):
        assert rel(got[r][0], want[r][0]) <= 1e-10
        for a, b in zip(jax.tree.leaves(want[r][1]), tree_leaves(got[r][1])):
            assert rel(_hwio(b), a) <= 1e-10
        for a, b in zip(jax.tree.leaves(want[r][2]), tree_leaves(got[r][2])):
            assert rel(b.numpy(), a) <= 1e-10
        for a, b in zip(tree_leaves(got[0][1]) + tree_leaves(got[0][2]),
                        tree_leaves(got[r][1]) + tree_leaves(got[r][2])):
            assert torch.equal(a, b)          # ranks bitwise identical


def test_dp_gradient_is_the_mean_of_per_shard_gradients_and_recipes_agree():
    n, lr = 2, 0.05
    params, state = jax_model(np.float64)
    images, labels = data(np.float64, seed=3)
    tp, ts = torch_model(params, state)
    b = len(labels) // n
    shard_grads = [value_and_grad(lambda p: PR.local_loss(
        CFG_P, p, ts, (torch.from_numpy(images[r * b:(r + 1) * b]),
                       torch.from_numpy(labels[r * b:(r + 1) * b])))[0],
        tp)[1] for r in range(n)]
    mean = [sum(g) / n for g in zip(*(tree_leaves(g) for g in shard_grads))]
    steps = {recipe: _torch_steps(getattr(PR, recipe), params, state,
                                  images, labels, n, 1)[0][1]
             for recipe in ("dp_grad_train_step", "dp_loss_train_step")}
    for recipe, new in steps.items():
        got = [(p - q) / lr for p, q in zip(tree_leaves(tp),
                                             tree_leaves(new))]
        for g, m in zip(got, mean):
            assert rel(g.numpy(), m.numpy()) <= 1e-8, recipe


def test_dp_training_reduces_the_loss():
    params, state = jax_model(np.float64)
    images, labels = data(np.float64, seed=4)

    def body(r):
        p, s = torch_model(params, state)
        batch = (torch.from_numpy(images[r * 4:(r + 1) * 4]),
                 torch.from_numpy(labels[r * 4:(r + 1) * 4]))
        losses = []
        for _ in range(4):
            loss, p, s = PR.dp_grad_train_step(P.COMM_WORLD, CFG_P, p, s,
                                               batch, lr=0.05)
            losses.append(loss.item())
        return losses

    outs = P.run_ranks(body, 2, device="cpu")
    assert outs[0] == outs[1] and outs[0][-1] < outs[0][0]


# --- MLP ---------------------------------------------------------------------

def _mlp_case(seed=0):
    params = JM.init_params(jax.random.PRNGKey(2), (4, 8, 8, 2),
                            dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    x, y = rng.standard_normal((8, 4)), rng.standard_normal((8, 2))
    return params, x, y


def test_mlp_forward_and_loss_match_jax():
    params, x, y = _mlp_case()
    tp = PM.params_from_jax(_np_tree(params), "cpu")
    want = JM.apply(params, jnp.asarray(x))
    got = PM.apply(tp, torch.from_numpy(x))
    assert rel(got.numpy(), want) <= 1e-12
    wl, wg = jax.value_and_grad(JM.local_loss)(params, (jnp.asarray(x),
                                                        jnp.asarray(y)))
    gl, gg = value_and_grad(lambda p: PM.local_loss(
        p, (torch.from_numpy(x), torch.from_numpy(y))), tp)
    assert rel(gl.numpy(), wl) <= 1e-12
    for a, b in zip(jax.tree.leaves(wg), tree_leaves(gg)):
        assert rel(b.numpy(), a) <= 1e-12
    own = PM.init_params(0, (4, 8, 2), device="cpu")
    assert [tuple(w.shape) for w, _ in own] == [(4, 8), (8, 2)]


@pytest.mark.parametrize("n", [2, 4])
def test_mlp_dp_train_step_matches_jax_and_one_rank(n):
    params, x, y = _mlp_case(seed=n)
    b = len(x) // n

    def jax_body():
        r = mpi.COMM_WORLD.rank
        batch = (jnp.asarray(x[r * b:(r + 1) * b]),
                 jnp.asarray(y[r * b:(r + 1) * b]))
        loss, p = JM.dp_train_step(mpi.COMM_WORLD, params, batch, lr=0.1)
        return np.asarray(loss), _np_tree(p)

    def torch_body(r):
        tp = PM.params_from_jax(_np_tree(params), "cpu")
        batch = (torch.from_numpy(x[r * b:(r + 1) * b]),
                 torch.from_numpy(y[r * b:(r + 1) * b]))
        loss, p = PM.dp_train_step(P.COMM_WORLD, tp, batch, lr=0.1)
        return loss.numpy(), p

    want = mpi.run_ranks(jax_body, n)
    got = P.run_ranks(torch_body, n, device="cpu")
    one_loss, one = PM.dp_train_step(
        P.COMM_WORLD, PM.params_from_jax(_np_tree(params), "cpu"),
        (torch.from_numpy(x), torch.from_numpy(y)), lr=0.1)
    for r in range(n):
        assert rel(got[r][0], want[r][0]) <= 1e-12
        assert rel(got[r][0], one_loss.numpy()) <= 1e-12
        for a, b_, c, r0 in zip(jax.tree.leaves(want[r][1]),
                                tree_leaves(got[r][1]), tree_leaves(one),
                                tree_leaves(got[0][1])):
            assert rel(b_.numpy(), a) <= 1e-12
            assert rel(b_.numpy(), c.numpy()) <= 1e-12
            assert torch.equal(b_, r0)        # ranks bitwise identical


def test_value_and_grad_has_aux_matches_jax():
    # The ResNet steps' ((loss, new_state), grads): the aux comes back
    # detached, the gradient of the scalar alone, as in JAX.
    w = np.random.default_rng(5).standard_normal((3, 4))

    def jfn(p):
        y = jnp.tanh(p["w"]).sum()
        return y, {"mean": jnp.mean(p["w"])}

    def tfn(p):
        y = torch.tanh(p["w"]).sum()
        return y, {"mean": p["w"].mean()}

    (jv, jaux), jg = jax.value_and_grad(jfn, has_aux=True)(
        {"w": jnp.asarray(w)})
    (tv, taux), tg = value_and_grad(tfn, {"w": torch.from_numpy(w)},
                                    has_aux=True)
    assert not taux["mean"].requires_grad and not tv.requires_grad
    assert rel(tv.numpy(), jv) <= 1e-12
    assert rel(taux["mean"].numpy(), jaux["mean"]) <= 1e-12
    assert rel(tg["w"].numpy(), jg["w"]) <= 1e-12
