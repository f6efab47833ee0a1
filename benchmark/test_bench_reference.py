"""The plain references against the port at a tiny size on the CPU, in
float32: the loss and every parameter's gradient of one rank's batch, and
the float8 control's products near the float32 ones."""

import math

import pytest
import torch

from benchmark import harness
from benchmark.conftest import tiny_cell
from benchmark.loops import dp_train
from benchmark.reference import common

CELLS = {"transformer": "mistral7b-l4-dp2-s4096", "vit": "vitb16-dp2-b256"}


def _port_loss(family, cfg, params, batch):
    if family == "transformer":
        from mpi4torch_tpu_torch.models import transformer as T

        return T.lm_loss(cfg, params, batch)
    from mpi4torch_tpu_torch.models import vit as V

    return V.local_loss(cfg, params, batch)


@pytest.mark.parametrize("family", sorted(CELLS))
def test_reference_matches_port(family):
    torch.manual_seed(0)
    cell = tiny_cell(CELLS[family])
    conf, traffic = cell["config"], cell["traffic"]
    fam = harness.module("models", family)
    ref = common.family(family)
    specs, leaves, inputs, _ = dp_train.draw(fam, conf, traffic, 7, "cpu",
                                             torch.float32)
    # Norm scales and biases away from 1 and 0, so that their gradients
    # are checked at general values.
    for (path, shape, kind, _), t in zip(specs, leaves):
        if kind != "normal":
            t.add_(0.1 * torch.randn(shape))
    batch = fam.batch(inputs, 0, 0)
    tree = dp_train.tree_from_leaves(
        specs, [t.clone().requires_grad_(True) for t in leaves])
    port = _port_loss(family, fam.port_config(conf), tree, batch)
    port_grads = torch.autograd.grad(port, dp_train._leaves(tree, specs))
    P = {s[0]: t.clone().requires_grad_(True)
         for s, t in zip(specs, leaves)}
    total = ref.loss_sum(conf, P, batch, common.mm_f32) / (
        ref.n_rows(batch) * ref.positions_per_row(batch))
    ref_grads = torch.autograd.grad(total, [P[s[0]] for s in specs])
    assert float(total.detach()) == pytest.approx(float(port.detach()),
                                                  rel=1e-5)
    for s, a, b in zip(specs, port_grads, ref_grads):
        err = float((a - b).norm()) / max(float(b.norm()), 1e-30)
        assert err < 1e-4, (s[0], err)


def test_fp8_products_are_coarser_than_f32():
    torch.manual_seed(1)
    x = torch.randn(64, 128, requires_grad=True)
    w = torch.randn(128, 32, requires_grad=True)
    exact = x @ w
    low = common.mm_fp8(x, w)
    rel = float((low - exact).detach().norm() / exact.detach().norm())
    # e4m3 keeps 3 bits of mantissa: a few percent, far above f32's 1e-7.
    assert 5e-3 < rel < 0.1
    low.sum().backward()
    gw = x.detach().t() @ torch.ones(64, 32)
    assert float((w.grad - gw).norm() / gw.norm()) < 0.1


def test_reference_train_stores_in_the_configuration_dtype():
    cell = tiny_cell(CELLS["transformer"], dtype="bfloat16")
    conf, traffic = cell["config"], cell["traffic"]
    fam = harness.module("models", "transformer")
    specs, leaves, inputs, _ = dp_train.draw(fam, conf, traffic, 3, "cpu",
                                             torch.bfloat16)
    params = {s[0]: t.float() for s, t in zip(specs, leaves)}
    batches = [[fam.batch(inputs, k, r) for r in range(traffic["ranks"])]
               for k in range(2)]
    res = common.train(conf, batches, params, traffic["lr"], 2)
    for p, d in res["delta"].items():
        after = params[p] + d
        assert torch.equal(after, after.to(torch.bfloat16).float()), p
    assert all(math.isfinite(x) for x in res["losses"])
