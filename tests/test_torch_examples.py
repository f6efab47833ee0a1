"""The port's strategy examples (``mpi4torch_tpu_torch.examples``):
ring/Ulysses long-context attention, the expert-parallel MoE and the
tensor-parallel MLP.  Each ``run`` drives its ``main`` on rank threads on
the CPU (float64) and checks itself against its single-device oracle:
ring and Ulysses against dense attention over the full sequence (values
and gradients, rtol 1e-9), the MoE loss and gradient at every one of 25
steps against ``moe_ffn_dense`` (rtol 1e-10 / 1e-8), the TP MLP's loss
at every step and its final shards against the unsharded SGD trajectory
(rtol 1e-10)."""

import pytest

from mpi4torch_tpu_torch.examples import expert_parallel_moe as moe_ex
from mpi4torch_tpu_torch.examples import ring_attention_longcontext as ring_ex
from mpi4torch_tpu_torch.examples import tensor_parallel_mlp as tp_ex


@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_example(n):
    assert ring_ex.run(n, 8, device="cpu") == ["ring", "ulysses"]


def test_ring_attention_example_skips_ulysses_off_the_heads():
    assert ring_ex.run(3, 4, device="cpu") == ["ring"]


@pytest.mark.parametrize("n", [2, 4])
def test_expert_parallel_moe_example(n):
    losses = moe_ex.run(n, device="cpu")
    assert len(losses) == moe_ex.N_STEPS and losses[-1] < losses[0]


@pytest.mark.parametrize("n", [2, 4])
def test_tensor_parallel_mlp_example(n):
    losses = tp_ex.run(n, device="cpu")
    assert len(losses) == tp_ex.N_STEPS and losses[-1] < losses[0]
