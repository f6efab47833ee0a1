"""The port's strategy examples (``mpi4torch_tpu_torch.examples``):
ring/Ulysses long-context attention, the expert-parallel MoE, the
tensor-parallel MLP, and beside the JAX package's own examples the
compressed DP regression, ResNet, ViT, the pipeline, KV-cache generation,
the ZeRO-1/3 optimizer, checkpoint/resume and the variable token
exchange under ``run_spmd``.  Each ``run`` drives its ``main`` on rank
threads on the CPU (float64) and checks itself against its single-device
oracle:
ring and Ulysses against dense attention over the full sequence (values
and gradients, rtol 1e-9), the MoE loss and gradient at every one of 25
steps against ``moe_ffn_dense`` (rtol 1e-10 / 1e-8), the TP MLP's loss
at every step and its final shards against the unsharded SGD trajectory
(rtol 1e-10)."""

import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import mpi4torch_tpu as jmpi
from mpi4torch_tpu_torch.examples import checkpoint_resume as ckpt_ex
from mpi4torch_tpu_torch.examples import compressed_data_parallel as cdp_ex
from mpi4torch_tpu_torch.examples import expert_parallel_moe as moe_ex
from mpi4torch_tpu_torch.examples import generate_kv_cache as kv_ex
from mpi4torch_tpu_torch.examples import pipeline_training as pp_ex
from mpi4torch_tpu_torch.examples import resnet_cifar_dp as resnet_ex
from mpi4torch_tpu_torch.examples import ring_attention_longcontext as ring_ex
from mpi4torch_tpu_torch.examples import tensor_parallel_mlp as tp_ex
from mpi4torch_tpu_torch.examples import variable_token_exchange as vte_ex
from mpi4torch_tpu_torch.examples import vit_patch_parallel as vit_ex
from mpi4torch_tpu_torch.examples import zero_sharded_optimizer as zero_ex


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
def test_expert_parallel_moe_example_dropless_topk(n):
    losses = moe_ex.run_topk(n, device="cpu")
    assert len(losses) == moe_ex.N_STEPS and losses[-1] < losses[0]


@pytest.mark.parametrize("n", [2, 4])
def test_tensor_parallel_mlp_example(n):
    losses = tp_ex.run(n, device="cpu")
    assert len(losses) == tp_ex.N_STEPS and losses[-1] < losses[0]


_JAX_EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", _JAX_EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_compressed_data_parallel_example(monkeypatch):
    # The same data and zero start in both packages: the three final
    # losses agree with the JAX example's (the q8 wire is bitwise JAX's),
    # and the compressed ones land within 2% of the exact one.
    jmod = _jax_example("compressed_data_parallel")
    jmod.STEPS = 60
    monkeypatch.setattr(cdp_ex, "STEPS", 60)
    want = jmpi.run_ranks(jmod.main, 2)[0]
    got = cdp_ex.run(2, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_resnet_cifar_dp_example():
    # BASELINE config 4 at the JAX test's reduced width: the JAX example's
    # initial weights carried across (params_from_jax), the same seeded
    # data and pipeline; losses within 1e-5 and the ranks in lock-step.
    from mpi4torch_tpu.models import resnet as JR
    from mpi4torch_tpu_torch.models import resnet as PR

    jmod = _jax_example("resnet_cifar_dp")
    kw = dict(steps=2, hw=8, batch_per_rank=2)
    jcfg = JR.ResNetConfig(num_classes=10, stage_sizes=(1, 1), widths=(8, 16))
    pcfg = PR.ResNetConfig(num_classes=10, stage_sizes=(1, 1), widths=(8, 16))
    want = jmpi.run_ranks(lambda: jmod.main(cfg=jcfg, **kw), 2)[0]
    jp, js = JR.init_resnet(jax.random.PRNGKey(0), jcfg)
    params = PR.params_from_jax(jax.tree.map(np.asarray, jp),
                                jax.tree.map(np.asarray, js), "cpu")
    losses, head = resnet_ex.run(2, device="cpu", cfg=pcfg, params=params,
                                 **kw)
    np.testing.assert_allclose(losses, want[0], rtol=1e-5)
    np.testing.assert_allclose(head, want[1], rtol=1e-4, atol=1e-6)


def test_vit_patch_parallel_example():
    # The JAX example's initial ViT carried across; losses and the trained
    # head within 1e-5 of the JAX example's, and the patch-parallel logits
    # equal to the single-device ones (checked inside run).
    from mpi4torch_tpu.models import vit as JV
    from mpi4torch_tpu_torch.models import vit as PV

    jmod = _jax_example("vit_patch_parallel")
    want = jmpi.run_ranks(lambda: jmod.main(steps=2), 2)[0]
    params = PV.params_from_jax(jax.tree.map(np.asarray, JV.init_vit(
        jax.random.PRNGKey(0), jmod.CFG)), "cpu")
    got = vit_ex.run(2, device="cpu", steps=2, params=params)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_training_example(n):
    # The same numpy stages in both packages: the 1F1B loss trajectory is
    # the JAX example's within 1e-10 (GPipe == 1F1B is checked inside).
    jmod = _jax_example("pipeline_training")
    want = jmpi.run_ranks(jmod.main, n)[0]
    got = pp_ex.run(n, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_generate_kv_cache_example(monkeypatch):
    # The JAX example's initial weights and data carried across: ten DP
    # steps on 2 rank threads give the JAX example's loss within 1e-10
    # and its parameters within 1e-8 (float64), and generate() emits the
    # JAX generate()'s tokens (each equal to its own full-forward
    # oracle, checked inside both).
    from mpi4torch_tpu.models import transformer as JT
    from mpi4torch_tpu_torch.models import transformer as PT

    jmod = _jax_example("generate_kv_cache")
    monkeypatch.setattr(jmod, "STEPS", 10)
    tokens = np.asarray(jmod.make_data(jax.random.PRNGKey(1)))
    jloss, jparams = jmod.train(2)
    prompt = np.asarray([kv_ex.PROMPT], np.int32)
    jgen = np.asarray(JT.generate(jmod.CFG, jparams, prompt,
                                  n_new=kv_ex.N_NEW))[0, len(kv_ex.PROMPT):]
    params0 = PT.params_from_jax(jax.tree.map(np.asarray, JT.init_transformer(
        jax.random.PRNGKey(0), jmod.CFG, dtype=jax.numpy.float64)), "cpu")
    loss, params, gen, want = kv_ex.run(2, device="cpu", params=params0,
                                        tokens=tokens, steps=10)
    np.testing.assert_allclose(loss, jloss, rtol=1e-10)
    for a, b in zip(jax.tree.leaves(PT.params_to_numpy(params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jparams))):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12)
    np.testing.assert_array_equal(gen, jgen)
    assert want.tolist() == [7, 0, 1, 2, 3, 4, 5, 6, 7, 0, 1, 2]


@pytest.mark.parametrize("n", [2, 4])
def test_zero_sharded_optimizer_example(n):
    # Both stages match the single-process Adam oracle on every rank and
    # leaf (checked inside run, rtol 1e-9), and the JAX example's
    # parameters (optax's adam) within 1e-12.
    jmod = _jax_example("zero_sharded_optimizer")
    want, _ = jmod.main(n)
    p1, p3, ref = zero_ex.run(n, device="cpu")
    for k in ("w", "b"):
        for got in (p1, p3, ref):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("n", [2, 4])
def test_checkpoint_resume_example(n, tmp_path, monkeypatch):
    # The resumed run is bitwise the uninterrupted one on every rank
    # (checked inside run), and the final parameters are the JAX
    # example's within 1e-12 (float64; the packages' loss sums may
    # associate differently).  The JAX example reads its workdir from
    # argv, as its own test runs it.
    jmod = _jax_example("checkpoint_resume")
    monkeypatch.setattr(sys, "argv", ["checkpoint_resume", str(n),
                                      str(tmp_path / "jax")])
    want = jmpi.run_ranks(jmod.main, n)[0]
    params, losses, tail = ckpt_ex.run(n, device="cpu",
                                       workdir=str(tmp_path / "port"))
    assert len(losses) == ckpt_ex.N_STEPS
    assert len(tail) == ckpt_ex.N_STEPS - ckpt_ex.CRASH_AFTER
    assert tail == losses[ckpt_ex.CRASH_AFTER:]
    np.testing.assert_allclose(params.numpy(), np.asarray(want),
                               rtol=1e-12)


@pytest.mark.parametrize("n", [4, 8])
def test_variable_token_exchange_example(n):
    # The butterfly + packed Alltoall under run_spmd: the spans and the
    # per-rank gradients are checked inside run against the token-id
    # oracle, and the tokens, spans and gradients equal the JAX example's
    # (its own run_spmd), bitwise (float64 data movement and integer
    # sums).
    jmod = _jax_example("variable_token_exchange")
    want = [np.asarray(t) for t in jmpi.run_spmd(jmod.main, nranks=n)()]
    got = [t.numpy() for t in vte_ex.run(n, device="cpu")]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="even"):
        vte_ex.run(3, device="cpu")
