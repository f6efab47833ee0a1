"""The port's CUDA kernel and its serving path on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one.
The file imports nothing of JAX, so on a GPU machine without JAX it runs
on its own, past the suite's JAX-configuring conftest::

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from mpi4torch_tpu_torch import serve
from mpi4torch_tpu_torch.models import transformer as T
from mpi4torch_tpu_torch.ops import _kernels
from mpi4torch_tpu_torch.ops import flash
from mpi4torch_tpu_torch.utils.tree import tree_leaves


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (b, sq, sk, h, h_kv, d, q_off, kv_off, window, causal)
SHAPES = [(1, 200, 200, 4, 2, 64, 0, 0, 0, True),
          (2, 77, 150, 4, 4, 128, 73, 0, 0, True),
          (1, 300, 300, 2, 1, 72, 0, 0, 64, True),
          (1, 64, 64, 2, 2, 256, 0, 40, 0, True),
          (2, 90, 33, 2, 2, 32, 0, 0, 0, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-5),
                                         (torch.bfloat16, 1e-2)])
def test_kernel_matches_plain(cuda, dtype, atol):
    g = torch.Generator(device=cuda).manual_seed(0)
    for b, sq, sk, h, h_kv, d, q_off, kv_off, window, causal in SHAPES:
        q = torch.randn((b, sq, h, d), generator=g, device=cuda, dtype=dtype)
        k = torch.randn((b, sk, h_kv, d), generator=g, device=cuda,
                        dtype=dtype)
        v = torch.randn((b, sk, h_kv, d), generator=g, device=cuda,
                        dtype=dtype)
        kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off,
                  window=window)
        o, l = flash.flash_block_attention(q, k, v, impl="cuda", **kw)
        po, pl = flash.flash_block_attention(q, k, v, impl="torch", **kw)
        torch.cuda.synchronize()
        assert (o.float() - po.float()).abs().max().item() <= atol
        assert (l - pl.float()).abs().max().item() <= 1e-4


def _grads(q, k, v, impl, kw, gen):
    """dq, dk, dv of a loss that reads both outputs (so dlse != 0)."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o, l = flash.flash_block_attention(q, k, v, impl=impl, **kw)
    wo = torch.randn(o.shape, generator=gen, device=o.device).to(o.dtype)
    wl = torch.randn(l.shape, generator=gen, device=o.device)
    live = l > flash.NEG_BIG / 2
    loss = (o.float() * wo.float()).sum() \
        + torch.where(live, l.float(), 0.0).mul(wl).sum()
    return torch.autograd.grad(loss, (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_match_plain(cuda, dtype):
    # f32: both sides sum in f32 in other orders (rtol 1e-3, atol 1e-4,
    # the JAX package's own kernel-vs-oracle bound).  bf16: the gradients
    # round once to bf16 from f32 sums over up to 300 keys, so a few bf16
    # ulps of the largest gradient (2e-2 of max |ref|).
    g = torch.Generator(device=cuda).manual_seed(1)
    for b, sq, sk, h, h_kv, d, q_off, kv_off, window, causal in SHAPES:
        q = torch.randn((b, sq, h, d), generator=g, device=cuda, dtype=dtype)
        k = torch.randn((b, sk, h_kv, d), generator=g, device=cuda,
                        dtype=dtype)
        v = torch.randn((b, sk, h_kv, d), generator=g, device=cuda,
                        dtype=dtype)
        kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off,
                  window=window)
        _kernels.reset_launch_counts()
        got = _grads(q, k, v, "cuda", kw, torch.Generator(
            device=cuda).manual_seed(2))
        assert _kernels.launch_counts["flash_bwd_dq"] == 1
        assert _kernels.launch_counts["flash_bwd_dkv"] == 1
        # No atomics: the same inputs give the same bits.
        again = _grads(q, k, v, "cuda", kw, torch.Generator(
            device=cuda).manual_seed(2))
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        want = _grads(q, k, v, "torch", kw, torch.Generator(
            device=cuda).manual_seed(2))
        torch.cuda.synchronize()
        for a, r in zip(got, want):
            assert a.dtype == r.dtype and a.shape == r.shape
            a, r = a.float(), r.float()
            if dtype == torch.float32:
                torch.testing.assert_close(a, r, rtol=1e-3, atol=1e-4)
            else:
                assert (a - r).abs().max() <= 2e-2 * r.abs().max()


@pytest.mark.cuda
def test_backward_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((1, 8, 2, 16), device=cuda)
    lse = torch.zeros((1, 8, 2), device=cuda)
    with pytest.raises(ValueError, match="lse must be float32"):
        _kernels.flash_bwd_dq(q, q, q, q, lse.double(), lse, 0, 0, True)
    with pytest.raises(ValueError, match="dd must be float32"):
        _kernels.flash_bwd_dkv(q, q, q, q, lse, lse[:, :4], 0, 0, True)
    with pytest.raises(ValueError, match="do"):
        _kernels.flash_bwd_dq(q, q, q, q[:, :4], lse, lse, 0, 0, True)
    bad = torch.zeros((1, 8, 2, 12), device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        _kernels.flash_bwd_dkv(bad, bad, bad, bad, lse, lse, 0, 0, True)


@pytest.mark.cuda
def test_dp2_training_step_on_rank_threads(cuda):
    # Two rank threads differentiate through blocking Allreduces on one
    # card: each backward runs on its own rank thread, so the step ends
    # well inside a short world timeout instead of deadlocking.
    import mpi4torch_tpu_torch as P

    cfg = T.TransformerConfig(vocab=97, d_model=128, n_heads=4, n_layers=2,
                              d_ff=256, max_seq=64)
    params = T.init_transformer(0, cfg, torch.float32, device=cuda)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (4, 64))).to(cuda)

    def body(r):
        return T.train_step(cfg, params, tokens[2 * r:2 * r + 2],
                            comm_dp=P.COMM_WORLD, lr=1e-2)

    _kernels.reset_launch_counts()
    (l0, p0), (l1, p1) = P.run_ranks(body, 2, timeout=20.0, device=cuda)
    assert _kernels.launch_counts["flash_bwd_dq"] == 2 * cfg.n_layers
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
        assert torch.equal(a, b)
    loss1, new1 = T.train_step(cfg, params, tokens, lr=1e-2)
    assert abs(l0.item() - loss1.item()) <= 1e-5
    for a, b in zip(tree_leaves(p0), tree_leaves(new1)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 2, 12), device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash.flash_block_attention(q, q, q, impl="auto")
    q = torch.zeros((1, 8, 2, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or"):
        flash.flash_block_attention(q, q, q, impl="auto")


@pytest.mark.cuda
def test_engine_prefill_runs_on_the_kernel(cuda):
    cfg = T.TransformerConfig(vocab=97, d_model=128, n_heads=4, n_layers=2,
                              d_ff=256, max_seq=64)
    params = T.init_transformer(0, cfg, torch.float32, device=cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (5, 17, 9, 30)]
    with torch.inference_mode():
        eng = serve.Engine(cfg, params, serve.ServeConfig(slots=2,
                                                          max_new=6))
        for p in prompts:
            eng.submit(p)
        _kernels.reset_launch_counts()
        res = eng.run()
        assert _kernels.launch_counts["flash_fwd"] == \
            cfg.n_layers * len(prompts)
        for i, p in enumerate(prompts):
            want = T.generate(cfg, params,
                              torch.as_tensor(p, device=cuda)[None], 6)
            assert res[i].tolist() == want[0].tolist()
