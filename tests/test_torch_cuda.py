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
