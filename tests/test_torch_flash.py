"""The port's block attention against the JAX package.

The plain version (the CPU path of ``impl="auto"``) is held to the JAX
package's ``_jnp_block`` in float64 at 1e-12, and to its Pallas forward
kernel run interpreted (``_pallas_block(..., interpret=True)``, as
tests/test_flash.py runs it off TPU) in float32 at 1e-5 on a tile-shaped
input.  Inputs come from numpy and feed both packages.  The CUDA kernel
itself runs only on the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4torch_tpu.ops import flash as jflash
from mpi4torch_tpu_torch.ops import _kernels
from mpi4torch_tpu_torch.ops import flash as pflash

# (name, b, sq, sk, h, h_kv, d, causal, q_off, kv_off, window)
CASES = [
    ("causal", 2, 9, 9, 4, 4, 16, True, 0, 0, 0),
    ("noncausal", 2, 9, 13, 4, 4, 16, False, 0, 0, 0),
    ("window", 1, 12, 12, 2, 2, 8, True, 0, 0, 4),
    ("gqa_4_2", 2, 10, 10, 4, 2, 16, True, 0, 0, 0),
    ("q_off_sq_lt_sk", 1, 5, 12, 2, 2, 8, True, 7, 0, 0),
    ("q_off_window", 1, 5, 12, 2, 1, 8, True, 7, 0, 3),
    ("fully_masked_rows", 1, 6, 8, 2, 2, 8, True, 0, 3, 0),
]


def _qkv(b, sq, sk, h, h_kv, d, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(dtype),
            rng.standard_normal((b, sk, h_kv, d)).astype(dtype),
            rng.standard_normal((b, sk, h_kv, d)).astype(dtype))


def _torch(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_jnp_block_f64(case):
    _, b, sq, sk, h, h_kv, d, causal, q_off, kv_off, window = case
    q, k, v = _qkv(b, sq, sk, h, h_kv, d)
    ro, rl = jflash.flash_block_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=q_off, kv_offset=kv_off, window=window, impl="jnp")
    o, l = pflash.flash_block_attention(
        *_torch(q, k, v), causal=causal, q_offset=q_off, kv_offset=kv_off,
        window=window)
    assert o.dtype == torch.float64 and l.dtype == torch.float64
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), atol=1e-12,
                               rtol=0)
    np.testing.assert_allclose(l.numpy(), np.asarray(rl), atol=1e-12,
                               rtol=0)


def test_fully_masked_rows_are_neutral():
    q, k, v = _qkv(1, 6, 8, 2, 2, 8)
    o, l = pflash.flash_block_attention(*_torch(q, k, v), causal=True,
                                        kv_offset=3)
    # Rows 0..2 precede every key: out = 0, lse = -1e30.
    assert torch.all(o[:, :3] == 0)
    assert torch.all(l[:, :3] == pflash.NEG_BIG)
    assert torch.all(l[:, 3:] > pflash.NEG_BIG)


@pytest.mark.parametrize("window", [0, 3])
def test_per_row_offsets_match_jnp_block(window):
    # The continuous-batching decode shape: one query per row, each row at
    # its own position over a shared max_seq buffer.
    b, sk, h, h_kv, d = 3, 10, 4, 2, 8
    q, k, v = _qkv(b, 1, sk, h, h_kv, d, seed=3)
    pos = np.array([2, 9, 5], np.int32)
    ro, rl = jflash.flash_block_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=jnp.asarray(pos), kv_offset=0, window=window, impl="jnp")
    o, l = pflash.flash_block_attention(
        *_torch(q, k, v), causal=True, q_offset=torch.from_numpy(pos),
        kv_offset=0, window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), atol=1e-12,
                               rtol=0)
    np.testing.assert_allclose(l.numpy(), np.asarray(rl), atol=1e-12,
                               rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_interpreted_pallas_kernel_f32(causal):
    q, k, v = _qkv(1, 128, 128, 2, 2, 64, dtype=np.float32, seed=7)
    ro, rl = jflash._pallas_block(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(0),
        jnp.int32(0), causal, interpret=True)
    o, l = pflash.flash_block_attention(*_torch(q, k, v), causal=causal)
    assert o.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(l.numpy(), np.asarray(rl), atol=1e-5,
                               rtol=0)


def test_flash_attention_is_block_out():
    q, k, v = _qkv(1, 7, 7, 2, 2, 8, seed=1)
    ref = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, impl="jnp")
    got = pflash.flash_attention(*_torch(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-12,
                               rtol=0)


def test_auto_on_cpu_tensors_takes_the_plain_version():
    _kernels.reset_launch_counts()
    q, k, v = _torch(*_qkv(1, 8, 8, 2, 2, 8))
    pflash.flash_block_attention(q, k, v, causal=True, impl="auto")
    pflash.flash_attention(q, k, v, causal=True)
    assert _kernels.launch_counts["flash_fwd"] == 0


def test_cuda_impl_on_cpu_tensors_raises():
    q, k, v = _torch(*_qkv(1, 8, 8, 2, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        pflash.flash_block_attention(q, k, v, causal=True, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        _kernels.flash_fwd(q, k, v, 0, 0, True)
    assert _kernels.launch_counts["flash_fwd"] == 0


@pytest.mark.parametrize("kw, match", [
    ({"impl": "pallas"}, "unknown impl"),
    ({"window": 2}, "requires causal"),
    ({"window": -1, "causal": True}, ">= 0"),
    ({"q_offset": torch.tensor([1, 2, 3]), "causal": True}, "per-row"),
    ({"q_offset": torch.tensor([1]), "causal": True, "impl": "cuda"},
     "plain version only"),
])
def test_argument_errors(kw, match):
    q, k, v = _torch(*_qkv(1, 8, 8, 2, 2, 8))
    with pytest.raises(ValueError, match=match):
        pflash.flash_block_attention(q, k, v, **kw)


def test_head_count_mismatch_raises():
    q, k, v = _torch(*_qkv(1, 8, 8, 3, 2, 8))
    with pytest.raises(ValueError, match="multiple of KV heads"):
        pflash.flash_block_attention(q, k, v)


def test_launch_counter_is_thread_safe():
    import sys
    import threading

    _kernels.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_kernels._count("flash_fwd")
                            for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert _kernels.launch_counts["flash_fwd"] == 16 * 2000
    _kernels.reset_launch_counts()
    assert _kernels.launch_counts["flash_fwd"] == 0


def test_build_without_nvcc_raises_clearly(monkeypatch):
    import shutil

    from torch.utils import cpp_extension

    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels._nvcc()
