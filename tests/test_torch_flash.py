"""The port's block attention against the JAX package.

The plain version (the CPU path of ``impl="auto"``) is held to the JAX
package's ``_jnp_block`` in float64 at 1e-12, and to its Pallas forward
kernel run interpreted (``_pallas_block(..., interpret=True)``, as
tests/test_flash.py runs it off TPU) in float32 at 1e-5 on a tile-shaped
input, and in bfloat16 within the tolerance the card holds the
tensor-core kernel to.  Inputs come from numpy and feed both packages.
The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py).
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
    # Raises before any launch, whatever variant is asked for, and leaves
    # every count (the per-variant ones too) at 0.
    _kernels.reset_launch_counts()
    q, k, v = _torch(*_qkv(1, 8, 8, 2, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        pflash.flash_block_attention(q, k, v, causal=True, impl="cuda")
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        q, k, v = (t.to(dtype) for t in (q, k, v))
        for variant in (None, "tc", "simt"):
            with pytest.raises(ValueError, match="CUDA tensor"):
                _kernels.flash_fwd(q, k, v, 0, 0, True, variant=variant)
    assert all(c == 0 for c in _kernels.launch_counts.values())
    assert {"flash_fwd.tc", "flash_fwd.simt"} <= set(_kernels.launch_counts)


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


# The card's tolerance for the forward kernels against the plain version
# in bf16 (chip_smoke.py TOL): out is bf16 (one ulp is 2^-8 relative),
# lse is f32 on both sides.
BF16_TOL = {"out": 1e-2, "lse": 1e-4}

# (name, b, sq, sk, h, h_kv, d, causal, q_off, kv_off, window); sq and sk
# are whole tiles of the interpreted kernel (min(128, s)).
BF16_CASES = [
    ("causal", 1, 128, 128, 2, 2, 64, True, 0, 0, 0),
    ("window", 1, 128, 128, 2, 2, 64, True, 0, 0, 24),
    ("gqa_4_2", 1, 128, 128, 4, 2, 64, True, 0, 0, 0),
    ("q_off_sq_lt_sk", 1, 64, 128, 2, 2, 64, True, 64, 0, 0),
    ("fully_masked_rows", 1, 64, 64, 2, 2, 64, True, 0, 40, 0),
    ("ragged_noncausal_d72", 2, 100, 72, 2, 1, 72, False, 0, 0, 0),
]


@pytest.mark.parametrize("case", BF16_CASES, ids=[c[0] for c in BF16_CASES])
def test_plain_bf16_within_card_tolerance_of_interpreted_pallas(case):
    # The JAX package's Pallas forward in bf16 rounds p to bf16 where it
    # enters the PV product, as the tensor-core kernel does; the port's
    # plain forward keeps p in f32.  They agree within the tolerance the
    # card holds the kernel to, so that tolerance covers the TPU kernel's
    # own rounding.
    _, b, sq, sk, h, h_kv, d, causal, q_off, kv_off, window = case
    q, k, v = _qkv(b, sq, sk, h, h_kv, d, dtype=np.float32, seed=11)
    ro, rl = jflash._pallas_block(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        jnp.int32(q_off), jnp.int32(kv_off), causal, interpret=True,
        window=window)
    o, l = pflash.flash_block_attention(
        *(t.to(torch.bfloat16) for t in _torch(q, k, v)), causal=causal,
        q_offset=q_off, kv_offset=kv_off, window=window)
    assert o.dtype == torch.bfloat16 and ro.dtype == jnp.bfloat16
    err_o = np.abs(o.float().numpy()
                   - np.asarray(ro.astype(jnp.float32))).max()
    err_l = np.abs(l.numpy() - np.asarray(rl)).max()
    assert err_o <= BF16_TOL["out"] and err_l <= BF16_TOL["lse"]
    if kv_off > q_off:
        # Rows before the first key: out exactly 0, lse -1e30, both sides.
        n = kv_off - q_off
        assert torch.all(o[:, :n] == 0) and torch.all(l[:, :n] == -1e30)
        assert np.all(np.asarray(rl)[:, :n] == -1e30)


@pytest.mark.parametrize("d", [8, 64, 72, 128])
def test_fwd_variant_takes_tensor_cores_for_bf16_up_to_128(d):
    assert _kernels.fwd_variant(torch.bfloat16, d) == "tc"


@pytest.mark.parametrize("dtype, d", [
    (torch.float32, 8), (torch.float32, 64), (torch.float32, 128),
    (torch.float32, 256), (torch.bfloat16, 136), (torch.bfloat16, 256)])
def test_fwd_variant_keeps_simt_for_f32_and_wide_heads(dtype, d):
    assert _kernels.fwd_variant(dtype, d) == "simt"


def test_forward_and_backward_share_the_variant_rule():
    for dtype in (torch.float32, torch.bfloat16):
        for d in range(8, 257, 8):
            assert _kernels.fwd_variant(dtype, d) == \
                _kernels.bwd_variant(dtype, d)


def test_forward_variant_by_name_is_checked_against_the_operands():
    bf, f32 = torch.bfloat16, torch.float32
    resolve = _kernels._resolve_variant
    assert resolve("flash_fwd", torch.zeros((1, 8, 2, 72), dtype=bf),
                   None) == "tc"
    assert resolve("flash_fwd", torch.zeros((1, 8, 2, 128), dtype=bf),
                   "simt") == "simt"
    for dtype, d in ((f32, 64), (bf, 256)):
        with pytest.raises(ValueError, match="flash_fwd: variant 'tc' "
                                             "takes bfloat16"):
            resolve("flash_fwd", torch.zeros((1, 8, 2, d), dtype=dtype),
                    "tc")
    with pytest.raises(ValueError, match="unknown variant"):
        resolve("flash_fwd", torch.zeros((1, 8, 2, 64), dtype=bf), "wgmma")


@pytest.mark.parametrize("d, want", [(1, 8), (4, 8), (8, 8), (12, 16),
                                     (128, 128), (260, 264), (264, 264),
                                     (512, 512)])
def test_padded_head_dim_is_the_next_multiple_of_8(d, want):
    assert _kernels.padded_head_dim(d) == want


def test_kernel_operands_pad_and_cast_and_results_come_back():
    x16 = torch.randn(2, 3, 4, 12).to(torch.float16)
    xb = torch.randn(2, 3, 4, 16).to(torch.bfloat16)
    pad, same = _kernels._kernel_operands((x16, xb))
    # float16 runs in float32, zero-padded to 16 columns; an operand that
    # needs neither comes back as the very same tensor.
    assert pad.dtype == torch.float32 and pad.shape == (2, 3, 4, 16)
    assert torch.equal(pad[..., :12], x16.float())
    assert torch.all(pad[..., 12:] == 0)
    assert same is xb
    back = _kernels._caller_result(pad, 12, torch.float16)
    assert back.dtype == torch.float16 and back.shape == x16.shape
    assert back.is_contiguous() and torch.equal(back, x16)
    assert _kernels._caller_result(xb, 16, torch.bfloat16) is xb


@pytest.mark.parametrize("d", [4, 12, 260])
def test_zero_padded_head_dim_gives_the_true_attention(d):
    # What the launchers do for a head dim that is not a multiple of 8:
    # the kernel sees zero-padded operands and scales by 1 / sqrt(d) of
    # the true d.  The plain version at the padded width, with q rescaled
    # to that scale and the result sliced back, equals the JAX package's
    # attention at the true width.
    q, k, v = _qkv(2, 9, 11, 4, 2, d, seed=d)
    kw = dict(causal=True, q_offset=2, kv_offset=0, window=0)
    ro, rl = jflash.flash_block_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="jnp", **kw)
    qp, kp, vp = _kernels._kernel_operands(_torch(q, k, v))
    dp = _kernels.padded_head_dim(d)
    assert qp.shape[-1] == dp and torch.all(qp[..., d:] == 0)
    o, l = pflash.flash_block_attention(qp * (dp / d) ** 0.5, kp, vp, **kw)
    o = _kernels._caller_result(o, d, torch.float64)
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), atol=1e-12, rtol=0)
    np.testing.assert_allclose(l.numpy(), np.asarray(rl), atol=1e-12, rtol=0)
