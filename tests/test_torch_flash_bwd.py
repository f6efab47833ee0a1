"""The port's block-attention backward against the JAX package.

The port's plain backward (the CPU path of ``impl="auto"``, reached
through ``torch.autograd.grad``) is held to ``jax.grad`` through the JAX
package's ``flash_block_attention(impl="jnp")`` in float64 at 1e-12, and
to its Pallas backward kernels run interpreted (``impl="pallas"`` off
TPU, as tests/test_flash.py runs them) in float32 at rtol 1e-3 / atol
1e-4, the JAX package's own kernel-vs-oracle bound.  Every loss reads
both outputs, so ``dlse`` is live.  Inputs come from numpy and feed both
packages.  The CUDA kernels run only on the card
(tests/test_torch_cuda.py).
"""

import jax
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
    # sk > 512 and a multiple of 128: the KV-tiled recompute.
    ("tiled_gqa_q_off", 1, 16, 640, 4, 2, 8, True, 624, 0, 0),
    ("tiled_window_q_off", 1, 8, 768, 2, 2, 8, True, 700, 0, 100),
    ("tiled_noncausal", 1, 6, 640, 2, 1, 8, False, 0, 0, 0),
]


def _inputs(b, sq, sk, h, h_kv, d, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in
            ((b, sq, h, d), (b, sk, h_kv, d), (b, sk, h_kv, d),
             (b, sq, h, d), (b, sq, h))]


def _jax_grads(q, k, v, wo, wl, use_lse=True, **kw):
    def loss(q, k, v):
        o, l = jflash.flash_block_attention(q, k, v, **kw)
        r = jnp.sum(o * wo)
        if use_lse:
            # Fully masked rows hold lse = -1e30: leave them out of the
            # loss, as a merge of partials would.
            r = r + jnp.sum(jnp.where(l > -1e29, l, 0.0) * wl)
        return r

    g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    return [np.asarray(x) for x in g]


def _torch_grads(q, k, v, wo, wl, use_lse=True, **kw):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, l = pflash.flash_block_attention(tq, tk, tv, **kw)
    r = (o * torch.from_numpy(wo)).sum()
    if use_lse:
        r = r + (torch.where(l > -1e29, l, 0.0)
                 * torch.from_numpy(wl)).sum()
    return [g.numpy() for g in torch.autograd.grad(r, (tq, tk, tv))]


@pytest.mark.parametrize("use_lse", [False, True], ids=["out", "out_lse"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_backward_matches_jax_grad_f64(case, use_lse):
    _, b, sq, sk, h, h_kv, d, causal, q_off, kv_off, window = case
    q, k, v, wo, wl = _inputs(b, sq, sk, h, h_kv, d)
    kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off,
              window=window)
    want = _jax_grads(q, k, v, wo, wl, use_lse, impl="jnp", **kw)
    _kernels.reset_launch_counts()
    got = _torch_grads(q, k, v, wo, wl, use_lse, **kw)
    assert _kernels.launch_counts == {n: 0 for n in _kernels.launch_counts}
    for name, a, r in zip("qkv", got, want):
        assert a.dtype == np.float64 and a.shape == r.shape, name
        np.testing.assert_allclose(a, r, atol=1e-12, rtol=0, err_msg=name)


def test_fully_masked_rows_get_zero_gradients():
    q, k, v, wo, wl = _inputs(1, 6, 8, 2, 2, 8)
    dq, _, _ = _torch_grads(q, k, v, wo, wl, causal=True, kv_offset=3)
    # Rows 0..2 precede every key.
    assert np.all(dq[:, :3] == 0)
    assert np.any(dq[:, 3:] != 0)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_interpreted_pallas_f32(causal):
    q, k, v, wo, wl = _inputs(1, 256, 256, 4, 2, 128, dtype=np.float32,
                              seed=5)
    want = _jax_grads(q, k, v, wo, wl, impl="pallas", causal=causal)
    got = _torch_grads(q, k, v, wo, wl, causal=causal)
    for name, a, r in zip("qkv", got, want):
        assert a.dtype == np.float32, name
        np.testing.assert_allclose(a, r, rtol=1e-3, atol=1e-4,
                                   err_msg=name)


def test_recomputing_backward_matches_autograd_through_plain_forward():
    # The recomputing backward agrees with autograd through the plain
    # forward's own operations, up to the reassociation of sums.
    q, k, v, wo, wl = _inputs(1, 7, 7, 2, 1, 8, seed=3)
    got = _torch_grads(q, k, v, wo, wl, causal=True)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    zero = torch.tensor(0, dtype=torch.int32)
    o, l = pflash._torch_block(tq, tk, tv, zero, zero, True)
    r = (o * torch.from_numpy(wo)).sum() + (l * torch.from_numpy(wl)).sum()
    want = torch.autograd.grad(r, (tq, tk, tv))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-12, rtol=0)


@pytest.mark.parametrize("case", [CASES[3], CASES[7]],
                         ids=["untiled_gqa", "tiled_gqa"])
def test_plain_backward_parts_equal_the_whole(case):
    # The dq-only and dk/dv-only plain backwards (the two kernels' plain
    # counterparts) give the same bits as the whole backward.
    _, b, sq, sk, h, h_kv, d, causal, q_off, kv_off, window = case
    q, k, v, do, dlse = (torch.from_numpy(x) for x in
                         _inputs(b, sq, sk, h, h_kv, d, seed=6))
    qo, ko = torch.tensor(q_off, dtype=torch.int32), \
        torch.tensor(kv_off, dtype=torch.int32)
    out, lse = pflash._torch_block(q, k, v, qo, ko, causal, window)
    args = (q, k, v, out, lse, do, dlse, qo, ko, causal, window)
    whole = pflash._torch_block_bwd(*args)
    dq, none_k, none_v = pflash._torch_block_bwd(*args, parts=("dq",))
    none_q, dk, dv = pflash._torch_block_bwd(*args, parts=("dkv",))
    assert none_k is None and none_v is None and none_q is None
    for a, r in zip((dq, dk, dv), whole):
        assert torch.equal(a, r)


def test_cuda_backward_on_cpu_tensors_raises():
    # Raises before any launch, whatever variant is asked for, and leaves
    # every count (the per-variant ones too) at 0.
    q, k, v, _, lse = _inputs(1, 8, 8, 2, 2, 16, dtype=np.float32)
    q, k, v, lse = (torch.from_numpy(x) for x in (q, k, v, lse))
    _kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        pflash.flash_block_attention(q.requires_grad_(), k, v, causal=True,
                                     impl="cuda")
    q = q.detach()
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dtype) for t in (q, k, v))
        for variant in (None, "tc", "simt"):
            for fn in (_kernels.flash_bwd_dq, _kernels.flash_bwd_dkv):
                with pytest.raises(ValueError, match="CUDA tensor"):
                    fn(q, k, v, q, lse, lse, 0, 0, True, variant=variant)
    assert all(c == 0 for c in _kernels.launch_counts.values())
    assert {f"flash_bwd_{p}.{v}" for p in ("dq", "dkv")
            for v in ("tc", "simt")} <= set(_kernels.launch_counts)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_bf16_within_card_tolerance_of_interpreted_pallas(
        causal):
    # The JAX package's Pallas backward in bf16 rounds p and ds to bf16
    # where they enter a product, as the tensor-core kernels do; the
    # port's plain backward keeps them f32.  They agree within the bound
    # the card holds the kernels to (2e-2 of max |ref|), so that bound
    # covers the TPU kernel's own rounding.
    q, k, v, wo, wl = _inputs(1, 256, 256, 4, 2, 64, dtype=np.float32,
                              seed=5)

    def jax_loss(q, k, v):
        o, l = jflash.flash_block_attention(q, k, v, impl="pallas",
                                            causal=causal)
        return jnp.sum(o.astype(jnp.float32) * wo) \
            + jnp.sum(jnp.where(l > -1e29, l, 0.0) * wl)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
                  for x in (q, k, v))
    o, l = pflash.flash_block_attention(tq, tk, tv, causal=causal)
    r = (o.float() * torch.from_numpy(wo)).sum() \
        + (torch.where(l > -1e29, l, 0.0) * torch.from_numpy(wl)).sum()
    got = torch.autograd.grad(r, (tq, tk, tv))
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        a = a.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        assert np.abs(a - w).max() <= 2e-2 * np.abs(w).max(), name


@pytest.mark.parametrize("d", range(8, 129, 8))
def test_bwd_variant_takes_tensor_cores_for_bf16_up_to_128(d):
    assert _kernels.bwd_variant(torch.bfloat16, d) == "tc"


@pytest.mark.parametrize("dtype, d", [
    (torch.float32, 8), (torch.float32, 64), (torch.float32, 128),
    (torch.float32, 256), (torch.bfloat16, 136), (torch.bfloat16, 192),
    (torch.bfloat16, 256)])
def test_bwd_variant_keeps_simt_for_f32_and_wide_heads(dtype, d):
    assert _kernels.bwd_variant(dtype, d) == "simt"


def test_variant_by_name_is_checked_against_the_operands():
    bf, f32 = torch.bfloat16, torch.float32
    resolve = _kernels._resolve_variant
    assert resolve("k", torch.zeros((1, 8, 2, 64), dtype=bf), None) == "tc"
    assert resolve("k", torch.zeros((1, 8, 2, 64), dtype=bf),
                   "simt") == "simt"
    assert resolve("k", torch.zeros((1, 8, 2, 64)), None) == "simt"
    for dtype, d in ((f32, 64), (bf, 256)):
        with pytest.raises(ValueError, match="'tc' takes bfloat16"):
            resolve("k", torch.zeros((1, 8, 2, d), dtype=dtype), "tc")
    with pytest.raises(ValueError, match="unknown variant"):
        resolve("k", torch.zeros((1, 8, 2, 64), dtype=bf), "wgmma")


def test_tc_operands_get_16_byte_rows():
    bf = torch.bfloat16
    # q of a fused (b, s, 3, h, d) projection: rows start every 16 bytes.
    qkv = torch.randn((1, 8, 3, 2, 8)).to(bf)
    q = qkv[:, :, 1]
    assert _kernels._rows_aligned(q) is q
    # A head stride of 12 elements, or storage one element off: copied.
    wide = torch.randn((1, 8, 2, 12)).to(bf)[..., :8]
    flat = torch.randn(1 * 8 * 2 * 8 + 1).to(bf)[1:].view(1, 8, 2, 8)
    for t in (wide, flat):
        c = _kernels._rows_aligned(t)
        assert c is not t and torch.equal(c, t) and c.is_contiguous()
        assert c.data_ptr() % 16 == 0


def test_per_row_offsets_stay_on_the_plain_forward():
    q, k, v, _, _ = _inputs(3, 1, 10, 4, 2, 8, seed=4)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    pos = torch.tensor([2, 9, 5])
    o, _ = pflash.flash_block_attention(q.requires_grad_(), k, v,
                                        causal=True, q_offset=pos)
    assert o.grad_fn is not None
    assert "BlockAttention" not in type(o.grad_fn).__name__


def test_bwd_tiling_constants_match_jax():
    assert pflash._BWD_TILE_ABOVE == jflash._BWD_TILE_ABOVE
    assert pflash._KV_TILE == jflash._KV_TILE


@pytest.mark.parametrize("d", [4, 12, 260])
def test_zero_padded_head_dim_gives_the_true_gradients(d):
    # The launchers' padding, backward: gradients taken through the
    # zero-padded operands (q rescaled to the true width's softmax scale,
    # as the kernels scale by 1 / sqrt(d) of the true d) and sliced back
    # equal the JAX package's gradients at the true width.
    q, k, v, wo, wl = _inputs(1, 7, 9, 2, 1, d, seed=d)
    kw = dict(causal=True, q_offset=2, kv_offset=0, window=0)
    want = _jax_grads(q, k, v, wo, wl, impl="jnp", **kw)
    dp = _kernels.padded_head_dim(d)
    x = [t.requires_grad_() for t in _kernels._kernel_operands(
        [torch.from_numpy(a) for a in (q, k, v)])]
    o, l = pflash.flash_block_attention(x[0] * (dp / d) ** 0.5, x[1], x[2],
                                        **kw)
    o = _kernels._caller_result(o, d, torch.float64)
    r = (o * torch.from_numpy(wo)).sum() + (
        torch.where(l > -1e29, l, 0.0) * torch.from_numpy(wl)).sum()
    got = torch.autograd.grad(r, x)
    for name, a, w in zip("qkv", got, want):
        assert a.shape[-1] == dp and torch.all(a[..., d:] == 0), name
        a = _kernels._caller_result(a, d, torch.float64)
        np.testing.assert_allclose(a.numpy(), w, atol=1e-12, rtol=0,
                                   err_msg=name)
