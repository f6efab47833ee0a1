"""The port's CUDA kernels and their paths on the card.

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
from mpi4torch_tpu_torch.utils.tree import tree_leaves, tree_map


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


def bf16_out_bound(ref):
    """Per-element bound on |tc kernel - plain| for a bf16 out: 1e-2, or
    one bf16 ulp of the plain value where that is larger.  Both round
    once to bf16, from f32 sums that differ by the kernel's rounding of p
    to bf16 (as the TPU kernel rounds it), so an element can land one ulp
    apart; at |out| >= 2 one ulp is 2^-6."""
    ulp = torch.pow(2.0, torch.floor(torch.log2(
        ref.float().abs().clamp_min(2.0 ** -126))) - 7)
    return torch.maximum(ulp, torch.full_like(ulp, 1e-2))


# The tensor-core forward's edges: GQA, sq and sk off the 64-row tiles with
# fewer keys than one tile, a window with d = 72 (zero-padded to 128), a
# q offset, non-causal ragged keys (zero-filled keys must be masked),
# fully masked rows, d = 32.
FWD_TC_SHAPES = [(1, 200, 200, 4, 2, 64, 0, 0, 0, True),
                 (2, 77, 150, 4, 4, 128, 73, 0, 0, True),
                 (1, 300, 300, 4, 2, 72, 0, 0, 64, True),
                 (2, 133, 37, 4, 2, 128, 0, 0, 0, True),
                 (2, 130, 70, 4, 2, 128, 0, 0, 0, False),
                 (1, 128, 128, 4, 4, 64, 0, 100, 0, True),
                 (2, 90, 33, 2, 2, 32, 0, 0, 0, False),
                 (1, 256, 256, 16, 4, 128, 0, 0, 0, True)]


@pytest.mark.cuda
def test_tc_forward_matches_plain_and_repeats_its_bits(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    for b, sq, sk, h, h_kv, d, q_off, kv_off, window, causal in \
            FWD_TC_SHAPES:
        q = torch.randn((b, sq, h, d), generator=g, device=cuda,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((b, sk, h_kv, d), generator=g, device=cuda,
                            dtype=torch.bfloat16) for _ in range(2))
        kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off,
                  window=window)
        _kernels.reset_launch_counts()
        o, l = flash.flash_block_attention(q, k, v, impl="cuda", **kw)
        o2, l2 = flash.flash_block_attention(q, k, v, impl="cuda", **kw)
        assert _kernels.launch_counts["flash_fwd.tc"] == 2
        assert _kernels.launch_counts["flash_fwd.simt"] == 0
        po, pl = flash.flash_block_attention(q, k, v, impl="torch", **kw)
        torch.cuda.synchronize()
        assert torch.equal(o, o2) and torch.equal(l, l2)
        assert bool(((o.float() - po.float()).abs()
                     <= bf16_out_bound(po)).all())
        assert (l - pl.float()).abs().max().item() <= 1e-4
        if causal and kv_off > q_off:
            n = kv_off - q_off
            assert bool((o[:, :n] == 0).all())
            assert bool((l[:, :n] == flash.NEG_BIG).all())


@pytest.mark.cuda
def test_tc_forward_takes_rows_off_16_bytes(cuda):
    # q one element into its storage, k/v views of a fused projection:
    # the wrapper copies what is not 16-byte aligned, the result is the
    # same bits as on contiguous operands.
    g = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn((2, 96, 3, 4, 64), generator=g, device=cuda,
                      dtype=torch.bfloat16)
    q = torch.empty(qkv[:, :, 0].numel() + 1, device=cuda,
                    dtype=torch.bfloat16)[1:].view(2, 96, 4, 64)
    q.copy_(qkv[:, :, 0])
    k, v = qkv[:, :, 1], qkv[:, :, 2]
    got = _kernels.flash_fwd(q, k, v, 0, 0, True)
    want = _kernels.flash_fwd(*(t.contiguous() for t in (q, k, v)), 0, 0,
                              True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_kernel_path_never_waits_for_the_device(cuda):
    # Forward and backward through flash_attention with its int offsets
    # queue their work without a host-device synchronisation (an offset
    # tensor's copy to the card would be one, on every layer).
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((2, 160, 4, 64), generator=g, device=cuda,
                           dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        o = flash.flash_attention(q, k, v, causal=True)
        grads = torch.autograd.grad(o.float().square().sum(), (q, k, v))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in grads)
    for name in _kernels.ATTENTION_KERNELS:
        assert _kernels.launch_counts[f"{name}.tc"] == 1, name


@pytest.mark.cuda
def test_forward_simt_by_name_agrees_with_tc(cuda):
    # The CUDA-core forward still takes bf16 at d <= 128 when asked by
    # name (the smoke times it there); both hold the plain version's
    # bound, so they agree within twice it.
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn((1, 160, 4, 128), generator=g, device=cuda,
                           dtype=torch.bfloat16) for _ in range(3))
    _kernels.reset_launch_counts()
    o_tc, l_tc = _kernels.flash_fwd(q, k, v, 0, 0, True)
    o_s, l_s = _kernels.flash_fwd(q, k, v, 0, 0, True, variant="simt")
    torch.cuda.synchronize()
    assert _kernels.launch_counts["flash_fwd.tc"] == 1
    assert _kernels.launch_counts["flash_fwd.simt"] == 1
    assert bool(((o_tc.float() - o_s.float()).abs()
                 <= 2 * bf16_out_bound(o_s)).all())
    assert (l_tc - l_s).abs().max().item() <= 2e-4


@pytest.mark.cuda
def test_bf16_prefill_and_training_step_run_only_the_tc_kernels(cuda):
    cfg = T.TransformerConfig(vocab=97, d_model=128, n_heads=4, n_layers=2,
                              d_ff=256, max_seq=64)
    params = T.init_transformer(0, cfg, torch.bfloat16, device=cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (5, 17, 30)]
    with torch.inference_mode():
        eng = serve.Engine(cfg, params, serve.ServeConfig(slots=2,
                                                          max_new=4))
        for p in prompts:
            eng.submit(p)
        _kernels.reset_launch_counts()
        eng.run()
    want = cfg.n_layers * len(prompts)
    assert _kernels.launch_counts["flash_fwd"] == want
    assert _kernels.launch_counts["flash_fwd.tc"] == want
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))).to(cuda)
    _kernels.reset_launch_counts()
    loss, _ = T.train_step(cfg, params, tokens, lr=1e-2)
    assert bool(torch.isfinite(loss))
    for name in _kernels.ATTENTION_KERNELS:
        assert _kernels.launch_counts[name] == cfg.n_layers, name
        assert _kernels.launch_counts[f"{name}.tc"] == cfg.n_layers, name
        assert _kernels.launch_counts[f"{name}.simt"] == 0, name


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


# The forward's shapes, then the tensor-core backward's edges: GQA 16/4,
# sq and sk off the 64- and 32-row tiles with fewer keys than one tile,
# a window with a q offset, and fully masked rows at d = 64.  In bf16,
# d = 64, 72 and 128 (and 32) take the tc variant, d = 256 the simt one.
BWD_SHAPES = SHAPES + [(1, 256, 256, 16, 4, 128, 0, 0, 0, True),
                       (2, 133, 37, 4, 2, 128, 0, 0, 0, True),
                       (1, 200, 300, 4, 4, 128, 100, 0, 48, True),
                       (1, 128, 128, 4, 4, 64, 0, 100, 0, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_match_plain(cuda, dtype):
    # f32: both sides sum in f32 in other orders (rtol 1e-3, atol 1e-4,
    # the JAX package's own kernel-vs-oracle bound).  bf16: the gradients
    # round once to bf16 from f32 sums over up to 300 keys, and the tc
    # kernels round p and ds to bf16 where they enter a product (as the
    # TPU kernel does), so a few bf16 ulps of the largest gradient (2e-2
    # of max |ref|).
    g = torch.Generator(device=cuda).manual_seed(1)
    for b, sq, sk, h, h_kv, d, q_off, kv_off, window, causal in BWD_SHAPES:
        q = torch.randn((b, sq, h, d), generator=g, device=cuda, dtype=dtype)
        k = torch.randn((b, sk, h_kv, d), generator=g, device=cuda,
                        dtype=dtype)
        v = torch.randn((b, sk, h_kv, d), generator=g, device=cuda,
                        dtype=dtype)
        kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off,
                  window=window)
        variant = _kernels.bwd_variant(dtype, d)
        other = "simt" if variant == "tc" else "tc"
        _kernels.reset_launch_counts()
        got = _grads(q, k, v, "cuda", kw, torch.Generator(
            device=cuda).manual_seed(2))
        for part in ("dq", "dkv"):
            assert _kernels.launch_counts[f"flash_bwd_{part}"] == 1
            assert _kernels.launch_counts[f"flash_bwd_{part}.{variant}"] == 1
            assert _kernels.launch_counts[f"flash_bwd_{part}.{other}"] == 0
        # No atomics: the same inputs give the same bits.
        again = _grads(q, k, v, "cuda", kw, torch.Generator(
            device=cuda).manual_seed(2))
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        want = _grads(q, k, v, "torch", kw, torch.Generator(
            device=cuda).manual_seed(2))
        torch.cuda.synchronize()
        if causal and kv_off > q_off:
            # Queries before the first key and keys after the last query
            # get exactly zero gradients.
            assert bool((got[0][:, :kv_off - q_off] == 0).all())
            for t in got[1:]:
                assert bool((t[:, q_off + sq - kv_off:] == 0).all())
        for a, r in zip(got, want):
            assert a.dtype == r.dtype and a.shape == r.shape
            a, r = a.float(), r.float()
            if dtype == torch.float32:
                torch.testing.assert_close(a, r, rtol=1e-3, atol=1e-4)
            else:
                assert (a - r).abs().max() <= 2e-2 * r.abs().max()


@pytest.mark.cuda
def test_simt_by_name_agrees_with_tc(cuda):
    # The CUDA-core kernels still take bf16 at d <= 128 when asked by
    # name (the smoke times them there); both variants hold the plain
    # backward's tolerance, so they agree within twice it.
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn((1, 160, 4, 128), generator=g, device=cuda,
                               dtype=torch.bfloat16) for _ in range(4))
    out, lse = _kernels.flash_fwd(q, k, v, 0, 0, True)
    dd = (do.float() * out.float()).sum(-1)
    _kernels.reset_launch_counts()
    grads = {}
    for variant in (None, "simt"):
        args = (q, k, v, do, lse, dd, 0, 0, True)
        grads[variant] = [
            _kernels.flash_bwd_dq(*args, variant=variant),
            *_kernels.flash_bwd_dkv(*args, variant=variant)]
    for a, r in zip(grads[None], grads["simt"]):
        a, r = a.float(), r.float()
        assert (a - r).abs().max() <= 4e-2 * r.abs().max()
    assert _kernels.launch_counts["flash_bwd_dq.tc"] == 1
    assert _kernels.launch_counts["flash_bwd_dq.simt"] == 1
    assert _kernels.launch_counts["flash_bwd_dkv.tc"] == 1
    assert _kernels.launch_counts["flash_bwd_dkv.simt"] == 1


@pytest.mark.cuda
def test_tc_variant_refuses_what_it_does_not_take(cuda):
    lse = torch.zeros((1, 8, 2), device=cuda)
    _kernels.reset_launch_counts()
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 256)):
        q = torch.zeros((1, 8, 2, d), device=cuda, dtype=dtype)
        for fn in (_kernels.flash_bwd_dq, _kernels.flash_bwd_dkv):
            with pytest.raises(ValueError, match="'tc' takes bfloat16"):
                fn(q, q, q, q, lse, lse, 0, 0, True, variant="tc")
        with pytest.raises(ValueError, match="'tc' takes bfloat16"):
            _kernels.flash_fwd(q, q, q, 0, 0, True, variant="tc")
    q = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unknown variant"):
        _kernels.flash_bwd_dq(q, q, q, q, lse, lse, 0, 0, True,
                              variant="wgmma")
    with pytest.raises(ValueError, match="unknown variant"):
        _kernels.flash_fwd(q, q, q, 0, 0, True, variant="wgmma")
    assert all(c == 0 for c in _kernels.launch_counts.values())


@pytest.mark.cuda
def test_tc_kernels_do_not_spill_and_fit_two_blocks(cuda):
    for kernel in _kernels.ATTENTION_KERNELS:
        for d in (64, 128):
            props = _kernels.tc_props(kernel, d)
            assert props["local_bytes"] == 0, (kernel, d, props)
            assert props["blocks_per_sm"] >= 2, (kernel, d, props)


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
    # Head dims up to 512 run (a dim off the multiples of 8 zero-padded);
    # wider ones raise.
    bad = torch.zeros((1, 8, 2, 520), device=cuda)
    with pytest.raises(ValueError, match=r"head_dim must be in \[1, 512\]"):
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
    # float64 has no kernel: the refusal names the dtype and ROADMAP.md,
    # and nothing falls back to the plain version.
    _kernels.reset_launch_counts()
    q = torch.zeros((1, 8, 2, 16), device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="float64.*ROADMAP.md"):
        flash.flash_block_attention(q, q, q, impl="auto")
    q = torch.zeros((1, 8, 2, 520), device=cuda)
    with pytest.raises(ValueError, match="head_dim must be in"):
        flash.flash_block_attention(q, q, q, impl="auto")
    assert all(c == 0 for c in _kernels.launch_counts.values())


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


# --- K1: the quantized ring hop (csrc/quant_hop.cu) -------------------------


def _offset_view(t, offset):
    """``t``'s values in a view ``offset`` elements into its storage."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def _hop_operands(nb, block, seed, device, offset=0):
    """q, scale, mine, noise for one hop: int8 payload, power-of-two
    scales, and mine with a zero block, a subnormal block and a block
    whose values are large; each ``offset`` elements into its storage."""
    from mpi4torch_tpu_torch.ops import quant_kernels as qk

    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(-127, 128, (nb, block),
                                      dtype=np.int8))
    scale = qk.po2_scale(torch.from_numpy(
        np.abs(rng.standard_normal(nb)).astype(np.float32) * 0.1 + 1e-3))
    mine = torch.from_numpy(rng.standard_normal((nb, block))
                            .astype(np.float32) * 3.0)
    mine[0] = 0.0
    if nb > 1:
        mine[1] = torch.from_numpy(rng.standard_normal(block)
                                   .astype(np.float32) * 1e-39)
    if nb > 2:
        mine[2] *= 1e30
    noise = torch.from_numpy(rng.random((nb, block), dtype=np.float32))
    return [_offset_view(t.to(device), offset)
            for t in (q, scale, mine, noise)]


def _bits_differ(a, b):
    """Elements whose bits differ (NaN matches NaN)."""
    if a.dtype == torch.float32:
        both_nan = torch.isnan(a) & torch.isnan(b)
        return int(((a.view(torch.int32) != b.view(torch.int32))
                    & ~both_nan).sum())
    return int((a != b).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("block, nb, offset", [(128, 37, 0), (256, 300, 0),
                                               (384, 5, 0), (130, 9, 0),
                                               (256, 12, 1)])
def test_quant_hop_bitwise_equal_to_plain(cuda, block, nb, offset):
    from mpi4torch_tpu_torch.ops import quant_kernels as qk

    q, scale, mine, noise = _hop_operands(nb, block, block + nb, cuda,
                                          offset)
    # a block that is not whole 4-element groups, or operands off their
    # storage's alignment, take the element-by-element path
    assert _kernels.hop_vec(block, [mine, noise], [q]) == \
        (1 if block % 4 or offset else 4)
    for hop0 in (False, True):
        for stochastic in (False, True):
            for want_resid in (False, True):
                args = (None, None) if hop0 else (q, scale)
                nz = noise if stochastic else None
                name = "q8_requant" if hop0 else "q8_hop"
                before = _kernels.launch_counts[name]
                got = qk.dequant_accum_requant(*args, mine, noise=nz,
                                               want_resid=want_resid,
                                               impl="cuda")
                assert _kernels.launch_counts[name] == before + 1
                want = qk.dequant_accum_requant(*args, mine, noise=nz,
                                                want_resid=want_resid,
                                                impl="torch")
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    assert (a is None) == (b is None)
                    if a is not None:
                        assert a.dtype == b.dtype and a.shape == b.shape
                        assert _bits_differ(a, b) == 0, \
                            (hop0, stochastic, want_resid)


@pytest.mark.cuda
def test_quant_hop_non_finite_block_gets_non_finite_scale(cuda):
    from mpi4torch_tpu_torch.ops import quant_kernels as qk

    q, scale, mine, _ = _hop_operands(6, 256, 3, cuda)
    mine[3, 17] = float("nan")
    mine[4, 200] = float("inf")
    got = qk.dequant_accum_requant(q, scale, mine, want_resid=True,
                                   impl="cuda")
    want = qk.dequant_accum_requant(q, scale, mine, want_resid=True,
                                    impl="torch")
    torch.cuda.synchronize()
    assert not torch.isfinite(got[1][3:5]).any()
    assert _bits_differ(got[1], want[1]) == 0
    finite = [0, 1, 2, 5]
    assert _bits_differ(got[0][finite], want[0][finite]) == 0
    assert _bits_differ(got[2][finite], want[2][finite]) == 0


@pytest.mark.cuda
def test_quant_hop_refuses_what_it_does_not_take(cuda):
    m = torch.zeros((4, 256), device=cuda)
    q = torch.zeros((4, 256), dtype=torch.int8, device=cuda)
    s = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="together"):
        _kernels.quant_hop(q, None, m)
    with pytest.raises(ValueError, match="float32"):
        _kernels.quant_hop(None, None, m.double())
    with pytest.raises(ValueError, match="noise"):
        _kernels.quant_hop(q, s, m, noise=m[:, :128])
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.quant_hop(q, s, m.t().contiguous().t())


@pytest.mark.cuda
def test_threefry_noise_on_the_card_equals_the_cpu(cuda):
    from mpi4torch_tpu_torch.ops import quant_kernels as qk

    for salt, hop, rank, shape in [(0, 0, 0, (7, 256)), (3, 2, 1, (33, 5)),
                                   (5, 7, 3, (1, 1))]:
        key = qk.schedule_key(salt, hop, rank)
        a = qk.hop_noise(key, *shape, device=cuda).cpu()
        b = qk.hop_noise(key, *shape)
        assert _bits_differ(a, b) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["q8", "q8_ef", "q8_ef_hop"])
@pytest.mark.parametrize("n, numel", [(3, 5000), (2, 1025)])
def test_compressed_allreduce_on_the_kernel_equals_plain(cuda, codec, n,
                                                         numel):
    # At 2 x 1025, bidir's channel 1 starts at float 513 and fills its
    # chunks exactly: its hops read views that are only 4-byte aligned.
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch import config

    xs = [torch.from_numpy(np.random.default_rng(r).standard_normal(numel)
                           .astype(np.float32)).to(cuda) for r in range(n)]

    def run():
        def body(r):
            x = xs[r].clone().requires_grad_()
            y = P.COMM_WORLD.Allreduce(x, P.MPI_SUM, compression=codec,
                                       algorithm="bidir")
            (g,) = torch.autograd.grad((y * y).sum(), x)
            return y.detach(), g
        return P.run_ranks(body, n, timeout=30.0, device=cuda)

    _kernels.reset_launch_counts()
    got = run()
    assert _kernels.launch_counts["q8_hop"] > 0
    config.set_quant_hop_impl("torch")
    try:
        _kernels.reset_launch_counts()
        want = run()
        assert _kernels.launch_counts["q8_hop"] == 0
    finally:
        config.set_quant_hop_impl("auto")
    for (y, g), (yw, gw) in zip(got, want):
        assert torch.equal(y, got[0][0]) and torch.equal(g, got[0][1])
        assert _bits_differ(y, yw) == 0 and _bits_differ(g, gw) == 0


# ---------------------------------------------------------------------------
# The attention kernels take every shape and dtype the JAX package serves:
# head dims off the multiples of 8 (zero-padded) and up to 512, more than
# 65535 batch x heads, float16 (run in float32).  Nothing falls back to the
# plain version: each case launches its variant's kernels once.

def _ulp_bound(ref, mantissa_bits, floor):
    """One ulp of the plain value in a type with ``mantissa_bits``, or
    ``floor`` where that is larger: kernel and plain round once from f32
    sums that differ in the last f32 bits, so an element may land one ulp
    of its type apart."""
    ulp = torch.pow(2.0, torch.floor(torch.log2(
        ref.float().abs().clamp_min(2.0 ** -126))) - mantissa_bits)
    return torch.clamp_min(ulp, floor)


# (name, dtype, b, sq, sk, h, h_kv, d, variant)
REPAIR_CASES = [
    ("d12_f32", torch.float32, 1, 70, 70, 4, 2, 12, "simt"),
    ("d12_bf16", torch.bfloat16, 1, 70, 70, 4, 2, 12, "tc"),
    ("d4_f32", torch.float32, 2, 33, 40, 2, 2, 4, "simt"),
    ("d264_f32", torch.float32, 1, 100, 100, 2, 1, 264, "simt"),
    ("d264_bf16", torch.bfloat16, 1, 100, 100, 2, 1, 264, "simt"),
    ("d260_f32", torch.float32, 1, 40, 40, 2, 2, 260, "simt"),
    ("d512_f32", torch.float32, 1, 50, 50, 2, 2, 512, "simt"),
    ("f16", torch.float16, 1, 90, 90, 4, 4, 64, "simt"),
    ("f16_d12", torch.float16, 1, 40, 40, 2, 2, 12, "simt"),
    ("bh_65540_f32", torch.float32, 16385, 8, 8, 4, 4, 8, "simt"),
    ("bh_65540_bf16", torch.bfloat16, 16385, 8, 8, 4, 4, 8, "tc"),
]


def _out_bound(ref, dtype):
    if dtype == torch.bfloat16:
        return bf16_out_bound(ref)
    if dtype == torch.float16:
        return _ulp_bound(ref, 10, 2e-5)
    return torch.full_like(ref.float(), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", REPAIR_CASES, ids=[c[0] for c in
                                                    REPAIR_CASES])
def test_repaired_shapes_and_dtypes_run_on_the_kernels(cuda, case):
    name, dtype, b, sq, sk, h, h_kv, d, variant = case
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda, dtype=dtype)
    k, v = (torch.randn((b, sk, h_kv, d), generator=g, device=cuda,
                        dtype=dtype) for _ in range(2))
    wo = torch.randn(q.shape, generator=g, device=cuda, dtype=dtype)
    kw = dict(causal=True, q_offset=sk - sq, kv_offset=0, window=0)
    assert _kernels.fwd_variant(dtype, d) == variant
    x = [t.detach().requires_grad_() for t in (q, k, v)]
    _kernels.reset_launch_counts()
    o, l = flash.flash_block_attention(*x, impl="cuda", **kw)
    got = torch.autograd.grad((o.float() * wo.float()).sum(), x)
    for kname in _kernels.ATTENTION_KERNELS:
        assert _kernels.launch_counts[kname] == 1, kname
        assert _kernels.launch_counts[f"{kname}.{variant}"] == 1, kname
    y = [t.detach().requires_grad_() for t in (q, k, v)]
    po, pl = flash.flash_block_attention(*y, impl="torch", **kw)
    want = torch.autograd.grad((po.float() * wo.float()).sum(), y)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape and l.dtype == torch.float32
    assert bool(((o.float() - po.float()).abs()
                 <= _out_bound(po, dtype)).all()), name
    assert (l - pl.float()).abs().max().item() <= 1e-4, name
    for a, r in zip(got, want):
        assert a.dtype == r.dtype == dtype and a.shape == r.shape
        a, r = a.float(), r.float()
        if dtype == torch.bfloat16:
            assert (a - r).abs().max().item() <= 2e-2 * r.abs().max().item()
        else:
            assert bool(((a - r).abs() <= 1e-4 + 1e-3 * r.abs()).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("d_model, n_heads", [(48, 4), (528, 2)],
                         ids=["head_dim_12", "head_dim_264"])
def test_transformer_with_off_grid_head_dims_trains_on_the_kernels(
        cuda, d_model, n_heads):
    cfg = T.TransformerConfig(vocab=97, d_model=d_model, n_heads=n_heads,
                              n_layers=2, d_ff=2 * d_model, max_seq=64)
    # The generators of the two devices draw different numbers: initialise
    # on the CPU and copy to the card.
    host = T.init_transformer(0, cfg, torch.float32, device="cpu")
    params = tree_map(lambda t: t.to(cuda), host)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 64))).to(cuda)
    _kernels.reset_launch_counts()
    loss, new = T.train_step(cfg, params, tokens, lr=1e-2)
    for kname in _kernels.ATTENTION_KERNELS:
        assert _kernels.launch_counts[f"{kname}.simt"] == cfg.n_layers
    loss_c, new_c = T.train_step(cfg, host, tokens.cpu(), lr=1e-2)
    assert abs(loss.item() - loss_c.item()) <= 1e-5 * abs(loss_c.item())
    for a, b in zip(tree_leaves(new), tree_leaves(new_c)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The op table on the card: every collective of COMM_WORLD, the exact
# Allreduce on every algorithm, ring_shift and halo_exchange, value and
# gradient of vdot(out, w_r) on four rank threads, bitwise equal to the
# same program on the CPU (the folds are elementwise adds in one fixed
# association, and the gradients are moves and such adds too).

def _tri(n):
    return n * (n + 1) // 2


def _card_ops():
    from mpi4torch_tpu_torch import MPI_SUM as SUM
    from mpi4torch_tpu_torch.parallel.ring import halo_exchange, ring_shift

    ops = {
        "bcast_ring": (lambda c, t, r: c.Bcast_(t, 1), lambda r, n: (40,),
                       lambda r, n: (40,)),
        "bcast_tree": (lambda c, t, r: c.Bcast_(t, 1, algorithm="tree"),
                       lambda r, n: (40,), lambda r, n: (40,)),
        "reduce_ring": (lambda c, t, r: c.Reduce_(t, SUM, 1),
                        lambda r, n: (40,), lambda r, n: (40,)),
        "reduce_tree": (lambda c, t, r: c.Reduce_(t, SUM, 1, algorithm="tree"),
                        lambda r, n: (40,), lambda r, n: (40,)),
        "gather": (lambda c, t, r: c.Gather(t, 0, 2), lambda r, n: (r + 3, 5),
                   lambda r, n: (_tri(n) + 2 * n, 5)),
        "scatter": (lambda c, t, r: c.Scatter(t, 0, r + 1, 2),
                    lambda r, n: (_tri(n), 5) if r == 2 else (1,),
                    lambda r, n: (r + 1, 5)),
        "allgather": (lambda c, t, r: c.Allgather(t, 1),
                      lambda r, n: (3, r + 1), lambda r, n: (3, _tri(n))),
        "reduce_scatter": (lambda c, t, r: c.Reduce_scatter(t, SUM, 0),
                           lambda r, n: (4 * n, 3), lambda r, n: (4, 3)),
        "alltoall": (lambda c, t, r: c.Alltoall(t, 0, 1, r + 1),
                     lambda r, n: (r + 1, _tri(n)),
                     lambda r, n: (_tri(n), r + 1)),
        "ring_shift": (lambda c, t, r: ring_shift(c, t, 1),
                       lambda r, n: (33,), lambda r, n: (33,)),
        "halo_exchange": (lambda c, t, r: halo_exchange(c, t, 1, axis=0),
                          lambda r, n: (6, 7), lambda r, n: (8, 7)),
    }
    for algo in ("ring", "rhd", "tree", "hier", "bidir", "torus"):
        ops[f"allreduce_{algo}"] = (
            lambda c, t, r, a=algo: c.Allreduce(t, SUM, algorithm=a),
            lambda r, n: (1001,), lambda r, n: (1001,))
    return ops


CARD_RANKS = 4


def _card_inputs(ops):
    rng = np.random.default_rng(21)
    return {name: ([rng.standard_normal(i(r, CARD_RANKS)).astype(np.float32)
                    for r in range(CARD_RANKS)],
                   [rng.standard_normal(o(r, CARD_RANKS)).astype(np.float32)
                    for r in range(CARD_RANKS)])
            for name, (_, i, o) in ops.items()}


def _run_card_ops(device, ops, inputs):
    """Per rank, per op: (value, gradient), left on ``device``."""
    import mpi4torch_tpu_torch as P

    def body(r):
        out = {}
        for name, (op, _, _) in ops.items():
            xs, ws = inputs[name]
            t = torch.from_numpy(xs[r]).to(device).requires_grad_()
            w = torch.from_numpy(ws[r]).to(device)
            y = op(P.COMM_WORLD, t, r)
            (g,) = torch.autograd.grad(torch.vdot(y.reshape(-1),
                                                  w.reshape(-1)), t)
            out[name] = (y.detach(), g)
        return out

    return P.run_ranks(body, CARD_RANKS, timeout=60.0, device=device)


@pytest.mark.cuda
def test_op_table_on_the_card_is_bitwise_the_cpu_run(cuda):
    ops = _card_ops()
    inputs = _card_inputs(ops)
    got = _run_card_ops(cuda, ops, inputs)
    want = _run_card_ops(torch.device("cpu"), ops, inputs)
    for name in ops:
        for r in range(CARD_RANKS):
            for a, b in zip(got[r][name], want[r][name]):
                assert a.is_cuda and torch.equal(a.cpu(), b), (name, r)
        # Each rank's value is its own buffer (Reduce_'s non-root zeros
        # and Gather's included).
        ptrs = [got[r][name][0].data_ptr() for r in range(CARD_RANKS)]
        assert len(set(ptrs)) == CARD_RANKS, name


@pytest.mark.cuda
def test_op_table_never_waits_for_the_device(cuda):
    ops = _card_ops()
    inputs = {name: ([torch.from_numpy(x).to(cuda) for x in xs],
                     [torch.from_numpy(w).to(cuda) for w in ws])
              for name, (xs, ws) in _card_inputs(ops).items()}
    import mpi4torch_tpu_torch as P

    def body(r):
        out = []
        for name, (op, _, _) in ops.items():
            xs, ws = inputs[name]
            t = xs[r].detach().requires_grad_()
            y = op(P.COMM_WORLD, t, r)
            (g,) = torch.autograd.grad(torch.vdot(y.reshape(-1),
                                                  ws[r].reshape(-1)), t)
            out.append((name, y.detach(), g))
        return out

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = P.run_ranks(body, CARD_RANKS, timeout=60.0, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert [n for n, _, _ in res[0]] == list(ops)
    assert all(bool(torch.isfinite(t).all()) for rr in res
               for _, y, g in rr for t in (y, g))


# ---------------------------------------------------------------------------
# The packed and ragged collectives, the fused and split-phase trees, ZeRO
# and the decode overlap window on the card.


def _packed_ops():
    from mpi4torch_tpu_torch.ops import ragged

    counts = (5, 0, 7, 3)
    cap, total = max(counts), sum(counts)
    new = tuple(reversed(counts))
    sends = [[(r + d) % 4 for d in range(4)] for r in range(4)]

    def dev(t, like):
        return torch.as_tensor(t, device=like.device)

    return {
        "gather": (lambda c, t, r: c.Gather(t, 0, 2, numelem=counts),
                   (cap, 3)),
        "allgather": (lambda c, t, r: c.Allgather(t, 0, numelem=counts),
                      (cap, 3)),
        "scatter": (lambda c, t, r: c.Scatter(t, 0, counts, 1), (total, 2)),
        "alltoall_same_axis": (
            lambda c, t, r: c.Alltoall(t, 0, 0, new,
                                       current_numelem=counts), (cap, 2)),
        "alltoall_axes": (lambda c, t, r: c.Alltoall(t, 1, 0, counts),
                          (total, cap)),
        "ragged_alltoall": (lambda c, t, r: ragged.ragged_alltoall(
            c, t, dev(sends[r], t))[0], (4, 3, 2)),
        "ragged_allgather": (lambda c, t, r: ragged.ragged_allgather(
            c, t, dev(counts[r], t))[0], (cap, 2)),
        "ragged_gather": (lambda c, t, r: ragged.ragged_gather(
            c, t, dev(counts[r], t), root=3)[0], (cap, 2)),
        "ragged_scatter": (lambda c, t, r: ragged.ragged_scatter(
            c, t, dev([3, 1, 0, 2], t), root=0)[0], (4, 3, 2)),
    }


@pytest.mark.cuda
def test_packed_and_ragged_on_the_card_are_bitwise_the_cpu_run(cuda):
    import mpi4torch_tpu_torch as P

    ops = _packed_ops()
    rng = np.random.default_rng(5)
    xs = {k: [rng.standard_normal(shape).astype(np.float32)
              for _ in range(4)] for k, (_, shape) in ops.items()}

    def run(device):
        def body(r):
            out = {}
            for name, (op, _) in ops.items():
                t = torch.from_numpy(xs[name][r]).to(device) \
                    .requires_grad_()
                y = op(P.COMM_WORLD, t, r)
                w = torch.arange(y.numel(), device=device,
                                 dtype=y.dtype).reshape(y.shape) * 0.25 - r
                (g,) = torch.autograd.grad((y * w).sum(), t)
                out[name] = (y.detach(), g)
            return out
        return P.run_ranks(body, 4, timeout=60.0, device=device)

    got, want = run(cuda), run(torch.device("cpu"))
    for r in range(4):
        for name in ops:
            for a, b in zip(got[r][name], want[r][name]):
                assert a.is_cuda and torch.equal(a.cpu(), b), (name, r)


@pytest.mark.cuda
@pytest.mark.parametrize("bucket_bytes", [1024, 1 << 20])
def test_fused_q8_tree_on_the_kernel_equals_plain_and_the_cpu(cuda,
                                                              bucket_bytes):
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch import config, fuse

    rng = np.random.default_rng(9)
    trees = [{"a": rng.standard_normal(700).astype(np.float32),
              "b": rng.standard_normal((9, 31)).astype(np.float32),
              "c": rng.standard_normal(5).astype(np.float32)}
             for _ in range(2)]
    nb = fuse.bucket_layout({k: torch.from_numpy(v)
                             for k, v in trees[0].items()},
                            bucket_bytes).num_buckets

    def run(device):
        def body(r):
            t = {k: torch.from_numpy(v).to(device)
                 for k, v in trees[r].items()}
            return P.COMM_WORLD.Allreduce_tree(
                t, P.MPI_SUM, compression="q8", bucket_bytes=bucket_bytes,
                mean=True)
        return P.run_ranks(body, 2, timeout=30.0, device=device)

    _kernels.reset_launch_counts()
    got = run(cuda)
    assert _kernels.launch_counts["q8_hop"] == 2 * nb
    config.set_quant_hop_impl("torch")
    try:
        plain = run(cuda)
    finally:
        config.set_quant_hop_impl("auto")
    cpu = run(torch.device("cpu"))
    for g, p, c in zip(got, plain, cpu):
        for k in g:
            assert _bits_differ(g[k], got[0][k]) == 0
            assert _bits_differ(g[k], p[k]) == 0
            assert torch.equal(g[k].cpu(), c[k])


@pytest.mark.cuda
def test_fused_overlap_split_phase_and_zero_on_the_card(cuda):
    # Fused exact (blocking and the Isend/Irecv pipeline), split-phase
    # handles and ZeRO-1 with adam on the card: bitwise their blocking,
    # per-leaf and replicated forms.  The sums are also bitwise the CPU
    # run's; a division by a scalar is not (CUDA multiplies by the
    # reciprocal), so the means and Adam are held on the card only.
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch.parallel import zero as Z
    from mpi4torch_tpu_torch.utils import optim

    rng = np.random.default_rng(13)
    trees = [{"w": rng.standard_normal((40, 7)).astype(np.float32),
              "b": rng.standard_normal(13).astype(np.float32)}
             for _ in range(3)]

    def run(device):
        def body(r):
            c = P.COMM_WORLD
            t = {k: torch.from_numpy(v).to(device).requires_grad_()
                 for k, v in trees[r].items()}
            outs = []
            for kw in (dict(bucket_bytes=0), dict(bucket_bytes=64),
                       dict(bucket_bytes=64, overlap=True)):
                y = c.Allreduce_tree(t, P.MPI_SUM, **kw)
                g = torch.autograd.grad(sum((v * v).sum()
                                            for v in y.values()),
                                        list(t.values()))
                outs.append([v.detach() for v in y.values()] + list(g))
            x = t["w"].detach()
            outs.append([c.Wait(c.Allreduce_start(x, P.MPI_SUM)),
                         c.Wait(c.Reduce_scatter_start(x[:39], P.MPI_SUM,
                                                       0)),
                         c.Wait(c.Allgather_start(x, 0))])
            opt = optim.adam(1e-2)
            p = {k: torch.from_numpy(v).to(device)
                 for k, v in trees[0].items()}           # replicated
            g = {k: v.detach() for k, v in t.items()}    # rank-local
            st = Z.zero_init(c, opt, p)
            p1, _ = Z.zero_step(c, opt, p, g, st)
            rep_g = c.Allreduce_tree(g, P.MPI_SUM, mean=True)
            upd, _ = opt.update(rep_g, opt.init(p), p)
            outs.append(list(p1.values())
                        + [a + b for a, b in zip(p.values(),
                                                 upd.values())])
            return outs
        return P.run_ranks(body, 3, timeout=60.0, device=device)

    got, cpu = run(cuda), run(torch.device("cpu"))
    for r in range(3):
        leaf, fused, pipe, split, zero = got[r]
        assert all(torch.equal(a, b) for a, b in zip(fused, leaf))
        assert all(torch.equal(a, b) for a, b in zip(pipe, leaf))
        assert all(torch.equal(a, b) for a, b in zip(zero[:2], zero[2:]))
        for a, b in zip(sum(got[r][:4], []), sum(cpu[r][:4], [])):
            assert a.is_cuda and torch.equal(a.cpu(), b)
        assert split[0].shape == (40, 7) and split[2].shape == (120, 7)


@pytest.mark.cuda
def test_decode_overlap_and_rhd_on_the_card(cuda):
    import mpi4torch_tpu_torch as P

    cfg = T.TransformerConfig(vocab=61, d_model=32, n_heads=4, n_layers=2,
                              d_ff=64, max_seq=32)
    params = T.init_transformer(0, cfg, torch.float32, device=cuda)

    def body():
        c = P.COMM_WORLD
        shards = serve.shard_params_tp(cfg, params, c)
        outs = []
        for kw in (dict(), dict(overlap=True), dict(algorithm="rhd"),
                   dict(overlap=3, algorithm="rhd")):
            cache = serve.init_kv_cache_tp(cfg, 2, c.size, torch.float32,
                                           cuda)
            for t in range(3):
                logits, cache = serve.decode_step_tp(
                    cfg, shards, cache,
                    torch.tensor([5 + t, 9 + t], device=cuda),
                    torch.tensor([t, t], device=cuda), c, **kw)
            outs.append(logits)
        return outs

    for outs in P.run_ranks(body, 2, timeout=60.0, device=cuda):
        assert all(torch.equal(o, outs[0]) for o in outs)
