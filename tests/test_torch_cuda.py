"""The port's CUDA kernels and their paths on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one.
The file imports nothing of JAX, so on a GPU machine without JAX it runs
on its own, past the suite's JAX-configuring conftest::

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses

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


# The warpgroup-MMA backward (K3 in 128-row q tiles, two to a block; K4
# in 128-key KV tiles against 64-row q tiles) at the shapes the main path
# gives it: (name, b, sq, sk, h, h_kv, d, q_off, kv_off, window, causal,
# live dlse).  The LM cell's GQA block, the ViT cell's 196-patch block,
# sequence-parallel blocks (a q offset with a window; a block wholly in
# the future), a head dim of 72 zero-padded to 128, and sq / sk off every
# tile (fewer keys than one K3 tile, one q row past a K4 tile).
TC_BWD_CASES = [
    ("lm_gqa", 2, 4096, 4096, 32, 8, 128, 0, 0, 0, True, False),
    ("vit", 64, 196, 196, 12, 12, 64, 0, 0, 0, False, False),
    ("sp_window_offset", 1, 200, 300, 4, 4, 128, 100, 0, 48, True, True),
    ("sp_masked", 2, 512, 512, 8, 8, 128, 0, 512, 0, True, True),
    ("d72_window", 1, 300, 300, 4, 2, 72, 0, 0, 64, True, True),
    ("ragged", 3, 333, 41, 4, 2, 128, 0, 0, 0, True, True),
    ("ragged_non_causal", 2, 65, 201, 6, 3, 64, 0, 0, 0, False, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_BWD_CASES, ids=[c[0] for c in TC_BWD_CASES])
def test_tc_backward_at_main_path_shapes(cuda, case):
    # Held to the plain backward within the bf16 bound of
    # test_backward_kernels_match_plain (2e-2 of max |ref|: p and ds round
    # to bf16 where they enter a product, the gradients once at the end),
    # one tc launch of each kernel, and a masked block's exact zeros.
    name, b, sq, sk, h, h_kv, d, q_off, kv_off, window, causal, live = case
    g = torch.Generator(device=cuda).manual_seed(21)
    bf = torch.bfloat16
    q, do = (torch.randn((b, sq, h, d), generator=g, device=cuda, dtype=bf)
             for _ in range(2))
    k, v = (torch.randn((b, sk, h_kv, d), generator=g, device=cuda,
                        dtype=bf) for _ in range(2))
    dlse = (torch.randn((b, sq, h), generator=g, device=cuda) if live
            else None)
    out, lse = _kernels.flash_fwd(q, k, v, q_off, kv_off, causal, window)
    dd = (do.float() * out.float()).sum(-1)
    if dlse is not None:
        dd = dd - dlse
    args = (q, k, v, do, lse, dd, q_off, kv_off, causal, window)
    _kernels.reset_launch_counts()
    got = [_kernels.flash_bwd_dq(*args), *_kernels.flash_bwd_dkv(*args)]
    for part in ("dq", "dkv"):
        assert _kernels.launch_counts[f"flash_bwd_{part}"] == 1
        assert _kernels.launch_counts[f"flash_bwd_{part}.tc"] == 1
    off = [torch.tensor(x, dtype=torch.int32, device=cuda)
           for x in (q_off, kv_off)]
    want = flash._torch_block_bwd(q, k, v, out, lse, do, dlse, *off, causal,
                                  window)
    torch.cuda.synchronize()
    for a, r in zip(got, want):
        assert a.dtype == r.dtype and a.shape == r.shape
        assert bool(torch.isfinite(a).all())
        a, r = a.float(), r.float()
        assert (a - r).abs().max() <= 2e-2 * r.abs().max()
    if _kernels.block_masked(sq, sk, q_off, kv_off, causal, window):
        assert all(bool((t == 0).all()) for t in got)


@pytest.mark.cuda
def test_tc_backward_repeats_its_bits(cuda):
    # No atomics anywhere: dq sums each q tile inside one block and dk/dv
    # each KV tile (over its GQA group, in a fixed order) inside one block,
    # so two launches on the same inputs give the same bits.
    g = torch.Generator(device=cuda).manual_seed(22)
    bf = torch.bfloat16
    q, do = (torch.randn((4, 2048, 16, 128), generator=g, device=cuda,
                         dtype=bf) for _ in range(2))
    k, v = (torch.randn((4, 2048, 4, 128), generator=g, device=cuda,
                        dtype=bf) for _ in range(2))
    out, lse = _kernels.flash_fwd(q, k, v, 0, 0, True)
    dd = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, dd, 0, 0, True)
    first = [_kernels.flash_bwd_dq(*args), *_kernels.flash_bwd_dkv(*args)]
    second = [_kernels.flash_bwd_dq(*args), *_kernels.flash_bwd_dkv(*args)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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
    # The forward runs two blocks of four MMA warps on an SM; each backward
    # block is three warpgroups (a producer and two consumers, which take
    # the producer's registers) and must fit one.
    for kernel in _kernels.ATTENTION_KERNELS:
        for d in (64, 128):
            props = _kernels.tc_props(kernel, d)
            assert props["local_bytes"] == 0, (kernel, d, props)
            want = 2 if kernel == "flash_fwd" else 1
            assert props["blocks_per_sm"] >= want, (kernel, d, props)


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
        b = qk.hop_noise(key, *shape, device="cpu")
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
    # per-leaf and replicated forms, and bitwise the CPU run's, the
    # means and Adam included (they divide by 0-d device tensors).
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
        for a, b in zip(sum(got[r], []), sum(cpu[r], [])):
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


# --- sampled decoding and the paged engine ---------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_draw_on_the_card_is_the_row_by_row_draw(cuda, dtype):
    from mpi4torch_tpu_torch.utils import threefry

    keys = [threefry.split(threefry.PRNGKey(s))[1] for s in range(4)]
    table = torch.tensor(keys, dtype=torch.int64, device=cuda)
    noise = threefry.gumbel(table, (32768,), dtype)
    logits = torch.randn((4, 32768), device=cuda).to(dtype)
    toks = T.select_token(logits, table, 0.8, 50)
    for r, key in enumerate(keys):
        own = threefry.gumbel(key, (1, 32768), dtype, device=cuda)[0]
        assert torch.equal(noise[r], own)
        assert int(toks[r]) == int(T.select_token(logits[r:r + 1], key, 0.8,
                                                  50)[0])
        # The uniforms under the noise are the CPU's, bit for bit.
        u = threefry.uniform(key, (32768,), dtype, device=cuda)
        assert torch.equal(u.cpu(), threefry.uniform(key, (32768,), dtype,
                                                     device="cpu"))


# Prefill chunks on K2: a 256-row chunk at q_off 256/512/768/1024 against
# q_off + 256 keys, and the 36-row last chunk of a 1316-token prompt.
CHUNK_SHAPES = [(256, q_off) for q_off in (256, 512, 768, 1024)] + \
    [(36, 1280)]


@pytest.mark.cuda
def test_prefill_chunk_shapes_on_the_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    n = 1316
    q, k, v = (torch.randn((1, n, 16, 128), generator=g, device=cuda,
                           dtype=torch.bfloat16) for _ in range(3))
    full, full_lse = flash.flash_block_attention(q, k, v, causal=True)
    for rows, q_off in CHUNK_SHAPES:
        hi = q_off + rows
        _kernels.reset_launch_counts()
        o, lse = flash.flash_block_attention(q[:, q_off:hi], k[:, :hi],
                                             v[:, :hi], causal=True,
                                             q_offset=q_off)
        assert _kernels.launch_counts["flash_fwd.tc"] == 1
        assert _kernels.launch_counts["flash_fwd.q_off"] == 1
        po, pl = flash.flash_block_attention(q[:, q_off:hi], k[:, :hi],
                                             v[:, :hi], causal=True,
                                             q_offset=q_off, impl="torch")
        assert ((o.float() - po.float()).abs() <= bf16_out_bound(po)).all()
        assert (lse - pl.float()).abs().max().item() <= 1e-4
        # Fully masked key tiles add nothing: the chunk's rows are the
        # one-shot rows, bit for bit.
        assert torch.equal(o, full[:, q_off:hi])
        assert torch.equal(lse, full_lse[:, q_off:hi])


@pytest.mark.cuda
def test_paged_sampled_engine_on_the_card(cuda):
    from mpi4torch_tpu_torch.utils import threefry

    cfg = T.TransformerConfig(vocab=97, d_model=128, n_heads=4, n_layers=2,
                              d_ff=256, max_seq=64)
    params = T.init_transformer(0, cfg, torch.bfloat16, device=cuda)
    rng = np.random.default_rng(0)
    base = rng.integers(0, cfg.vocab, size=21)
    prompts = [base, np.concatenate([base, rng.integers(0, 97, 9)]),
               rng.integers(0, cfg.vocab, size=40), base.copy()]
    scfg = serve.ServeConfig(slots=2, max_new=8, block_size=8, num_blocks=16,
                             prefill_chunk=16, temperature=0.8, top_k=20)
    with torch.inference_mode():
        eng = serve.Engine(cfg, params, scfg)
        for i, p in enumerate(prompts):
            eng.submit(p, key=threefry.PRNGKey(50 + i))
        _kernels.reset_launch_counts()
        res = eng.run()
        snap = eng.stats.snapshot()
        assert _kernels.launch_counts["flash_fwd"] == \
            _kernels.launch_counts["flash_fwd.tc"] > 0
        assert _kernels.launch_counts["flash_fwd.q_off"] > 0
        assert snap["prefix_hits"] >= 1 and snap["cow_copies"] >= 1
        assert snap["blocks_in_use"] == 0
        for i, p in enumerate(prompts):
            assert len(res[i]) == len(p) + 8
            assert res[i][:len(p)].tolist() == p.tolist()


# Sequence-parallel blocks (all causal): (name, b, sq, sk, h, h_kv, d,
# q_off, kv_off).  The ring chunk at SP = 2: its past block (every pair
# live), a block wholly in the future, the diagonal at a nonzero offset;
# zigzag's half chunks; Ulysses' full sequence over half the heads.
SP_BLOCKS = [("ring_past", 8, 1024, 1024, 16, 16, 128, 1024, 0),
             ("ring_masked", 8, 1024, 1024, 16, 16, 128, 0, 1024),
             ("ring_diag", 8, 1024, 1024, 16, 16, 128, 1024, 1024),
             ("zigzag_hi_past", 8, 512, 512, 16, 16, 128, 1536, 512),
             ("zigzag_hi_diag", 8, 512, 512, 16, 16, 128, 1536, 1536),
             ("ulysses", 8, 2048, 2048, 8, 8, 128, 0, 0)]


def _sp_grads(q, k, v, wo, wl, impl, kw):
    """dq, dk, dv of sum(out * wo) + sum(lse * wl): the lse term makes
    dlse nonzero, as the ring's merge does."""
    x = [t.detach().requires_grad_() for t in (q, k, v)]
    o, l = flash.flash_block_attention(*x, impl=impl, **kw)
    loss = (o.float() * wo.float()).sum() + (l.float() * wl).sum()
    return o.detach(), l.detach(), torch.autograd.grad(loss, x)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SP_BLOCKS, ids=[c[0] for c in SP_BLOCKS])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sp_blocks_on_the_kernels_with_live_dlse(cuda, case, dtype):
    name, b, sq, sk, h, h_kv, d, q_off, kv_off = case
    if dtype == torch.float32:
        b = 2       # the simt kernels, at a quarter of the batch
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda, dtype=dtype)
    k, v = (torch.randn((b, sk, h_kv, d), generator=g, device=cuda,
                        dtype=dtype) for _ in range(2))
    wo = torch.randn(q.shape, generator=g, device=cuda, dtype=dtype)
    wl = torch.randn(q.shape[:3], generator=g, device=cuda)
    kw = dict(causal=True, q_offset=q_off, kv_offset=kv_off)
    masked = _kernels.block_masked(sq, sk, q_off, kv_off, True)
    assert masked == (name == "ring_masked")
    _kernels.reset_launch_counts()
    o, l, got = _sp_grads(q, k, v, wo, wl, "cuda", kw)
    for kname in _kernels.ATTENTION_KERNELS:
        assert _kernels.launch_counts[kname] == 1
        assert _kernels.launch_counts[f"{kname}.offset"] == int(
            q_off != 0 or kv_off != 0)
        assert _kernels.launch_counts[f"{kname}.masked"] == int(masked)
    po, pl, want = _sp_grads(q, k, v, wo, wl, "torch", kw)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        assert bool(((o.float() - po.float()).abs()
                     <= bf16_out_bound(po)).all())
    else:
        assert (o - po).abs().max().item() <= 1e-5
    assert (l - pl.float()).abs().max().item() <= 1e-4
    for a, r in zip(got, want):
        assert bool(torch.isfinite(a).all())
        e = (a.float() - r.float()).abs().max().item()
        if dtype == torch.bfloat16:
            assert e <= 2e-2 * r.float().abs().max().item()
        else:
            assert bool(((a - r).abs() <= 1e-4 + 1e-3 * r.abs()).all())
    if masked:
        # A block wholly in the future: out 0, lse -1e30 and exactly zero
        # gradients, so the merge gives it weight 0.
        assert bool((o == 0).all()) and bool((l == flash.NEG_BIG).all())
        assert all(bool((t == 0).all()) for t in got)


@pytest.mark.cuda
def test_sp_views_run_in_place_on_the_kernels(cuda):
    # Zigzag hands the kernels its halves q[:, :c] / q[:, c:] as views
    # (batch stride 2c rows); they take strides, so a view gives the bits
    # of its contiguous copy, forward and backward.
    g = torch.Generator(device=cuda).manual_seed(12)
    full = [torch.randn((4, 1024, 16, 128), generator=g, device=cuda,
                        dtype=torch.bfloat16) for _ in range(3)]
    wo = torch.randn((4, 512, 16, 128), generator=g, device=cuda,
                     dtype=torch.bfloat16)
    wl = torch.randn((4, 512, 16), generator=g, device=cuda)
    kw = dict(causal=True, q_offset=1536, kv_offset=0)
    views = [full[0][:, 512:], full[1][:, :512], full[2][:, :512]]
    assert not any(t.is_contiguous() for t in views)
    assert all(_kernels._rows_aligned(t) is t for t in views)
    got = _sp_grads(*views, wo, wl, "cuda", kw)
    want = _sp_grads(*(t.contiguous() for t in views), wo, wl, "cuda", kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("attn", ["ring", "zigzag", "ulysses"])
def test_sp_lm_loss_on_two_rank_threads_matches_one_device(cuda, attn):
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch.parallel import zigzag_positions
    from mpi4torch_tpu_torch.parallel.dp import all_average_tree
    from mpi4torch_tpu_torch.utils.tree import value_and_grad

    cfg = T.TransformerConfig(vocab=256, d_model=256, n_heads=4,
                              n_layers=2, d_ff=512, max_seq=512)
    params = T.init_transformer(0, cfg, torch.float32, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 512))).to(cuda)
    pos = zigzag_positions(2, 256)

    def local(r):
        return tokens[:, pos[r]] if attn == "zigzag" else \
            tokens[:, r * 256:(r + 1) * 256]

    def body(r):
        c = P.COMM_WORLD
        return value_and_grad(lambda p: T.lm_loss(
            cfg, all_average_tree(c, p), local(r), comm_sp=c, attn=attn),
            params)

    _kernels.reset_launch_counts()
    (l0, g0), (l1, g1) = P.run_ranks(body, 2, device=cuda)
    counts = dict(_kernels.launch_counts)
    ref_l, ref_g = value_and_grad(lambda p: T.lm_loss(cfg, p, tokens),
                                  params)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(g0), tree_leaves(g1)))
    assert abs(l0.item() - ref_l.item()) <= 1e-5 * ref_l.item()
    for a, r in zip(tree_leaves(g0), tree_leaves(ref_g)):
        assert ((a - r).norm() / r.norm().clamp_min(1e-30)).item() <= 1e-4
    blocks = {"ring": 2, "zigzag": 6, "ulysses": 1}[attn]
    masked = {"ring": 1, "zigzag": 2, "ulysses": 0}[attn]
    for kname in _kernels.ATTENTION_KERNELS:
        assert counts[kname] == counts[f"{kname}.simt"] == \
            2 * cfg.n_layers * blocks
        assert counts[f"{kname}.masked"] == cfg.n_layers * masked
        assert (counts[f"{kname}.offset"] > 0) == (attn != "ulysses")


@pytest.mark.cuda
def test_bf16_top1_route_on_the_card_counts_every_slot(cuda):
    # The EP phase's routing: 8192 tokens a rank, 4 experts, capacity
    # 2560, bf16.  Every token's (expert, slot) is the integer count's,
    # so no two tokens share a slot past 256 and the capacity binds.
    from mpi4torch_tpu_torch.parallel import moe

    rng = np.random.default_rng(7)
    T_, E, C = 8192, 4, 2560
    expert = rng.choice(E, size=T_, p=[0.55, 0.25, 0.1, 0.1])
    logits = 0.1 * rng.standard_normal((T_, E))
    logits[np.arange(T_), expert] += 4.0
    d, c, _ = moe.top1_route(
        torch.from_numpy(logits).to(cuda, torch.bfloat16), C)
    t, e, s = (x.cpu().numpy() for x in d.nonzero(as_tuple=True))
    seen, want = [0] * E, []
    for i, x in enumerate(expert):
        if seen[x] < C:
            want.append((i, x, seen[x]))
        seen[x] += 1
    assert list(zip(t.tolist(), e.tolist(), s.tolist())) == want
    assert bool((d.float().sum(dim=0) <= 1).all())
    assert bool(((c != 0) == (d != 0)).all())


# ---------------------------------------------------------------------------
# The compressed Allgather, the ViT's attention and the pipeline on the card.

@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["q8", "q8_ef", "q8_ef_hop", "bf16r"])
def test_compressed_allgather_on_the_kernel_equals_plain(cuda, codec):
    # Every block-q8 encode of the Allgather and of its adjoint is K1's
    # hop-0 form: one q8_requant launch a rank and round each way, bitwise
    # the plain requant; bf16r launches none.
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch import config

    n = 3
    xs = [torch.from_numpy(np.random.default_rng(r).standard_normal(
        (700 + 300 * r, 3)).astype(np.float32)).to(cuda) for r in range(n)]

    def run():
        def body(r):
            x = xs[r].clone().requires_grad_()
            y = P.COMM_WORLD.Allgather(x, 0, compression=codec)
            (g,) = torch.autograd.grad(y, x, y.detach() * (r + 1))
            return y.detach(), g
        return P.run_ranks(body, n, timeout=30.0, device=cuda)

    rounds = P.compress.get_codec(codec).ef_rounds
    _kernels.reset_launch_counts()
    got = run()
    want_launches = 2 * n * rounds if codec.startswith("q8") else 0
    assert _kernels.launch_counts["q8_requant"] == want_launches
    assert _kernels.launch_counts["q8_hop"] == 0
    config.set_quant_hop_impl("torch")
    try:
        _kernels.reset_launch_counts()
        want = run()
        assert _kernels.launch_counts["q8_requant"] == 0
    finally:
        config.set_quant_hop_impl("auto")
    for (y, g), (yw, gw) in zip(got, want):
        assert torch.equal(y, got[0][0])
        assert _bits_differ(y, yw) == 0 and _bits_differ(g, gw) == 0


@pytest.mark.cuda
def test_tc_at_head_dim_64_on_a_196_row_non_causal_block(cuda):
    # The ViT-B/16 block: 196 patches (off the 64-row tiles), 12 heads of
    # 64, non-causal, forward and backward on the tc kernels against the
    # plain version, the forward repeating its bits.
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn((4, 196, 12, 64), generator=g, device=cuda,
                           dtype=torch.bfloat16) for _ in range(3))
    _kernels.reset_launch_counts()
    o, l = flash.flash_block_attention(q, k, v, impl="cuda")
    o2, l2 = flash.flash_block_attention(q, k, v, impl="cuda")
    assert torch.equal(o, o2) and torch.equal(l, l2)
    po, pl = flash.flash_block_attention(q, k, v, impl="torch")
    torch.cuda.synchronize()
    assert bool(((o.float() - po.float()).abs() <= bf16_out_bound(po)).all())
    assert (l - pl.float()).abs().max().item() <= 1e-4
    got = _grads(q, k, v, "cuda", {}, torch.Generator(
        device=cuda).manual_seed(2))
    want = _grads(q, k, v, "torch", {}, torch.Generator(
        device=cuda).manual_seed(2))
    for a, b in zip(got, want):
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= 2e-2 * scale
    for kname in _kernels.ATTENTION_KERNELS:
        assert _kernels.launch_counts[kname] == \
            _kernels.launch_counts[f"{kname}.tc"] > 0


@pytest.mark.cuda
def test_pipeline_schedules_on_the_card(cuda):
    # GPipe and 1F1B (blocking and overlapped) on two rank threads of the
    # card: the same loss, the same gradients (1F1B's two forms bitwise).
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch.parallel import pp

    rng = np.random.default_rng(3)
    stages = [{"w": torch.from_numpy(rng.standard_normal((16, 16)) / 4)
               .to(cuda), "b": torch.zeros(16, device=cuda,
                                           dtype=torch.float64)}
              for _ in range(2)]
    mbs = [torch.from_numpy(rng.standard_normal((4, 16))).to(cuda)
           for _ in range(4)]

    def apply(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    def loss_fn(y, i):
        return (i + 1.0) * (y ** 2).sum()

    def run(fn, **kw):
        return P.run_ranks(lambda r: fn(
            P.COMM_WORLD, apply, stages[r], mbs, loss_fn,
            recv_like=torch.zeros_like(mbs[0]), **kw), 2, timeout=30.0,
            device=cuda)

    gpipe = run(pp.pipeline_step)
    f1 = run(pp.pipeline_step_1f1b)
    f2 = run(pp.pipeline_step_1f1b, overlap=True)
    for r in range(2):
        assert torch.equal(f1[r][0], f2[r][0])
        for k in ("w", "b"):
            assert torch.equal(f1[r][1][k], f2[r][1][k])
            torch.testing.assert_close(f1[r][1][k], gpipe[r][1][k],
                                       rtol=1e-10, atol=1e-12)
        torch.testing.assert_close(f1[r][0], gpipe[r][0], rtol=1e-12,
                                   atol=0)



# ---------------------------------------------------------------------------
# The rank means, the integrity guards, the wire checksum and the comm
# tracer on CUDA payloads.

def _means_body(rank, device):
    """The DP mean, Allreduce_tree's mean (per leaf, fused, pipelined),
    the reduce-scatter mean and ZeRO-1 with adam, at 3 ranks (1/3 is
    inexact, so a reciprocal multiplication would show) and 85000
    elements (enough for an ulp of a square root not correctly rounded
    to show in Adam)."""
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch import fuse
    from mpi4torch_tpu_torch.parallel import all_average_tree, zero
    from mpi4torch_tpu_torch.parallel.dp import dp_loss
    from mpi4torch_tpu_torch.utils import optim
    from mpi4torch_tpu_torch.utils.tree import value_and_grad

    c = P.COMM_WORLD
    rng = np.random.default_rng(100 + rank)
    t = {"w": torch.from_numpy(rng.standard_normal((1700, 50))
                               .astype(np.float32)).to(device),
         "b": torch.from_numpy(rng.standard_normal(11)
                               .astype(np.float32)).to(device)}
    out = [c.Allreduce_tree(t, P.MPI_SUM, mean=True, **kw)
           for kw in (dict(bucket_bytes=0), {},
                      dict(bucket_bytes=4096, overlap=True))]
    out.append(all_average_tree(c, t))
    out.append(value_and_grad(lambda p: dp_loss(
        c, lambda q, x: q["w"][0, 0] * x[1, 1] + q["b"][3] ** 2, p,
        t["w"]), t))
    out.append(fuse.fused_reduce_scatter_tree(c, t, P.MPI_SUM, mean=True,
                                              bucket_bytes=8192))
    opt = optim.adam(1e-2)
    p = {k: v * 0.5 for k, v in t.items()}
    st = zero.zero_init(c, opt, p)
    for _ in range(2):
        p, st = zero.zero_step(c, opt, p, t, st)
    out.append(p)
    return tree_leaves(out)


@pytest.mark.cuda
def test_three_rank_means_and_adam_bitwise_the_cpu_run(cuda):
    import mpi4torch_tpu_torch as P

    got = P.run_ranks(lambda r: _means_body(r, cuda), 3, timeout=60.0,
                      device=cuda)
    cpu = P.run_ranks(lambda r: _means_body(r, torch.device("cpu")), 3,
                      timeout=60.0, device="cpu")
    for r in range(3):
        assert len(got[r]) == len(cpu[r])
        for a, b in zip(got[r], cpu[r]):
            assert a.is_cuda and torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_finite_guard_raises_alike_on_every_rank_thread(cuda):
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch import config, resilience as rz

    def body(rank):
        x = torch.arange(4096.0, device=cuda) * (rank + 1)
        y = x.clone()
        try:
            P.COMM_WORLD.Allreduce(y, P.MPI_SUM)
        except P.IntegrityError as e:
            # The fault acted on a clone: the caller's tensor is intact.
            return "IntegrityError", e.ranks, torch.equal(x, y)
        return "ok", None, torch.equal(x, y)

    config.set_comm_finite_guard("raise")
    try:
        with rz.fault_scope([rz.FaultSpec("corrupt_nan", rank=1,
                                          op="Allreduce")]) as plan:
            outs = P.run_ranks(body, 3, timeout=30.0, device=cuda)
        clean = P.run_ranks(lambda r: P.COMM_WORLD.Allreduce(
            torch.arange(70000.0, device=cuda) * (r + 1), P.MPI_SUM), 3,
            timeout=30.0, device=cuda)
    finally:
        config.set_comm_finite_guard("off")
    assert plan.fired_kinds() == frozenset({"corrupt_nan"})
    assert outs == [("IntegrityError", frozenset({1}), True)] * 3
    off = P.run_ranks(lambda r: P.COMM_WORLD.Allreduce(
        torch.arange(70000.0, device=cuda) * (r + 1), P.MPI_SUM), 3,
        timeout=30.0, device=cuda)
    assert all(torch.equal(a, b) for a, b in zip(clean, off))


@pytest.mark.cuda
def test_poison_and_bitflip_clone_on_the_card(cuda):
    from mpi4torch_tpu_torch.resilience import faults

    x = torch.arange(6.0, device=cuda)
    p = faults._poison(x, float("inf"))
    q = torch.arange(5, dtype=torch.int8, device=cuda)
    f = faults._flip_bits(q, 3)
    torch.cuda.synchronize()
    assert p.is_cuda and torch.isinf(p[0]) and torch.equal(
        x, torch.arange(6.0, device=cuda))
    assert f.is_cuda and torch.equal(
        q, torch.arange(5, dtype=torch.int8, device=cuda))
    assert torch.equal(f.cpu(), faults._flip_bits(q.cpu(), 3))


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["q8", "bf16"])
def test_wire_checksum_on_the_card(cuda, codec):
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch import config, resilience as rz
    from mpi4torch_tpu_torch.compress import get_codec

    def body(rank):
        x = torch.linspace(-2.0, 2.0, 5000, device=cuda) * (rank + 1)
        return P.COMM_WORLD.Allgather(x, 0, compression=codec)

    off = P.run_ranks(body, 3, timeout=30.0, device=cuda)
    config.set_comm_wire_checksum(True)
    try:
        on = P.run_ranks(body, 3, timeout=30.0, device=cuda)
        # A bit-flip needs an integer wire (the q8 blocks); the bf16 wire
        # is float, so a NaN stands in for its corruption.
        kind = "bitflip" if codec == "q8" else "corrupt_nan"
        with rz.fault_scope([rz.FaultSpec(kind, rank=1, op="Allgather.c")]):
            with pytest.raises(P.IntegrityError) as ei:
                P.run_ranks(body, 3, timeout=30.0, device=cuda)
    finally:
        config.set_comm_wire_checksum(False)
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    assert ei.value.ranks == frozenset({1})
    # The CRC of a wire on the card equals the CRC of the same wire on
    # the CPU.
    payload, meta = get_codec(codec).encode(
        torch.linspace(-1.0, 1.0, 777, device=cuda))
    cpu_payload = {k: v.cpu() for k, v in payload.items()}
    assert rz.wire_checksum((meta, payload)) \
        == rz.wire_checksum((meta, cpu_payload))


@pytest.mark.cuda
def test_tracer_adds_no_device_sync(cuda):
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch import obs

    def body(rank):
        x = torch.ones(70000, device=cuda) * (rank + 1)
        t = {"a": x, "b": x[:1000] * 2}
        y = P.COMM_WORLD.Allreduce(x, P.MPI_SUM)
        z = P.COMM_WORLD.Allreduce_tree(t, P.MPI_SUM, mean=True)
        return y, z["a"], z["b"]

    plain = P.run_ranks(body, 2, timeout=30.0, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with obs.trace() as t:
            traced = P.run_ranks(body, 2, timeout=30.0, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for pa, ta in zip(plain, traced)
               for a, b in zip(pa, ta))
    evs = t.events_for(rank=0)
    assert [e.op for e in evs] == ["Allreduce", "Allreduce.fold",
                                   "Allreduce", "Allreduce.fold"]
    assert evs[0].payload_bytes == 70000 * 4
    assert evs[2].payload_bytes == 71000 * 4


# ------------------------------------------------ reshard and checkpoints

def _reshard_run(device, strategy=None, compression=None, n=8):
    """(8,) rows -> (2, 4) blocks of a float32 (64, 32) array on ``n``
    rank threads of ``device``: each rank's value and the gradient of
    ``vdot(y, w_r)``."""
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch import reshard as rs

    full = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 32)).astype(np.float32))
    src, dst = rs.layout((n,), 0, None), rs.layout((2, n // 2), 0, 1)

    def body(r):
        x = rs.slice_shard(full, src, r).to(device).requires_grad_()
        y = P.COMM_WORLD.Reshard(x, src, dst, strategy=strategy,
                                 compression=compression)
        w = torch.arange(y.numel(), dtype=y.dtype, device=device).reshape(
            y.shape) * 1e-3 + r
        (g,) = torch.autograd.grad(y, x, w)
        return y.detach().cpu(), g.cpu()

    return P.run_ranks(body, n, timeout=60.0, device=device), full, dst


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", [None, "gather", "rounds"])
def test_reshard_on_the_card_bitwise_its_cpu_run(cuda, strategy):
    from mpi4torch_tpu_torch import reshard as rs

    got, full, dst = _reshard_run(cuda, strategy)
    want, _, _ = _reshard_run("cpu", strategy)
    for r, ((y, g), (yw, gw)) in enumerate(zip(got, want)):
        assert torch.equal(y, rs.slice_shard(full, dst, r))
        assert torch.equal(y, yw) and torch.equal(g, gw)


@pytest.mark.cuda
def test_compressed_wide_hop_launches_q8_requant(cuda):
    # compression="q8" rides the gather strategy's full-world gather
    # through the compressed Allgather: one K1 requant launch a rank, the
    # bits of the CPU run, and an exact backward.
    _kernels.reset_launch_counts()
    got, full, dst = _reshard_run(cuda, "gather", "q8")
    assert _kernels.launch_counts["q8_requant"] == 8
    want, _, _ = _reshard_run("cpu", "gather", "q8")
    exact, _, _ = _reshard_run(cuda, "gather")
    for (y, g), (yw, gw), (ye, ge) in zip(got, want, exact):
        assert _bits_differ(y, yw) == 0 and torch.equal(g, gw)
        assert torch.equal(g, ge) and not torch.equal(y, ye)


@pytest.mark.cuda
def test_checkpoint_round_trip_onto_a_cuda_template(cuda, tmp_path):
    from mpi4torch_tpu_torch.resilience import restore_or_init
    from mpi4torch_tpu_torch.utils import (CheckpointManager,
                                           restore_checkpoint,
                                           save_checkpoint)

    g = torch.Generator(device=cuda).manual_seed(0)
    state = {"w": torch.randn((300, 7), generator=g, device=cuda,
                              dtype=torch.bfloat16),
             "m": torch.randn(513, generator=g, device=cuda),
             "n": torch.tensor(5, dtype=torch.int32, device=cuda)}
    save_checkpoint(str(tmp_path / "ck"), state)
    got = restore_checkpoint(str(tmp_path / "ck"),
                             tree_map(torch.zeros_like, state))
    for k in state:
        assert got[k].device == state[k].device and \
            got[k].dtype == state[k].dtype
        assert torch.equal(got[k], state[k])
    # A CPU template takes the leaves to the host, bitwise.
    host = restore_checkpoint(str(tmp_path / "ck"),
                              tree_map(lambda t: t.cpu(), state))
    assert all(torch.equal(host[k], state[k].cpu()) for k in state)
    with CheckpointManager(str(tmp_path / "run"), max_to_keep=2) as mgr:
        for step in range(3):
            mgr.save(step, tree_map(lambda t: t * (step + 1), state))
    res = restore_or_init(str(tmp_path / "run"), template=state)
    assert res.step == 2 and res.skipped == ()
    assert torch.equal(res.state["w"], state["w"] * 3)


@pytest.mark.cuda
def test_admit_zero3_at_two_layers_bitwise_shard_params_tp(cuda):
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch.parallel import zero as Z
    from mpi4torch_tpu_torch.serve import kv

    cfg = T.TransformerConfig(vocab=32768, d_model=2048, n_heads=16,
                              n_layers=2, d_ff=8192, max_seq=2048)
    params = T.init_transformer(0, cfg, torch.float32, device=cuda)

    def body(r):
        c = P.COMM_WORLD
        shards = Z.zero3_shard_params(c, params)
        got = kv.admit_zero3(cfg, c, shards, params, dtype=torch.bfloat16)
        want = kv.shard_params_tp(cfg, Z.zero3_params(c, shards, params), c)
        return all(a.dtype == torch.bfloat16
                   and torch.equal(a, b.to(torch.bfloat16))
                   for a, b in zip(tree_leaves(got), tree_leaves(want)))

    assert all(P.run_ranks(body, 2, timeout=120.0, device=cuda))


# -------------------------------------------------- the process transport


@pytest.mark.cuda
def test_process_backend_bitwise_the_thread_backend(cuda):
    # The same Allreduce and DP=2 step of a two-layer model on rank
    # threads and in worker processes (each with its own CUDA context)
    # give the same bits, on the world's device.
    import os

    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch.transport.__main__ import bitwise_equal

    def allreduce(rank):
        x = (torch.sin(torch.arange(1 << 17, device=cuda,
                                    dtype=torch.float32)) * (rank + 1)
             ).requires_grad_()
        y = P.COMM_WORLD.Allreduce(x, P.MPI_SUM)
        (g,) = torch.autograd.grad(torch.vdot(y, torch.cos(y)), x)
        return (y.detach(), g, torch.cuda.current_device(), os.getpid())

    a = P.run_ranks(allreduce, 3, device=cuda, backend="thread")
    b = P.run_ranks(allreduce, 3, device=cuda, backend="process")
    assert bitwise_equal([r[:3] for r in a], [r[:3] for r in b])
    assert all(r[0].device.type == "cuda" for r in b)
    assert len({r[3] for r in b} | {os.getpid()}) == 4

    cfg = T.TransformerConfig(vocab=97, d_model=128, n_heads=4, n_layers=2,
                              d_ff=256, max_seq=64)

    def step(rank):
        params = T.init_transformer(0, cfg, torch.float32, device=cuda)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (4, 64))).to(cuda)
        _kernels.reset_launch_counts()
        out = T.train_step(cfg, params, tokens[2 * rank:2 * rank + 2],
                           comm_dp=P.COMM_WORLD, lr=1e-2)
        return out, dict(_kernels.launch_counts)

    a = P.run_ranks(step, 2, timeout=60.0, device=cuda, backend="thread")
    b = P.run_ranks(step, 2, timeout=60.0, device=cuda, backend="process")
    assert bitwise_equal([r[0] for r in a], [r[0] for r in b])
    assert bitwise_equal(b[0][0], b[1][0])
    # Each worker counts its own launches: n_layers of each kernel.
    assert all(r[1]["flash_bwd_dq"] == cfg.n_layers for r in b)


@pytest.mark.cuda
def test_a_killed_workers_card_memory_comes_back(cuda):
    import os
    import time

    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch.resilience.matrix import run_cell
    from mpi4torch_tpu_torch.transport.pool import shared_pool

    def touch(rank):
        torch.ones(1 << 20, device=cuda).sum().item()
        return os.getpid()

    pids = P.run_ranks(touch, 3, device=cuda, backend="process")
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    rec = run_cell("rank_death", "plain", nranks=3, backend="process",
                   device=cuda)
    assert rec["status"] == "ok", rec["detail"]
    with pytest.raises(ProcessLookupError):
        os.kill(pids[1], 0)
    deadline, gained = time.monotonic() + 20.0, 0
    while time.monotonic() < deadline:
        gained = torch.cuda.mem_get_info()[0] - free0
        if gained >= 100 << 20:
            break
        time.sleep(0.2)
    assert gained >= 100 << 20, f"only {gained} B came back"
    before = shared_pool().spawned_total
    P.run_ranks(touch, 3, device=cuda, backend="process")
    assert shared_pool().spawned_total == before + 1


# ------------------------------------------------------------- Mode A


def _mode_a_table(P, n):
    """The Mode A op table of tests/test_torch_spmd.py, per op ``op(comm,
    t)``: every Allreduce algorithm that serves ``n`` ranks, the rooted,
    shard and p2p ops."""
    S = P.MPI_SUM
    ops = {f"allreduce_{a}": (lambda a: lambda c, t: c.Allreduce(
        t, S, algorithm=a))(a)
        for a in ("ring", "tree", "bidir") + (
            ("rhd", "hier", "torus") if n == 8 else ())}

    def ring(c, t):
        h = c.Isend(t, (c.rank + 1) % c.size, 0)
        b = c.Recv(torch.empty_like(t), (c.rank - 1) % c.size, 0)
        c.Wait(h)
        return b * (1.0 + c.rank)

    ops.update({
        "bcast_tree": lambda c, t: c.Bcast_(t, n - 1, algorithm="tree"),
        "bcast_ring": lambda c, t: c.Bcast_(t, 1, algorithm="ring"),
        "reduce_tree": lambda c, t: c.Reduce_(t, S, 2, algorithm="tree"),
        "allgather": lambda c, t: c.Allgather(t, 0),
        "gather": lambda c, t: c.Gather(t, 0, 1),
        "scatter": lambda c, t: c.Scatter(t[:n * 8].reshape(n, 8), 0, 1, 0),
        "alltoall": lambda c, t: c.Alltoall(t[:n * 8].reshape(n, 8), 1, 0,
                                            1),
        "reduce_scatter": lambda c, t: c.Reduce_scatter(
            t[:n * 8].reshape(n, 8), S, 0),
        "ring": ring,
    })
    return ops


def _mode_a_run(P, op, n, x, device, seed):
    comm = P.COMM_WORLD
    f = P.run_spmd(lambda v: op(comm, v[comm.rank]), nranks=n,
                   device=device)
    xt = x.to(device).requires_grad_()
    out = f(xt)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed))
    (g,) = torch.autograd.grad(
        torch.vdot(out.reshape(-1), w.to(device).reshape(-1)), xt)
    return out.detach().cpu(), g.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("det", [True, False])
def test_mode_a_op_table_bitwise_the_cpu_run(cuda, n, det):
    # Every op of the Mode A table under run_spmd on the card: values and
    # the gradients taken from outside run_spmd bitwise the CPU run's.
    import mpi4torch_tpu_torch as P

    x = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (n, 4096)).astype(np.float32))
    for i, (name, op) in enumerate(_mode_a_table(P, n).items()):
        with P.config.deterministic_mode(det):
            got = _mode_a_run(P, op, n, x, cuda, i)
            want = _mode_a_run(P, op, n, x, "cpu", i)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                name


@pytest.mark.cuda
def test_mode_a_misuse_and_mesh_on_the_card(cuda):
    import mpi4torch_tpu_torch as P

    comm = P.COMM_WORLD

    def lonely(x):
        comm.Isend(x, (comm.rank + 1) % comm.size, 0)
        return x

    with pytest.raises(P.DeadlockError, match="ring shift 1"):
        P.run_spmd(lonely, nranks=2)(torch.ones(2, device=cuda))
    # The mesh's default devices repeat the card; the tier stack's hier
    # Allreduce there is bitwise the CPU mesh's.
    card = P.device_mesh({"dp": 2, "tp": 4})
    assert {d.type for d in card.devices.reshape(-1)} == {"cuda"}
    cpu = P.device_mesh({"dp": 2, "tp": 4}, devices=["cpu"] * 8)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (8, 1000)).astype(np.float32))
    outs = []
    for mesh in (card, cpu):
        tier = P.comm_from_mesh(mesh, ("dp", "tp"))
        outs.append(P.run_spmd(lambda v: tier.Allreduce(
            v[tier.rank], P.MPI_SUM), mesh=mesh, axis_name="dp")(
                x.to(mesh.devices.reshape(-1)[0])).cpu())
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))


@pytest.mark.cuda
def test_variable_token_exchange_example_on_the_card(cuda):
    from mpi4torch_tpu_torch.examples import variable_token_exchange as vte

    card = vte.run(8, device=cuda)
    cpu = vte.run(8, device="cpu")
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["q8", "q8_ef", "q8_ef_hop"])
@pytest.mark.parametrize("algo", ["ring", "bidir", "torus"])
def test_mode_a_compressed_k1_bitwise_plain(cuda, codec, algo):
    # The compressed Allreduce under run_spmd on the card: every rank runs
    # its own hops on K1, whose output is bitwise its plain version
    # (config.set_quant_hop_impl("torch") on the same card) and the CPU
    # run, values and gradients; K1's launches are the schedule's.
    import mpi4torch_tpu_torch as P

    n = 4
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (n, 5000)).astype(np.float32))

    def op(c, t):
        return c.Allreduce(t, P.MPI_SUM, compression=codec, algorithm=algo)

    _kernels.reset_launch_counts()
    got = _mode_a_run(P, op, n, x, cuda, 0)
    hops = _kernels.launch_counts["q8_hop"]
    enc = _kernels.launch_counts["q8_requant"]
    P.config.set_quant_hop_impl("torch")
    try:
        plain = _mode_a_run(P, op, n, x, cuda, 0)
    finally:
        P.config.set_quant_hop_impl("auto")
    cpu = _mode_a_run(P, op, n, x, "cpu", 0)
    for a, b, c in zip(got, plain, cpu):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
    # Forward and backward; per channel and round n first encodes and
    # n (n - 1) hops.
    chans = 1 if algo == "ring" else 2
    rounds = 2 if codec == "q8_ef" else 1
    assert (hops, enc) == (2 * chans * rounds * n * (n - 1),
                           2 * chans * rounds * n)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["q8", "bf16"])
def test_mode_a_compressed_allgather_and_reshard_on_the_card(cuda, codec):
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch import reshard as rs

    n = 8
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (n, 96)).astype(np.float32))

    def op(c, t):
        return c.Allgather(t, 0, compression=codec)

    _kernels.reset_launch_counts()
    got = _mode_a_run(P, op, n, x, cuda, 1)
    if codec == "q8":
        # One encode a rank forward; the backward's ring encodes n - 1
        # hops a rank.
        assert _kernels.launch_counts["q8_requant"] == n * n
    want = _mode_a_run(P, op, n, x, "cpu", 1)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # The SPMD reshard's compressed wide hop on the card: bitwise the CPU.
    fl, tl = rs.layout((8,), 0, None), rs.layout((2, 4), 0, 1)
    full = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (32, 8)).astype(np.float32))
    shards = torch.stack([rs.slice_shard(full, fl, r) for r in range(n)])
    outs = [P.run_spmd(lambda v: P.COMM_WORLD.Reshard(
        v[P.COMM_WORLD.rank], fl, tl, strategy="gather", compression=codec),
        nranks=n, device=dev)(shards.to(dev)).cpu()
        for dev in (cuda, "cpu")]
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))


@pytest.mark.cuda
def test_spmd_engine_k2_launches_tc(cuda):
    # Engine(spmd=True) on two ranks of run_spmd on the card: the tokens
    # of the rank-thread engine, and every K2 launch (prefill, one per
    # layer and rank) the tensor-core variant.
    import mpi4torch_tpu_torch as P

    cfg = T.TransformerConfig(vocab=512, d_model=256, n_heads=4,
                              n_layers=2, d_ff=512, max_seq=256)
    params = T.init_transformer(0, cfg, torch.bfloat16, device=cuda)
    prompts = [np.arange(1, 40) % 500, np.arange(7, 100) % 500]
    scfg = serve.ServeConfig(slots=2, max_new=6)

    def drive(eng):
        for p in prompts:
            eng.submit(p)
        return {k: v.tolist() for k, v in eng.run().items()}

    _kernels.reset_launch_counts()
    got = drive(serve.Engine(cfg, params, scfg, spmd=True, nranks=2))
    assert _kernels.launch_counts["flash_fwd.tc"] == \
        len(prompts) * cfg.n_layers * 2
    assert _kernels.launch_counts["flash_fwd.simt"] == 0
    want = P.run_ranks(lambda: drive(serve.Engine(cfg, params, scfg)), 2)
    assert got == want[0]


# ------------------------------------------------------- the schedule IR


class _HandWrittenAllreduce(torch.autograd.Function):
    """The hand-written Allreduce dispatch of ops/spmd.py, forward and
    adjoint: the reference the IR route is held to."""

    @staticmethod
    def forward(fctx, x, ctx, op, algo):
        from mpi4torch_tpu_torch.ops import spmd

        fctx.ctx, fctx.algo = ctx, algo
        return spmd._handwritten_allreduce_value(ctx, x, op, algo)

    @staticmethod
    def backward(fctx, g):
        from mpi4torch_tpu_torch.ops import spmd

        return (spmd._handwritten_allreduce_value(
            fctx.ctx, g.contiguous(), 3, fctx.algo, reverse=True),
            None, None, None)


def _ir_run(P, fn, x, device, n, seed):
    """run_spmd(fn) on the stacked rows x: (out, grad of vdot(out, w) from
    outside, rank 0's exchanges), on the CPU."""
    from mpi4torch_tpu_torch import runtime

    seen = []
    saved = runtime.World.exchange

    def exchange(w, rank, signature, *a, **kw):
        if rank == 0:
            seen.append(signature)
        return saved(w, rank, signature, *a, **kw)

    runtime.World.exchange = exchange
    try:
        out, g = _mode_a_run(P, fn, n, x, device, seed)
    finally:
        runtime.World.exchange = saved
    return out, g, seen


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["bidir", "hier"])
@pytest.mark.parametrize("det", [False, True])
def test_csched_lowered_bitwise_hand_written_on_the_card(cuda, algo, det):
    # The Allreduce through the schedule IR on the card: values and
    # gradients bitwise the hand-written dispatch's and the CPU run's,
    # with the same exchanges.
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch.ops import spmd

    n = 8
    x = torch.from_numpy(np.random.default_rng(16).standard_normal(
        (n, 4099)).astype(np.float32))

    def ir(c, t):
        return c.Allreduce(t, P.MPI_SUM, algorithm=algo)

    def hw(c, t):
        return _HandWrittenAllreduce.apply(
            t, spmd.current_spmd_context(), P.MPI_SUM, algo)

    with P.config.deterministic_mode(det):
        a = _ir_run(P, ir, x, cuda, n, 0)
        b = _ir_run(P, hw, x, cuda, n, 0)
        c = _ir_run(P, ir, x, "cpu", n, 0)
    assert a[2] == b[2] and len(a[2]) > 0
    for u, v, w in zip(a[:2], b[:2], c[:2]):
        assert torch.equal(u.view(torch.int32), v.view(torch.int32))
        assert torch.equal(u.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
def test_csched_q8_ir_route_launches_k1_as_the_hand_composed(cuda):
    # compress/spmd's q8 Allreduce lowers its codec-rewritten program:
    # bitwise the hand-composed pipeline, with K1's hop and requant
    # launches equal to it and to the schedule's.
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch.compress import get_codec
    from mpi4torch_tpu_torch.compress import spmd as cspmd
    from mpi4torch_tpu_torch.ops import spmd

    class HandComposed(torch.autograd.Function):
        @staticmethod
        def forward(fctx, t, ctx, codec):
            fctx.args = (ctx, codec)
            return cspmd._fused_allreduce_value(ctx, t, codec, "bidir",
                                                False)

        @staticmethod
        def backward(fctx, g):
            ctx, codec = fctx.args
            return (cspmd._fused_allreduce_value(ctx, g.contiguous(),
                                                 codec, "bidir", True),
                    None, None)

    n = 4
    x = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (n, 20000)).astype(np.float32))
    runs, counts = [], []
    for fn in (lambda c, t: c.Allreduce(t, P.MPI_SUM, compression="q8_ef",
                                        algorithm="bidir"),
               lambda c, t: HandComposed.apply(
                   t, spmd.current_spmd_context(), get_codec("q8_ef"))):
        _kernels.reset_launch_counts()
        runs.append(_ir_run(P, fn, x, cuda, n, 1))
        counts.append((_kernels.launch_counts["q8_hop"],
                       _kernels.launch_counts["q8_requant"]))
    assert runs[0][2] == runs[1][2]
    for u, v in zip(runs[0][:2], runs[1][:2]):
        assert torch.equal(u.view(torch.int32), v.view(torch.int32))
    # Forward and backward x 2 channels x 2 rounds.
    assert counts[0] == counts[1] == (8 * n * (n - 1), 8 * n)


@pytest.mark.cuda
def test_csched_dp_sp_step_on_the_card(cuda):
    # train_step on a 2 x 2 dp x sp mesh under run_spmd at a small width:
    # f32 against the one-rank full-batch step, every mesh position
    # bitwise alike; bf16 at head dim 64 with every attention launch tc.
    import dataclasses

    import mpi4torch_tpu_torch as P

    cfg = T.TransformerConfig(vocab=512, d_model=256, n_heads=4,
                              n_layers=2, d_ff=512, max_seq=256)
    tokens = torch.from_numpy(np.random.default_rng(18).integers(
        0, cfg.vocab, (4, 256))).to(cuda)
    mesh = P.device_mesh({"dp": 2, "sp": 2})
    cd, cs = P.comm_from_mesh(mesh, "dp"), P.comm_from_mesh(mesh, "sp")

    def body(p, toks):
        local = toks.narrow(0, cd.rank * 2, 2).narrow(1, cs.rank * 128, 128)
        return T.train_step(cfg, p, local, comm_sp=cs, comm_dp=cd,
                            attn="ring", lr=2.0 ** 20)

    p32 = T.init_transformer(0, cfg, torch.float32, device=cuda)
    loss, new = P.run_spmd(body, mesh=mesh, axis_name="dp")(p32, tokens)
    ref_loss, ref = T.train_step(cfg, p32, tokens, lr=2.0 ** 20)
    assert all(torch.equal(loss[i], loss[0]) for i in range(4))
    assert abs(loss[0].item() - ref_loss.item()) <= 1e-5 * ref_loss.item()
    for a, b in zip(tree_leaves(new), tree_leaves(ref)):
        assert all(torch.equal(a[i], a[0]) for i in range(4))
        assert ((a[0] - b).norm() / b.norm()).item() <= 1e-5
    pb = T.init_transformer(0, cfg, torch.bfloat16, device=cuda)
    _kernels.reset_launch_counts()
    loss, new = P.run_spmd(body, mesh=mesh, axis_name="dp")(pb, tokens)
    assert all(torch.equal(loss[i], loss[0]) for i in range(4))
    for k in _kernels.ATTENTION_KERNELS:
        # 2 dp groups x 2 layers x the ring's 4 blocks over two sp ranks.
        assert _kernels.launch_counts[k] == \
            _kernels.launch_counts[f"{k}.tc"] == 16


@pytest.mark.cuda
def test_tune_sweep_q8_leg_against_the_plain_hop(cuda, tmp_path,
                                                 monkeypatch):
    # The autotuner's q8 leg on the card: every candidate it times runs
    # K1, and each candidate's Allreduce is bitwise the plain hop's
    # (config.set_quant_hop_impl("torch")) on the same inputs.
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch import config, tune

    monkeypatch.setenv(tune.autotuner.CACHE_ENV, str(tmp_path / "c.json"))
    tune.clear()
    try:
        _kernels.reset_launch_counts()
        rep = tune.autotune_allreduce(sizes=(1 << 14,), nranks=4, iters=1,
                                      persist=False, apply_crossover=False,
                                      codecs=(None, "q8"))
        q8 = rep["entries"][str(1 << 14)]["codecs"]["q8"]
        assert set(q8["algorithms"]) == {"ring", "bidir", "torus"}
        assert all("seconds_per_step" in v
                   for v in q8["algorithms"].values())
        assert _kernels.launch_counts["q8_hop"] > 0
        x = torch.from_numpy(np.random.default_rng(62).standard_normal(
            4096).astype(np.float32)).to(cuda)
        for algo in q8["algorithms"]:
            def run():
                return P.run_spmd(lambda v: P.COMM_WORLD.Allreduce(
                    v, P.MPI_SUM, compression="q8", algorithm=algo),
                    nranks=4)(x)
            _kernels.reset_launch_counts()
            got = run()
            assert _kernels.launch_counts["q8_hop"] > 0
            config.set_quant_hop_impl("torch")
            try:
                want = run()
            finally:
                config.set_quant_hop_impl("auto")
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32))
    finally:
        tune.clear()


@pytest.mark.cuda
def test_tier_q8_slow_program_requant_launches(cuda):
    # A q8-slow tier program named explicitly: bitwise its interpretation
    # and the plain requant's run, with one K1 requant launch per rank
    # per q8_level_fold step, forward and backward.
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch import config, csched

    res = csched.synthesize_tiers(8, 1 << 14, 4, tiers=(2, 2, 2),
                                  tier_bandwidths=(100.0, 25.0, 3.125))
    assert res["composition"] == "q8-slow"
    prog = res["program"]
    name = csched.install(prog)
    steps = sum(s.kind == "q8_level_fold" for ph in prog.phases
                for s in ph.steps)
    rows = torch.from_numpy(np.random.default_rng(63).standard_normal(
        (8, 4096)).astype(np.float32)).to(cuda)

    def run():
        x = rows.clone().requires_grad_()
        out = P.run_spmd(lambda v: P.COMM_WORLD.Allreduce(
            v[P.COMM_WORLD.rank], P.MPI_SUM, algorithm=name), nranks=8)(x)
        (g,) = torch.autograd.grad(out.sum(), x)
        return out.detach(), g

    try:
        _kernels.reset_launch_counts()
        out, g = run()
        assert _kernels.launch_counts["q8_requant"] == 2 * 8 * steps > 0
        config.set_quant_hop_impl("torch")
        try:
            pout, pg = run()
        finally:
            config.set_quant_hop_impl("auto")
        oracle = csched.interpret_allreduce(prog, P.MPI_SUM, list(rows))
        for r in range(8):
            assert torch.equal(out[r], oracle)
        assert torch.equal(out.view(torch.int32), pout.view(torch.int32))
        assert torch.equal(g.view(torch.int32), pg.view(torch.int32))
    finally:
        from mpi4torch_tpu_torch.csched import synth
        synth.clear_installed()


import mpi4torch_tpu_torch as mpi  # noqa: E402


def _small_flagship(cuda, dtype):
    cfg = T.TransformerConfig(vocab=32768, d_model=2048, n_heads=16,
                              n_layers=2, d_ff=8192, max_seq=2048)
    return cfg, T.init_transformer(0, cfg, dtype, device=cuda)


@pytest.mark.cuda
def test_elastic_zero_drain_bitwise_fresh_start(cuda):
    """Leg A of the elastic smoke phase at 2 layers: one ZeRO-1 Adam step
    on (4,), drain(leaving=[2, 3]) re-laying the Adam shards with
    replan_zero, one step on (2,): the drained shards are the slices of
    the gathered state and the step bitwise a fresh DP=2 step from it;
    every attention launch tc."""
    from mpi4torch_tpu_torch import elastic as E
    from mpi4torch_tpu_torch.parallel import zero as Z
    from mpi4torch_tpu_torch.utils import optim

    cfg, params = _small_flagship(cuda, torch.bfloat16)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (8, 512))).to(cuda)
    opt = optim.adam(1e-4)

    def rows(pos, n):
        return tokens[pos * (8 // n):(pos + 1) * (8 // n)]

    rt = E.ElasticRuntime(4, probe_timeout=0.6, device=cuda)
    _kernels.reset_launch_counts()
    res1 = rt.run_phase(lambda pos, rid: T.zero_train_step(
        cfg, params, rows(pos, 4), opt, Z.zero_init(
            mpi.COMM_WORLD, opt, params), mpi.COMM_WORLD)[1:])
    p1, states = res1[0][0], [r[1] for r in res1]

    def sliced(j):
        def one(tmpl, *parts):
            n = tmpl.numel()
            flat = torch.cat(parts)[:n]
            per = -(-n // 2)
            return torch.nn.functional.pad(
                flat, (0, 2 * per - n))[j * per:(j + 1) * per]
        return optim.AdamState(
            states[0].count,
            tree_map(one, params, *[s.mu for s in states]),
            tree_map(one, params, *[s.nu for s in states]))

    want = [sliced(0), sliced(1)]
    drained = rt.drain(lambda pos, rid, old, new: optim.AdamState(
        states[pos].count,
        E.replan_zero(mpi.COMM_WORLD, states[pos].mu, params, old, new,
                      mode="drain"),
        E.replan_zero(mpi.COMM_WORLD, states[pos].nu, params, old, new,
                      mode="drain")), leaving=[2, 3])
    assert rt.view.alive == (0, 1) and rt.view.epoch == 1
    for j in range(2):
        for a, b in zip(tree_leaves((drained[j].mu, drained[j].nu)),
                        tree_leaves((want[j].mu, want[j].nu))):
            assert torch.equal(a, b)
    got = rt.run_phase(lambda pos, rid: T.zero_train_step(
        cfg, p1, rows(pos, 2), opt, drained[pos], mpi.COMM_WORLD)[1:],
        view=rt.view)
    oracle = mpi.run_ranks(lambda pos: T.zero_train_step(
        cfg, p1, rows(pos, 2), opt, want[pos], mpi.COMM_WORLD)[1:], 2,
        device=cuda)
    for j in range(2):
        for a, b in zip(tree_leaves(got[j]), tree_leaves(oracle[j])):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b)
    counts = _kernels.launch_counts
    for k in _kernels.ATTENTION_KERNELS:
        assert counts[k] == counts[f"{k}.tc"] > 0


@pytest.mark.cuda
def test_codec_escalate_lockstep_k1_launches(cuda):
    """Leg D of the elastic smoke phase at 2 layers: codec_escalate
    through one consensus round flips the fused DP=2 step at 4 MiB buckets
    to q8 on both ranks at epoch 1, each bucket's two hops on K1 (bitwise
    an explicit q8 step), a stale phase fenced, reset bitwise exact."""
    from mpi4torch_tpu_torch import config, fuse
    from mpi4torch_tpu_torch.elastic import StaleEpochError
    from mpi4torch_tpu_torch.resilience import DegradeController
    from mpi4torch_tpu_torch.utils import tree

    cfg, params = _small_flagship(cuda, torch.bfloat16)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 512))).to(cuda)
    bb = config.DEFAULT_BUCKET_BYTES
    nbk = fuse.bucket_layout(params, bb).num_buckets

    def step(pos, rid=None, compression=None):
        x = tokens[2 * pos:2 * pos + 2]
        _, g = tree.value_and_grad(lambda q: T.lm_loss(cfg, q, x), params)
        out = mpi.COMM_WORLD.Allreduce_tree(
            g, mpi.MPI_SUM, mean=True, bucket_bytes=bb,
            compression=compression)
        codec = config.default_compression()
        return getattr(codec, "name", codec), out

    exact = mpi.run_ranks(step, 2, device=cuda)
    q8 = mpi.run_ranks(lambda p: step(p, compression="q8"), 2, device=cuda)
    ctl = DegradeController(n_ranks=2, device=cuda)
    stale = ctl.runtime.view
    try:
        tr = ctl.apply("codec_escalate", None)
        _kernels.reset_launch_counts()
        got = ctl.runtime.run_phase(step, view=ctl.runtime.view)
        hops = _kernels.launch_counts["q8_hop"]
        with pytest.raises(StaleEpochError):
            ctl.runtime.run_phase(step, view=stale)
    finally:
        ctl.reset()
    assert tr.epoch == 1 and {c for c, _ in got} == {"q8"}
    assert hops == 2 * nbk
    for (_c, a), (_q, b) in zip(got, q8):
        assert all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(a), tree_leaves(b)))
    after = mpi.run_ranks(step, 2, device=cuda)
    for (c, a), (_e, b) in zip(after, exact):
        assert c is None
        assert all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.cuda
def test_rank_death_rerun_on_a_cold_cuda_pool(cuda):
    """The elastic rank_death x plain x shrink cell over CUDA worker
    processes, from an empty pool of exactly the world's size: the
    SIGKILL's replacement is spawned for the consensus after it and makes
    its CUDA context before it says hello, so its probe meets the
    survivors' within the 0.6 s probe timeout; the record is the CPU's."""
    from mpi4torch_tpu_torch import transport
    from mpi4torch_tpu_torch.elastic.matrix import run_cell
    from mpi4torch_tpu_torch.transport.pool import shared_pool

    keys = ("kind", "subsystem", "action", "expected", "status", "fired",
            "fallback", "epoch", "algorithm", "slots")
    transport.shutdown()
    try:
        with mpi.config.transport_scope("process"):
            rec = run_cell("rank_death", "plain", "shrink", device=cuda)
            spawned = shared_pool().spawned_total
        cpu = run_cell("rank_death", "plain", "shrink", device="cpu")
    finally:
        transport.shutdown()
    assert rec["status"] == "ok", rec["detail"]
    assert spawned == 9, "eight workers and one replacement"
    assert {k: rec.get(k) for k in keys} == {k: cpu.get(k) for k in keys}


# ------------------------------------------------ the multi-process runtime

_DIST_WORKER = """
import os, sys
import torch
import mpi4torch_tpu_torch as mpi

pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.backends.cuda.matmul.allow_tf32 = False
mpi.init_distributed(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=2, process_id=pid)
comm = mpi.COMM_WORLD
xs = torch.load(os.path.join(out, "xs.pt")).to("cuda")


def body(xs, codec):
    x = xs[comm.rank].detach().requires_grad_()
    y = comm.Allreduce(x, mpi.MPI_SUM, compression=codec,
                       algorithm="ring" if codec else None)
    (g,) = torch.autograd.grad(torch.vdot(y, y), x)
    return y, g


res = {codec: [t.cpu() for t in mpi.run_spmd(body)(xs, codec)]
       for codec in (None, "q8")}
torch.save(res, os.path.join(out, f"res{pid}.pt"))
mpi.finalize_distributed()
"""


@pytest.mark.cuda
def test_two_processes_on_the_card_bitwise_rank_threads(cuda, tmp_path):
    """Two processes on the one card, each one rank of ``run_spmd`` under
    ``init_distributed``: the exact Allreduce and the q8 ``ring``
    Allreduce, value and gradient of ``vdot(y, y)``, bitwise the same
    body on two rank threads of one process."""
    import os
    import socket
    import subprocess
    import sys

    import mpi4torch_tpu_torch as P

    g = torch.Generator().manual_seed(0)
    xs = torch.randn(2, 1 << 20, generator=g)
    torch.save(xs, tmp_path / "xs.pt")
    (tmp_path / "worker.py").write_text(_DIST_WORKER)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"), str(pid), port,
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out

    comm = P.COMM_WORLD

    def body(xs, codec):
        x = xs[comm.rank].detach().requires_grad_()
        y = comm.Allreduce(x, P.MPI_SUM, compression=codec,
                           algorithm="ring" if codec else None)
        (g,) = torch.autograd.grad(torch.vdot(y, y), x)
        return y, g

    for codec in (None, "q8"):
        y, g = P.run_spmd(body, nranks=2, device=cuda)(xs.to(cuda), codec)
        for pid in range(2):
            got = torch.load(tmp_path / f"res{pid}.pt")[codec]
            assert torch.equal(got[0][0], y[pid].cpu()), (codec, pid)
            assert torch.equal(got[1][0], g[pid].cpu()), (codec, pid)


@pytest.mark.cuda
def test_analyze_recorded_q8_bidir_equals_the_cpu_record(cuda):
    # A recorded q8 bidir Allreduce on the card: the same collective
    # sequence as the CPU record (kinds, pairs, types, labels), and its
    # K1 custom_call events equal the launches _kernels counts for the
    # same run, the program's rank holding its share.
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch import analyze

    n = 4
    x = torch.from_numpy(np.random.default_rng(23).standard_normal(
        4096).astype(np.float32))

    def record(device):
        call = P.run_spmd(lambda v: P.COMM_WORLD.Allreduce(
            v, P.MPI_SUM, compression="q8", algorithm="bidir"),
            nranks=n, device=device)
        return analyze.lower(call, x.to(device))

    cpu = record("cpu")
    _kernels.reset_launch_counts()
    card = record(cuda)
    launches = dict(_kernels.launch_counts)
    def wire(prog):
        # Event indices differ: the card's hop is one custom_call where
        # the CPU runs the plain hop's aten ops.
        return [dataclasses.replace(op, line=0) for op in prog.collectives]

    assert wire(card) == wire(cpu)
    assert analyze.wire_bytes_per_device(card) == \
        analyze.wire_bytes_per_device(cpu)
    assert analyze.run_lints(card) == []
    assert card.kernels() == {k: launches[k] for k in ("q8_hop",
                                                      "q8_requant")
                              if launches[k]}
    assert launches["q8_hop"] > 0
    mine = analyze.parse_program(card).kernel_events()
    assert mine["q8_hop"] * n == launches["q8_hop"]
    assert cpu.kernels() == {}


@pytest.mark.cuda
def test_analyze_attention_kernel_events_equal_launches(cuda):
    # A recorded DP=2 training step of a small bf16 transformer: its K2,
    # K3 and K4 custom_call events (every rank) equal the launch counts,
    # n_layers of each on each rank, and the program lints clean.
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch import analyze
    from mpi4torch_tpu_torch.parallel import dp

    cfg = T.TransformerConfig(vocab=128, d_model=128, n_heads=2,
                              n_layers=2, d_ff=256, max_seq=128)
    params = T.init_transformer(0, cfg, torch.bfloat16, device=cuda)
    toks = torch.randint(0, cfg.vocab, (4, 128), device=cuda,
                         generator=torch.Generator(device=cuda)
                         .manual_seed(0))
    comm = P.COMM_WORLD

    def body(p, t):
        idx = comm.rank * 2 + torch.arange(2, device=t.device)
        return dp.dp_value_and_grad(
            comm, lambda q, x: T.lm_loss(cfg, q, x))(
                p, t.index_select(0, idx))

    _kernels.reset_launch_counts()
    prog = analyze.lower(P.run_spmd(body, nranks=2), params, toks)
    launches = dict(_kernels.launch_counts)
    mine = analyze.parse_program(prog).kernel_events()
    for k in _kernels.ATTENTION_KERNELS:
        assert launches[k] == 2 * cfg.n_layers, k
        assert prog.kernels()[k] == launches[k]
        assert mine[k] == cfg.n_layers
    assert analyze.run_lints(prog) == []
