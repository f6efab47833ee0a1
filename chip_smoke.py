#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mpi4torch_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 (sm_90a)
and the CUDA toolkit.  It exits non-zero, printing no result, when CUDA is
unavailable, when the package cannot be imported, or when any phase's
check fails.  Phases, in order:

1. device: the card's name and power limit;
2. build: ``nvcc`` compiles the port's kernel sources from ``ops/csrc``,
   one compiler per source, all at once; the tensor-core attention
   kernels' (forward, dq, dk/dv) registers, shared memory, spill bytes
   and blocks per SM (none may spill, two blocks must fit an SM), and the
   same for the simt kernels at their widest instantiation (DMAX 512);
3. the block-attention forward kernel (``flash_fwd``) against its plain
   PyTorch version on the card, on the cases listed in ``KERNEL_CASES``
   (among them head dims 12 and 264, batch x heads 65540 and float16),
   each within the stated tolerance, printed with the variant that
   ``_kernels.fwd_variant`` picks (``tc`` on the tensor cores, ``simt``
   on the CUDA cores) and counted under it; every ``tc`` case runs twice
   and must repeat its bits;
4. serving at the full width of the flagship transformer (vocab 32768,
   d_model 2048, 16 heads, 8 layers, d_ff 8192, max_seq 2048; bf16,
   random weights from a seed) on a tensor-parallel world of one: eight
   greedy requests through ``serve.Engine`` with four slots, checked
   against the port's own ``generate()``, with the kernel's launch count
   proving that every prefill ran through it, on the ``tc`` variant;
5. the same model on a two-rank world (``run_ranks``, both rank threads on
   the one card): four requests, both ranks bitwise identical, the
   first prefill's logits within tolerance of the one-rank logits, every
   forward launch ``tc``;
6. serving numbers: the forward kernel's time at the flagship prefill
   shape (the ``tc`` readings before and after the ``simt`` kernel called
   by name) beside its bound, its plain version and
   ``scaled_dot_product_attention`` (timed only; the port never calls
   it), then prefill, TTFT, decode rate and peak memory.  Kernel times
   are device times: CUDA events around calls queued behind a GPU sleep,
   so that the host's launch overhead is not counted;
7. the backward kernels (``flash_bwd_dq``, ``flash_bwd_dkv``) against the
   plain backward on the card: ``torch.autograd.grad`` through
   ``flash_block_attention`` with ``impl="cuda"`` and ``impl="torch"`` on
   the cases of ``BWD_CASES`` (the repaired shapes and float16 among
   them), each printed with the variant that
   ``_kernels.bwd_variant`` picks (``tc`` on the tensor cores, ``simt``
   on the CUDA cores) and counted under it; every ``tc`` case runs twice
   and must repeat its bits;
8. training the same model on one rank, the bench recipe: ``lm_loss``
   with ``vocab_chunk=4096`` on 8 x 2048 tokens, ``torch.autograd.grad``,
   ``p - 1e-3 g``, three steps; exactly ``n_layers`` launches of each
   kernel per step, every attention launch the ``tc`` variant,
   bitwise-repeatable gradients, kernel gradients
   against plain-attention gradients at batch 1, chunked against dense
   loss;
9. data-parallel training on two rank threads of the one card
   (``train_step`` with ``comm_dp=COMM_WORLD``): every attention launch
   the ``tc`` variant, both ranks bitwise
   identical, the update exactly ``p - lr g`` of the DP gradient, and
   that gradient within tolerance of the one-rank gradient at batch 8;
10. training numbers: step time, tokens/s, the device's busy and idle
    share and top ops, the attention kernels' share of device time, peak
    memory, the DP=2 step; then each attention kernel at the training
    shape (8, 2048, 16, 128) bf16 causal, held against its plain version,
    and its time beside its bound, its plain version,
    ``scaled_dot_product_attention``'s forward or backward and the
    ``simt`` kernels on the same inputs (both timed only: the port never
    calls SDPA, and the main path never takes ``simt`` for bf16 with head
    dim <= 128);
11. the quantized ring hop kernel (``q8_hop``, ``csrc/quant_hop.cu``)
    against its plain version on the card, bitwise: every combination of
    residual, stochastic rounding and hop 0, blocks of 128, 256 and 384,
    ragged row counts, zero, subnormal and non-finite blocks, and the
    kernel's element-by-element path (a block of 130; operands one
    element into their storage); the threefry noise made on the card
    against the same noise made on the CPU; and the compressed Allreduce
    on ``bidir`` at an odd split (2 ranks x 1025 float32, where the
    second channel's hops take the element-by-element path), value and
    gradient bitwise equal to the run on the plain hop;
12. the compressed Allreduce at the JAX package's bench size
    (``bench.py:249``, ``1 << 24`` float32 per rank) on a world of four
    rank threads, differentiated through ``vdot(y, y)``, for each of
    ``q8``/``q8_ef``/``q8_ef_hop`` on ``ring``/``bidir``/``torus``: ranks
    bitwise identical, value and gradient bitwise equal to the same run
    on the plain hop, the kernel's launch counts equal to the schedule's,
    and the error against the exact Allreduce within the codec's bound;
13. compressed-gradient data-parallel training of the flagship
    transformer on two rank threads, two steps of ``lm_loss`` →
    ``torch.autograd.grad`` → ``ef_allreduce(..., compression="q8")`` →
    ``/ 2`` → ``p - 1e-3 g``: ranks bitwise identical, each step's
    residual exactly ``corrected - roundtrip(corrected)``, two hop
    launches per leaf per step, every attention launch ``tc``, and the
    first step's synced gradient within a bound derived from the block
    scales of the exact DP gradient;
14. compressed numbers: the hop kernel's time at the two shapes the paths
    give it beside its bound and its plain version, each compressed
    Allreduce's step beside the exact one, and the compressed DP=2 step
    beside the exact DP=2 step, with a profile of one compressed step;
15. the mpi4torch op table at the same size on four rank threads:
    ``Bcast_`` and ``Reduce_`` (root 1, ``ring`` and ``tree``), ``Gather``
    and ``Scatter`` (root 2, uneven counts), ``Allgather``,
    ``Reduce_scatter``, ``Alltoall``, the exact ``Allreduce`` on ``ring``,
    ``rhd``, ``tree``, ``hier``, ``bidir`` and ``torus``, and
    ``ring_shift``: each value bitwise equal to its plain recomputation (a
    concatenation, a slice or the schedule's ``constants.reduce_*`` fold),
    each gradient of ``vdot(out, w_r)`` bitwise equal to the closed-form
    adjoint, every rank's output a buffer of its own; per op the fwd+bwd
    wall and device time, the bytes, the share of the copy bound, the
    device's idle share and the peak memory;
16. the halo-exchange stencil (BASELINE config 5) at 8192 x 8192 on four
    rank threads: the distributed float32 loss and gradient against the
    single-tensor computation at a seeded random field, then 20 L-BFGS
    iterations (history 10) in float64, the example's dtype, from that
    field made zero-mean (in float32, or from u = 0, L-BFGS takes no step
    on this grid; see ``stencil_phase``), with every global line-search
    scalar bitwise equal across ranks, a loss that never rises and a
    field whose mean stays at 0; time per evaluation and per iteration,
    idle share, peak memory;
17. BASELINE configs 1 and 3 at their own sizes: the linear regression
    under L-BFGS and the Isend/Irecv/Wait ring, with their own checks;
18. fused exact DP=2 training: ``train_step`` (``all_average_tree``) with
    the default 4 MiB buckets, per leaf (``fusion_scope(0)``) and through
    the Isend/Irecv pipeline (``overlap_scope(True)``): parameters
    bitwise equal to the per-leaf run, ranks identical, every attention
    launch ``tc``; bucket count, rendezvous per step, step ms and idle
    share;
19. fused compressed DP=2: ``comm.Allreduce_tree(grads, MPI_SUM,
    mean=True, compression="q8", bucket_bytes=B)`` at 4 MiB and at one
    bucket per dtype: the same step on the plain hop bitwise, ranks
    identical, each bucket within phase 13's q8 ring bound, two
    ``q8_hop`` launches per bucket; step ms and idle share beside phase
    14's per-leaf and exact steps; K1 at the largest bucket chunk of each
    against its bound;
20. ZeRO-1 (``zero_train_step``) and ZeRO-3 (``zero3_train_step``) with
    the port's ``adam`` on DP=2, two steps each: parameters bitwise equal
    to replicated-DP Adam, ranks identical, half the optimizer state (and
    for ZeRO-3 half the parameters) per rank, every attention launch
    ``tc``; step ms, idle share, peak memory;
21. the packed (``numelem`` tuples on Gather/Allgather/Scatter/Alltoall)
    and ragged collectives at phase 15's size and uneven counts, padding
    poisoned with NaN: value and gradient bitwise equal to the plain
    recomputation and the closed-form adjoint, every padding slot's
    gradient zero; wall ms, device ms, idle share per op;
22. TP=2 serving with ``ServeConfig(overlap=True)`` and with
    ``algorithm="rhd"``: phase 5's requests, tokens identical to phase
    5's blocking engine; decode tokens/s beside phase 5's;
23. one JSON line describing each ported kernel (K2, K3 and K4 with
    the variant the main path ran; the launches of phases 18–20).

The last line is ``{"ok": true, "device": {"platform": "gpu", ...}}``.
TF32 is switched off for matmuls and cuDNN here, so float32 work on the
card stays float32-exact like the JAX reference.
"""

import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and
# float32 on the CUDA cores; device-memory bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_S = 3.35e12

# Kernel vs plain tolerances: the kernel and the plain version both
# accumulate in f32 and round once at the end; lse is f32 on both sides.
# A bf16 out may land one bf16 ulp (2^-7 of its power of two) from the
# plain value: the tc kernel rounds p to bf16 where it enters the PV
# product, as the TPU kernel does, and the plain version keeps p in f32,
# so the two f32 sums differ by up to 2^-9 of the largest weights and can
# straddle a rounding boundary.  Where one ulp is above 1e-2 (|out| >= 2,
# the first rows of a causal mask, which average a handful of values)
# the bound is that ulp (ulp_out_bound).
TOL = {torch.bfloat16: {"out": 1e-2, "lse": 1e-4},
       torch.float32: {"out": 1e-5, "lse": 1e-5},
       torch.float16: {"out": 2e-5, "lse": 1e-5}}
# float16 runs the simt kernel in float32 and rounds out once to float16,
# as the plain version does: the two f32 values differ in their last bits,
# so an element may land one float16 ulp (2^-10 of its power of two)
# apart; the bound is that ulp, or TOL's 2e-5 where that is larger.
# Mantissa bits of the types whose out is bounded by one ulp.
ULP_BITS = {torch.bfloat16: 7, torch.float16: 10}

# (name, dtype, b, sq, sk, h, h_kv, d, q_off, kv_off, window, causal)
KERNEL_CASES = [
    ("flagship_prefill", torch.bfloat16, 1, 1024, 1024, 16, 16, 128,
     0, 0, 0, True),
    ("ragged_1000", torch.bfloat16, 1, 1000, 1000, 16, 16, 128, 0, 0, 0,
     True),
    ("gqa_16_4", torch.bfloat16, 1, 1024, 1024, 16, 4, 128, 0, 0, 0, True),
    ("window_256", torch.bfloat16, 1, 1024, 1024, 16, 16, 128, 0, 0, 256,
     True),
    ("q_off_256_sq_lt_sk", torch.bfloat16, 1, 256, 512, 16, 16, 128, 256,
     0, 0, True),
    ("fully_masked_rows", torch.float32, 1, 128, 128, 4, 4, 64, 0, 100, 0,
     True),
    ("f32", torch.float32, 2, 300, 300, 8, 4, 128, 0, 0, 0, True),
    ("f32_noncausal_ragged", torch.float32, 2, 130, 70, 4, 2, 128, 0, 0, 0,
     False),
    ("d64", torch.bfloat16, 2, 512, 512, 8, 8, 64, 0, 0, 0, True),
    # The tc tiles are 64 rows: "ragged_133_37" has neither edge on a tile
    # and fewer keys than one tile; "d72_window_64" is zero-padded to 128
    # in shared memory; "bf16_noncausal_ragged" masks the zero-filled keys
    # past sk without a causal mask; "d256_simt" takes the simt route.
    ("d72_window_64", torch.bfloat16, 1, 300, 300, 4, 2, 72, 0, 0, 64,
     True),
    ("ragged_133_37", torch.bfloat16, 2, 133, 37, 4, 2, 128, 0, 0, 0, True),
    ("bf16_noncausal_ragged", torch.bfloat16, 2, 130, 70, 4, 2, 128, 0, 0,
     0, False),
    ("fully_masked_rows_bf16", torch.bfloat16, 1, 128, 128, 4, 4, 64, 0,
     100, 0, True),
    ("d256_simt", torch.bfloat16, 1, 512, 512, 4, 4, 256, 0, 0, 0, True),
    # The shapes and dtypes the JAX package serves that the kernels once
    # refused: head dims off the multiples of 8 (zero-padded to 16) and
    # above 256 (264, the simt kernels at DMAX 512), batch x heads above
    # 65535 (grid x), float16 (the simt kernel in float32).
    ("d12_f32", torch.float32, 1, 512, 512, 8, 4, 12, 0, 0, 0, True),
    ("d12_bf16", torch.bfloat16, 1, 512, 512, 8, 4, 12, 0, 0, 0, True),
    ("d264_f32", torch.float32, 1, 512, 512, 4, 2, 264, 0, 0, 0, True),
    ("d264_bf16", torch.bfloat16, 1, 512, 512, 4, 2, 264, 0, 0, 0, True),
    ("bh_65540", torch.float32, 16385, 16, 16, 4, 4, 8, 0, 0, 0, True),
    ("f16", torch.float16, 1, 1024, 1024, 16, 16, 64, 0, 0, 0, True),
]

# Serving checks.  Engine (batch of slots) and generate() (batch of one)
# run different GEMM shapes, so their bf16 logits differ slightly (the
# logits are ~N(0, 1) at random init, where one bf16 ulp is 2^-8 to 2^-6;
# the largest difference measured at matched steps on an H100 was 0.047).
# A token may differ only where the oracle's top-2 logit gap is within
# TIE_TOL, and the measured logit difference must stay within it.
TIE_TOL = 0.1
# Two TP ranks sum their partial products in another order than one rank:
# bound on the first prefill's max |logit difference|, TP=2 vs TP=1
# (0.035 measured on an H100).
TP_LOGIT_TOL = 0.1
N_REQUESTS, MAX_NEW, SLOTS = 8, 32, 4
TP2_REQUESTS, TP2_MAX_NEW = 4, 8

# Backward kernels vs the plain backward.  f32: both sides sum in f32 in
# other orders; rtol 1e-3 / atol 1e-4 is the JAX package's own
# kernel-vs-oracle bound (test_pallas_bwd_interpret_grads_match).  bf16:
# each gradient rounds once to bf16 from an f32 sum over up to 2048 keys
# or queries, and the tc kernels round p and ds to bf16 where they enter
# a product, as the TPU kernel does; max |err| <= 2e-2 max |ref|, a few
# bf16 ulps (2^-8).  The JAX package's interpreted Pallas backward in bf16
# meets the same bound against the plain backward on the CPU
# (tests/test_torch_flash_bwd.py).
BWD_F32_TOL = (1e-3, 1e-4)           # (rtol, atol)
BWD_BF16_REL = 2e-2
# (name, dtype, b, sq, sk, h, h_kv, d, q_off, kv_off, window, causal,
#  the loss also reads lse).  The tc tiles are 64 rows (K3's q tiles and
# K4's KV tiles) and 32 rows (K4's q tiles): "ragged_133_37" has neither
# edge on a tile and fewer keys than one tile; "d72_window_64" is
# zero-padded to 128 in shared memory; "d256_simt" takes the simt route.
BWD_CASES = [
    ("seq_2048_b2", torch.bfloat16, 2, 2048, 2048, 16, 16, 128, 0, 0, 0,
     True, False),
    ("ragged_1000", torch.bfloat16, 1, 1000, 1000, 16, 16, 128, 0, 0, 0,
     True, False),
    ("gqa_16_4", torch.bfloat16, 1, 1024, 1024, 16, 4, 128, 0, 0, 0, True,
     False),
    ("window_256", torch.bfloat16, 1, 1024, 1024, 16, 16, 128, 0, 0, 256,
     True, False),
    ("q_off_256_sq_lt_sk", torch.bfloat16, 1, 256, 512, 16, 16, 128, 256,
     0, 0, True, False),
    ("fully_masked_rows", torch.float32, 1, 128, 128, 4, 4, 64, 0, 100, 0,
     True, False),
    ("f32", torch.float32, 2, 300, 300, 8, 4, 128, 0, 0, 0, True, False),
    ("f32_noncausal_ragged", torch.float32, 2, 130, 70, 4, 2, 128, 0, 0, 0,
     False, False),
    ("d64", torch.bfloat16, 2, 512, 512, 8, 8, 64, 0, 0, 0, True, False),
    ("lse_in_loss", torch.bfloat16, 1, 1024, 1024, 16, 16, 128, 0, 0, 0,
     True, True),
    ("d72_window_64", torch.bfloat16, 1, 300, 300, 4, 2, 72, 0, 0, 64, True,
     True),
    ("ragged_133_37", torch.bfloat16, 2, 133, 37, 4, 2, 128, 0, 0, 0, True,
     False),
    ("fully_masked_rows_bf16", torch.bfloat16, 1, 128, 128, 4, 4, 64, 0,
     100, 0, True, False),
    ("d256_simt", torch.bfloat16, 1, 512, 512, 4, 4, 256, 0, 0, 0, True,
     False),
    # The repaired shapes and dtypes (see KERNEL_CASES); float16 gradients
    # round once to float16 from f32, within BWD_F32_TOL's rtol.
    ("d12_f32", torch.float32, 1, 512, 512, 8, 4, 12, 0, 0, 0, True, True),
    ("d12_bf16", torch.bfloat16, 1, 512, 512, 8, 4, 12, 0, 0, 0, True,
     False),
    ("d264_f32", torch.float32, 1, 512, 512, 4, 2, 264, 0, 0, 0, True,
     False),
    ("d264_bf16", torch.bfloat16, 1, 512, 512, 4, 2, 264, 0, 0, 0, True,
     True),
    ("f16", torch.float16, 1, 1024, 1024, 16, 16, 64, 0, 0, 0, True, False),
]

# Training: the bench recipe (bench.py _bench_train_step) at full width.
TRAIN_BATCH, TRAIN_SEQ, VOCAB_CHUNK, LR, TRAIN_STEPS = 8, 2048, 4096, 1e-3, 3
# At init the logits are about N(0, 1) over 32768 classes, so the loss is
# near ln(32768) = 10.40 (ln V + 1/2 for unit-variance logits).
INIT_LOSS_TOL = 1.0
# Whole-model gradients at batch 1, kernel vs plain attention: every
# activation rounds to bf16 on both sides, and the two attention paths
# round at other places; bound on the norm-relative error of each leaf.
GRAD_REL_TOL = 5e-2
# Chunked (f32 logsumexp) vs dense loss (bf16 log_softmax and a bf16 sum,
# as in the JAX package): the dense loss is a bf16 number near 10.4,
# where one ulp is 0.0625; two ulps.  The same bound holds the DP=2 loss
# (a bf16 mean of two bf16 rank losses) against the one-rank loss.
LOSS_TOL = 0.125
# DP=2 vs one rank: the mean of the two ranks' gradients against the
# full-batch gradient, norm-relative per leaf.  The update lr * g is far
# below a bf16 ulp of most weights, so the updated parameters cannot show
# a wrong gradient; the gradient is compared instead, at the bound of the
# kernel-vs-plain comparison above (bf16 activations and bf16 gradient
# sums in another grouping), and train_step's update must be exactly
# p - lr * g of that DP gradient.
DP_GRAD_REL = GRAD_REL_TOL

# Quantized hop kernel vs plain: (name, nb, block, storage offset in
# elements).  Rows 0, 1 and 2 of every case are a zero block, a subnormal
# block and a block near 1e30.  The last two cases take the kernel's
# element-by-element path (kernels.hop_vec == 1): a block that is not a
# multiple of 4, and operands that start one element into their storage
# (as the second channel of bidir/torus does at an odd split).
HOP_CASES = [("block_128_ragged", 1000, 128, 0), ("block_256", 4096, 256, 0),
             ("block_384_ragged", 77, 384, 0),
             ("block_130_scalar", 50, 130, 0),
             ("block_256_offset_1", 64, 256, 1)]
# bidir on 2 ranks x 1025 float32: channel 1 starts at float 513 and fills
# its chunks exactly, so its hops read views that are only 4-byte aligned.
ODD_RANKS, ODD_NUMEL = 2, 1025
# The compressed Allreduce at the JAX package's chip size (bench.py:249):
# 1 << 24 float32 per rank on four rank threads; torus's inner group is 2.
BENCH_RANKS, BENCH_NUMEL = 4, 1 << 24
Q8_CODECS = ("q8", "q8_ef", "q8_ef_hop")
Q8_ALGOS = ("ring", "bidir", "torus")
EF_ROUNDS = {"q8": 1, "q8_ef": 2, "q8_ef_hop": 1}
# Norm-relative error against the exact Allreduce: the JAX package's own
# bounds for q8 and q8_ef (tests/test_compress.py: q8 2.5e-2 at lines 154,
# 263 and 833; q8_ef 1e-3 at line 268).  The JAX tests state none for
# q8_ef_hop: its stochastic rounding errs by f(1 - f) s^2 in variance (f
# the fractional part), up to s^2 / 4, three times round-to-nearest's
# s^2 / 12 at worst, so it is held to sqrt(3) times q8's bound.
CODEC_REL = {"q8": 2.5e-2, "q8_ef": 1e-3, "q8_ef_hop": 2.5e-2 * 3 ** 0.5}
# bf16 unit roundoff: each rounding of the synced and exact gradients.
BF16_U = 2.0 ** -8

# The op table at the same size (bench.py:249): 1 << 24 float32 per rank
# on four rank threads.  Gather and Scatter deal uneven counts around it:
# rank r holds OP_NUMEL + (2r - 3) * OP_SKEW elements (the four sum to
# 4 * OP_NUMEL).  Alltoall takes (4096, 4096) per rank, gathered along
# rows and scattered along columns, 1024 columns a rank.
OP_RANKS, OP_NUMEL, OP_SKEW = BENCH_RANKS, BENCH_NUMEL, 4096
A2A_SIDE = 4096

# The halo-exchange stencil (BASELINE config 5) at 8192 x 8192,
# row-partitioned over four rank threads (2048 rows each), halo 1: the
# distributed float32 loss and gradient against the single-tensor
# computation (torch.roll on the whole grid), which sums the same float32
# terms in other groupings; then L-BFGS in float64 (see stencil_phase)
# with history 10 for 20 iterations.
STENCIL_N, STENCIL_RANKS, STENCIL_ITERS, STENCIL_HISTORY = 8192, 4, 20, 10
STENCIL_REL = 1e-5
# ZeRO-1 and ZeRO-3 against replicated-DP Adam: steps and learning rate.
ZERO_STEPS, ADAM_LR = 2, 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def event_ms(fn, iters=20, warmup=3):
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls.
    The calls queue behind a GPU sleep longer than the host takes to
    issue them, so the interval holds the device's work and not the host's
    launch overhead (a call whose device work is shorter than its Python
    wrapper would otherwise time the wrapper)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # Cycles at up to 2 GHz: three times the issue time of the timed calls
    # plus a millisecond.
    torch.cuda._sleep(int(2e9 * min(1e-3 + 3 * iters * host_s, 2.0)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase(n, title):
    print(f"\n== phase {n}: {title}", flush=True)


def attention_inputs(dtype, b, sq, sk, h, h_kv, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda", dtype=dtype)
            for shape in ((b, sq, h, d), (b, sk, h_kv, d), (b, sk, h_kv, d))]


def live_pairs(sq, sk, q_off, kv_off, window, causal):
    """Unmasked (query, key) pairs of one head: the work these inputs
    need (masked tiles and pairs need none)."""
    if not causal:
        return sq * sk
    qp = q_off + torch.arange(sq, device="cuda")[:, None]
    kp = kv_off + torch.arange(sk, device="cuda")[None, :]
    mask = qp >= kp
    if window:
        mask &= (qp - kp) < window
    return int(mask.sum().item())


def ulp_out_bound(ref, dt):
    """Per-element bound on |kernel - plain| for a bf16 or float16 out:
    TOL's absolute bound, or one ulp of the plain value in its type where
    that is larger (see TOL)."""
    ulp = torch.pow(2.0, torch.floor(torch.log2(
        ref.float().abs().clamp_min(2.0 ** -126))) - ULP_BITS[dt])
    return torch.clamp_min(ulp, TOL[dt]["out"])


def forward_errors(o, l, po, pl, dt):
    """(max |out err|, elements of out beyond TOL's absolute bound, max
    |lse err|, within the tolerance)."""
    e = (o.float() - po.float()).abs()
    err_l = (l - pl.float()).abs().max().item()
    bound = ulp_out_bound(po, dt) if dt in ULP_BITS else TOL[dt]["out"]
    ok = (bool((e <= bound).all()) and err_l <= TOL[dt]["lse"]
          and bool(torch.isfinite(o).all()))
    return (e.max().item(), int((e > TOL[dt]["out"]).sum()), err_l, ok)


def kernel_phase(flash, kernels):
    """Each case: the forward kernel against the plain version, one
    launch counted under the variant ``fwd_variant`` picks; a tc case runs
    twice and must repeat its bits.  Returns max |out err| per case."""
    results = {}
    for i, (name, dt, b, sq, sk, h, h_kv, d, q_off, kv_off, window,
            causal) in enumerate(KERNEL_CASES):
        q, k, v = attention_inputs(dt, b, sq, sk, h, h_kv, d, seed=i)
        kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off,
                  window=window)
        variant = kernels.fwd_variant(dt, d)
        names = ("flash_fwd", f"flash_fwd.{variant}")
        before = [kernels.launch_counts[n] for n in names]
        o, l = flash.flash_block_attention(q, k, v, impl="cuda", **kw)
        rose = [kernels.launch_counts[n] - c for n, c in zip(names, before)]
        repeat = "-"
        if variant == "tc":
            o2, l2 = flash.flash_block_attention(q, k, v, impl="cuda", **kw)
            repeat = torch.equal(o, o2) and torch.equal(l, l2)
            del o2, l2
        po, pl = flash.flash_block_attention(q, k, v, impl="torch", **kw)
        torch.cuda.synchronize()
        err_o, n_over, err_l, ok = forward_errors(o, l, po, pl, dt)
        ok = ok and rose == [1, 1] and repeat is not False
        if name.startswith("fully_masked_rows"):
            n_masked = kv_off - q_off
            ok = ok and bool((o[:, :n_masked] == 0).all()) and bool(
                (l[:, :n_masked] == flash.NEG_BIG).all())
        tol = TOL[dt]
        print(f"  {name:24s} {str(dt):15s} d {d:3d} {variant:4s} out err "
              f"{err_o:.3e} (tol {tol['out']:g}"
              f"{' or 1 ulp' if dt in ULP_BITS else ''}; "
              f"{n_over} beyond {tol['out']:g})  lse err {err_l:.3e} "
              f"(tol {tol['lse']:g})  launches +{rose[0]} ({variant} "
              f"+{rose[1]}); repeat bitwise {repeat}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"kernel case {name} disagrees with the plain version, "
              f"did not launch the {variant} kernel once, or did not "
              "repeat its bits")
        results[name] = err_o
    return results


def flagship_config(T):
    return T.TransformerConfig(vocab=32768, d_model=2048, n_heads=16,
                               n_layers=8, d_ff=8192, max_seq=2048)


def make_prompts(cfg, n):
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1537, size=n)
    if all(x % 128 == 0 for x in lens):
        lens[0] += 1
    return [rng.integers(0, cfg.vocab, size=int(x)) for x in lens]


def oracle_stream(T, cfg, params, prompt, n_new):
    """The port's generate() loop for one request, keeping each step's
    top-2 logit gap (the near-tie measure) and its logits row."""
    cache = T.init_kv_cache(cfg, 1, params["embed"].dtype, "cuda")
    p = torch.as_tensor(prompt, device="cuda")[None]
    logits, cache = T.prefill(cfg, params, cache, p)
    toks, gaps, rows = [], [], []
    for i in range(n_new):
        if i:
            logits, cache = T.decode_step(cfg, params, cache,
                                          torch.tensor([toks[-1]],
                                                       device="cuda"),
                                          len(prompt) + i - 1)
        top2 = logits[0].float().topk(2).values
        gaps.append((top2[0] - top2[1]).item())
        rows.append(logits[0])
        toks.append(int(T.select_token(logits)[0]))
    return toks, gaps, rows


def serve_tp1(T, serve, kernels, cfg, params, prompts):
    eng = serve.Engine(cfg, params,
                       serve.ServeConfig(slots=SLOTS, max_new=MAX_NEW),
                       device="cuda")
    for p in prompts:
        eng.submit(p)
    slot_of, engine_rows = {}, {}
    decode_ms, decode_tok = 0.0, 0
    kernels.reset_launch_counts()
    t_run = time.perf_counter()
    while eng.pending():
        t0 = time.perf_counter()
        ev = eng.step()           # ends in a host read of the tokens
        dt = (time.perf_counter() - t0) * 1e3
        for rid, j in eng.slot_log:
            slot_of[rid] = j
        n_dec = 0
        for rid, toks in ev["emitted"].items():
            decoded = toks[1:] if rid in ev["admitted"] else toks
            if decoded:
                n_dec += 1
                engine_rows.setdefault(rid, []).append(
                    eng.last_logits[slot_of[rid]].clone())
        if not ev["admitted"]:
            decode_ms += dt
            decode_tok += n_dec
    run_s = time.perf_counter() - t_run
    launches = (kernels.launch_counts["flash_fwd"],
                kernels.launch_counts["flash_fwd.tc"])
    return eng, launches, engine_rows, decode_ms, decode_tok, run_s


def compare_with_oracle(T, cfg, params, prompts, results, engine_rows):
    """Per request: the first token equal; later tokens equal until the
    first near-tie step of the oracle.  Returns (near-tie divergences,
    oracle near-tie steps, max |logit diff| at matched steps)."""
    divergences, tie_steps, max_diff = 0, 0, 0.0
    for rid, prompt in enumerate(prompts):
        got = results[rid][len(prompt):].tolist()
        want, gaps, rows = oracle_stream(T, cfg, params, prompt, MAX_NEW)
        tie_steps += sum(g <= TIE_TOL for g in gaps)
        check(got[0] == want[0],
              f"request {rid}: first token {got[0]} != generate()'s "
              f"{want[0]}")
        first_diff = next((i for i, (a, b) in enumerate(zip(got, want))
                           if a != b), None)
        upto = MAX_NEW if first_diff is None else first_diff
        # engine_rows[rid][i] produced token i + 1 from tokens 0..i, which
        # both paths share while i < upto.
        for i, row in enumerate(engine_rows.get(rid, [])[:upto]):
            max_diff = max(max_diff,
                           (row.float() - rows[i + 1].float()).abs().max()
                           .item())
        if first_diff is not None:
            check(gaps[first_diff] <= TIE_TOL,
                  f"request {rid}: token {first_diff} differs from "
                  f"generate() without a near tie (top-2 gap "
                  f"{gaps[first_diff]:.4f} > {TIE_TOL})")
            divergences += 1
    check(max_diff <= TIE_TOL,
          f"engine vs generate() logits differ by {max_diff:.4f} at matched "
          f"steps, beyond the near-tie tolerance {TIE_TOL}")
    # generate() itself is the loop above.
    g = T.generate(cfg, params, torch.as_tensor(prompts[0],
                                                device="cuda")[None],
                   MAX_NEW)[0, len(prompts[0]):].tolist()
    want0, _, _ = oracle_stream(T, cfg, params, prompts[0], MAX_NEW)
    check(g == want0, "generate() disagrees with its own step loop")
    return divergences, tie_steps, max_diff


def profile_top(fn, label, n_top=6):
    """Run ``fn`` under torch.profiler; print its wall time, the device's
    busy time and share, and the device ops that took the most time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side kernels and copies only: CPU ops also carry the device
    # time of what they launched, and the spans mirror onto the GPU
    # timeline as annotations, so either would count time twice.
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not e.is_user_annotation and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    top = sorted(ev, key=lambda e: e.self_device_time_total, reverse=True)
    print(f"  profile {label}: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.0f}%, idle "
          f"{100 - 100 * busy_ms / wall_ms:.0f}%)")
    for e in top[:n_top]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms  "
              f"x{e.count:<5d} {e.key[:90]}")
    return wall_ms, busy_ms, ev


def serve_tp2(P, T, serve, kv, kernels, cfg, params, prompts, **scfg):
    """Phase 5's two-rank run (a prefill, then TP2_REQUESTS requests
    through serve.Engine with ServeConfig options ``scfg``).  Returns each
    rank's (first prefill's logits, token streams), the flash_fwd launch
    counts (all, tc), the run's ms and rank 0's decode tokens per second
    over its decode-only steps (steps that admitted no request), as phase
    6 counts them."""
    def rank_body():
        with torch.inference_mode():
            shards = kv.shard_params_tp(cfg, params, P.COMM_WORLD)
            cache = kv.init_kv_cache_tp(cfg, 1, P.COMM_WORLD.size,
                                        params["embed"].dtype, "cuda")
            p0 = torch.as_tensor(prompts[0], device="cuda")[None]
            logits, _ = kv.prefill_tp(cfg, shards, cache, p0, P.COMM_WORLD)
            eng = serve.Engine(cfg, params,
                               serve.ServeConfig(slots=SLOTS,
                                                 max_new=TP2_MAX_NEW,
                                                 **scfg),
                               device="cuda")
            for p in prompts[:TP2_REQUESTS]:
                eng.submit(p)
            decode_s, decode_tok = 0.0, 0
            while eng.pending():
                t0 = time.perf_counter()
                ev = eng.step()       # ends in a host read of the tokens
                if not ev["admitted"]:
                    decode_s += time.perf_counter() - t0
                    decode_tok += len(ev["emitted"])
            res = eng.results()
            return logits[0].float().cpu(), \
                [res[i].tolist() for i in range(TP2_REQUESTS)], \
                decode_tok / decode_s

    kernels.reset_launch_counts()
    ms, out = sync_ms(lambda: P.run_ranks(rank_body, 2, device="cuda"))
    return [o[:2] for o in out], (kernels.launch_counts["flash_fwd"],
                                  kernels.launch_counts["flash_fwd.tc"]), \
        ms, out[0][2]


def bound(flops, nbytes, dtype):
    """The least time (ms) the card could take: operations over the peak
    rate for the type, or bytes over the memory rate, whichever is
    larger; and which of the two it is."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def attention_grads(flash, q, k, v, wo, wl, impl, kw):
    """dq, dk, dv of sum(out * wo) (+ sum(lse * wl) when wl is given)."""
    x = [t.detach().requires_grad_() for t in (q, k, v)]
    o, l = flash.flash_block_attention(*x, impl=impl, **kw)
    loss = (o.float() * wo.float()).sum()
    if wl is not None:
        loss = loss + (l.float() * wl).sum()
    return torch.autograd.grad(loss, x)


def backward_phase(flash, kernels):
    """Each case: the kernels' gradients against the plain backward's, one
    launch of each backward kernel, counted under the variant
    ``bwd_variant`` picks; a tc case runs twice and must repeat its bits.
    Returns max |err| per case."""
    results = {}
    for i, (name, dt, b, sq, sk, h, h_kv, d, q_off, kv_off, window,
            causal, uses_lse) in enumerate(BWD_CASES):
        q, k, v = attention_inputs(dt, b, sq, sk, h, h_kv, d, seed=100 + i)
        g = torch.Generator(device="cuda").manual_seed(200 + i)
        wo = torch.randn(q.shape, generator=g, device="cuda", dtype=dt)
        wl = torch.randn(q.shape[:3], generator=g, device="cuda") \
            if uses_lse else None
        kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off,
                  window=window)
        variant = kernels.bwd_variant(dt, d)
        names = [f"flash_bwd_{p}{s}" for s in ("", f".{variant}")
                 for p in ("dq", "dkv")]
        before = [kernels.launch_counts[n] for n in names]
        got = attention_grads(flash, q, k, v, wo, wl, "cuda", kw)
        rose = [kernels.launch_counts[n] - c for n, c in zip(names, before)]
        repeat = "-"
        if variant == "tc":
            again = attention_grads(flash, q, k, v, wo, wl, "cuda", kw)
            repeat = all(torch.equal(a, r) for a, r in zip(got, again))
            del again
        want = attention_grads(flash, q, k, v, wo, wl, "torch", kw)
        torch.cuda.synchronize()
        ok, err, rel = rose == [1, 1, 1, 1] and repeat is not False, 0.0, 0.0
        for a, r in zip(got, want):
            ok = ok and a.dtype == r.dtype and bool(torch.isfinite(a).all())
            a, r = a.float(), r.float()
            e = (a - r).abs()
            err = max(err, e.max().item())
            rel = max(rel, e.max().item() / r.abs().max().item())
            if dt != torch.bfloat16:
                rtol, atol = BWD_F32_TOL
                ok = ok and bool((e <= atol + rtol * r.abs()).all())
            else:
                ok = ok and rel <= BWD_BF16_REL
        if name.startswith("fully_masked_rows"):
            # Queries before the first key, and keys after the last query,
            # get exactly zero gradients.
            n_masked, n_seen = kv_off - q_off, q_off + sq - kv_off
            ok = ok and bool((got[0][:, :n_masked] == 0).all()) and all(
                bool((t[:, n_seen:] == 0).all()) for t in got[1:])
        tol = (f"rtol {BWD_F32_TOL[0]:g} atol {BWD_F32_TOL[1]:g}"
               if dt != torch.bfloat16 else f"{BWD_BF16_REL:g} max|ref|")
        print(f"  {name:24s} {str(dt):15s} d {d:3d} {variant:4s} dq/dk/dv "
              f"max err {err:.3e} = {rel:.2e} max|ref| (tol {tol})"
              f"{'  dlse live' if uses_lse else ''}"
              f"  launches +{rose[0]}/+{rose[1]} ({variant} +{rose[2]}/"
              f"+{rose[3]}); repeat bitwise {repeat}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"backward case {name} disagrees with the plain backward, "
              f"did not launch each {variant} kernel once, or did not "
              "repeat its bits")
        results[name] = err
    return results


def recipe_step(T, tree, cfg, params, tokens, vocab_chunk=VOCAB_CHUNK):
    """The bench recipe's step: lm_loss, torch.autograd.grad, p - lr g."""
    loss, grads = tree.value_and_grad(
        lambda p: T.lm_loss(cfg, p, tokens, vocab_chunk=vocab_chunk),
        params)
    with torch.no_grad():
        new = tree.tree_map(lambda p, g: p - LR * g, params, grads)
    return loss, grads, new


def leaves_equal(tree, a, b):
    return all(torch.equal(x, y) for x, y in
               zip(tree.tree_leaves(a), tree.tree_leaves(b)))


def train_tp1(T, tree, flash, kernels, cfg, params, tokens):
    n = cfg.n_layers
    names = kernels.ATTENTION_KERNELS + tuple(
        f"{k}.tc" for k in kernels.ATTENTION_KERNELS)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    p, losses, step_ms, per_step = params, [], [], []
    for _ in range(TRAIN_STEPS):
        before = [kernels.launch_counts[k] for k in names]
        ms, (loss, grads, p) = sync_ms(
            lambda p=p: recipe_step(T, tree, cfg, p, tokens))
        per_step.append([kernels.launch_counts[k] - c
                         for k, c in zip(names, before)])
        losses.append(loss.item())
        step_ms.append(ms)
        if len(per_step) == 1:
            loss0, grads0 = loss, grads
        del grads
    launches = dict(kernels.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {TRAIN_STEPS} steps at batch {TRAIN_BATCH} x {TRAIN_SEQ}: "
          f"losses {[round(x, 4) for x in losses]} (ln V = "
          f"{np.log(cfg.vocab):.3f}); step wall {[round(x) for x in step_ms]}"
          f" ms; launches per step (fwd, dq, dkv, fwd.tc, dq.tc, dkv.tc) "
          f"{per_step}")
    check(all(np.isfinite(losses)), "a training loss is not finite")
    check(abs(losses[0] - np.log(cfg.vocab)) <= INIT_LOSS_TOL,
          f"initial loss {losses[0]:.4f} is not near ln V")
    check(all(c == [n] * len(names) for c in per_step),
          f"expected exactly n_layers = {n} launches of each kernel per "
          "step, every attention launch on the tc variant")

    loss_r, grads_r, _ = recipe_step(T, tree, cfg, params, tokens)
    same = torch.equal(loss_r, loss0) and leaves_equal(tree, grads_r,
                                                       grads0)
    print(f"  the first step again from the same parameters: loss and "
          f"gradients bitwise equal: {same}")
    check(same, "two runs of the same step differ")
    del grads0, grads_r

    # Whole-model gradients at batch 1: kernels against plain attention.
    one = tokens[:1]
    _, g_k = tree.value_and_grad(
        lambda q: T.lm_loss(cfg, q, one, vocab_chunk=VOCAB_CHUNK), params)
    kernel_attention = T.flash_attention
    T.flash_attention = lambda *a, **kw: flash.flash_attention(
        *a, **dict(kw, impl="torch"))
    try:
        before = dict(kernels.launch_counts)
        _, g_p = tree.value_and_grad(
            lambda q: T.lm_loss(cfg, q, one, vocab_chunk=VOCAB_CHUNK),
            params)
        check(dict(kernels.launch_counts) == before,
              "the plain-attention run launched a kernel")
    finally:
        T.flash_attention = kernel_attention
    worst = max(((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30)).item()
                for a, b in zip(tree.tree_leaves(g_k), tree.tree_leaves(g_p)))
    print(f"  batch 1, kernel vs plain attention: worst leaf's "
          f"norm-relative gradient error {worst:.3e} (tol {GRAD_REL_TOL:g})")
    check(worst <= GRAD_REL_TOL, "kernel gradients disagree with the "
          "plain-attention gradients")
    del g_k, g_p

    with torch.no_grad():
        dense = T.lm_loss(cfg, params, tokens, vocab_chunk=0).item()
        chunked = T.lm_loss(cfg, params, tokens,
                            vocab_chunk=VOCAB_CHUNK).item()
    print(f"  loss dense {dense:.4f} vs vocab_chunk={VOCAB_CHUNK} "
          f"{chunked:.4f} (tol {LOSS_TOL})")
    check(abs(dense - chunked) <= LOSS_TOL, "chunked and dense losses "
          "disagree")
    return step_ms, launches, peak_gb


def norm_rel(tree, a, b):
    """The worst leaf's ||a - b|| / ||b||."""
    return max(((x.float() - y.float()).norm()
                / y.float().norm().clamp_min(1e-30)).item()
               for x, y in zip(tree.tree_leaves(a), tree.tree_leaves(b)))


def train_dp2(P, T, tree, dp, kernels, cfg, params, tokens):
    rows = TRAIN_BATCH // 2

    def shard(rank):
        return tokens[rank * rows:(rank + 1) * rows]

    def body(rank):
        return T.train_step(cfg, params, shard(rank), comm_dp=P.COMM_WORLD,
                            lr=LR)

    kernels.reset_launch_counts()
    dp_ms, ((l0, p0), (l1, p1)) = sync_ms(
        lambda: P.run_ranks(body, 2, device="cuda"))
    launches = dict(kernels.launch_counts)
    same = torch.equal(l0, l1) and leaves_equal(tree, p0, p1)
    del p1
    # The DP gradient itself, from the same recipe (parameters averaged
    # over the world, loss Allreduced) through dp_value_and_grad.
    vg = dp.dp_value_and_grad(P.COMM_WORLD,
                              lambda p, x: T.lm_loss(cfg, p, x))
    (gl0, g0), (gl1, g1) = P.run_ranks(lambda rank: vg(params, shard(rank)),
                                       2, device="cuda")
    same_g = torch.equal(gl0, gl1) and leaves_equal(tree, g0, g1)
    del g1
    with torch.no_grad():
        applied = leaves_equal(tree, p0, tree.tree_map(
            lambda p, g: p - LR * g, params, g0))
    del p0
    ref_loss, ref_g = tree.value_and_grad(
        lambda p: T.lm_loss(cfg, p, tokens), params)
    worst = norm_rel(tree, g0, ref_g)
    del g0, ref_g
    want = 2 * cfg.n_layers
    print(f"  2 ranks x batch {rows}: step {dp_ms:.0f} ms; ranks bitwise "
          f"identical: parameters {same}, gradients {same_g}; update is "
          f"p - {LR:g} g of the DP gradient bitwise: {applied}; loss "
          f"{l0.item():.4f} vs one rank at batch {TRAIN_BATCH} "
          f"{ref_loss.item():.4f} (tol {LOSS_TOL}); DP vs one-rank "
          f"gradient, worst leaf's norm-relative error {worst:.3e} (tol "
          f"{DP_GRAD_REL:g}); launches {launches} (expected {want} each of "
          "flash_fwd, flash_bwd_dq, flash_bwd_dkv and their .tc)")
    check(same and same_g, "the two DP ranks disagree")
    check(applied and torch.equal(gl0, l0),
          "train_step's update is not p - lr g of the DP gradient")
    check(abs(l0.item() - ref_loss.item()) <= LOSS_TOL,
          "DP=2 loss too far from the one-rank loss")
    check(worst <= DP_GRAD_REL, "DP=2 gradient too far from one rank's")
    check(all(launches[k] == launches[f"{k}.tc"] == want
              for k in kernels.ATTENTION_KERNELS),
          "DP=2 did not run every attention on the tc kernels")
    return dp_ms


def backward_numbers(flash, kernels):
    """K2, K3 and K4 at the shape the training step gives them, (8, 2048,
    16, 128) bf16 causal: each held against its plain version on the same
    inputs (the backward from the kernel forward's out and lse), then
    kernel ms, bound, plain ms and the library yardsticks.  Returns
    (kernel ms, bounds, plain ms, library ms, max |err|, simt ms), keyed
    by kernel; "pair" is the whole backward (dq, dk and dv together)."""
    dt, b, s, h, d = torch.bfloat16, TRAIN_BATCH, TRAIN_SEQ, 16, 128
    q, k, v = attention_inputs(dt, b, s, s, h, h, d, seed=7)
    do = attention_inputs(dt, b, s, s, h, h, d, seed=8)[0]
    zero = torch.tensor(0, dtype=torch.int32, device="cuda")
    out, lse = kernels.flash_fwd(q, k, v, 0, 0, True)
    dd = (do.float() * out.float()).sum(-1)
    got = [kernels.flash_bwd_dq(q, k, v, do, lse, dd, 0, 0, True),
           *kernels.flash_bwd_dkv(q, k, v, do, lse, dd, 0, 0, True)]
    p_out, p_lse = flash._torch_block(q, k, v, zero, zero, True)
    want = flash._torch_block_bwd(q, k, v, out, lse, do, None, zero, zero,
                                  True)
    torch.cuda.synchronize()
    err_o, n_over, err_l, ok = forward_errors(out, lse, p_out, p_lse, dt)
    errs, rel = [], []
    for a, r in zip(got, want):
        ok = ok and bool(torch.isfinite(a).all())
        errs.append((a.float() - r.float()).abs().max().item())
        rel.append(errs[-1] / r.float().abs().max().item())
        ok = ok and rel[-1] <= BWD_BF16_REL
    print(f"  at ({b}, {s}, {h}, {d}) bf16 causal against the plain "
          f"versions: out err {err_o:.3e} (tol {TOL[dt]['out']:g} or 1 ulp;"
          f" {n_over} beyond {TOL[dt]['out']:g}), lse err {err_l:.3e} (tol "
          f"{TOL[dt]['lse']:g}); dq/dk/dv max err "
          + "/".join(f"{e:.3e}" for e in errs) + " = "
          + "/".join(f"{x:.2e}" for x in rel)
          + f" max|ref| (tol {BWD_BF16_REL:g})  {'ok' if ok else 'FAIL'}",
          flush=True)
    check(ok, "a kernel disagrees with its plain version at the training "
          "shape")
    err = {"flash_fwd": err_o, "flash_bwd_dq": errs[0],
           "flash_bwd_dkv": max(errs[1:])}
    del got, want, p_out, p_lse

    pairs = b * h * live_pairs(s, s, 0, 0, 0, True)
    qbytes, stats = b * s * h * d * 2, b * s * h * 4
    res = {}
    bwd = {"flash_bwd_dq": kernels.flash_bwd_dq,
           "flash_bwd_dkv": kernels.flash_bwd_dkv}

    def time_all(variant, iters):
        t = {"flash_fwd": event_ms(lambda: kernels.flash_fwd(
            q, k, v, 0, 0, True, variant=variant), iters=iters)}
        t.update({n: event_ms(lambda fn=fn: fn(q, k, v, do, lse, dd, 0, 0,
                                               True, variant=variant),
                              iters=iters) for n, fn in bwd.items()})
        return t

    # The main path's variant (tc), then the simt kernels on the same
    # inputs, called by name and timed only, then tc again: in turns, so
    # that a drift of the card's clock shows as a spread of the two tc
    # readings.
    tc_runs = [time_all("tc", 10)]
    simt = time_all("simt", 5)
    tc_runs.append(time_all("tc", 10))
    for n in tc_runs[0]:
        res[n] = sum(r[n] for r in tc_runs) / len(tc_runs)
    bounds = {"flash_fwd": bound(4.0 * d * pairs, 4 * qbytes + stats, dt),
              "flash_bwd_dq": bound(6.0 * d * pairs,
                                    5 * qbytes + 2 * stats, dt),
              "flash_bwd_dkv": bound(8.0 * d * pairs,
                                     6 * qbytes + 2 * stats, dt)}

    def plain_bwd(parts):
        return event_ms(lambda: flash._torch_block_bwd(
            q, k, v, out, lse, do, None, zero, zero, True, parts=parts),
            iters=3, warmup=1)

    plain = {"flash_fwd": event_ms(lambda: flash._torch_block(
        q, k, v, zero, zero, True), iters=3, warmup=1),
        "flash_bwd_dq": plain_bwd(("dq",)),
        "flash_bwd_dkv": plain_bwd(("dkv",)),
        "pair": plain_bwd(("dq", "dkv"))}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = event_ms(lambda: sdpa(qt, kt, vt, is_causal=True), iters=10)
    lib_fb = event_ms(lambda: torch.autograd.grad(
        sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), dot), iters=10)
    lib = {"flash_fwd": lib_fwd, "pair": lib_fb - lib_fwd}
    for name in res:
        b_ms, b_by = bounds[name]
        more = ""
        if name == "flash_fwd":
            more = (f"; scaled_dot_product_attention forward {lib_fwd:.4f} "
                    f"ms (tc {res[name] / lib_fwd:.2f}x it); "
                    f"{4.0 * d * pairs / res[name] / 1e9:.1f} TFLOP/s of live "
                    "pairs")
        print(f"  {name} at ({b}, {s}, {h}, {d}) bf16 causal: kernel tc "
              f"{res[name]:.4f} ms (runs "
              + "/".join(f"{r[name]:.4f}" for r in tc_runs)
              + f"), simt {simt[name]:.4f} ms ({simt[name] / res[name]:.1f}x"
              f" the tc time), plain {plain[name]:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / res[name]:.2f}% of "
              f"bound{more}")
    pair = res["flash_bwd_dq"] + res["flash_bwd_dkv"]
    pair_bound = bounds["flash_bwd_dq"][0] + bounds["flash_bwd_dkv"][0]
    print(f"  backward pair (dq, dk, dv), tc: kernels {pair:.4f} ms, "
          f"{100 * pair_bound / pair:.2f}% of the pair's bound "
          f"{pair_bound:.4f} ms; simt "
          f"{simt['flash_bwd_dq'] + simt['flash_bwd_dkv']:.4f} ms; plain "
          f"backward {plain['pair']:.4f} ms; scaled_dot_product_attention "
          f"forward {lib_fwd:.4f} ms, backward (grad minus forward) "
          f"{lib['pair']:.4f} ms ({pair / lib['pair']:.2f}x)")
    return res, bounds, plain, lib, err, simt


def bits_differ(a, b):
    """Count of elements whose bits differ; NaN matches NaN."""
    if a.dtype == torch.float32:
        both_nan = torch.isnan(a) & torch.isnan(b)
        return int(((a.view(torch.int32) != b.view(torch.int32))
                    & ~both_nan).sum())
    return int((a != b).sum())


def offset_view(t, offset):
    """``t``'s values in a view that starts ``offset`` elements into its
    storage."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def hop_operands(nb, block, seed, offset=0):
    """q, scale, mine, noise of one hop on the card, from a seed: an int8
    payload, power-of-two scales, contributions with a zero block (row 0),
    a subnormal block (row 1) and a block near 1e30 (row 2); each starting
    ``offset`` elements into its storage."""
    from mpi4torch_tpu_torch.ops import quant_kernels as qk

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randint(-127, 128, (nb, block), generator=g, device="cuda",
                      dtype=torch.int8)
    q[:2] = 0
    scale = qk.po2_scale(torch.rand(nb, generator=g, device="cuda") * 0.1
                         + 1e-3)
    mine = torch.randn((nb, block), generator=g, device="cuda") * 3.0
    mine[0] = 0.0
    mine[1] = torch.linspace(-1.1e-38, 1.1e-38, block, device="cuda")
    mine[2] *= 1e30
    noise = torch.rand((nb, block), generator=g, device="cuda")
    return [offset_view(t, offset) for t in (q, scale, mine, noise)]


def max_abs_diff(a, b):
    """max |a - b| over the elements where both are finite (0.0 when
    none)."""
    a, b = a.double(), b.double()
    both = torch.isfinite(a) & torch.isfinite(b)
    return (a - b)[both].abs().max().item() if bool(both.any()) else 0.0


def hop_compare(qk, args, mine, noise, want_resid, finite_rows=None):
    """One hop on the kernel and on the plain version, same inputs;
    returns the mismatched element counts of (q, scale, resid), the
    largest |kernel - plain| over the compared finite values, and the
    kernel's outputs.  Rows outside ``finite_rows`` hold a non-finite
    input: there only the scale is compared (the int8 value of a NaN is
    not specified)."""
    got = qk.dequant_accum_requant(*args, mine, noise=noise,
                                   want_resid=want_resid, impl="cuda")
    want = qk.dequant_accum_requant(*args, mine, noise=noise,
                                    want_resid=want_resid, impl="torch")
    torch.cuda.synchronize()
    rows = slice(None) if finite_rows is None else finite_rows
    out = [bits_differ(got[0][rows], want[0][rows]),
           bits_differ(got[1], want[1])]
    out.append(bits_differ(got[2][rows], want[2][rows]) if want_resid
               else 0)
    err = max([max_abs_diff(got[0][rows], want[0][rows]),
               max_abs_diff(got[1], want[1])]
              + ([max_abs_diff(got[2][rows], want[2][rows])]
                 if want_resid else []))
    return out, err, got


def hop_kernel_phase(qk, kernels):
    """K1 against its plain version on every case; prints the mismatched
    element counts, which must all be 0.  Returns the largest |kernel -
    plain| over the compared finite values."""
    total, max_err = 0, 0.0
    for i, (name, nb, block, offset) in enumerate(HOP_CASES):
        q, scale, mine, noise = hop_operands(nb, block, seed=300 + i,
                                             offset=offset)
        vec = kernels.hop_vec(block, [mine, noise], [q])
        want_vec = 1 if block % 4 or offset else 4
        check(vec == want_vec, f"hop case {name} takes vec {vec}, expected "
              f"{want_vec}")
        counts = []
        for hop0 in (False, True):
            for stochastic in (False, True):
                for want_resid in (False, True):
                    args = (None, None) if hop0 else (q, scale)
                    key = "q8_requant" if hop0 else "q8_hop"
                    before = kernels.launch_counts[key]
                    c, err, got = hop_compare(qk, args, mine,
                                              noise if stochastic else None,
                                              want_resid)
                    max_err = max(max_err, err)
                    check(kernels.launch_counts[key] == before + 1,
                          f"hop case {name} did not launch the kernel")
                    check(got[1][0].item() == got[1][1].item() == 2.0**-126,
                          f"hop case {name}: zero/subnormal block scale "
                          "is not 2^-126")
                    counts.append(sum(c))
        total += sum(counts)
        print(f"  {name:18s} ({nb}, {block}), vec {vec}: 8 flag "
              f"combinations (hop 0 x stochastic x residual), mismatched "
              f"elements "
              f"{counts}  {'ok' if not sum(counts) else 'FAIL'}",
              flush=True)
    q, scale, mine, noise = hop_operands(64, 256, seed=399)
    mine[5, 17] = float("nan")
    mine[6, 100] = float("inf")
    finite = [r for r in range(64) if r not in (5, 6)]
    c, err, got = hop_compare(qk, (q, scale), mine, noise, True, finite)
    max_err = max(max_err, err)
    bad_scale = bool(torch.isfinite(got[1][5:7]).any())
    print(f"  non_finite (64, 256): scales of the NaN and inf blocks "
          f"{got[1][5].item()}, {got[1][6].item()}; mismatched elements "
          f"{c} (q and residual over finite rows)  "
          f"{'ok' if not sum(c) and not bad_scale else 'FAIL'}", flush=True)
    total += sum(c)
    check(total == 0, "the hop kernel disagrees with its plain version")
    check(not bad_scale, "a non-finite block got a finite scale")
    mism = 0
    for salt, hop, rank, shape in [(0, 0, 0, (1024, 256)),
                                   (3, 2, 1, (333, 384)),
                                   (5, 7, 3, (1, 1))]:
        key = qk.schedule_key(salt, hop, rank)
        mism += bits_differ(qk.hop_noise(key, *shape, device="cuda").cpu(),
                            qk.hop_noise(key, *shape))
    print(f"  threefry noise made on the card vs on the CPU, 3 keys: "
          f"mismatched elements {mism}  {'ok' if not mism else 'FAIL'}")
    check(mism == 0, "threefry noise differs between the card and the CPU")
    return max_err


def odd_split_phase(P, C, kernels, config):
    """bidir at an odd split: every block-q8 codec on ODD_RANKS rank
    threads x ODD_NUMEL float32, value and gradient, on the kernel and on
    the plain hop, bitwise.  Channel 1's hops read views that start at an
    odd float offset, so the kernel goes element by element there.
    Returns the largest |kernel - plain| over the outputs."""
    m = C.multipath_split(ODD_NUMEL)
    g = torch.Generator(device="cuda").manual_seed(11)
    xs = [torch.randn(ODD_NUMEL, generator=g, device="cuda")
          for _ in range(ODD_RANKS)]
    vec = kernels.hop_vec(256, [xs[0][m:]], [])
    pad = (ODD_NUMEL - m) % (ODD_RANKS * 256)
    check(vec == 1 and pad == 0, "the odd-split case does not reach the "
          "element-by-element path")
    max_err = 0.0
    for codec in Q8_CODECS:
        kernels.reset_launch_counts()
        got = q8_value_and_grad(P, xs, codec, "bidir")
        hops = kernels.launch_counts["q8_hop"]
        config.set_quant_hop_impl("torch")
        try:
            want = q8_value_and_grad(P, xs, codec, "bidir")
        finally:
            config.set_quant_hop_impl("auto")
        same = all(torch.equal(y, got[0][0]) and torch.equal(gr, got[0][1])
                   for y, gr in got)
        pairs = [(a, b) for (y, gr), (yw, gw) in zip(got, want)
                 for a, b in ((y, yw), (gr, gw))]
        mism = sum(bits_differ(a, b) for a, b in pairs)
        max_err = max([max_err] + [max_abs_diff(a, b) for a, b in pairs])
        ok = same and mism == 0 and hops > 0
        print(f"  {codec:9s} bidir, {ODD_RANKS} x {ODD_NUMEL} (channel 1 "
              f"from float {m}, vec {vec}): ranks identical {same}; vs "
              f"plain hop mismatched {mism}; hop launches {hops}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"odd-split {codec}/bidir disagrees with the plain hop")
    return max_err


def bench_inputs():
    g = torch.Generator(device="cuda").manual_seed(5)
    return [torch.randn(BENCH_NUMEL, generator=g, device="cuda")
            for _ in range(BENCH_RANKS)]


def q8_value_and_grad(P, xs, compression, algo):
    """Each rank's (y, dL/dx) for L = vdot(y, y), y = Allreduce(x)."""
    def body(rank):
        x = xs[rank].clone().requires_grad_()
        y = P.COMM_WORLD.Allreduce(x, P.MPI_SUM, compression=compression,
                                   algorithm=algo)
        (g,) = torch.autograd.grad(torch.vdot(y, y), x)
        return y.detach(), g

    return P.run_ranks(body, len(xs), device="cuda")


def norm_rel1(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def path1_phase(P, kernels, config):
    """The compressed Allreduce at the bench size for every codec x
    algorithm.  Returns per pair (kernel run ms, plain run ms, launches),
    and the exact Allreduce's ms on the same world."""
    n = BENCH_RANKS
    xs = bench_inputs()
    exact = xs[0].clone()
    for x in xs[1:]:
        exact += x
    q8_value_and_grad(P, xs, False, None)          # warm-up
    exact_ms = min(sync_ms(lambda: q8_value_and_grad(P, xs, False, None))[0]
                   for _ in range(2))
    res = {}
    for codec in Q8_CODECS:
        for algo in Q8_ALGOS:
            kernels.reset_launch_counts()
            ms, got = sync_ms(lambda: q8_value_and_grad(P, xs, codec, algo))
            hops = kernels.launch_counts["q8_hop"]
            requants = kernels.launch_counts["q8_requant"]
            config.set_quant_hop_impl("torch")
            try:
                plain_ms, want = sync_ms(
                    lambda: q8_value_and_grad(P, xs, codec, algo))
            finally:
                config.set_quant_hop_impl("auto")
            same_ranks = all(torch.equal(y, got[0][0])
                             and torch.equal(g, got[0][1]) for y, g in got)
            mism = sum(bits_differ(a, b) for (y, g), (yw, gw)
                       in zip(got, want) for a, b in ((y, yw), (g, gw)))
            chans = 1 if algo == "ring" else 2
            rounds = EF_ROUNDS[codec]
            want_hops = 2 * chans * rounds * n * (n - 1)
            want_req = 2 * chans * rounds * n
            y, g = got[0]
            rel = norm_rel1(y, exact)
            # Every rank's cotangent is 2y, so the exact backward is 2n y.
            rel_g = norm_rel1(g, 2 * n * y)
            bound_rel = CODEC_REL[codec]
            ok = (same_ranks and mism == 0 and hops == want_hops
                  and requants == want_req and rel <= bound_rel
                  and rel_g <= bound_rel)
            print(f"  {codec:9s} {algo:5s}: fwd+bwd {ms:8.2f} ms (plain hop "
                  f"{plain_ms:8.2f} ms); ranks identical {same_ranks}; vs "
                  f"plain hop mismatched {mism}; launches hop {hops}/"
                  f"{want_hops} requant {requants}/{want_req} "
                  f"(2 x {chans} ch x {rounds} rd x n(n-1) / n); err vs "
                  f"exact {rel:.3e}, grad {rel_g:.3e} (bound "
                  f"{bound_rel:g})  {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"compressed Allreduce {codec}/{algo} failed a check")
            res[(codec, algo)] = (ms, plain_ms, hops, requants)
            del got, want, y, g
    print(f"  exact Allreduce, same world and size: fwd+bwd {exact_ms:.2f} "
          "ms")
    return res, exact_ms


def block_scales(qk, flat, n, block=256):
    """The power-of-two scale of each block of ``flat`` in the chunk
    layout of an n-rank ring."""
    xcb, _ = qk.chunk_blocks(flat, n, block)
    return qk.po2_scale(xcb.reshape(-1, block).abs().amax(1))


def path2_phase(P, T, tree, ef, qk, kernels, cfg, params, tokens):
    """Two compressed-gradient DP=2 steps with all checks.  Returns the
    launch counts of the run."""
    rows = TRAIN_BATCH // 2
    leaves = tree.tree_leaves(params)
    codec = P.compress.get_codec("q8")

    def body(rank):
        comm = P.COMM_WORLD
        x = tokens[rank * rows:(rank + 1) * rows]
        p, resid, out = params, None, []
        for step in range(2):
            _, g = tree.value_and_grad(lambda q: T.lm_loss(cfg, q, x), p)
            if resid is None:
                resid = ef.ef_init(g)
            corrected = tree.tree_map(lambda a, r: a + r.to(a.dtype), g,
                                      resid)
            hops0 = kernels.launch_counts["q8_hop"]
            synced, resid = ef.ef_allreduce(comm, g, resid,
                                            compression="q8")
            hops = kernels.launch_counts["q8_hop"] - hops0
            exact_res = all(torch.equal(r, c - codec.roundtrip(c))
                            for r, c in zip(tree.tree_leaves(resid),
                                            tree.tree_leaves(corrected)))
            mean = tree.tree_map(lambda s: s / comm.size, synced)
            errs = None
            if step == 0:
                # The exact DP=2 gradient sum, and the rigorous bound on
                # the q8 ring's error: hop 0 errs by at most s0/2 (s0 the
                # largest hop-0 scale of the block over the ranks), hop 1
                # by s1/2 with s1 <= po2(amax(sum)(1 + u) + s0/2); then
                # one bf16 rounding each of the synced and exact sums.
                errs = []
                for sy, gl in zip(tree.tree_leaves(synced),
                                  tree.tree_leaves(g)):
                    ex = comm.Allreduce(gl, P.MPI_SUM, compression=False)
                    s0 = comm.Allreduce(
                        block_scales(qk, gl.float().reshape(-1), comm.size),
                        P.MPI_MAX, compression=False)
                    _, nb = qk.chunk_blocks(gl.reshape(-1), comm.size, 256)
                    amax = qk.chunk_blocks(ex.float().reshape(-1),
                                           comm.size, 256)[0] \
                        .reshape(-1, 256).abs().amax(1)
                    s1 = qk.po2_scale(amax * (1 + BF16_U) + s0 / 2)
                    e_q = (256 * ((s0.double() + s1.double()) / 2)
                           .square().sum()).sqrt()
                    e_ref = ex.double().norm()
                    e_out = sy.double().norm()
                    err = (sy.double() - ex.double()).norm()
                    if e_ref > 0:
                        errs.append(((err / e_ref).item(),
                                     ((e_q + BF16_U * (e_ref + e_out))
                                      / e_ref).item()))
                    del ex, s0, s1, amax
            out.append((mean, hops, exact_res, errs))
            with torch.no_grad():
                p = tree.tree_map(lambda a, b: a - LR * b, p, mean)
        return out

    kernels.reset_launch_counts()
    ms, (r0, r1) = sync_ms(lambda: P.run_ranks(body, 2, device="cuda"))
    launches = dict(kernels.launch_counts)
    same = all(leaves_equal(tree, a[0], b[0]) for a, b in zip(r0, r1))
    hops = [s[1] for s in r0]
    exact_res = all(s[2] for s in r0 + r1)
    errs = r0[0][3]
    worst = max(errs, key=lambda e: e[0])
    tight = max(e[0] / e[1] for e in errs)
    finite = all(bool(torch.isfinite(m).all())
                 for s in r0 for m in tree.tree_leaves(s[0]))
    print(f"  2 ranks x batch {rows}, {len(leaves)} gradient leaves, 2 "
          f"steps in {ms:.0f} ms (with the checks); ranks bitwise "
          f"identical: {same}; q8_hop launches per step {hops} (expected "
          f"2 x {len(leaves)} = {2 * len(leaves)}); residual == corrected - "
          f"roundtrip(corrected) bitwise on both ranks and steps: "
          f"{exact_res}; synced gradients finite: {finite}")
    attn = {k: (launches[k], launches[f"{k}.tc"])
            for k in kernels.ATTENTION_KERNELS}
    want = 2 * 2 * cfg.n_layers
    print(f"  attention launches (all, tc): {attn} (expected {want} each, "
          "all tc)")
    check(all(a == (want, want) for a in attn.values()),
          "the compressed DP=2 run did not run every attention on the tc "
          "kernels")
    print(f"  step 1 vs the exact DP=2 gradient, norm-relative per leaf: "
          f"worst {worst[0]:.3e} (its bound {worst[1]:.3e}); largest "
          f"error / bound {tight:.3f}; bounds {min(e[1] for e in errs):.3e}"
          f"-{max(e[1] for e in errs):.3e}")
    check(same, "the two compressed DP ranks disagree")
    check(all(h == 2 * len(leaves) for h in hops),
          "q8_hop did not launch twice per leaf per step")
    check(exact_res, "a carried residual is not corrected - roundtrip")
    check(finite, "a synced gradient is not finite")
    check(tight <= 1.0, "a leaf's compressed gradient is outside its bound")
    return launches


def dp_step(P, T, tree, ef, cfg, params, tokens, compression):
    rows = TRAIN_BATCH // 2

    def body(rank):
        x = tokens[rank * rows:(rank + 1) * rows]
        _, g = tree.value_and_grad(lambda q: T.lm_loss(cfg, q, x), params)
        synced, _ = ef.ef_allreduce(P.COMM_WORLD, g, ef.ef_init(g),
                                    compression=compression)
        with torch.no_grad():
            return tree.tree_map(lambda a, s: a - LR * (s / 2), params,
                                 synced)

    P.run_ranks(body, 2, device="cuda")


def hop_bytes(nb, block, stochastic, resid):
    """Bytes one hop with an arriving payload moves: q (1 B), mine (4 B)
    and q' (1 B) per element, noise and residual (4 B each) when asked,
    and the scale in and out (4 B each) per row."""
    return nb * block * (6 + 4 * stochastic + 4 * resid) + nb * 8


def hop_numbers(qk):
    """K1 at the two shapes of the paths: the bench ring chunk (16384,
    256) for each codec's hop, and the DP=2 embed leaf's chunk (131072,
    256) for q8; each held against the plain version (bitwise), then
    kernel ms, bound and plain ms.  The bench chunk's operands (25-59 MB)
    would sit in the 50 MB L2 across launches, so the kernel cycles over
    four copies of them."""
    res = {}
    for label, nb, stochastic, resid in (
            ("bench_q8", 16384, False, False),
            ("bench_q8_ef", 16384, False, True),
            ("bench_q8_ef_hop", 16384, True, True),
            ("dp2_embed_q8", 131072, False, False)):
        copies = [hop_operands(nb, 256, seed=500 + i)
                  for i in range(4 if nb < 65536 else 1)]
        q, scale, mine, noise = copies[0]
        nz = noise if stochastic else None
        c, err, _ = hop_compare(qk, (q, scale), mine, nz, resid)
        check(sum(c) == 0, f"hop kernel disagrees at {label}")
        cycle = itertools.cycle(copies)

        def kern():
            q, scale, mine, noise = next(cycle)
            qk.dequant_accum_requant(q, scale, mine,
                                     noise=noise if stochastic else None,
                                     want_resid=resid, impl="cuda")

        k_ms = event_ms(kern, iters=40, warmup=4)
        p_ms = event_ms(lambda: qk.dequant_accum_requant(
            q, scale, mine, noise=nz, want_resid=resid, impl="torch"),
            iters=5, warmup=1)
        nbytes = hop_bytes(nb, 256, stochastic, resid)
        b_ms, b_by = bound(12.0 * nb * 256, nbytes, torch.float32)
        res[label] = (k_ms, p_ms, b_ms, b_by, nbytes, err)
        print(f"  q8_hop {label:16s} ({nb}, 256)"
              f"{' noise' if stochastic else ''}{' resid' if resid else ''}:"
              f" kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB), "
              f"{100 * b_ms / k_ms:.1f}% of bound; kernel vs plain "
              f"mismatched elements 0", flush=True)
        del copies, q, scale, mine, noise
    print("  library_ms is null: no single PyTorch call computes the fused "
          "dequantize-accumulate-requantize hop")
    return res


def device_busy_ms(fn):
    """(wall ms, device busy ms, result) of one call of ``fn`` under
    torch.profiler: busy time is the device time of kernels and copies,
    without annotations (see profile_top)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3
    return wall_ms, busy_ms, out


def op_table(P, C, ring, tune):
    """name -> (op(comm, x, rank), per-rank inputs(seed), per-rank
    cotangents(seed), plain forward(xs), closed-form adjoint(xs, ws)).
    Every tensor lives on the card; the plain forward and the adjoint are
    concatenations, slices and the ``constants.reduce_*`` folds of the
    schedule the op names."""
    n, SUM = OP_RANKS, P.MPI_SUM
    counts = [OP_NUMEL + (2 * r - 3) * OP_SKEW for r in range(n)]
    offs = [sum(counts[:r]) for r in range(n)]
    g = tune.resolve_hier_group(n)

    def randn(seed, shapes):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return [torch.randn(sh, generator=gen, device="cuda")
                for sh in shapes]

    def even(seed, numel=OP_NUMEL):
        return lambda s: randn(seed + s, [(numel,)] * n)

    def zeros_but(r_keep, val, like):
        return [val if r == r_keep else torch.zeros_like(t)
                for r, t in enumerate(like)]

    def ordered(vals):
        return C.reduce_ordered(SUM, vals)

    def rooted_tree(vals, root):
        return C.reduce_tree(SUM, vals[root:] + vals[:root])

    folds = {"ring": ordered, "bidir": ordered,
             "rhd": lambda v: C.reduce_rhd(SUM, v),
             "tree": lambda v: C.reduce_tree(SUM, v),
             "hier": lambda v: C.reduce_grouped(SUM, v, g),
             "torus": lambda v: C.reduce_torus(SUM, v, g)}
    root_folds = {"ring": ordered, "tree": lambda v: rooted_tree(v, 1)}
    ops = {}
    for algo, fold in root_folds.items():
        ops[f"Bcast_ {algo} root 1"] = (
            lambda c, t, r, a=algo: c.Bcast_(t, 1, algorithm=a),
            even(10), even(20),
            lambda xs: [xs[1]] * n,
            lambda xs, ws, f=fold: zeros_but(1, f(ws), xs))
        ops[f"Reduce_ {algo} root 1"] = (
            lambda c, t, r, a=algo: c.Reduce_(t, SUM, 1, algorithm=a),
            even(30), even(40),
            lambda xs, f=fold: zeros_but(1, f(xs), xs),
            lambda xs, ws: [ws[1]] * n)
    ops["Gather root 2 uneven"] = (
        lambda c, t, r: c.Gather(t, 0, 2),
        lambda s: randn(50 + s, [(m,) for m in counts]),
        even(60, sum(counts)),
        lambda xs: zeros_but(2, torch.cat(xs), [torch.empty(sum(counts),
                                                             device="cuda")]
                             * n),
        lambda xs, ws: [ws[2][offs[r]:offs[r] + counts[r]]
                        for r in range(n)])
    ops["Scatter root 2 uneven"] = (
        lambda c, t, r: c.Scatter(t, 0, counts[r], 2),
        lambda s: randn(70 + s, [(sum(counts),) if r == 2 else (1,)
                                 for r in range(n)]),
        lambda s: randn(80 + s, [(m,) for m in counts]),
        lambda xs: [xs[2][offs[r]:offs[r] + counts[r]] for r in range(n)],
        lambda xs, ws: zeros_but(2, torch.cat(ws), xs))
    ops["Allgather"] = (
        lambda c, t, r: c.Allgather(t, 0),
        even(90), even(100, n * OP_NUMEL),
        lambda xs: [torch.cat(xs)] * n,
        lambda xs, ws: [ordered([w[r * OP_NUMEL:(r + 1) * OP_NUMEL]
                                 for w in ws]) for r in range(n)])
    seg = OP_NUMEL // n
    ops["Reduce_scatter"] = (
        lambda c, t, r: c.Reduce_scatter(t, SUM, 0),
        even(110), even(120, seg),
        lambda xs: [ordered([x[r * seg:(r + 1) * seg] for x in xs])
                    for r in range(n)],
        lambda xs, ws: [torch.cat(ws)] * n)
    cols = A2A_SIDE // n
    ops["Alltoall"] = (
        lambda c, t, r: c.Alltoall(t, 0, 1, cols),
        lambda s: randn(130 + s, [(A2A_SIDE, A2A_SIDE)] * n),
        lambda s: randn(140 + s, [(n * A2A_SIDE, cols)] * n),
        lambda xs: [torch.cat(xs, 0)[:, r * cols:(r + 1) * cols]
                    for r in range(n)],
        lambda xs, ws: [torch.cat(ws, 1)[r * A2A_SIDE:(r + 1) * A2A_SIDE]
                        for r in range(n)])
    for algo, fold in folds.items():
        ops[f"Allreduce {algo}"] = (
            lambda c, t, r, a=algo: c.Allreduce(t, SUM, algorithm=a),
            even(150), even(160),
            lambda xs, f=fold: [f(xs)] * n,
            lambda xs, ws, f=fold: [f(ws)] * n)
    ops["ring_shift"] = (
        lambda c, t, r: ring.ring_shift(c, t, 1),
        even(170), even(180),
        lambda xs: [xs[(r - 1) % n] for r in range(n)],
        lambda xs, ws: [ws[(r + 1) % n] for r in range(n)])
    return ops


def op_value_and_grad(P, op, xs, ws):
    """Each rank's (op output, d vdot(out, w_r) / dx_r)."""
    def body(r):
        t = xs[r].detach().requires_grad_()
        y = op(P.COMM_WORLD, t, r)
        (g,) = torch.autograd.grad(torch.vdot(y.reshape(-1),
                                              ws[r].reshape(-1)), t)
        return y.detach(), g

    return P.run_ranks(body, OP_RANKS, device="cuda")


def run_table(P, table):
    """Every op of ``table`` on four rank threads: value and gradient
    bitwise equal to the plain recomputation and the closed-form adjoint,
    a buffer of its own on every rank, and (for an op with padding views)
    every padding slot's gradient exactly zero; fwd+bwd wall and device
    ms, bytes, share of the copy bound, peak memory.  Returns per op
    (wall ms, device ms, bound ms, peak GiB, idle share)."""
    res = {}
    for name, (op, make_x, make_w, fwd, adj, *padding) in table.items():
        xs, ws = make_x(0), make_w(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = op_value_and_grad(P, op, xs, ws)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        want_y, want_g = fwd(xs), adj(xs, ws)
        bad_y = [r for r in range(OP_RANKS)
                 if not torch.equal(got[r][0], want_y[r])]
        bad_g = [r for r in range(OP_RANKS)
                 if not (got[r][1].shape == want_g[r].shape
                         and torch.equal(got[r][1], want_g[r]))]
        own = len({y.data_ptr() for y, _ in got}) == OP_RANKS
        pad = padding[0] if padding else None
        bad_pad = [] if pad is None else [
            r for r in range(OP_RANKS)
            if any(not bool((v == 0).all()) for v in pad(got[r][1], r))]
        nbytes = 4 * sum(xs[r].numel() + got[r][0].numel() + ws[r].numel()
                         + got[r][1].numel() for r in range(OP_RANKS))
        del got, want_y, want_g
        wall_ms = min(sync_ms(lambda: op_value_and_grad(P, op, xs, ws))[0]
                      for _ in range(2))
        prof_wall, busy_ms, _ = device_busy_ms(
            lambda: op_value_and_grad(P, op, xs, ws))
        bound_ms = nbytes / PEAK_BYTES_S * 1e3
        ok = not bad_y and not bad_g and own and not bad_pad
        idle = 100 - 100 * busy_ms / prof_wall
        print(f"  {name:26s} fwd+bwd {wall_ms:8.2f} ms wall, device "
              f"{busy_ms:7.3f} ms (idle {100 - 100 * busy_ms / prof_wall:.0f}%"
              f" of {prof_wall:.2f} ms profiled); {nbytes / 1e9:.3f} GB, copy "
              f"bound {bound_ms:.3f} ms = {100 * bound_ms / busy_ms:.1f}% of "
              f"device; peak +{peak:.2f} GiB; value bitwise "
              f"{not bad_y}, grad bitwise {not bad_g}, own buffers {own}"
              + ("" if pad is None else
                 f", padding gradient zero {not bad_pad}")
              + f"  {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"op {name}: ranks {bad_y} value / {bad_g} gradient differ "
              "from the plain recomputation, ranks share an output, or "
              f"ranks {bad_pad} have a padding gradient that is not zero")
        res[name] = (wall_ms, busy_ms, bound_ms, peak, idle)
        del xs, ws
        torch.cuda.empty_cache()
    return res


class RecordingComm:
    """A communicator that keeps every Allreduce result it hands out: the
    global scalars L-BFGS branches on."""

    def __init__(self, comm):
        self._comm = comm
        self.scalars = []

    @property
    def rank(self):
        return self._comm.rank

    @property
    def size(self):
        return self._comm.size

    def Allreduce(self, tensor, op, **kw):
        out = self._comm.Allreduce(tensor, op, **kw)
        self.scalars.append(out.detach())
        return out


def stencil_phase(P, H, lbfgs):
    """Config 5 at 8192 x 8192 on four rank threads: the distributed
    float32 loss and gradient against the single-tensor computation at a
    seeded random field, then 20 float64 L-BFGS iterations from that
    field made zero-mean, with ranks in lock-step, a loss that never
    rises and a
    field whose mean stays at 0.  Returns the numbers it prints."""
    n, nr = STENCIL_N, STENCIL_RANKS
    rows = n // nr
    gen = torch.Generator(device="cuda").manual_seed(9)
    u_full = torch.randn((n, n), generator=gen, device="cuda")
    g_full = H.source_term(n, n, torch.float32, "cuda")

    def dist_loss_grad(r):
        u = u_full[r * rows:(r + 1) * rows].clone().requires_grad_()
        loss = H.residual_loss(u, g_full[r * rows:(r + 1) * rows])
        (g,) = torch.autograd.grad(loss, u)
        return loss.detach(), g

    got = P.run_ranks(dist_loss_grad, nr, device="cuda")
    eval_ms = min(sync_ms(lambda: P.run_ranks(dist_loss_grad, nr,
                                              device="cuda"))[0]
                  for _ in range(3))
    u = u_full.clone().requires_grad_()
    lap = (torch.roll(u, 1, 0) + torch.roll(u, -1, 0) + torch.roll(u, 1, 1)
           + torch.roll(u, -1, 1) - 4.0 * u)
    loss1 = torch.sum((lap - g_full) ** 2)
    (grad1,) = torch.autograd.grad(loss1, u)
    loss_rel = abs(got[0][0].item() - loss1.item()) / abs(loss1.item())
    # Every rank differentiates the same global loss, and the Allreduce's
    # adjoint sums the ranks' unit cotangents: each rank's gradient is
    # size times its block of the single-tensor one (a power of two here,
    # so the division is exact).
    grad_d = torch.cat([gr for _, gr in got]) / nr
    grad_rel = ((grad_d.double() - grad1.double()).norm()
                / grad1.double().norm()).item()
    same_loss = all(torch.equal(l, got[0][0]) for l, _ in got)
    print(f"  loss+grad at a seeded random u: distributed vs single tensor "
          f"(torch.roll): loss rel {loss_rel:.3e}, gradient norm-rel "
          f"{grad_rel:.3e} (bound {STENCIL_REL:g}); loss bitwise equal on "
          f"every rank {same_loss}; one distributed evaluation {eval_ms:.2f}"
          " ms wall")
    check(loss_rel <= STENCIL_REL and grad_rel <= STENCIL_REL and same_loss,
          "the distributed stencil loss or gradient disagrees with the "
          "single-tensor computation")
    del got, grad_d, u, lap, loss1, grad1
    # L-BFGS runs in float64, the example's own dtype, from that field made
    # zero-mean.  In float32 it takes no step on this grid: its first trial
    # step (t = 1 / |g|_1) moves an element by ~1/N = 1.5e-8, under half an
    # ulp of |u| ~ 1.  From the example's u = 0 the source is so smooth on
    # an 8192 grid that even in float64 the line search fails after one
    # iteration.  The gradient has zero mean on the periodic grid, so the
    # field's mean stays at 0.
    u_start = u_full.double()
    u_start -= u_start.mean()
    g64 = H.source_term(n, n, torch.float64, "cuda")

    def solve():
        rec = RecordingComm(P.COMM_WORLD)
        r = P.COMM_WORLD.rank
        g_local = g64[r * rows:(r + 1) * rows]
        losses, evals = [], [0]

        def loss_fn(v):
            evals[0] += 1
            return H.residual_loss(v, g_local)

        u0 = u_start[r * rows:(r + 1) * rows]
        loss0 = float(H.residual_loss(u0, g_local))
        opt = lbfgs.LBFGS(max_iter=STENCIL_ITERS,
                          history_size=STENCIL_HISTORY, comm=rec)
        u_end, loss = opt.step(loss_fn, u0,
                               callback=lambda it, f: losses.append(f))
        return loss0, losses, evals[0], torch.stack(rec.scalars), u_end

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    solve_ms, res = sync_ms(lambda: P.run_ranks(solve, nr, device="cuda"))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    loss0, losses, evals, scalars, _ = res[0]
    lockstep = all(torch.equal(sc, scalars) and ls == losses
                   for _, ls, _, sc, _ in res)
    monotone = all(b <= a for a, b in zip([loss0] + losses, losses))
    u_end = torch.cat([ue for *_, ue in res])
    mean, umax = abs(u_end.double().mean().item()), \
        u_end.abs().max().item()
    iters, last = len(losses), (losses or [loss0])[-1]
    print(f"  L-BFGS (history {STENCIL_HISTORY}) on {n} x {n} float64, "
          f"{nr} ranks x {rows} rows: loss {loss0:.6e} -> {last:.6e} "
          f"in {iters} iterations, {evals} loss+grad evaluations; "
          f"{scalars.numel()} global scalars bitwise equal on every rank "
          f"{lockstep}; loss never rises {monotone}; |mean(u)| {mean:.3e} "
          f"<= 1e-5 max|u| = {1e-5 * umax:.3e}")
    check(iters == STENCIL_ITERS and lockstep and monotone
          and last < loss0 and mean <= 1e-5 * umax,
          "the stencil's L-BFGS run broke lock-step, raised its loss, "
          "stopped early or drifted its mean")
    prof_wall, busy_ms, _ = device_busy_ms(
        lambda: P.run_ranks(solve, nr, device="cuda"))
    print(f"  {solve_ms / evals:.2f} ms per loss+grad evaluation, "
          f"{solve_ms / iters:.2f} ms per iteration ({solve_ms:.1f} ms for "
          f"{iters}); device busy {busy_ms:.1f} of {prof_wall:.1f} ms "
          f"profiled (idle {100 - 100 * busy_ms / prof_wall:.0f}%); peak "
          f"memory {peak_gb:.2f} GiB", flush=True)
    return {"eval_ms": solve_ms / evals, "iter_ms": solve_ms / iters,
            "idle": 1 - busy_ms / prof_wall, "peak_gb": peak_gb,
            "grad_rel": grad_rel}


def examples_phase(linreg, ringex):
    """BASELINE configs 1 and 3 at their own sizes on four rank threads of
    the card: each example's own checks, values and gradients."""
    ms, res = sync_ms(lambda: linreg.run(4, device="cuda"))
    params, loss = res[0]
    print(f"  config 1, linear regression + L-BFGS (10000 points, f64): "
          f"ranks identical, params {np.round(params, 8).tolist()} (generated "
          f"with [0.1, 1.0, -2.0]), loss {loss:.3e}, {ms:.1f} ms")
    ms, res = sync_ms(lambda: ringex.run(4, device="cuda"))
    print(f"  config 3, Isend/Irecv/Wait ring: res "
          f"{[float(r[0]) for r, _ in res]}, a.grad "
          f"{[float(g[0]) for _, g in res]} (all 2.0), {ms:.1f} ms",
          flush=True)
    check(all(float(g[0]) == 2.0 for _, g in res), "ring gradients wrong")


class ExchangeCounter:
    """Counts rank 0's rendezvous (``World.exchange``) and point-to-point
    sends (``World.p2p_send``) while it is entered: one count per
    collective or message of the rank."""

    def __init__(self):
        from mpi4torch_tpu_torch import runtime

        self._world = runtime.World
        self.exchanges = self.sends = 0

    def __enter__(self):
        world, counter = self._world, self
        self._saved = world.exchange, world.p2p_send

        def exchange(w, rank, *a, **kw):
            counter.exchanges += rank == 0
            return counter._saved[0](w, rank, *a, **kw)

        def p2p_send(w, src, *a, **kw):
            counter.sends += src == 0
            return counter._saved[1](w, src, *a, **kw)

        world.exchange, world.p2p_send = exchange, p2p_send
        return self

    def __exit__(self, *exc):
        self._world.exchange, self._world.p2p_send = self._saved
        return False


def attention_all_tc(kernels, launches):
    return all(launches[k] == launches[f"{k}.tc"] > 0
               for k in kernels.ATTENTION_KERNELS)


def fused_dp2_phase(P, T, tree, fuse, kernels, config, cfg, params, tokens,
                    dp_ms):
    """The train_step recipe (all_average_tree) on two rank threads with
    the default 4 MiB buckets, per leaf (fusion_scope(0)) and through the
    overlap pipeline (overlap_scope(True)): parameters bitwise equal to
    the per-leaf run, ranks identical, every attention launch tc; bucket
    count, rendezvous per step, step ms and the device's idle share.
    Returns the fused run's launch counts and numbers."""
    rows = TRAIN_BATCH // 2
    n_leaves = len(tree.tree_leaves(params))
    n_buckets = fuse.bucket_layout(params,
                                   config.DEFAULT_BUCKET_BYTES).num_buckets

    def step(bucket_bytes, overlap):
        def body(rank):
            x = tokens[rank * rows:(rank + 1) * rows]
            with config.fusion_scope(bucket_bytes), \
                    config.overlap_scope(overlap):
                return T.train_step(cfg, params, x, comm_dp=P.COMM_WORLD,
                                    lr=LR)
        return P.run_ranks(body, 2, device="cuda")

    runs = {"per-leaf": (0, None),
            "fused": (config.DEFAULT_BUCKET_BYTES, None),
            "fused+overlap": (config.DEFAULT_BUCKET_BYTES, True)}
    out, launches, counts = {}, {}, {}
    for label, (bb, ov) in runs.items():
        kernels.reset_launch_counts()
        with ExchangeCounter() as cnt:
            out[label] = step(bb, ov)
        launches[label] = dict(kernels.launch_counts)
        counts[label] = (cnt.exchanges, cnt.sends)
    (l0, p0), (l1, p1) = out["per-leaf"]
    results = {}
    for label in runs:
        (a0, q0), (a1, q1) = out[label]
        same_ranks = torch.equal(a0, a1) and leaves_equal(tree, q0, q1)
        same_leaf = torch.equal(a0, l0) and leaves_equal(tree, q0, p0)
        tc = attention_all_tc(kernels, launches[label])
        results[label] = same_ranks and same_leaf and tc
        print(f"  {label:13s}: buckets "
              f"{n_leaves if label == 'per-leaf' else n_buckets} for "
              f"{n_leaves} leaves; rank 0 per step: {counts[label][0]} "
              f"rendezvous, {counts[label][1]} p2p messages; ranks bitwise "
              f"identical {same_ranks}; parameters bitwise equal to the "
              f"per-leaf run {same_leaf}; attention all tc {tc}  "
              f"{'ok' if results[label] else 'FAIL'}", flush=True)
    del out, p0, p1, q0, q1
    check(all(results.values()), "a fused DP=2 run differs from the "
          "per-leaf run, the ranks disagree, or an attention launch was "
          "not tc")
    times = {label: [] for label in runs}
    for label in list(runs) + list(reversed(list(runs))):
        times[label].append(sync_ms(lambda: step(*runs[label]))[0])
    idle = {}
    for label in runs:
        wall, busy, _ = profile_top(lambda: step(*runs[label]),
                                    f"one DP=2 step, {label}", n_top=4)
        idle[label] = 100 - 100 * busy / wall
    print(f"  DP=2 step ms (two runs each, interleaved): "
          + "; ".join(f"{k} {[round(x, 1) for x in v]}"
                      for k, v in times.items())
          + f" (phase 9's step {dp_ms:.1f} ms ran fused by default)")
    return launches["fused"], {
        "buckets": n_buckets, "leaves": n_leaves,
        "rendezvous": {k: v[0] for k, v in counts.items()},
        "p2p": {k: v[1] for k, v in counts.items()},
        "ms": {k: min(v) for k, v in times.items()}, "idle_pct": idle}


def bucket_q8_bounds(qk, fuse, g0, g1, s0_mean, s1_mean, bb):
    """Per bucket of ``bb``, the compressed DP=2 sum (2 x the rank-mean
    ``s0_mean``) against the exact bf16 sum of the two ranks' gradient
    buckets: (norm-relative error, the rigorous q8 ring bound of phase
    13 applied to the bucket), and whether rank 1's result is bitwise
    rank 0's."""
    b0, layout = fuse.flatten_buckets(g0, bb)
    b1, _ = fuse.flatten_buckets(g1, bb)
    y0, _ = fuse.flatten_buckets(s0_mean, bb)
    y1, _ = fuse.flatten_buckets(s1_mean, bb)
    errs, same = [], True
    for x0, x1, r0, r1 in zip(b0, b1, y0, y1):
        same = same and torch.equal(r0, r1)
        ex = x0 + x1
        sy = r0 * 2
        s0 = torch.maximum(block_scales(qk, x0.float(), 2),
                           block_scales(qk, x1.float(), 2))
        amax = qk.chunk_blocks(ex, 2, 256)[0].reshape(-1, 256) \
            .float().abs().amax(1)
        s1 = qk.po2_scale(amax * (1 + BF16_U) + s0 / 2)
        e_q = (256 * ((s0.double() + s1.double()) / 2).square().sum()) \
            .sqrt()
        e_ref = torch.linalg.vector_norm(ex.float(), dtype=torch.float64)
        e_out = torch.linalg.vector_norm(sy.float(), dtype=torch.float64)
        err = torch.linalg.vector_norm(sy.float() - ex.float(),
                                       dtype=torch.float64)
        if e_ref > 0:
            errs.append(((err / e_ref).item(),
                         ((e_q + BF16_U * (e_ref + e_out)) / e_ref).item()))
        del ex, sy, s0, s1, amax
    return errs, same, layout


def fused_q8_phase(P, T, tree, fuse, qk, kernels, config, cfg, params,
                   tokens):
    """Compressed-gradient DP=2 through comm.Allreduce_tree(...,
    compression="q8", mean=True) at 4 MiB buckets and at one bucket per
    dtype: the hops on K1 bitwise equal to the plain hop, ranks
    identical, each bucket within the q8 ring bound, two q8_hop launches
    per bucket per step; step ms and idle share; K1 at the largest
    bucket chunk against its bound."""
    rows = TRAIN_BATCH // 2
    grad_bytes = sum(t.numel() * t.element_size()
                     for t in tree.tree_leaves(params))
    sizes = {"4MiB": config.DEFAULT_BUCKET_BYTES, "one_bucket": grad_bytes}

    def step(bb, keep=False):
        def body(rank):
            x = tokens[rank * rows:(rank + 1) * rows]
            _, g = tree.value_and_grad(lambda q: T.lm_loss(cfg, q, x),
                                       params)
            synced = P.COMM_WORLD.Allreduce_tree(
                g, P.MPI_SUM, mean=True, compression="q8", bucket_bytes=bb)
            with torch.no_grad():
                new = tree.tree_map(lambda p, s: p - LR * s, params, synced)
            return (g, synced) if keep else new
        return P.run_ranks(body, 2, device="cuda")

    res = {}
    for label, bb in sizes.items():
        nbk = fuse.bucket_layout(params, bb).num_buckets
        kernels.reset_launch_counts()
        with ExchangeCounter() as cnt:
            (g0, y0), (g1, y1) = step(bb, keep=True)
        hops = kernels.launch_counts["q8_hop"]
        launches = dict(kernels.launch_counts)
        config.set_quant_hop_impl("torch")
        try:
            (_, w0), (_, w1) = step(bb, keep=True)
        finally:
            config.set_quant_hop_impl("auto")
        mism = sum(bits_differ(a, b) for a, b in zip(
            tree.tree_leaves((y0, y1)), tree.tree_leaves((w0, w1))))
        max_err = max(max_abs_diff(a, b) for a, b in zip(
            tree.tree_leaves((y0, y1)), tree.tree_leaves((w0, w1))))
        del w0, w1
        errs, same, layout = bucket_q8_bounds(qk, fuse, g0, g1, y0, y1, bb)
        del g0, g1, y0, y1
        torch.cuda.empty_cache()
        tight = max(e / b for e, b in errs)
        worst = max(errs, key=lambda e: e[0])
        tc = attention_all_tc(kernels, launches)
        ok = (mism == 0 and same and hops == 2 * nbk and tight <= 1.0
              and tc)
        big = max(layout.bucket_sizes)
        print(f"  {label:10s} (bucket_bytes {bb}): {nbk} buckets "
              f"(largest {big} elements); rank 0: {cnt.exchanges} "
              f"rendezvous; q8_hop launches {hops} (expected 2 x {nbk}); "
              f"K1 vs plain hop mismatched {mism}; ranks bitwise identical "
              f"{same}; per-bucket error vs the exact sum: worst "
              f"{worst[0]:.3e} (its bound {worst[1]:.3e}), largest error / "
              f"bound {tight:.3f}; attention all tc {tc}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"fused compressed DP=2 at {label} failed a check")
        t = [sync_ms(lambda: step(bb))[0] for _ in range(2)]
        wall, busy, _ = profile_top(lambda: step(bb),
                                    f"one fused q8 DP=2 step, {label}",
                                    n_top=6)
        res[label] = {"buckets": nbk, "hops": hops,
                      "rendezvous": cnt.exchanges, "ms": min(t),
                      "runs_ms": t, "idle_pct": 100 - 100 * busy / wall,
                      "largest_bucket": big, "max_abs_err": max_err,
                      "launches": launches}
        print(f"  {label}: step {[round(x, 1) for x in t]} ms", flush=True)
    # K1 at the largest bucket chunk of the one-bucket step (and of the
    # 4 MiB step, the embedding's own bucket): its time against its bound.
    for label in sizes:
        nb = qk.chunk_blocks(torch.empty(res[label]["largest_bucket"],
                                         device="meta"), 2, 256)[1]
        q, scale, mine, noise = hop_operands(nb, 256, seed=900)
        c, err, _ = hop_compare(qk, (q, scale), mine, None, False)
        check(sum(c) == 0, f"hop kernel disagrees at the {label} chunk")
        k_ms = event_ms(lambda: qk.dequant_accum_requant(
            q, scale, mine, impl="cuda"), iters=10, warmup=2)
        p_ms = event_ms(lambda: qk.dequant_accum_requant(
            q, scale, mine, impl="torch"), iters=3, warmup=1)
        nbytes = hop_bytes(nb, 256, False, False)
        b_ms, b_by = bound(12.0 * nb * 256, nbytes, torch.float32)
        res[label]["k1"] = (nb, k_ms, p_ms, b_ms, b_by, err)
        print(f"  q8_hop at the {label} largest chunk ({nb}, 256): kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}, {nbytes / 1e6:.1f} MB), "
              f"{100 * b_ms / k_ms:.1f}% of bound", flush=True)
        del q, scale, mine, noise
        torch.cuda.empty_cache()
    return res


def state_bytes(tree, state):
    """Bytes of every tensor of an optimizer state (Adam's mu and nu)."""
    return sum(t.numel() * t.element_size()
               for t in tree.tree_leaves((state.mu, state.nu)))


def zero_phase(P, T, tree, kernels, cfg, params, tokens):
    """ZeRO-1 (zero_train_step) and ZeRO-3 (zero3_train_step) with the
    port's adam on two rank threads, two steps each, against
    replicated-DP Adam on the card: parameters bitwise equal, ranks
    identical, half the optimizer state (and for ZeRO-3 half the
    parameters) per rank, every attention launch tc; step ms, idle share,
    peak memory."""
    from mpi4torch_tpu_torch.parallel import zero as Z
    from mpi4torch_tpu_torch.utils import optim

    rows = TRAIN_BATCH // 2
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree.tree_leaves(params))
    step_ms = {}

    def timed(label, rank, fn):
        """Run one step, timing it on rank 0 between synchronisations."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        if rank == 0:
            step_ms.setdefault(label, []).append(
                (time.perf_counter() - t0) * 1e3)
        return out

    def replicated(rank, steps=ZERO_STEPS):
        x = tokens[rank * rows:(rank + 1) * rows]
        opt = optim.adam(ADAM_LR)
        p, st = params, opt.init(params)
        def step(p, st):
            _, g = tree.value_and_grad(lambda q: T.lm_loss(cfg, q, x), p)
            g = P.COMM_WORLD.Allreduce_tree(g, P.MPI_SUM, mean=True)
            with torch.no_grad():
                upd, st = opt.update(g, st, p)
                return tree.tree_map(torch.add, p, upd), st

        for _ in range(steps):
            p, st = timed("replicated", rank, lambda: step(p, st))
        return p, state_bytes(tree, st), param_bytes

    def zero1(rank, steps=ZERO_STEPS):
        x = tokens[rank * rows:(rank + 1) * rows]
        opt = optim.adam(ADAM_LR)
        p, st = params, Z.zero_init(P.COMM_WORLD, opt, params)
        for _ in range(steps):
            _, p, st = timed("ZeRO-1", rank, lambda: T.zero_train_step(
                cfg, p, x, opt, st, P.COMM_WORLD))
        return p, state_bytes(tree, st), param_bytes

    def zero3(rank, steps=ZERO_STEPS):
        x = tokens[rank * rows:(rank + 1) * rows]
        opt = optim.adam(ADAM_LR)
        shards, st = Z.zero3_init(P.COMM_WORLD, opt, params)
        for _ in range(steps):
            _, shards, st = timed("ZeRO-3", rank, lambda: T.zero3_train_step(
                cfg, shards, params, x, opt, st, P.COMM_WORLD))
        held = sum(t.numel() * t.element_size()
                   for t in tree.tree_leaves(shards))
        return Z.zero3_params(P.COMM_WORLD, shards, params), \
            state_bytes(tree, st), held

    out, numbers = {}, {}
    for label, fn in (("replicated", replicated), ("ZeRO-1", zero1),
                      ("ZeRO-3", zero3)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        res = P.run_ranks(fn, 2, device="cuda")
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = dict(kernels.launch_counts)
        out[label] = res
        wall, busy, _ = profile_top(
            lambda: P.run_ranks(lambda r: fn(r)[1], 2, device="cuda"),
            f"{label}: {ZERO_STEPS} DP=2 steps with the optimizer's init",
            n_top=4)
        numbers[label] = {"ms": step_ms[label][ZERO_STEPS - 1],
                          "steps_ms": step_ms[label][:ZERO_STEPS],
                          "peak_gib": peak,
                          "idle_pct": 100 - 100 * busy / wall,
                          "state_bytes": res[0][1],
                          "param_bytes": res[0][2], "launches": launches}
        torch.cuda.empty_cache()
    ref = out["replicated"]
    rep_state = numbers["replicated"]["state_bytes"]
    ok_all = True
    for label in ("ZeRO-1", "ZeRO-3"):
        (p0, sb0, pb0), (p1, sb1, pb1) = out[label]
        same_ranks = leaves_equal(tree, p0, p1)
        same_ref = leaves_equal(tree, p0, ref[0][0]) and \
            leaves_equal(tree, p1, ref[1][0])
        half_state = 2 * sb0 == rep_state and sb0 == sb1
        half_params = (2 * pb0 == param_bytes) if label == "ZeRO-3" \
            else pb0 == param_bytes
        tc = attention_all_tc(kernels, numbers[label]["launches"])
        ok = same_ranks and same_ref and half_state and half_params and tc
        ok_all = ok_all and ok
        n = numbers[label]
        print(f"  {label}: {ZERO_STEPS} Adam steps; parameters bitwise "
              f"equal to replicated-DP Adam {same_ref}; ranks identical "
              f"{same_ranks}; optimizer state per rank {sb0} B vs "
              f"replicated {rep_state} B ({sb0 / rep_state:.3f}); "
              f"parameters held per rank {pb0} B vs {param_bytes} B "
              f"({pb0 / param_bytes:.3f}); steps "
              f"{[round(x, 1) for x in n['steps_ms']]} ms (replicated "
              f"{[round(x, 1) for x in numbers['replicated']['steps_ms']]}"
              f" ms), idle "
              f"{n['idle_pct']:.0f}%, peak {n['peak_gib']:.2f} GiB "
              f"(replicated {numbers['replicated']['peak_gib']:.2f} GiB); "
              f"attention all tc {tc}  {'ok' if ok else 'FAIL'}",
              flush=True)
    del out, ref
    torch.cuda.empty_cache()
    check(ok_all, "a ZeRO run differs from replicated Adam, keeps more "
          "than half the state or parameters, or ran a non-tc attention")
    return numbers


def packed_table(P, C, ragged):
    """name -> (op, per-rank inputs, per-rank cotangents, plain forward,
    closed-form adjoint, padding views) for the packed and ragged
    collectives at the op table's size: rank r holds OP_NUMEL + (2r - 3)
    OP_SKEW valid elements in a buffer of the largest count (the ragged
    Alltoall a quarter of that per destination), its padding poisoned
    with NaN; ``padding(t, r)`` lists the views of rank r's input (or its
    gradient) that are padding, None where the input has none."""
    n, SUM = OP_RANKS, P.MPI_SUM
    counts = tuple(OP_NUMEL + (2 * r - 3) * OP_SKEW for r in range(n))
    cap, total = max(counts), sum(counts)
    offs = [sum(counts[:r]) for r in range(n)]
    new = tuple(reversed(counts))
    new_offs = [sum(new[:r]) for r in range(n)]
    # ragged_alltoall: a (n, per-destination capacity, 1) block a rank.
    acap = OP_NUMEL // n + 3 * OP_SKEW // n
    sends = [[OP_NUMEL // n + (2 * ((r + d) % n) - 3) * OP_SKEW // n
              for d in range(n)] for r in range(n)]

    def randn(seed, shape):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(shape, generator=gen, device="cuda")

    def poisoned(seed, shape, padding):
        xs = []
        for r in range(n):
            x = randn(seed + r, shape)
            for view in padding(x, r):
                view.fill_(float("nan"))
            xs.append(x)
        return xs

    def pad(t, length):
        return torch.cat([t, t.new_zeros((length - t.shape[0],)
                                         + tuple(t.shape[1:]))])

    def ordered(vals):
        return C.reduce_ordered(SUM, vals)

    def rows(t, r):
        return [t[counts[r]:]]

    def a2a_rows(t, r):
        return [t[d, sends[r][d]:] for d in range(n)]

    ops = {}
    ops["packed Gather root 2"] = (
        lambda c, t, r: c.Gather(t, 0, 2, numelem=counts),
        lambda s: poisoned(200 + s, (cap,), rows),
        lambda s: [randn(210 + s + r, (total,)) for r in range(n)],
        lambda xs: [torch.cat([x[:k] for x, k in zip(xs, counts)])
                    if r == 2 else torch.zeros(total, device="cuda")
                    for r in range(n)],
        lambda xs, ws: [pad(ws[2][offs[r]:offs[r] + counts[r]], cap)
                        for r in range(n)],
        rows)
    ops["packed Allgather"] = (
        lambda c, t, r: c.Allgather(t, 0, numelem=counts),
        lambda s: poisoned(220 + s, (cap,), rows),
        lambda s: [randn(230 + s + r, (total,)) for r in range(n)],
        lambda xs: [torch.cat([x[:k] for x, k in zip(xs, counts)])] * n,
        lambda xs, ws: [pad(ordered([w[offs[r]:offs[r] + counts[r]]
                                      for w in ws]), cap)
                        for r in range(n)],
        rows)
    ops["packed Scatter root 2"] = (
        lambda c, t, r: c.Scatter(t, 0, counts, 2),
        lambda s: [randn(240 + s + r, (total,)) for r in range(n)],
        lambda s: [randn(250 + s + r, (cap,)) for r in range(n)],
        lambda xs: [pad(xs[2][offs[r]:offs[r] + counts[r]], cap)
                    for r in range(n)],
        lambda xs, ws: [torch.cat([w[:k] for w, k in zip(ws, counts)])
                        if r == 2 else torch.zeros(total, device="cuda")
                        for r in range(n)],
        None)
    ops["packed Alltoall same axis"] = (
        lambda c, t, r: c.Alltoall(t, 0, 0, new, current_numelem=counts),
        lambda s: poisoned(260 + s, (cap,), rows),
        lambda s: [randn(270 + s + r, (max(new),)) for r in range(n)],
        lambda xs: [pad(torch.cat([x[:k] for x, k in zip(xs, counts)])
                        [new_offs[r]:new_offs[r] + new[r]], max(new))
                    for r in range(n)],
        lambda xs, ws: [pad(torch.cat([w[:k] for w, k in zip(ws, new)])
                            [offs[r]:offs[r] + counts[r]], cap)
                        for r in range(n)],
        rows)

    ops["ragged_alltoall"] = (
        lambda c, t, r: ragged.ragged_alltoall(
            c, t, torch.tensor(sends[r], device="cuda"))[0],
        lambda s: poisoned(280 + s, (n, acap, 1), a2a_rows),
        lambda s: [randn(290 + s + r, (n, acap, 1)) for r in range(n)],
        lambda xs: [torch.stack([pad(xs[s][r][:sends[s][r]], acap)
                                 for s in range(n)]) for r in range(n)],
        lambda xs, ws: [torch.stack([pad(ws[d][r][:sends[r][d]], acap)
                                     for d in range(n)]) for r in range(n)],
        a2a_rows)
    ops["ragged_allgather"] = (
        lambda c, t, r: ragged.ragged_allgather(
            c, t, torch.tensor(counts[r], device="cuda"))[0],
        lambda s: poisoned(300 + s, (cap, 1), rows),
        lambda s: [randn(310 + s + r, (n, cap, 1)) for r in range(n)],
        lambda xs: [torch.stack([pad(x[:k], cap)
                                 for x, k in zip(xs, counts)])] * n,
        lambda xs, ws: [pad(ordered([w[r][:counts[r]] for w in ws]), cap)
                        for r in range(n)],
        rows)
    ops["ragged_gather root 2"] = (
        lambda c, t, r: ragged.ragged_gather(
            c, t, torch.tensor(counts[r], device="cuda"), root=2)[0],
        lambda s: poisoned(320 + s, (cap, 1), rows),
        lambda s: [randn(330 + s + r, (n, cap, 1)) for r in range(n)],
        lambda xs: [torch.stack([pad(x[:k], cap) for x, k in
                                 zip(xs, counts)]) if r == 2
                    else torch.zeros(n, cap, 1, device="cuda")
                    for r in range(n)],
        lambda xs, ws: [pad(ws[2][r][:counts[r]], cap) for r in range(n)],
        rows)
    ops["ragged_scatter root 2"] = (
        lambda c, t, r: ragged.ragged_scatter(
            c, t, torch.tensor(counts, device="cuda"), root=2)[0],
        lambda s: [randn(340 + s + r, (n, cap, 1)) for r in range(n)],
        lambda s: [randn(350 + s + r, (cap, 1)) for r in range(n)],
        lambda xs: [pad(xs[2][r][:counts[r]], cap) for r in range(n)],
        lambda xs, ws: [torch.stack([pad(w[:k], cap) for w, k in
                                     zip(ws, counts)]) if r == 2
                        else torch.zeros(n, cap, 1, device="cuda")
                        for r in range(n)],
        None)
    return ops, {"counts": counts, "sends": sends}


def serve_overlap_phase(P, T, serve, kv, kernels, cfg, params, prompts,
                        blocking):
    """TP=2 serving through ServeConfig(overlap=True) and
    ServeConfig(algorithm="rhd"): the same requests as phase 5, tokens
    identical to phase 5's blocking ring engine, both ranks identical,
    every prefill launch tc; decode tokens/s beside phase 5's."""
    (r0, r1), launches, ms, rate = blocking
    want = 2 * cfg.n_layers * (1 + TP2_REQUESTS)
    out = {"blocking": rate}
    for label, kw in (("overlap=True", dict(overlap=True)),
                      ("algorithm=rhd", dict(algorithm="rhd"))):
        (a0, a1), got_launches, got_ms, got_rate = serve_tp2(
            P, T, serve, kv, kernels, cfg, params, prompts, **kw)
        same = a0[1] == r0[1] and a1[1] == r0[1]
        ok = same and got_launches == (want, want)
        print(f"  {label:14s}: tokens identical to phase 5's blocking "
              f"engine on both ranks {same}; flash_fwd launches "
              f"{got_launches} (expected {want}, all tc); decode "
              f"{got_rate:.1f} tokens/s (blocking {rate:.1f}); run "
              f"{got_ms / 1e3:.2f} s  {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"TP=2 serving with {label} differs from the blocking "
              "engine or prefill left the tc kernel")
        out[label] = got_rate
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs a GPU",
              file=sys.stderr)
        return 2
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch import serve
    from mpi4torch_tpu_torch.models import transformer as T
    from mpi4torch_tpu_torch.ops import _kernels as kernels
    from mpi4torch_tpu_torch.ops import flash
    from mpi4torch_tpu_torch.parallel import dp
    from mpi4torch_tpu_torch.serve import kv
    from mpi4torch_tpu_torch.utils import tree
    from mpi4torch_tpu_torch import config
    from mpi4torch_tpu_torch.compress import ef
    from mpi4torch_tpu_torch.ops import quant_kernels as qk
    from mpi4torch_tpu_torch import constants as C
    from mpi4torch_tpu_torch import tune
    from mpi4torch_tpu_torch.parallel import ring
    from mpi4torch_tpu_torch.utils import lbfgs
    from mpi4torch_tpu_torch.examples import halo_exchange_stencil as H
    from mpi4torch_tpu_torch.examples import isend_recv_wait as ringex
    from mpi4torch_tpu_torch.examples import simple_linear_regression \
        as linreg
    from mpi4torch_tpu_torch import fuse
    from mpi4torch_tpu_torch.ops import ragged

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    phase(1, "device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s); TF32 off")
    print(smi, flush=True)

    phase(2, "build")
    t0 = time.perf_counter()
    log = kernels.build_all()
    print(f"  built {sorted(log)} in {time.perf_counter() - t0:.2f} s")
    for lib in sorted(log):
        print(f"  {lib}: nvcc {log[lib]['seconds']:.2f} s")
        for line in log[lib]["output"].splitlines():
            if "registers" in line or "spill" in line:
                print("    " + line.strip())
    # The tensor-core attention kernels, as the card reports them: no
    # local memory (no spills) and two blocks (eight MMA warps) per SM.
    spills = [line for lib in ("flash_fwd_tc", "flash_bwd_tc")
              for line in log[lib]["output"].splitlines()
              if "spill" in line
              and " 0 bytes spill stores, 0 bytes spill loads" not in line]
    for kname in kernels.ATTENTION_KERNELS:
        for d in (64, 128):
            pr = kernels.tc_props(kname, d)
            print(f"  {kname} tc at head dim <= {d}: "
                  f"{pr['registers']} registers a thread, "
                  f"{pr['dynamic_smem']} B dynamic + {pr['static_smem']} B "
                  f"static shared memory, {pr['local_bytes']} B local "
                  f"(spill) memory, {pr['blocks_per_sm']} blocks per SM")
            check(pr["local_bytes"] == 0 and pr["blocks_per_sm"] >= 2,
                  f"{kname} tc spills or fits fewer than two blocks per SM")
    check(not spills, f"ptxas reports spills in the tc kernels: {spills}")
    # The simt kernels at their widest instantiation (DMAX 512: head dims
    # above 256, 32-row tiles forward, 16/32-row tiles backward): what
    # one block takes of an SM; one block must fit.
    for kname in kernels.ATTENTION_KERNELS:
        for sdt in (torch.float32, torch.bfloat16):
            pr = kernels.simt_props(kname, sdt, 264)
            print(f"  {kname} simt {str(sdt)[6:]} at head dim 264 (DMAX "
                  f"512): {pr['registers']} registers a thread, "
                  f"{pr['dynamic_smem']} B dynamic + {pr['static_smem']} B "
                  f"static shared memory, {pr['local_bytes']} B local "
                  f"(spill) memory, {pr['blocks_per_sm']} blocks per SM")
            check(pr["blocks_per_sm"] >= 1,
                  f"{kname} simt at DMAX 512 does not fit an SM")

    phase(3, "kernel vs plain version on the card")
    errs = kernel_phase(flash, kernels)

    phase(4, "serve the flagship transformer, TP=1")
    cfg = flagship_config(T)
    torch.cuda.reset_peak_memory_stats()
    params = T.init_transformer(0, cfg, torch.bfloat16, device="cuda")
    n_params = sum(t.numel() for t in
                   [params["embed"], params["pos"], params["unembed"]]
                   + [w for blk in params["blocks"] for w in
                      (blk["wqkv"], blk["wo"], blk["w1"], blk["w2"])])
    prompts = make_prompts(cfg, N_REQUESTS)
    print(f"  {n_params / 1e6:.0f}M parameters (bf16); prompt lengths "
          f"{[len(p) for p in prompts]}", flush=True)
    with torch.inference_mode():
        eng, launches, engine_rows, decode_ms, decode_tok, run_s = \
            serve_tp1(T, serve, kernels, cfg, params, prompts)
        results, snap = eng.results(), eng.stats.snapshot()
        check(len(results) == N_REQUESTS and all(
            eng.status(r) == serve.STATUS_OK for r in range(N_REQUESTS)),
            "not every request finished")
        check(all(len(results[r]) == len(prompts[r]) + MAX_NEW
                  for r in range(N_REQUESTS)), "a request was cut short")
        want = cfg.n_layers * N_REQUESTS
        print(f"  engine: {N_REQUESTS} requests in {run_s:.2f} s, "
              f"{snap['steps']} decode steps, flash_fwd launches "
              f"{launches[0]}, of them tc {launches[1]} (expected n_layers "
              f"x prefills = {want}, all tc)")
        check(launches == (want, want), f"flash_fwd launched {launches} "
              f"times (all, tc), expected {want} tc: prefill did not run "
              "on the tc kernel")
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        divergences, tie_steps, max_diff = compare_with_oracle(
            T, cfg, params, prompts, results, engine_rows)
        print(f"  tokens vs generate(): first tokens equal; near-tie "
              f"divergences {divergences} (oracle steps with top-2 gap <= "
              f"{TIE_TOL}: {tie_steps}); max |logit diff| at matched "
              f"steps {max_diff:.4f}")
        # Where the time goes: four decode steps over four busy slots, and
        # the longest prompt's prefill.
        for p in prompts[:SLOTS]:
            eng.submit(p, max_new=8)
        eng.step()
        profile_top(lambda: [eng.step() for _ in range(4)],
                    f"4 decode steps x {SLOTS} slots")
        eng.run()
        prefill_ms = []
        shards = kv.shard_params_tp(cfg, params, P.COMM_WORLD)
        longest = max(prompts, key=len)
        profile_top(lambda: kv.prefill_tp(
            cfg, shards, kv.init_kv_cache_tp(cfg, 1, 1, torch.bfloat16,
                                             "cuda"),
            torch.as_tensor(longest, device="cuda")[None], P.COMM_WORLD),
            f"prefill of {len(longest)} tokens")
        for prompt in prompts:
            cache = kv.init_kv_cache_tp(cfg, 1, 1, torch.bfloat16, "cuda")
            p = torch.as_tensor(prompt, device="cuda")[None]
            ms, (tp1_logits, _) = sync_ms(
                lambda: kv.prefill_tp(cfg, shards, cache, p, P.COMM_WORLD))
            prefill_ms.append(ms)
            if prompt is prompts[0]:
                first_logits = tp1_logits[0].float().cpu()

    phase(5, "serve the flagship transformer, TP=2 on rank threads")
    tp2 = serve_tp2(P, T, serve, kv, kernels, cfg, params, prompts)
    (r0, r1), launches2, tp2_ms, tp2_rate = tp2
    check(r0[1] == r1[1] and torch.equal(r0[0], r1[0]),
          "the two TP ranks disagree")
    tp_diff = (r0[0] - first_logits).abs().max().item()
    same = sum(a == results[i].tolist()[:len(a)]
               for i, a in enumerate(r0[1]))
    want2 = 2 * cfg.n_layers * (1 + TP2_REQUESTS)
    print(f"  2 ranks, {TP2_REQUESTS} requests x {TP2_MAX_NEW} tokens in "
          f"{tp2_ms / 1e3:.2f} s; ranks bitwise identical; first prefill "
          f"max |logit diff| vs TP=1 {tp_diff:.4f} (tol {TP_LOGIT_TOL}); "
          f"{same}/{TP2_REQUESTS} token streams equal to TP=1's prefix; "
          f"flash_fwd launches {launches2[0]}, of them tc {launches2[1]} "
          f"(expected {want2}, all tc); decode {tp2_rate:.1f} tokens/s "
          "over rank 0's decode-only steps")
    check(tp_diff <= TP_LOGIT_TOL, "TP=2 prefill logits too far from TP=1")
    check(launches2 == (want2, want2),
          "TP=2 prefill did not run on the tc kernel")

    phase(6, "serving numbers")
    dt = torch.bfloat16
    _, _, b, sq, sk, h, h_kv, d, q_off, kv_off, window, causal = \
        KERNEL_CASES[0]
    q, k, v = attention_inputs(dt, b, sq, sk, h, h_kv, d, seed=0)
    kw = dict(causal=True, q_offset=q_off, kv_offset=kv_off, window=window)
    plain_ms = event_ms(lambda: flash.flash_block_attention(
        q, k, v, impl="torch", **kw))
    # The main path's variant (tc, through flash_block_attention), the simt
    # kernel called by name on the same inputs, then tc again, so that a
    # drift of the card's clock shows as a spread of the two tc readings.
    serve_variant = kernels.fwd_variant(dt, d)
    tc_ms = [event_ms(lambda: flash.flash_block_attention(
        q, k, v, impl="cuda", **kw))]
    simt_ms_prefill = event_ms(lambda: kernels.flash_fwd(
        q, k, v, q_off, kv_off, True, window, variant="simt"), iters=10)
    tc_ms.append(event_ms(lambda: flash.flash_block_attention(
        q, k, v, impl="cuda", **kw)))
    kernel_ms = sum(tc_ms) / len(tc_ms)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = event_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
    pairs = live_pairs(sq, sk, q_off, kv_off, window, causal)
    flops = 4.0 * b * h * d * pairs
    nbytes = (2 * b * sq * h * d + 2 * b * sk * h_kv * d) * 2 \
        + b * sq * h * 4
    bound_ms, bound_by = bound(flops, nbytes, dt)
    print(f"  flash_fwd at (1, 1024, 16, 128) bf16 causal: kernel "
          f"{serve_variant} {kernel_ms:.4f} ms (runs "
          + "/".join(f"{x:.4f}" for x in tc_ms)
          + f"), simt {simt_ms_prefill:.4f} ms "
          f"({simt_ms_prefill / kernel_ms:.1f}x the {serve_variant} time), "
          f"plain {plain_ms:.4f} ms, scaled_dot_product_attention "
          f"{library_ms:.4f} ms ({serve_variant} {kernel_ms / library_ms:.2f}x"
          f" it), bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} "
          f"GFLOP, {nbytes / 1e6:.2f} MB), {100 * bound_ms / kernel_ms:.2f}% "
          "of bound")
    ttft = snap.get("ttft_s", {})
    print(f"  prefill per request {np.mean(prefill_ms):.2f} ms mean "
          f"(prompts {min(map(len, prompts))}-{max(map(len, prompts))} "
          f"tokens); TTFT p50 {ttft.get('p50', float('nan')) * 1e3:.1f} ms "
          f"(all {N_REQUESTS} submitted at once, {SLOTS} slots); decode "
          f"{decode_tok / (decode_ms / 1e3):.1f} tokens/s over "
          f"decode-only steps; peak memory {peak_gb:.2f} GiB")

    del eng, shards, cache, engine_rows
    torch.cuda.empty_cache()

    phase(7, "backward kernels vs the plain backward on the card")
    backward_phase(flash, kernels)

    phase(8, "train the flagship transformer, TP=1 (the bench recipe)")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ))).to("cuda")
    step_ms, train_launches, train_peak_gb = train_tp1(
        T, tree, flash, kernels, cfg, params, tokens)

    phase(9, "train the flagship transformer, DP=2 on rank threads")
    dp_ms = train_dp2(P, T, tree, dp, kernels, cfg, params, tokens)

    phase(10, "training numbers")
    mean_ms = float(np.mean(step_ms[1:]))
    print(f"  TP=1 step {mean_ms:.1f} ms (mean of steps 2-{TRAIN_STEPS}), "
          f"{TRAIN_BATCH * TRAIN_SEQ / (mean_ms / 1e3):.0f} tokens/s; peak "
          f"memory {train_peak_gb:.2f} GiB; DP=2 step {dp_ms:.1f} ms")
    wall, busy, ev = profile_top(
        lambda: recipe_step(T, tree, cfg, params, tokens),
        f"one training step, batch {TRAIN_BATCH} x {TRAIN_SEQ}", n_top=8)
    attn = {n: sum(e.self_device_time_total for e in ev
                   if f"{n}_kernel" in e.key or f"{n}_tc_kernel" in e.key)
            / 1e3 for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    print("  attention kernels' share of device time: " + ", ".join(
        f"{n} {t:.1f} ms ({100 * t / busy:.1f}%)" for n, t in attn.items())
        + f"; together {100 * sum(attn.values()) / busy:.1f}%")
    check(sum(attn.values()) > 0, "the profile shows no attention kernel")
    k_ms, bounds, plain, lib, train_err, simt_ms = backward_numbers(
        flash, kernels)

    phase(11, "quantized hop kernel vs plain version on the card")
    hop_err = hop_kernel_phase(qk, kernels)
    hop_err = max(hop_err, odd_split_phase(P, C, kernels, config))

    phase(12, f"compressed Allreduce, {BENCH_RANKS} rank threads x "
          f"{BENCH_NUMEL} float32 (the bench size)")
    p1, p1_exact_ms = path1_phase(P, kernels, config)

    phase(13, "compressed-gradient DP=2 training of the flagship "
          "transformer")
    p2_launches = path2_phase(P, T, tree, ef, qk, kernels, cfg, params,
                              tokens)

    phase(14, "compressed numbers")
    print(smi)
    hop = hop_numbers(qk)
    print(f"  compressed Allreduce fwd+bwd at {BENCH_RANKS} x {BENCH_NUMEL} "
          f"float32, kernel hop (plain hop), exact Allreduce "
          f"{p1_exact_ms:.2f} ms:")
    for (codec, algo), (run_ms, run_plain_ms, _, _) in p1.items():
        print(f"    {codec:9s} {algo:5s} {run_ms:8.2f} ms "
              f"({run_plain_ms:8.2f} ms), {run_ms / p1_exact_ms:.2f}x exact")
    steps = {}
    for comp in (None, "q8", "q8", None):
        t_ms, _ = sync_ms(lambda: dp_step(P, T, tree, ef, cfg, params,
                                          tokens, comp))
        steps.setdefault(comp, []).append(t_ms)
    print(f"  DP=2 step (lm_loss, grad, ef_allreduce, update) at batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: compressed q8 "
          f"{[round(x, 1) for x in steps['q8']]} ms, exact "
          f"{[round(x, 1) for x in steps[None]]} ms")
    profile_top(lambda: dp_step(P, T, tree, ef, cfg, params, tokens, "q8"),
                "one compressed DP=2 step", n_top=8)

    phase(15, f"the op table, {OP_RANKS} rank threads x {OP_NUMEL} float32 "
          "(the bench size)")
    print(smi)
    run_table(P, op_table(P, C, ring, tune))

    phase(16, f"halo-exchange stencil (config 5), {STENCIL_N} x {STENCIL_N} "
          f"on {STENCIL_RANKS} rank threads, L-BFGS")
    stencil_phase(P, H, lbfgs)

    phase(17, "configs 1 and 3: linear regression with L-BFGS, the "
          "Isend/Irecv/Wait ring")
    examples_phase(linreg, ringex)

    phase(18, "fused exact DP=2 training of the flagship transformer "
          "(all_average_tree, 4 MiB buckets)")
    print(smi)
    fused_launches, fused = fused_dp2_phase(P, T, tree, fuse, kernels,
                                            config, cfg, params, tokens,
                                            dp_ms)

    phase(19, "fused compressed DP=2: Allreduce_tree(compression='q8') at "
          "4 MiB buckets and at one bucket per dtype")
    q8f = fused_q8_phase(P, T, tree, fuse, qk, kernels, config, cfg, params,
                         tokens)
    print(f"  beside phase 14 (per-leaf ef_allreduce q8 step "
          f"{min(steps['q8']):.1f} ms, exact step {min(steps[None]):.1f} "
          f"ms) and phase 18 (fused exact step {fused['ms']['fused']:.1f} "
          f"ms, idle {fused['idle_pct']['fused']:.0f}%): fused q8 step "
          + "; ".join(f"{k} {v['ms']:.1f} ms, idle {v['idle_pct']:.0f}%, "
                      f"{v['buckets']} buckets, {v['hops']} q8_hop launches"
                      for k, v in q8f.items()))

    phase(20, f"ZeRO-1 and ZeRO-3 DP=2 with the port's adam, {ZERO_STEPS} "
          "steps each, against replicated-DP Adam")
    zero_numbers = zero_phase(P, T, tree, kernels, cfg, params, tokens)

    phase(21, f"packed and ragged collectives, {OP_RANKS} rank threads x "
          f"{OP_NUMEL} float32 (per-rank counts {OP_NUMEL} + (2r - 3) x "
          f"{OP_SKEW})")
    print(smi)
    table, _ = packed_table(P, C, ragged)
    run_table(P, table)
    del table

    phase(22, "TP=2 serving with ServeConfig(overlap=True) and "
          "ServeConfig(algorithm='rhd')")
    serve_overlap_phase(P, T, serve, kv, kernels, cfg, params, prompts,
                        tp2)

    phase(23, "kernels")
    # flash_fwd: launches on the serving path (phase 4), times at the
    # flagship prefill shape, its error the worst of the serving and the
    # training shape; "variant" is the one every serving launch took
    # (phase 4 checks that it is tc), "simt_ms" the CUDA-core kernel on
    # the same inputs, called by name, and "train_*" its numbers at the
    # training shape (phase 10).  flash_bwd_*: launches in the TP=1 training run
    # (phase 8), everything else at the training shape.  No single
    # library call computes dq alone or dk/dv alone, so their library_ms
    # is null; pair_plain_ms and pair_library_ms are the whole backward's
    # (dq, dk and dv together), the plain one and that of
    # scaled_dot_product_attention.  q8_hop: launches in the compressed
    # DP=2 run (phase 13), times at the DP=2 embed leaf's chunk; the
    # bench-size Allreduce's launches and times beside them; max_abs_err
    # is the largest |kernel - plain| of every comparison of phases 11
    # and 14 (0.0 when bitwise); no single library call computes the
    # fused hop, so library_ms is null.  K3/K4's "variant" is the one
    # every launch of the training run took (phase 8 checks that it is
    # tc), "source" that variant's file; "simt_ms" is the CUDA-core
    # kernel (simt_source) on the same inputs, called by name.
    csrc = "mpi4torch_tpu_torch/ops/csrc/"
    src = {kname: {"tc": f"{csrc}{stem}_tc.cu", "simt": f"{csrc}{stem}.cu"}
           for kname, stem in (("flash_fwd", "flash_fwd"),
                               ("flash_bwd_dq", "flash_bwd"),
                               ("flash_bwd_dkv", "flash_bwd"))}
    train_variant = {
        kname: "tc" if train_launches[f"{kname}.tc"] == train_launches[kname]
        else "simt" for kname in ("flash_bwd_dq", "flash_bwd_dkv")}
    serve_variant = "tc" if launches[1] == launches[0] else "simt"
    k_ms_hop, p_ms_hop, b_ms_hop, b_by_hop, _, _ = hop["dp2_embed_q8"]
    hop_err = max([hop_err] + [v[5] for v in hop.values()])
    line = {"kernels": [{
        "name": "flash_fwd", "route": "cuda", "variant": serve_variant,
        "source": src["flash_fwd"][serve_variant],
        "replaces": "mpi4torch_tpu/ops/flash.py:243",
        "launches": launches[0],
        "max_abs_err": max(errs["flagship_prefill"], train_err["flash_fwd"]),
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "simt_ms": simt_ms_prefill,
        "simt_source": src["flash_fwd"]["simt"],
        "train_launches": train_launches["flash_fwd"],
        "train_ms": k_ms["flash_fwd"], "train_simt_ms": simt_ms["flash_fwd"],
        "train_plain_ms": plain["flash_fwd"],
        "train_bound_ms": bounds["flash_fwd"][0],
        "train_library_ms": lib["flash_fwd"]}] + [{
            "name": kname, "route": "cuda",
            "variant": train_variant[kname],
            "source": src[kname][train_variant[kname]],
            "replaces": f"mpi4torch_tpu/ops/flash.py:{line_no}",
            "launches": train_launches[kname],
            "max_abs_err": train_err[kname],
            "ms": k_ms[kname], "kernel_ms": k_ms[kname],
            "plain_ms": plain[kname], "bound_ms": bounds[kname][0],
            "bound_by": bounds[kname][1], "library_ms": None,
            "pair_plain_ms": plain["pair"], "pair_library_ms": lib["pair"],
            "simt_ms": simt_ms[kname], "simt_source": src[kname]["simt"]}
            for kname, line_no in (("flash_bwd_dq", 444),
                                  ("flash_bwd_dkv", 485))] + [{
        "name": "q8_hop", "route": "cuda",
        "source": "mpi4torch_tpu_torch/ops/csrc/quant_hop.cu",
        "replaces": "mpi4torch_tpu/ops/quant_kernels.py:196",
        "launches": p2_launches["q8_hop"],
        "requant_launches": p2_launches["q8_requant"],
        "bench_launches": sum(v[2] for v in p1.values()),
        "max_abs_err": hop_err,
        "ms": k_ms_hop, "plain_ms": p_ms_hop, "bound_ms": b_ms_hop,
        "bound_by": b_by_hop, "library_ms": None,
        "bench_ms": {k: v[0] for k, v in hop.items()},
        "bench_plain_ms": {k: v[1] for k, v in hop.items()},
        "bench_bound_ms": {k: v[2] for k, v in hop.items()}}]}
    # This slice's paths: the attention kernels' launches in the fused
    # exact DP=2 step (phase 18) and in the ZeRO-1/ZeRO-3 runs (phase 20);
    # q8_hop's launches per fused compressed step at each bucket size
    # (phase 19), and its times at the largest bucket chunk of each.
    for entry in line["kernels"][:3]:
        kname = entry["name"]
        entry["fused_dp2_launches"] = fused_launches[kname]
        entry["zero_launches"] = {
            k: zero_numbers[k]["launches"][kname] for k in ("ZeRO-1",
                                                            "ZeRO-3")}
    hop_entry = line["kernels"][3]
    hop_entry["fused_launches"] = {k: v["hops"] for k, v in q8f.items()}
    hop_entry["fused_buckets"] = {k: v["buckets"] for k, v in q8f.items()}
    for key, i in (("bucket_chunk_rows", 0), ("bucket_ms", 1),
                   ("bucket_plain_ms", 2), ("bucket_bound_ms", 3)):
        hop_entry[key] = {k: v["k1"][i] for k, v in q8f.items()}
    hop_entry["max_abs_err"] = max(
        [hop_entry["max_abs_err"]]
        + [v["max_abs_err"] for v in q8f.values()]
        + [v["k1"][5] for v in q8f.values()])
    check(p2_launches["q8_hop"] > 0 and p2_launches["q8_requant"] > 0,
          "the compressed DP=2 run launched no hop kernel")
    check(all(v["hops"] > 0 for v in q8f.values()),
          "a fused compressed DP=2 run launched no hop kernel")
    print(json.dumps(line))
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
