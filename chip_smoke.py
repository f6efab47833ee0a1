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
   (among them head dims 12 and 264, batch x heads 65540, float16 and
   the chunked-prefill shapes of phase 23),
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
23. paged, sampled serving of the flagship at full width (``PAGED``:
    16-token pages, 170 of them, the prefix cache, 256-token prefill
    chunks, temperature 0.8, top-k 50; eight requests, four sharing a
    600-token system prompt, one repeating another exactly) and its greedy
    twin: greedy tokens equal ``generate()``'s and phase 4's dense
    engine's but at near ties; every sampled token is bitwise the draw of
    the engine's own logits row with ``generate()``'s subkey of its step,
    and the sampled tokens equal each request's ``generate(temperature,
    top_k, key)`` but at a near tie of the two tokens (their perturbed
    scores within ``TIE_TOL / temperature``, or the one a top-k mask
    dropped within ``TIE_TOL`` of the k-th logit), and differ from the
    greedy ones; prefix hits >= 4, a copy-on-write, a preemption, fewer
    prefill tokens than prompt tokens; every K2 launch ``tc``, launches at
    a q offset counted; K2's chunk rows bitwise the one-shot rows; TTFT
    p50/p99, decode tokens/s, ms per prefill chunk, ms of the sampling
    noise, peak KV bytes paged against dense, the idle share of a
    profiled window; K2 at each chunk shape beside its bound, its plain
    version and SDPA with a lower-right causal mask;
24. sequence-parallel training of the flagship on two rank threads
    (``comm_sp=COMM_WORLD``, s_local 1024) under ``attn="ring"``,
    ``"zigzag"`` (tokens through ``zigzag_slice``'s layout) and
    ``"ulysses"``: each strategy's loss and gradient against one device,
    first in float32 at batch 1 x 2048 (the simt kernels; the algebra,
    within ``SP_F32_REL``), then in bf16 at batch 8 x 2048 (within
    phase 9's bounds); three ``train_step``s each, the first update
    exactly ``p - lr g``, both ranks' parameters bitwise identical; K2/K3/K4
    launches a step, at a nonzero offset and on a wholly masked block, as
    ``SP_BLOCKS`` predicts, all ``tc``; step ms beside phase 10's TP=1
    step, a profiled step's idle share and each rank's attention device
    ms (the profiler's kernel records, attributed to the rank threads by
    launch order);
25. long-context SP: 1 x 16384 tokens with rope (no position table), SP=2
    (s_local 8192), ring and zigzag, two steps each of the chunked loss
    (``vocab_chunk=4096``) at full depth; a 2-layer float32 model's
    hidden states, loss and gradient against one device on the whole
    sequence;
26. expert-parallel MoE training of the flagship with four gelu experts
    (capacity 2560 a source rank), EP=2 rank threads of batch 4 x 2048:
    the first gradient against the replicated dense-expert form (float32
    at 2 layers, bf16 at full depth), three ``train_step``s (ranks
    identical, the update ``p - lr g``), the dropped-token share (every
    (expert, slot) holds at most one token, and each routing keeps
    ``sum_e min(count_e, capacity)`` tokens), the forward ``Alltoall``
    payload, the aux loss, peak memory, K2/K3/K4 launches; then greedy
    ``generate()`` of the MoE config (float32, dense experts) against the
    stepwise argmax of ``forward``;
27. the tensor-parallel layers at the flagship widths, x (8, 2048, 2048)
    bf16 on two rank threads: ``tp_mlp`` and ``tp_attention`` with
    ``attention_fn=flash_attention``, forward and backward against the
    unsharded layers, one ``Allreduce`` each way, ms;
28. the bf16 Allreduces and the compressed Allgather of every codec at
    four rank threads x 2^24 float32, bitwise their plain recomputation;
29. BASELINE config 4, ResNet-18 DP=2 (both recipes);
30. ViT-B/16 bf16, DP=2 and patch-parallel SP=2;
31. PP=2 on the flagship: GPipe, 1F1B (blocking, overlapped),
    interleaved;
32. K2–K4 at the ViT, patch-parallel and PP microbatch shapes, K1's
    requant form at the Allgather shard;
33. the observability layer on phase 18's fused DP=2 step: traced and
    untraced bitwise equal; events per step per rank; the censused
    all-reduce bytes equal to twice the bucket bytes plus the loss; step
    ms and idle share with the tracer off and on; the tracer's host us
    per event; the device-to-host copies and syncs of one profiled step
    off and on (equal); a Chrome trace with one track per rank; then one
    traced fused q8 step (K1's hops);
34. the flight recorder: ``rank_death`` on rank 1 mid-step, every
    survivor's ``RankFailedError`` naming rank 1 far inside the world
    timeout, the postmortem's per-rank tails;
35. the finite guard on the DP=2 step: ``corrupt_nan`` on rank 1 under
    ``"raise"`` raises ``IntegrityError`` naming rank 1 on every rank,
    ``"warn"`` completes, a clean guarded step is bitwise the unguarded
    one; the guard's ms on a 4 x 2^24 float32 Allreduce and on the step;
36. the wire checksum on the compressed q8 and bf16 Allgather at phase
    28's size: bitwise inert on a clean wire, a corrupted wire on rank 1
    named, the same fault silent without it; K1's requant launches;
37. retries and gray failure: a delay past the world timeout rescued by
    ``comm_retries=2`` (retry events mirrored in the metrics); a
    ``slow_rank`` named by the ``GrayFailureDetector``;
38. phase 5's TP=2 serving traced: tokens unchanged; ``serve.stats()``
    and the ``mpi4torch_serve_*`` Prometheus lines against
    ``ServeStats.snapshot()``;
39. the ``generate_kv_cache`` and ``zero_sharded_optimizer`` examples on
    the card (float32) against their CPU runs, and the 3-rank means
    (DP, ``Allreduce_tree``, reduce-scatter, ZeRO-1 Adam) bitwise the
    CPU run;
40. the reshard planner at full width: eight rank threads each hold the
    flagship's bf16 tree in the (8,) row layout and move it to (2, 4) by
    partition rules (2-D leaves rows x columns, the 1-D norms over both
    mesh axes) under the auto strategy and ``gather``: bitwise the sliced
    tree, the backward bitwise the reverse reshard; steps per leaf kind,
    ms a tree, wire bytes a rank (plan), the card's peak live bytes
    against eight times the plan's per-rank estimate; then
    ``restore_resharded`` of the tree saved by rank 0, from the (8,)
    layout to (2, 4), bitwise; then the compressed wide hop
    (``compression="q8"``, ``strategy="gather"``) on the f32 embedding:
    one K1 requant a rank, bitwise the plain recomputation;
41. the train -> serve handoff: two ZeRO-3 DP=2 Adam steps, then
    ``admit_zero3`` into TP=2 bf16 serving shards, bitwise
    ``shard_params_tp(zero3_params(...))``, its ms and peak against that
    gather-everything route; a TP=2 ``Engine`` on the admitted shards
    serves phase 4's eight requests, tokens held to ``generate()`` on the
    gathered parameters under the near-tie rule (the first token too);
42. checkpoint and preemption: phase 20's replicated DP=2 Adam, rank 0
    saving after steps 0, 1 and 2 (``CheckpointManager(max_to_keep=2)``),
    ``truncate_save`` tearing the step-2 save; ``restore_or_init``
    returns step 1 with step 2 skipped, ``Bcast_`` to rank 1, step 2
    again: parameters and Adam state bitwise the pre-crash step-2 state;
    a template of another layout raises ``CommError``; free disk, state
    bytes, save and restore GB/s (the checkpoints are deleted after);
43. the MoE rebalance on phase 26's EP=2 experts by router load:
    ``rebalance_experts`` with ``strategy="auto"`` (the default) and
    ``"rounds"`` bitwise equal to the permuted experts, the gradient the
    inverse move, each route timed after a warm-up; ``"permute"`` refused
    (no whole-shard bijection);
44. the ``checkpoint_resume`` example on the card (float32) within 1e-4
    of its CPU run, each bitwise its own uninterrupted run;
45. the process transport (``run_ranks(backend="process")``, one worker
    process, CUDA context and stream per rank): on (3,) worlds the plain
    Allreduce, deterministic mode, ``Allreduce_tree`` in 4 MiB buckets,
    the q8 Allreduce on ``ring``, an Isend/Recv/Wait ring, and on (8,)
    the (8,) -> (2, 4) reshard, each value and gradient bitwise the same
    body's on rank threads; every rank in a process of its own, none the
    launcher, each on the world's device; K1's launches counted in the
    workers and returned by the bodies, equal to the schedule's;
46. phase 9's flagship DP=2 ``train_step`` on two workers at full width
    and depth, seeded in each worker: ranks bitwise identical and
    bitwise the rank threads' run of the same two steps, every attention
    launch in each worker ``tc``; step ms on threads and processes,
    payload bytes a step through the parent, the idle share of a step
    profiled on rank 0;
47. real signals: the ``rank_death`` matrix cell on CUDA workers (rank 1
    attributed, its PID gone, its card memory back, one respawn), a real
    SIGTERM to rank 1 (a 64-op notice on the transport's board and in
    ``pending_preemptions``, the run's values right), a traced process
    run's events in seq order, as many per rank as on threads;
48. process-transport numbers: an 8-byte Allreduce's latency on 2 and 4
    ranks, the bench-size Allreduce (4 x 2^24 float32) and the parent
    wire's GB/s, cold spawn and warm run seconds, a worker's context
    bytes on the card;
49. Mode A (``run_spmd``), A: every op and p2p program of
    ``tests/test_torch_spmd.py`` at 2^20 float32 a rank on (3,) and (8,)
    worlds and the (2, 4) mesh on the card, with each registered
    Allreduce algorithm: values and gradients (taken from outside
    ``run_spmd``) bitwise equal to the same body under ``run_ranks`` in
    deterministic mode and to the port's CPU Mode A run;
50. Mode A, B: bench.py's Allreduce body (``value_and_grad`` of
    ``vdot(y, y)``, ``y = Allreduce(x)``) at 2^26 float32 on 2 and 4 rank
    threads of the card: the default (native) and the deterministic ring
    fold against the same body under ``run_ranks``, bitwise; median ms of
    20 steps, bench's GB/s accounting, rendezvous a step;
51. Mode A, C: the flagship's DP=2 step (``dp_value_and_grad`` + the SGD
    update, each rank taking its 4 rows by ``comm.rank``) under
    ``run_spmd(nranks=2)``, three steps, outside and inside deterministic
    mode: loss and parameters bitwise the same steps under ``run_ranks``;
    8 launches a step of each attention kernel on each rank, all ``tc``;
    step ms, rendezvous a step, the idle share;
52. Mode A, D: misuse on the card (an unmatched ``Isend`` raises
    ``DeadlockError`` naming the ring shift, ``int(comm.rank)`` raises)
    and gradients from outside through an Allreduce, an Allgather and a
    ring program bitwise the CPU run's;
53. the ``variable_token_exchange`` example under ``run_spmd`` on the card
    against its CPU run;
55. Mode A's users, A: the compressed Allreduce under ``run_spmd`` at
    phase 12's size (4 rank threads x 2^24 float32, ``value_and_grad`` of
    ``vdot(y, y)``) for ``q8``/``q8_ef``/``q8_ef_hop`` on ``ring``/
    ``bidir``/``torus`` and ``bf16``/``bf16r`` on ``ring``: ranks bitwise
    identical; the q8 family's value and gradient bitwise the same body
    under ``run_ranks`` (the schedule folded once on rank 0) with K1's
    hop and requant launches equal to the schedule's; ``bf16``, whose
    Mode A ring re-encodes every hop where Mode B folds once, within its
    bound and bitwise its CPU run at 2^20 a rank; ``bf16r`` within its
    bound with a mean signed error inside 4 standard errors; the
    compressed Allgather (``q8``, ``bf16``): forward bitwise ``run_ranks``,
    the adjoint (the quantized ring reduce-scatter) within the codec's
    bound; ms (the best of three on each side) beside the exact Mode A
    Allreduce.  Then phase 19's fused q8
    DP=2 step (4 MiB buckets) under ``run_spmd(nranks=2)``: loss and
    parameters bitwise the step under ``run_ranks``, K1's launches a step,
    K2–K4 all ``tc``, step ms and the idle share;
56. Mode A's users, B: ``Engine(spmd=True, nranks=2)`` at full width on
    phase 5's requests, dense greedy, paged with phase 23's pages and
    prefill chunks, and sampled with phase 23's temperature, top-k and
    keys: tokens equal the ``run_ranks`` TP=2 engine's, and
    ``generate()``'s but at near ties (phase 23's rule for the sampled
    form); every K2 launch ``tc``; TTFT, decode tokens/s beside phase 5's,
    and the stacked cache's bytes, copied twice a decode step, with the
    device ms of the copy kernels in one profiled decode step and their
    share of the step;
57. Mode A's users, C: ``pipeline_spmd`` PP=2 at full width, PP_MB
    microbatches of PP_ROWS x 2048 embedded tokens, 4 flagship blocks a
    stage, the LM loss in ``loss_fn``: the loss bitwise across ranks; loss
    and stage gradients (taken from outside ``run_spmd``) within 5e-2
    norm-relative per leaf of ``pipeline_step`` on the same inputs; K2–K4
    launches counted (every step's stage pass and its backward), all
    ``tc``; step ms and peak beside phase 31's GPipe;
58. Mode A's users, D: phase 40's flagship tree (8,) -> (2, 4) under
    ``run_spmd(nranks=8)``, planned and ``gather``: bitwise the eager
    executor on rank threads, one VJP bitwise the reverse reshard, ms and
    rendezvous a tree beside phase 40's; the ``q8`` compressed gather hop
    on the f32 embedding bitwise the eager hop, one K1 requant a rank;
59. Mode A's users, E: ``python -m mpi4torch_tpu_torch.compress --smoke``
    and ``python -m mpi4torch_tpu_torch.reshard --smoke`` as subprocesses
    on the card; both exit 0;
60. the schedule IR (``csched``) on the card, at phase 49's sizes: every
    Mode A ``Allreduce`` (each algorithm serving the world x default and
    deterministic x SUM/MAX/PROD on (3,) and (8,) worlds, and per axis of
    the (2, 4) mesh), ``Bcast_`` and ``Reduce_`` at every root through
    the IR, against the hand-written dispatch of ``ops/spmd.py``: values
    and gradients from outside bitwise, rank 0's exchange sequence equal;
    ``csched.interpret_allreduce`` on the card's rows bitwise the
    deterministic Mode A value; the q8 family on ``ring``/``bidir``/
    ``torus`` through ``lower_q8_allreduce`` against the hand-composed
    ``_fused_allreduce_value`` on 4 x 2^20, bitwise, with K1's hop and
    requant launches equal to each other and to the schedule's; the IR's
    host cost: bench's Allreduce body at 4 x 2^26 float32 (default and
    deterministic, 20 rounds) and phase 55's q8 bidir body at 4 x 2^24
    (10 rounds) with only the lowering swapped, the op's autograd
    Function on the IR route against the hand-written one in alternating
    order, medians and rendezvous a step, beside phases 50 and 55;
61. the flagship on a 2-D mesh under ``run_spmd(mesh=)``, four rank
    threads: DP=2 x SP=2 ``train_step`` (ring, Ulysses) and ZeRO-1 (the
    port's Adam) with SP on the same mesh, each rank slicing the tokens
    by the axes' symbolic ranks; f32 at 2 layers against the one-rank
    full-batch step on the card (loss and every updated leaf within
    1e-5), every mesh position bitwise alike; bf16 at full width a warm
    step and a timed one (ms, tokens/s), the idle share of a profiled
    one, K2-K4 launches all ``tc`` beside phase 24's SP=2 and phase 9's
    DP=2 steps; DP=2 x EP=2 with the MoE at 2 layers (f32 against the
    replicated dense-expert form, then a bf16 step);
62. algorithm selection, under a cache file in ``smoke_out/tune`` with
    the process state saved before and restored after: A, the
    autotuner's sweep (``tune.autotune_allreduce``, 4 rank threads,
    float32, 1 KiB to 64 MiB, exact and q8) with its winners, crossovers
    and K1's hop launches during the q8 leg; B, a fresh process serving
    the same winners from the file with no rendezvous, and ``python -m
    mpi4torch_tpu_torch.tune --show``; C, bench's Allreduce body under
    auto selection bitwise its explicit pick with the same rendezvous,
    the flagship's fused DP=2 step under ``run_spmd`` tuned against
    untuned (picks per bucket size, ms, ranks bitwise alike, loss within
    phase 9's tolerance, K2-K4 all ``tc``), ``algorithm_scope`` in the
    rank body taking effect on 4 ranks and degrading on 3 where
    ``algorithm="rhd"`` raises; D, ``csched.autotune_synthesis`` on 8
    ranks and a deterministic auto Allreduce taking each recorded winner,
    value and gradient bitwise ``csched.interpret_allreduce`` and
    ``run_ranks``, its rendezvous the census's; E, tier synthesis on a
    skewed (2, 2, 2) stack, the exact and q8-slow winners bitwise their
    interpretation, K1's requant launches those of the q8-slow program's
    ``q8_level_fold`` steps, ``overlap.tier_window_depth()``; F, serving's
    ``latency_report`` and the SPMD TP=2 dense engine's tokens tuned
    against untuned;
63. the elastic runtime, degraded mode, the chaos matrix and the
    self-tuning controller: A, a ZeRO-1 Adam drain (4,) -> (2,) of the
    flagship, the drained shards and the next step bitwise a fresh DP=2
    start; B, a hot spare beside DP=2 adding no rendezvous or bytes, a
    ``rank_death``, consensus and ``takeover_shard``, the redone step
    bitwise; C, paged TP=4 -> TP=2 serving through drain tickets and
    ``readmit`` against ``generate()``; D, ``codec_escalate``,
    ``schedule_failover`` and ``spare_demote`` under gray faults; E, the
    closed loop on 8 CUDA rank threads (its watermarks from the wire's
    measured healthy q8/exact goodput) and, escalated, the installed tier
    winner bitwise its interpreter with its K1 requants counted alone; F,
    the fast matrix cells against their CPU records and the process
    reruns on CUDA workers (a killed worker's replacement spawned
    mid-cell);
64. the multi-process runtime: this script runs again as two worker
    processes on the card (``--dist-worker``), which rendezvous through
    ``init_distributed`` (gloo over loopback) and run ``run_spmd``
    across each other: A, JAX's ``_WORKER`` shape (the Allreduce
    forward and backward, values 3 and gradient 2, ``local_values``
    giving each worker its rank, ``comm_from_mpi4py`` through an mpi4py
    stand-in on the initialized runtime); B, phase 51's DP=2 step at
    full width, its two ranks in the two processes, three steps (two
    outside deterministic mode, one inside): the seeded parameters'
    digests alike first, then every step's loss and parameters bitwise
    the same steps under ``run_spmd(nranks=2)`` in this process (SHA-256
    digests from the workers), 8 launches a step of each attention
    kernel in each worker, all ``tc``, step ms, the bytes that cross
    processes a step and worker 0's idle share; C, the q8 ``ring``
    Allreduce of 4 x 2^20 float32 a rank, forward and backward, bitwise
    the one-process run, K1's launches counted in each worker; D, JAX's
    ``_HYBRID_WORKER`` shape at 2 processes x 2 ranks
    (``hybrid_mesh({"tp": 2}, {"dp": 2})`` with each tp row inside one
    process, the tp and dp sums and the dp gradient, the deterministic
    fold on ``gather`` and ``ring`` bitwise ``run_ranks(4)``); E, a
    worker that leaves before its next Allreduce: the survivor raises
    ``RankFailedError`` naming its ranks within the world timeout;
65. the collective-schedule verifier (``analyze``) on the card: A, the
    registry-wide sweep and the seeded-defect corpus recorded on CUDA
    rank threads over the (8,), (3,), (1,) and (2, 4) worlds, no
    violation and every defect caught by its named lint; B, phase 51's
    full-width DP=2 step lowered: clean lints, its collectives and
    payload bytes those ``ExchangeCounter`` counts in one step, K2-K4
    ``custom_call`` events 8 a rank and equal to the launches, the
    recording's seconds against the step's, ``peak_live_bytes`` beside
    ``max_memory_allocated``; C, the fused q8 DP=2 step lowered: K1's
    events equal its launches, both rotations in
    ``int8_rotation_census``; D, ``Engine(spmd=True, nranks=2)``'s
    ``lower_step()`` at full width: exposure below 1.0 with overlap, 1.0
    blocking, the tokens unchanged by lowering before every step;
66. the runtime census against the recorded programs (``obs.reconcile``)
    on the card: A, phase 51's exact DP=2 step and the fused q8 DP=2
    step at full width traced under ``run_ranks`` and reconciled against
    phase 65's recordings of their ``run_spmd`` twins (wire bytes and
    per-kind counts exact, every rank consistent, nothing dropped; the
    q8 buckets priced through equivalent recordings, whose K1 launches
    are counted), with the seconds of each traced step; B, the TP=2
    overlap decode step at full width reconciled against
    ``Engine(spmd=True, nranks=2, overlap=True).lower_step()`` at
    exposure 0.0, with K2's launches; C, ``overlap --smoke``, ``obs
    --smoke``, ``csched --smoke``, ``csched --tiers`` and ``serve
    --smoke`` in this process on the card, each exiting 0, with their
    seconds;
67. one JSON line describing each ported kernel (K2, K3 and K4 with
    the variant the main path ran; the launches of phases 18–20, 23–27,
    30–31 and of the later slices' phases, ``obs_launches``,
    ``resilience_launches``, ``handoff_launches``,
    ``checkpoint_launches``, ``process_launches`` (counted in the
    workers), ``mode_a_launches`` (phases 51, 55, 56 and 57) and
    ``mesh_2d_launches`` (phase 61), ``tune_launches`` (phase 62),
    ``item6_launches`` (phase 63), ``dist_launches`` (phase 64,
    counted in the workers), ``analyze_launches`` (phase 65, the
    custom_call events of the recorded programs) and
    ``reconcile_launches`` (phase 66);
    their numbers at the SP and
    slice-10 shapes, against the plain versions, their bounds and SDPA;
    K1 with its hop and requant launches, ``reshard_launches``,
    ``process_launches``, ``mode_a_launches`` (phases 55 and 58) and
    ``csched_launches`` (phase 60), ``tune_launches`` (phase 62),
    ``item6_launches`` (phase 63), ``dist_launches`` (phase 64),
    ``analyze_launches`` (phase 65) and ``reconcile_launches`` (phase
    66) among them).

Each phase prints the seconds it took, and each of 28–67 the card's name
and power limit beside its numbers.  Times on the host clock are host times; event times of the
comm tracer are host times (a rendezvous returns before the card has
run its work).

The last line is ``{"ok": true, "device": {"platform": "gpu", ...}}``.
TF32 is switched off for matmuls and cuDNN here, so float32 work on the
card stays float32-exact like the JAX reference.
"""

import contextlib
import hashlib
import itertools
import json
import math
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types

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
    # Chunked prefill (phase 23): a 256-row chunk at q offsets 256 to 1024
    # against q_off + 256 keys, and the 36-row last chunk of a 1316-token
    # prompt (sq < sk, the causal tile cut taken from the offsets).
] + [(f"chunk_256_q_off_{q_off}", torch.bfloat16, 1, 256, q_off + 256, 16,
      16, 128, q_off, 0, 0, True) for q_off in (256, 512, 768, 1024)] + [
    ("chunk_36_q_off_1280", torch.bfloat16, 1, 36, 1316, 16, 16, 128, 1280,
     0, 0, True),
]
# (rows, q_off) of the prefill-chunk shapes above.
CHUNK_SHAPES = [(256, q_off) for q_off in (256, 512, 768, 1024)] + \
    [(36, 1280)]

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
# Paged, sampled serving (phase 23): 16-token pages, a pool of 170 (a third
# of the 512 pages the dense cache holds for 4 slots, under the run's peak
# demand, so pages are reclaimed and a request is preempted), the prefix
# cache, 256-token prefill chunks, temperature 0.8 and top-k 50.  Requests
# (submission order; request i's key is PRNGKey(1000 + i)): four share a
# 600-token system prompt with suffixes of 40-700 tokens, three are phase
# 4's prompts (its longest, median and shortest), and the last repeats the
# shortest exactly (a prefix hit that leaves a one-token suffix and copies
# the partly filled tail page).
PAGED = dict(slots=4, max_new=32, block_size=16, num_blocks=170,
             prefix_cache=True, prefill_chunk=256, temperature=0.8,
             top_k=50)
SYS_LEN, SYS_SUFFIXES = 600, (40, 150, 400, 700)

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
#  the loss also reads lse).  The tc tiles are 128 rows (K3's q tiles and
# K4's KV tiles) and 64 rows (K3's KV tiles and K4's q tiles):
# "ragged_133_37" has neither edge on a tile and fewer keys than one tile;
# "d72_window_64" is zero-padded to 128 in shared memory (by TMA's zero
# fill); "d256_simt" takes the simt route.
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

# Sequence-parallel training (phase 24): two rank threads of the one card
# share phase 8's batch 8 x 2048 (s_local 1024); three train_steps each.
SP_RANKS, SP_STEPS = 2, 3
SP_ATTNS = ("ring", "zigzag", "ulysses")
# Attention launches a layer makes on each kernel, summed over the two
# ranks, and how many sit at a nonzero q or KV offset and how many are
# wholly masked (parallel/attention.py): the ring 2 blocks a rank (rank
# 0's second block is wholly in its future); zigzag 3 (q, kv) half pairs
# per arriving block (one of them wholly in the future on each rank);
# Ulysses one full-sequence call a rank.
SP_BLOCKS = {"ring": (4, 3, 1), "zigzag": (12, 11, 2), "ulysses": (2, 0, 0)}
# f32 (the simt kernels) against one device, the worst leaf's
# norm-relative gradient error and the loss's relative error: the two
# differ in the order of their sums (the merges, the sp Allreduce); 1e-6
# on the CPU at a small config.
SP_F32_REL = 1e-4
# bf16 against one device: the merge rounds out to bf16 after every block,
# as the JAX package does; the f32 run above shows the algebra holds, so
# the bound is phase 9's for two ways of rounding the same gradient.
SP_BF16_REL = GRAD_REL_TOL
# Long-context SP (phase 25): batch 1 x 16384 with rope, s_local 8192.
LONG_SEQ, LONG_STEPS = 16384, 2
# EP MoE (phase 26): 4 gelu experts, capacity 1.25 x T_local / E with
# T_local = 4 x 2048 tokens a rank.
EP_EXPERTS, EP_CAPACITY, EP_BATCH = 4, 2560, 4
# Then greedy generate() of 8 tokens after a prompt of this many.
EP_PROMPT = 128
# TP layers (phase 27) at x (8, 2048, 2048) bf16: sharded against
# unsharded, norm-relative; each output sums two bf16-rounded rank
# partials where the unsharded product rounds once (a few bf16 ulps).
TP_REL = 2e-2

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


_PHASE_CLOCK = {}


def phase(n, title=None):
    """Print the seconds the previous phase took, then phase ``n``'s
    header (none when ``title`` is None: the end of the last phase)."""
    now = time.perf_counter()
    if _PHASE_CLOCK:
        print(f"  [phase {_PHASE_CLOCK['n']}: "
              f"{now - _PHASE_CLOCK['t']:.1f} s]", flush=True)
    _PHASE_CLOCK.update(n=n, t=now)
    if title is not None:
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
                            qk.hop_noise(key, *shape, device="cpu"))
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
    collective or message of the rank.  ``seq`` keeps the signatures of
    rank 0's rendezvous in order: the exchange sequence of a schedule."""

    def __init__(self):
        from mpi4torch_tpu_torch import runtime

        self._world = runtime.World
        self.exchanges = self.sends = 0
        self.seq = []

    def __enter__(self):
        world, counter = self._world, self
        self._saved = world.exchange, world.p2p_send

        def exchange(w, rank, signature, *a, **kw):
            if rank == 0:
                counter.exchanges += 1
                counter.seq.append(signature)
            return counter._saved[0](w, rank, signature, *a, **kw)

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


def paged_requests(cfg, prompts):
    """Phase 23's requests in submission order, each with the index of
    the phase 4 prompt it is (None for the system-prompt requests)."""
    rng = np.random.default_rng(7)
    sysp = rng.integers(0, cfg.vocab, SYS_LEN)
    sys_reqs = [np.concatenate([sysp, rng.integers(0, cfg.vocab, n)])
                for n in SYS_SUFFIXES]
    by_len = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))
    short, mid, longest = by_len[0], by_len[len(by_len) // 2], by_len[-1]
    order = [("sys", 0), ("p4", longest), ("p4", mid), ("sys", 1),
             ("p4", short), ("sys", 2), ("sys", 3), ("p4", short)]
    return [(sys_reqs[i].copy(), None) if kind == "sys"
            else (prompts[i].copy(), i) for kind, i in order]


def sampled_oracle(T, threefry, cfg, params, prompt, n_new, key):
    """The port's sampled generate() loop for one request with ``key``:
    its tokens, the subkey of each step (generate()'s split, which the
    engine follows whatever tokens it chose) and each step's logits
    row."""
    cache = T.init_kv_cache(cfg, 1, params["embed"].dtype, "cuda")
    p = torch.as_tensor(prompt, device="cuda")[None]
    logits, cache = T.prefill(cfg, params, cache, p)
    toks, subs, rows = [], [], []
    for i in range(n_new):
        if i:
            logits, cache = T.decode_step(cfg, params, cache,
                                          torch.tensor([toks[-1]],
                                                       device="cuda"),
                                          len(prompt) + i - 1)
        key, sub = threefry.split(key)
        subs.append(sub)
        rows.append(logits[0])
        toks.append(int(T.select_token(logits, sub, PAGED["temperature"],
                                       PAGED["top_k"])[0]))
    return toks, subs, rows


def sampled_tie(T, eng_row, gen_row, sub, got, want):
    """The near-tie measures of a step where the engine chose ``got``
    from its logits row and generate() chose ``want`` from its own, with
    the same subkey ``sub`` (each measure over its tolerance, so that at
    most 1 admits the divergence).  ``score``: the gap s[want] - s[got]
    of generate()'s perturbed scores (the top-k masked logits /
    temperature plus the Gumbel noise, what the draw takes the argmax
    of), over ``TIE_TOL / temperature``; only where ``got`` survives
    generate()'s top-k mask.  ``edge``: how far below its row's k-th
    logit lies the token that one row's top-k mask dropped (``got`` in
    generate()'s row, ``want`` in the engine's), over ``TIE_TOL``."""
    k, t = PAGED["top_k"], PAGED["temperature"]
    g, e = gen_row.float(), eng_row.float()
    s = T.perturbed_scores(gen_row[None], sub, t, k)[0].float()
    out = {}
    if torch.isfinite(s[got]):
        out["score"] = (s[want] - s[got]).item() * t / TIE_TOL
    kth_g, kth_e = g.topk(k).values[-1], e.topk(k).values[-1]
    edge = [(kth - row[tok]).item() for kth, row, tok in
            ((kth_g, g, got), (kth_e, e, want)) if row[tok] < kth]
    if edge:
        out["edge"] = min(edge) / TIE_TOL
    return out


def near_tie_check(label, rid, got, want, gaps, tol):
    """``got`` may leave ``want`` only at a step whose near-tie measure
    (``gaps``) is within ``tol``; returns the step it left at (None if
    equal)."""
    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
    if first is not None:
        check(gaps[first] <= tol,
              f"{label} request {rid}: token {first} differs from "
              f"generate() without a near tie ({gaps[first]:.4f} > {tol})")
    return first


def paged_run(serve, kernels, threefry, cfg, params, reqs, temperature,
              profile_at=None):
    """Drive phase 23's requests through a paged engine (the PAGED
    configuration at ``temperature``), timing every step.  Returns the
    engine, the flash_fwd launch counts of the run (all, tc, simt, at a
    q offset above 0), decode ms and tokens over decode-only steps (no
    admission, no prefill chunk), the peak paged and dense-equivalent KV
    bytes, the run's seconds, the profile of the steps from
    ``profile_at`` (None: no profile) and, per request, the logits rows
    its tokens were chosen from, in order."""
    eng = serve.Engine(cfg, params,
                       serve.ServeConfig(**dict(PAGED,
                                                temperature=temperature)),
                       device="cuda")
    hd = cfg.d_model // cfg.n_heads
    row = 2 * cfg.kv_heads * hd * cfg.n_layers * params["embed"].element_size()
    for i, (p, _) in enumerate(reqs):
        eng.submit(p, key=threefry.PRNGKey(1000 + i))
    # Every logits table the engine chose from, with the request of each
    # row (prefill and decode alike; the comparison with generate() reads
    # them).  Inside the timed steps the wrapper only keeps a reference:
    # no device work, no copy (the engine never writes a logits table
    # after choosing from it); the rows are split after the run.
    chosen = []
    select = eng._select

    def keep_rows(reqs_, logits):
        chosen.append(([None if r is None else r.rid for r in reqs_],
                       logits))
        return select(reqs_, logits)

    eng._select = keep_rows
    decode_ms, decode_tok, peak, peak_dense, prof = 0.0, 0, 0, 0, None
    kernels.reset_launch_counts()
    t_run = time.perf_counter()
    steps = 0
    while eng.pending():
        if profile_at is not None and steps == profile_at:
            prof = profile_top(lambda: [eng.step() for _ in range(6)],
                               "6 steps of the paged engine (greedy twin)")
            steps += 6
            continue
        before = eng.stats.counters["prefill_tokens"]
        t0 = time.perf_counter()
        ev = eng.step()           # ends in a host read of the tokens
        dt = (time.perf_counter() - t0) * 1e3
        steps += 1
        if not ev["admitted"] and eng.stats.counters["prefill_tokens"] \
                == before:
            decode_ms += dt
            decode_tok += len(ev["emitted"])
        peak = max(peak, eng.kv_bytes_resident())
        peak_dense = max(peak_dense, eng.occupancy() * cfg.max_seq * row)
    run_s = time.perf_counter() - t_run
    launches = {k: kernels.launch_counts[k] for k in
                ("flash_fwd", "flash_fwd.tc", "flash_fwd.simt",
                 "flash_fwd.q_off")}
    chosen_from = {}
    for rids, logits in chosen:
        for rid, lrow in zip(rids, logits):
            if rid is not None:
                chosen_from.setdefault(rid, []).append(lrow)
    return eng, launches, decode_ms, decode_tok, peak, peak_dense, run_s, \
        prof, chosen_from


def chunk_numbers(flash, kernels):
    """K2 at the chunked-prefill shapes (bf16, 16 heads of 128): the
    chunk's rows against rows q_off:q_off + rows of a one-shot call over
    1316 rows (bitwise), then per shape the kernel, its plain version and
    scaled_dot_product_attention with a lower-right causal mask (the
    chunk's causal alignment; SDPA's is_causal aligns top-left), its
    bound, and the largest kernel-vs-plain error."""
    from torch.nn.attention.bias import causal_lower_right

    dt, h, d = torch.bfloat16, 16, 128
    q, k, v = attention_inputs(dt, 1, 1316, 1316, h, h, d, seed=23)
    full, full_lse = flash.flash_block_attention(q, k, v, causal=True)
    same = True
    out = []
    for rows, q_off in CHUNK_SHAPES:
        hi = q_off + rows
        qc, kc, vc = q[:, q_off:hi], k[:, :hi], v[:, :hi]
        kw = dict(causal=True, q_offset=q_off)
        o, l = flash.flash_block_attention(qc, kc, vc, **kw)
        same = same and torch.equal(o, full[:, q_off:hi]) and torch.equal(
            l, full_lse[:, q_off:hi])
        po, pl = flash.flash_block_attention(qc, kc, vc, impl="torch", **kw)
        err, _, err_l, ok = forward_errors(o, l, po, pl, dt)
        check(ok, f"K2 at the chunk ({rows}, q_off {q_off}) disagrees with "
              "the plain version")
        ms = event_ms(lambda: flash.flash_block_attention(qc, kc, vc, **kw))
        plain_ms = event_ms(lambda: flash.flash_block_attention(
            qc, kc, vc, impl="torch", **kw), iters=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (qc, kc, vc))
        mask = causal_lower_right(rows, hi)
        lib_ms = event_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
        pairs = live_pairs(rows, hi, q_off, 0, 0, True)
        flops = 4.0 * h * d * pairs
        nbytes = (2 * rows * h * d + 2 * hi * h * d) * 2 + rows * h * 4
        b_ms, b_by = bound(flops, nbytes, dt)
        print(f"  K2 chunk ({rows} rows, q_off {q_off}, {hi} keys): tc "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA lower-right "
              f"causal {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{100 * b_ms / ms:.1f}% of bound; out err {err:.3e}, lse err "
              f"{err_l:.3e}", flush=True)
        out.append({"rows": rows, "q_off": q_off, "keys": hi, "ms": ms,
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err})
    print(f"  chunk rows bitwise equal to the one-shot rows (1316 rows): "
          f"{same}")
    check(same, "a chunk's K2 rows differ from the one-shot K2 rows")
    return out


def paged_phase(P, T, serve, kv, kernels, flash, threefry, cfg, params,
                prompts, dense_results):
    """Phase 23: paged, sampled serving of the flagship (see PAGED),
    with a greedy twin; checks and numbers as the module docstring says.
    Returns the numbers the kernels line carries."""
    reqs = paged_requests(cfg, prompts)
    lens = [len(p) for p, _ in reqs]
    print(f"  {len(reqs)} requests, prompt lengths {lens}; {PAGED}")
    with torch.inference_mode():
        greedy = paged_run(serve, kernels, threefry, cfg, params, reqs, 0.0,
                           profile_at=40)
        (eng, launches, decode_ms, decode_tok, peak, peak_dense, run_s,
         _, s_rows) = sampled = paged_run(serve, kernels, threefry, cfg, params,
                                  reqs, PAGED["temperature"])
        g_res, s_res = greedy[0].results(), eng.results()
        snap = eng.stats.snapshot()
        check(all(len(g_res[r]) == len(s_res[r]) == len(p) + PAGED["max_new"]
                  and eng.status(r) == serve.STATUS_OK
                  for r, (p, _) in enumerate(reqs)),
              "a paged request did not finish its budget")
        for name, run in (("greedy", greedy), ("sampled", sampled)):
            got = run[1]
            print(f"  {name}: flash_fwd launches {got['flash_fwd']}, of them "
                  f"tc {got['flash_fwd.tc']}, simt {got['flash_fwd.simt']}, "
                  f"at q_off > 0 {got['flash_fwd.q_off']}")
            check(got["flash_fwd"] == got["flash_fwd.tc"] > 0
                  and got["flash_fwd.q_off"] > 0,
                  f"the {name} paged run left the tc kernel or ran no "
                  "chunk at a q offset")
        counters = {k: snap[k] for k in ("prefix_hits", "prefix_misses",
                                         "prefill_tokens", "cow_copies",
                                         "preempted", "admitted",
                                         "blocks_in_use")}
        print(f"  counters (sampled): {counters}; sum of prompt lengths "
              f"{sum(lens)}; greedy twin's: "
              + str({k: greedy[0].stats.counters[k] for k in counters}))
        check(counters["prefix_hits"] >= 4 and counters["cow_copies"] >= 1
              and counters["preempted"] >= 1
              and counters["prefill_tokens"] < sum(lens)
              and counters["blocks_in_use"] == 0,
              "the paged run did not share prefixes, copy a tail page, "
              "preempt, save prefill tokens, or release its pages")
        # Greedy: near-tie parity with generate(), and with phase 4's
        # dense engine on the requests both served.  The logits rows the
        # engine chose from against generate()'s at the steps both share
        # (up to and including the first divergence).  Sampled: every
        # token the engine chose is, bit for bit, the draw of its own
        # logits row with the subkey of generate()'s split at that step
        # (the key discipline across admission, chunking and preemption,
        # the batched draw and the top-k mask on the card); where it
        # leaves generate()'s stream, the divergence must be a near tie
        # of those two tokens (sampled_tie).
        g_div, dense_div, ties, s_ties = 0, 0, 0, 0
        s_div = {"score": 0, "edge": 0}
        mine_equal, mine_total = 0, 0
        differs = False
        diff = {"greedy": 0.0, "sampled": 0.0}

        def row_diff(mine, theirs, upto):
            n = len(theirs) if upto is None else upto + 1
            return max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(mine[:n], theirs[:n]))

        for rid, (p, p4) in enumerate(reqs):
            got = g_res[rid][len(p):].tolist()
            g_rows, s_rows_r = greedy[8][rid], s_rows[rid]
            check(len(g_rows) == len(s_rows_r) == PAGED["max_new"],
                  f"request {rid}: the engine chose {len(g_rows)} greedy and "
                  f"{len(s_rows_r)} sampled tokens, not {PAGED['max_new']}")
            mine = torch.stack(g_rows).argmax(-1).tolist()
            check(mine == got, f"greedy paged request {rid}: a token is not "
                  "the argmax of the row the engine chose it from")
            want, gaps, rows = oracle_stream(T, cfg, params, p,
                                             PAGED["max_new"])
            ties += sum(g <= TIE_TOL for g in gaps)
            first = near_tie_check("greedy paged", rid, got, want, gaps,
                                   TIE_TOL)
            g_div += first is not None
            diff["greedy"] = max(diff["greedy"], row_diff(g_rows, rows, first))
            if p4 is not None:
                dense = dense_results[p4][len(p):].tolist()
                d_first = near_tie_check("phase 4 dense", rid, dense, want,
                                         gaps, TIE_TOL)
                both = next((i for i, (a, b) in enumerate(zip(got, dense))
                             if a != b), None)
                check(both is None or gaps[both] <= TIE_TOL or min(
                    [x for x in (first, d_first) if x is not None]
                    + [both]) < both,
                    f"request {rid}: paged and dense greedy tokens differ "
                    "without a near tie")
                dense_div += both is not None
            sgot = s_res[rid][len(p):].tolist()
            swant, subs, srows = sampled_oracle(
                T, threefry, cfg, params, p, PAGED["max_new"],
                threefry.PRNGKey(1000 + rid))
            redraw = [int(T.select_token(row[None], sub, PAGED["temperature"],
                                         PAGED["top_k"])[0])
                      for row, sub in zip(s_rows_r, subs)]
            bad = [i for i, (a, b) in enumerate(zip(redraw, sgot)) if a != b]
            mine_equal += len(sgot) - len(bad)
            mine_total += len(sgot)
            check(not bad, f"sampled paged request {rid}: token(s) {bad} are "
                  "not the draw of the engine's own logits row with "
                  "generate()'s subkey (the key discipline, the batched draw "
                  "or the mask)")
            s_first = next((i for i, (a, b) in enumerate(zip(sgot, swant))
                            if a != b), None)
            upto = len(swant) if s_first is None else s_first + 1
            for row, sub in zip(srows[:upto], subs[:upto]):
                top2 = T.perturbed_scores(row[None], sub,
                                          PAGED["temperature"],
                                          PAGED["top_k"])[0].float().topk(2)
                s_ties += (top2.values[0] - top2.values[1]).item() \
                    * PAGED["temperature"] <= TIE_TOL
            d = row_diff(s_rows_r, srows, s_first)
            diff["sampled"] = max(diff["sampled"], d)
            if s_first is not None:
                m = sampled_tie(T, s_rows_r[s_first], srows[s_first],
                                subs[s_first], sgot[s_first], swant[s_first])
                how = min(m, key=m.get) if m else None
                print(f"    sampled request {rid}: token {s_first} differs "
                      f"from generate() ({sgot[s_first]} for "
                      f"{swant[s_first]}); near-tie measures of those two "
                      f"tokens (<= 1 a near tie) "
                      + (", ".join(f"{n} {v:.3f}" for n, v in m.items())
                         or "none applies")
                      + f"; max |logit diff| up to it {d:.4f}")
                check(how is not None and m[how] <= 1.0,
                      f"sampled paged request {rid}: token {s_first} differs "
                      "from generate() without a near tie of the two tokens")
                s_div[how] += 1
            differs = differs or sgot != got
        print(f"  max |logit diff| against generate() at shared steps: "
              f"greedy {diff['greedy']:.4f}, sampled {diff['sampled']:.4f} "
              f"(tolerance {TIE_TOL})")
        check(max(diff.values()) <= TIE_TOL,
              "paged engine logits too far from generate()'s")
        print(f"  sampled tokens redrawn from the engine's own rows with "
              f"generate()'s subkeys: {mine_equal} of {mine_total} bitwise "
              f"equal")
        # generate() itself is the sampled loop above.
        p0 = reqs[0][0]
        g0 = T.generate(cfg, params, torch.as_tensor(p0, device="cuda")[None],
                        PAGED["max_new"], temperature=PAGED["temperature"],
                        top_k=PAGED["top_k"],
                        key=threefry.PRNGKey(1000))[0, len(p0):].tolist()
        check(g0 == sampled_oracle(T, threefry, cfg, params, p0,
                                   PAGED["max_new"],
                                   threefry.PRNGKey(1000))[0],
              "sampled generate() disagrees with its own step loop")
        check(differs, "no sampled token differs from the greedy stream: "
              "the sampler did not run")
        print(f"  tokens vs generate(): greedy near-tie divergences {g_div}; "
              f"sampled {sum(s_div.values())}, admitted by the perturbed-"
              f"score gap of the two tokens (<= "
              f"{TIE_TOL / PAGED['temperature']:g}) {s_div['score']}, by the "
              f"top-k edge (a dropped token within {TIE_TOL} of the k-th "
              f"logit) {s_div['edge']}; compared sampled steps with a "
              f"perturbed top-2 gap <= {TIE_TOL / PAGED['temperature']:g}: "
              f"{s_ties}; greedy vs phase 4's dense engine on the 4 requests "
              f"both served: {dense_div} near-tie divergences (oracle steps "
              f"with a top-2 gap <= {TIE_TOL}: {ties}); sampled differs from "
              f"greedy: {differs}")
        # Numbers.
        ttft = snap["ttft_s"]
        shards = eng._shards
        long_p = max((p for p, _ in reqs), key=len)
        past = [{"k": r["k"][:, :0], "v": r["v"][:, :0]}
                for r in kv.init_kv_cache_tp(cfg, 1, 1, torch.bfloat16,
                                             "cuda")]
        _, rows = kv.prefill_chunk_tp(
            cfg, shards, past, torch.as_tensor(long_p[:1024],
                                               device="cuda")[None])
        chunk = torch.as_tensor(long_p[1024:1280], device="cuda")[None]
        chunk_ms = [sync_ms(lambda: kv.prefill_chunk_tp(cfg, shards, rows,
                                                        chunk))[0]
                    for _ in range(4)][1:]
        keys = torch.tensor([threefry.split(threefry.PRNGKey(s))[1]
                             for s in range(PAGED["slots"])],
                            dtype=torch.int64, device="cuda")
        logits = eng.last_logits
        # A draw is about two hundred small int64 kernels, more than the
        # launch queue holds behind event_ms's sleep, so event_ms would
        # time the host's issue rate.  Both are read from the profiler's
        # trace (the sum of the kernels' durations over five calls), so
        # the selection, which draws the noise, reads at least the noise.
        def per_call(fn, n=5):
            return device_busy_ms(lambda: [fn() for _ in range(n)])[1] / n

        noise_ms = per_call(lambda: threefry.gumbel(keys, (cfg.vocab,),
                                                    logits.dtype))
        select_ms = per_call(lambda: T.select_token(
            logits, keys, PAGED["temperature"], PAGED["top_k"]))
        wall, busy, _ = greedy[7]
        print(f"  sampled run {run_s:.2f} s, {snap['steps']} decode steps; "
              f"TTFT p50 {ttft['p50'] * 1e3:.1f} ms, p99 "
              f"{ttft['p99'] * 1e3:.1f} ms; decode "
              f"{decode_tok / (decode_ms / 1e3):.1f} tokens/s over "
              f"decode-only steps; prefill chunk (256 rows at q_off 1024) "
              f"{np.mean(chunk_ms):.2f} ms (runs "
              + "/".join(f"{x:.2f}" for x in chunk_ms)
              + f"); sampling noise {noise_ms:.4f} device ms a step (the "
              f"whole batched selection {select_ms:.4f}; kernel time from "
              f"the profiler's trace); KV resident at peak "
              f"{peak / 2**20:.1f} MiB paged against {peak_dense / 2**20:.1f} "
              f"MiB dense ({peak / peak_dense:.3f}); profiled window idle "
              f"{100 - 100 * busy / wall:.0f}%", flush=True)
        chunks = chunk_numbers(flash, kernels)
    return {"launches": launches, "greedy_launches": greedy[1],
            "chunks": chunks}


# ------------------------------------------------- slice 9: SP, EP, TP

class LaunchOrder:
    """While entered, records the rank thread and kernel of every kernel
    launch in launch order: ``_kernels._launch`` runs under a lock, so on
    the one stream the device runs the kernels in the recorded order, and
    a profiler's kernel records sorted by start time pair off with it."""

    def __init__(self, P, kernels):
        self._P, self._kernels = P, kernels
        self.order = []

    def __enter__(self):
        lock, saved, order, P = threading.Lock(), self._kernels._launch, \
            self.order, self._P
        self._saved = saved

        def launch(kernel, *a, **kw):
            with lock:
                order.append((P.COMM_WORLD.rank, kernel))
                return saved(kernel, *a, **kw)

        self._kernels._launch = launch
        return self

    def __exit__(self, *exc):
        self._kernels._launch = self._saved
        return False


def profiled_rank_ms(P, kernels, fn, label, n_ranks):
    """Profile ``fn`` (which runs rank threads) twice: once as it runs,
    for the wall ms and the device's busy ms; once with the launches
    serialised by :class:`LaunchOrder`, for each rank's attention-kernel
    device ms (the profiler's kernel records, attributed by launch
    order; None where they do not pair off with the launches)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def profile(order=None):
        torch.cuda.synchronize()
        with contextlib.ExitStack() as stack:
            if order is not None:
                stack.enter_context(order)
            prof = stack.enter_context(
                torch.profiler.profile(activities=acts))
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        return wall, [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.is_user_annotation]

    wall, dev = profile()
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    lo = LaunchOrder(P, kernels)
    lo_wall, dev = profile(lo)
    lo_busy = sum(e.self_device_time_total for e in dev) / 1e3
    flash_ev = sorted((e for e in dev if "flash_" in e.name),
                      key=lambda e: e.time_range.start)
    attn = [x for x in lo.order if x[1] in kernels.ATTENTION_KERNELS]
    per_rank = None
    if len(flash_ev) == len(attn) and attn:
        per_rank = [0.0] * n_ranks
        for e, (rank, _) in zip(flash_ev, attn):
            per_rank[rank] += e.time_range.elapsed_us() / 1e3
    print(f"  profile {label}: wall {wall:.2f} ms, device busy {busy:.2f} "
          f"ms (idle {100 - 100 * busy / wall:.0f}%); launches serialised:"
          f" wall {lo_wall:.2f} ms, idle {100 - 100 * lo_busy / lo_wall:.0f}%,"
          f" attention kernels "
          + (f"per rank {[round(x, 3) for x in per_rank]} device ms"
             if per_rank is not None else
             f"not attributed ({len(flash_ev)} profiled, {len(attn)} "
             "launched)"))
    return wall, busy, per_rank


def sp_local(tokens, attn, rank, size=SP_RANKS):
    """This rank's sequence shard of replicated ``tokens``: contiguous, or
    the zigzag shard."""
    from mpi4torch_tpu_torch.parallel import zigzag_positions

    s_local = tokens.shape[1] // size
    if attn == "zigzag":
        idx = torch.as_tensor(zigzag_positions(size, s_local)[rank],
                              device=tokens.device)
        return tokens.index_select(1, idx)
    return tokens[:, rank * s_local:(rank + 1) * s_local]


def sp_grad(P, T, tree, dp, cfg, params, local, attn, vocab_chunk=0):
    """train_step's gradient on this rank: the sp-summed loss of the
    parameters averaged over sp (its adjoint makes every rank's gradient
    the one-device gradient)."""
    c = P.COMM_WORLD
    return tree.value_and_grad(lambda p: T.lm_loss(
        cfg, dp.all_average_tree(c, p), local, comm_sp=c, attn=attn,
        vocab_chunk=vocab_chunk), params)


def attention_counts(kernels, launches):
    """(all, offset, masked) launches of each attention kernel, and
    whether every launch took tc."""
    return ({k: (launches[k], launches[f"{k}.offset"],
                 launches[f"{k}.masked"])
             for k in kernels.ATTENTION_KERNELS},
            attention_all_tc(kernels, launches))


def sp_phase(P, T, tree, dp, kernels, cfg, params, tokens, tp1_ms):
    """SP=2 training of the flagship: each strategy's gradient against one
    device in f32 (batch 1) and bf16 (batch 8), then SP_STEPS train_steps
    with launches per step, both ranks bitwise identical; a profiled step
    (idle share, each rank's attention device ms)."""
    n = cfg.n_layers
    # f32 at batch 1 x 2048: the simt kernels; the algebra against one
    # device.
    p32 = tree.tree_map(lambda t: t.float(), params)
    one = tokens[:1]
    ref_l, ref_g = tree.value_and_grad(lambda p: T.lm_loss(cfg, p, one),
                                       p32)
    f32_err = {}
    for attn in SP_ATTNS:
        kernels.reset_launch_counts()
        (l0, g0), (l1, g1) = P.run_ranks(
            lambda r: sp_grad(P, T, tree, dp, cfg, p32,
                              sp_local(one, attn, r), attn), SP_RANKS,
            device="cuda")
        same = torch.equal(l0, l1) and leaves_equal(tree, g0, g1)
        del g1
        simt = all(kernels.launch_counts[k] == kernels.launch_counts[
            f"{k}.simt"] > 0 for k in kernels.ATTENTION_KERNELS)
        rel_l = abs(l0.item() - ref_l.item()) / ref_l.item()
        worst = norm_rel(tree, g0, ref_g)
        f32_err[attn] = worst
        ok = same and simt and rel_l <= SP_F32_REL and worst <= SP_F32_REL
        print(f"  f32 batch 1 x {TRAIN_SEQ}, {attn:7s}: loss {l0.item():.6f}"
              f" vs one device {ref_l.item():.6f} (rel {rel_l:.2e}); worst "
              f"leaf's norm-relative gradient error {worst:.3e} (tol "
              f"{SP_F32_REL:g}); ranks bitwise identical {same}; every "
              f"launch simt {simt}  {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"f32 SP ({attn}) disagrees with one device")
        del g0
    del p32, ref_g

    ref_l, ref_g = tree.value_and_grad(lambda p: T.lm_loss(cfg, p, tokens),
                                       params)
    out = {"launches": {}, "ms": {}, "idle_pct": {}, "rank_attn_ms": {},
           "f32_rel": f32_err, "bf16_rel": {}}
    for attn in SP_ATTNS:
        locs = [sp_local(tokens, attn, r) for r in range(SP_RANKS)]
        (l0, g0), (l1, g1) = P.run_ranks(
            lambda r: sp_grad(P, T, tree, dp, cfg, params, locs[r], attn),
            SP_RANKS, device="cuda")
        same = torch.equal(l0, l1) and leaves_equal(tree, g0, g1)
        del g1
        worst = norm_rel(tree, g0, ref_g)
        out["bf16_rel"][attn] = worst
        ps, ms, per_step = [params] * SP_RANKS, [], []
        for step in range(SP_STEPS):
            kernels.reset_launch_counts()
            t, res = sync_ms(lambda: P.run_ranks(
                lambda r: T.train_step(cfg, ps[r], locs[r],
                                       comm_sp=P.COMM_WORLD, attn=attn,
                                       lr=LR), SP_RANKS, device="cuda"))
            per_step.append(attention_counts(kernels, kernels.launch_counts))
            ms.append(t)
            if step == 0:
                with torch.no_grad():
                    applied = torch.equal(res[0][0], l0) and leaves_equal(
                        tree, res[0][1], tree.tree_map(
                            lambda p, g: p - LR * g, params, g0))
                del g0
            ps = [x[1] for x in res]
        ranks_same = leaves_equal(tree, ps[0], ps[1])
        del ps, res
        blocks, off, masked = SP_BLOCKS[attn]
        want = {k: (n * blocks, n * off, n * masked)
                for k in kernels.ATTENTION_KERNELS}
        counts_ok = all(c == (want, True) for c in per_step)
        out["launches"][attn] = per_step[0][0]
        out["ms"][attn] = float(np.mean(ms[1:]))
        ok = (same and applied and ranks_same and counts_ok
              and abs(l0.item() - ref_l.item()) <= LOSS_TOL
              and worst <= SP_BF16_REL)
        print(f"  bf16 batch {TRAIN_BATCH} x {TRAIN_SEQ}, {attn:7s}: first "
              f"loss {l0.item():.4f} vs one device {ref_l.item():.4f} (tol "
              f"{LOSS_TOL}); worst leaf's norm-relative gradient error "
              f"{worst:.3e} (tol {SP_BF16_REL:g}; f32 {f32_err[attn]:.1e});"
              f" first update p - lr g bitwise {applied}; {SP_STEPS} steps "
              f"{[round(x, 1) for x in ms]} ms (TP=1 step {tp1_ms:.1f} ms); "
              f"launches a step (all, offset, masked) "
              f"{per_step[0][0]} (expected {want[kernels.ATTENTION_KERNELS[0]]}"
              f" each), all tc {per_step[0][1]}; ranks' parameters bitwise "
              f"identical after {SP_STEPS} steps {ranks_same}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"SP training ({attn}) failed a check")
        wall, busy, per_rank = profiled_rank_ms(
            P, kernels, lambda: P.run_ranks(
                lambda r: T.train_step(cfg, params, locs[r],
                                       comm_sp=P.COMM_WORLD, attn=attn,
                                       lr=LR), SP_RANKS, device="cuda"),
            f"one SP=2 {attn} step", SP_RANKS)
        out["idle_pct"][attn] = 100 - 100 * busy / wall
        out["rank_attn_ms"][attn] = per_rank
    del ref_g
    return out


def long_context_phase(P, T, tree, dp, kernels, cfg, params):
    """SP=2 at 16384 tokens with rope: LONG_STEPS steps of the chunked
    loss per strategy at full depth; the 2-layer f32 model's hidden
    states, loss and gradient against one device on the whole sequence."""
    import dataclasses

    lcfg = dataclasses.replace(cfg, rope=True)
    lparams = {k: v for k, v in params.items() if k != "pos"}
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, LONG_SEQ))).to("cuda")
    out = {"launches": {}, "ms": {}, "f32_rel": {}, "rank_attn_ms": {}}
    torch.cuda.reset_peak_memory_stats()
    for attn in ("ring", "zigzag"):
        locs = [sp_local(tokens, attn, r) for r in range(SP_RANKS)]

        def step(r, p):
            loss, g = sp_grad(P, T, tree, dp, lcfg, p, locs[r], attn,
                              VOCAB_CHUNK)
            with torch.no_grad():
                return loss, tree.tree_map(lambda a, b: a - LR * b, p, g)

        ps, ms, losses = [lparams] * SP_RANKS, [], []
        for _ in range(LONG_STEPS):
            kernels.reset_launch_counts()
            t, res = sync_ms(lambda: P.run_ranks(lambda r: step(r, ps[r]),
                                                 SP_RANKS, device="cuda"))
            ms.append(t)
            losses.append([x[0].item() for x in res])
            ps = [x[1] for x in res]
        counts, tc = attention_counts(kernels, kernels.launch_counts)
        same = leaves_equal(tree, ps[0], ps[1])
        del ps, res
        out["launches"][attn] = counts
        out["ms"][attn] = ms
        _, _, out["rank_attn_ms"][attn] = profiled_rank_ms(
            P, kernels, lambda: P.run_ranks(lambda r: step(r, lparams),
                                            SP_RANKS, device="cuda"),
            f"one long-context {attn} step", SP_RANKS)
        ok = (same and tc and all(a == b for a, b in losses)
              and all(np.isfinite(losses[i][0]) for i in range(LONG_STEPS))
              and abs(losses[0][0] - np.log(cfg.vocab)) <= INIT_LOSS_TOL)
        print(f"  {attn:6s} 1 x {LONG_SEQ} (s_local {LONG_SEQ // SP_RANKS}),"
              f" rope, vocab_chunk {VOCAB_CHUNK}: losses "
              f"{[round(x[0], 4) for x in losses]}; step "
              f"{[round(x, 1) for x in ms]} ms; launches a step (all, "
              f"offset, masked) {counts}, all tc {tc}; ranks identical "
              f"{same}  {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"long-context SP ({attn}) failed a check")
    peak = torch.cuda.max_memory_allocated() / 2**30

    # f32 at n_layers=2 on the whole sequence: hidden states, loss and
    # gradient of one device against SP.
    c2 = dataclasses.replace(lcfg, n_layers=2)
    p2 = tree.tree_map(lambda t: t.float(), dict(
        lparams, blocks=lparams["blocks"][:2]))
    with torch.no_grad():
        ref_h = T.forward(c2, p2, tokens, return_hidden=True)
    ref_l, ref_g = tree.value_and_grad(lambda p: T.lm_loss(
        c2, p, tokens, vocab_chunk=VOCAB_CHUNK), p2)
    from mpi4torch_tpu_torch.parallel import zigzag_positions
    for attn in ("ring", "zigzag"):
        locs = [sp_local(tokens, attn, r) for r in range(SP_RANKS)]

        def body(r):
            with torch.no_grad():
                h = T.forward(c2, p2, locs[r], comm_sp=P.COMM_WORLD,
                              attn=attn, return_hidden=True)
            return h, sp_grad(P, T, tree, dp, c2, p2, locs[r], attn,
                              VOCAB_CHUNK)

        (h0, (l0, g0)), (h1, (l1, g1)) = P.run_ranks(body, SP_RANKS,
                                                     device="cuda")
        h = torch.cat([h0, h1], dim=1)
        if attn == "zigzag":
            perm = np.concatenate(list(zigzag_positions(
                SP_RANKS, LONG_SEQ // SP_RANKS)))
            h = torch.empty_like(h).index_copy_(
                1, torch.as_tensor(perm, device="cuda"), h)
        rel_h = ((h - ref_h).norm() / ref_h.norm()).item()
        rel_l = abs(l0.item() - ref_l.item()) / ref_l.item()
        worst = norm_rel(tree, g0, ref_g)
        same = torch.equal(l0, l1) and leaves_equal(tree, g0, g1)
        del g0, g1, h, h0, h1
        out["f32_rel"][attn] = max(rel_h, worst)
        ok = same and max(rel_h, rel_l, worst) <= SP_F32_REL
        print(f"  f32, 2 layers, {attn:6s} vs one device on {LONG_SEQ} "
              f"tokens: hidden states norm-relative {rel_h:.2e}, loss rel "
              f"{rel_l:.2e}, worst leaf's gradient {worst:.2e} (tol "
              f"{SP_F32_REL:g}); ranks identical {same}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"long-context f32 SP ({attn}) disagrees with one device")
    del p2, ref_g, ref_h
    out["peak_gb"] = peak
    print(f"  peak memory of the full-depth runs {peak:.2f} GiB")
    return out


class CollectiveNames:
    """While entered, lists the signature name of each of rank 0's
    rendezvous (``World.exchange``): one ``"Allreduce"`` per Allreduce,
    whose ring form adds an ``"Allreduce.fold"`` above a few thousand
    elements."""

    def __init__(self):
        from mpi4torch_tpu_torch import runtime

        self._world = runtime.World
        self.names = []

    def __enter__(self):
        saved, names = self._world.exchange, self.names
        self._saved = saved

        def exchange(w, rank, signature, *a, **kw):
            if rank == 0:
                names.append(signature[0])
            return saved(w, rank, signature, *a, **kw)

        self._world.exchange = exchange
        return self

    def __exit__(self, *exc):
        self._world.exchange = self._saved
        return False


class MoeCounter:
    """While entered, sums the tokens ``top1_route`` kept and routed, and
    the payload bytes of forward ``Alltoall`` calls on rank 0.  Per call
    it also records the fullest (expert, slot) (at most one token), the
    tokens kept against ``sum_e min(count_e, C)`` of the router's own
    argmax, and the largest share of tokens one expert was chosen by.
    Both rank threads route at once, so each call's numbers go in as one
    record (one ``append``): lists appended one by one would pair one
    rank's kept count with the other's expected count."""

    def __init__(self, P, moe):
        self._P, self._moe = P, moe
        # (kept, want_kept, slot_max, top_share, tokens routed)
        self.calls = []
        self.a2a_bytes = 0

    @property
    def routed(self):
        return sum(c[4] for c in self.calls)

    @property
    def kept(self):
        return [c[0] for c in self.calls]

    @property
    def top_share(self):
        return [c[3] for c in self.calls]

    def slots_ok(self):
        return all(m.item() <= 1 and int(k.item()) == int(w.item())
                   for k, w, m, _, _ in self.calls)

    def __enter__(self):
        moe, P, me = self._moe, self._P, self
        self._route, self._a2a = moe.top1_route, P.MPI_Communicator.Alltoall

        def route(logits, capacity):
            d, c, aux = me._route(logits, capacity)
            with torch.no_grad():
                expert = torch.softmax(logits, dim=-1).argmax(dim=-1)
                count = torch.bincount(expert, minlength=logits.shape[1])
                me.calls.append((
                    d.sum(dtype=torch.float32),
                    count.clamp(max=capacity).sum(),
                    d.sum(dim=0, dtype=torch.float32).max(),
                    count.max() / logits.shape[0], logits.shape[0]))
            return d, c, aux

        def a2a(comm, tensor, *a, **kw):
            if comm.rank == 0:
                me.a2a_bytes += tensor.numel() * tensor.element_size()
            return me._a2a(comm, tensor, *a, **kw)

        moe.top1_route, P.MPI_Communicator.Alltoall = route, a2a
        return self

    def __exit__(self, *exc):
        self._moe.top1_route = self._route
        self._P.MPI_Communicator.Alltoall = self._a2a
        return False


def ep_phase(P, T, tree, dp, kernels, cfg, tokens):
    """EP=2 training of the flagship with EP_EXPERTS gelu experts: the
    first gradient against the replicated dense-expert form (f32 at 2
    layers, bf16 at full depth), SP_STEPS train_steps, routing numbers;
    greedy generate() of an MoE config against the stepwise argmax of
    forward."""
    import dataclasses

    from mpi4torch_tpu_torch.parallel import moe

    mcfg = dataclasses.replace(cfg, n_experts=EP_EXPERTS,
                               capacity=EP_CAPACITY)
    torch.cuda.reset_peak_memory_stats()
    mparams = T.init_transformer(0, mcfg, torch.bfloat16, device="cuda")
    n_params = sum(t.numel() for t in tree.tree_leaves(mparams))
    locs = [tokens[r * EP_BATCH:(r + 1) * EP_BATCH] for r in range(2)]

    def ep_grad(r, cfg_, p):
        c = P.COMM_WORLD

        def loss(q):
            l_ = T.lm_loss(cfg_, dp.all_average_tree(c, q), locs[r],
                           comm_ep=c)
            return c.Allreduce(l_, P.MPI_SUM, compression=False) / c.size
        return tree.value_and_grad(loss, p)

    def replicated(cfg_, p):
        return tree.value_and_grad(lambda q: sum(
            T.lm_loss(cfg_, q, x) for x in locs) / len(locs), p)

    # f32 at 2 layers: the algebra.
    c2 = dataclasses.replace(mcfg, n_layers=2)
    p2 = tree.tree_map(lambda t: t.float(), dict(
        mparams, blocks=mparams["blocks"][:2]))
    (l0, g0), (l1, g1) = P.run_ranks(lambda r: ep_grad(r, c2, p2), 2,
                                     device="cuda")
    same32 = torch.equal(l0, l1) and leaves_equal(tree, g0, g1)
    del g1
    rl, rg = replicated(c2, p2)
    rel32 = max(abs(l0.item() - rl.item()) / rl.item(),
                norm_rel(tree, g0, rg))
    del g0, rg, p2
    print(f"  f32, 2 layers: EP loss {l0.item():.6f} vs replicated "
          f"{rl.item():.6f}; worst of loss and leaves' norm-relative "
          f"gradient error {rel32:.2e} (tol {SP_F32_REL:g}); ranks identical"
          f" {same32}", flush=True)
    check(same32 and rel32 <= SP_F32_REL,
          "f32 EP disagrees with the replicated form")

    # bf16 at full depth: the first gradient, then SP_STEPS steps.
    with MoeCounter(P, moe) as mc:
        (l0, g0), (l1, g1) = P.run_ranks(lambda r: ep_grad(r, mcfg, mparams),
                                         2, device="cuda")
    same = torch.equal(l0, l1) and leaves_equal(tree, g0, g1)
    del g1
    kept = sum(k.item() for k in mc.kept)
    dropped = 1 - kept / mc.routed
    slots_ok = mc.slots_ok()
    top_share = max(x.item() for x in mc.top_share)
    a2a_fwd = mc.a2a_bytes
    rl, rg = replicated(mcfg, mparams)
    worst = norm_rel(tree, g0, rg)
    del rg
    ps, ms, per_step = [mparams] * 2, [], []
    for step in range(SP_STEPS):
        kernels.reset_launch_counts()
        t, res = sync_ms(lambda: P.run_ranks(
            lambda r: T.train_step(mcfg, ps[r], locs[r],
                                   comm_ep=P.COMM_WORLD, lr=LR), 2,
            device="cuda"))
        per_step.append(attention_counts(kernels, kernels.launch_counts))
        ms.append(t)
        if step == 0:
            with torch.no_grad():
                applied = torch.equal(res[0][0], l0) and leaves_equal(
                    tree, res[0][1], tree.tree_map(lambda p, g: p - LR * g,
                                                   mparams, g0))
            del g0
        ps = [x[1] for x in res]
    ranks_same = leaves_equal(tree, ps[0], ps[1])
    del ps, res
    with torch.no_grad():
        # forward sums the layers' load-balancing losses: a layer's mean.
        aux = P.run_ranks(lambda r: T.forward(
            mcfg, mparams, locs[r], comm_ep=P.COMM_WORLD, return_aux=True,
            return_hidden=True)[1].item() / cfg.n_layers, 2, device="cuda")
    peak = torch.cuda.max_memory_allocated() / 2**30
    # One routing's wall ms at a rank's shape (F.one_hot checks its
    # indices on the host, so the call waits for the device).
    g = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((EP_BATCH * TRAIN_SEQ, EP_EXPERTS), generator=g,
                         device="cuda").to(torch.bfloat16)
    route_ms = float(np.median([sync_ms(lambda: moe.top1_route(
        logits, EP_CAPACITY))[0] for _ in range(10)]))
    del logits
    want = {k: (2 * cfg.n_layers, 0, 0) for k in kernels.ATTENTION_KERNELS}
    counts_ok = all(c == (want, True) for c in per_step)
    ok = (same and applied and ranks_same and counts_ok and slots_ok
          and abs(l0.item() - rl.item()) <= LOSS_TOL
          and worst <= GRAD_REL_TOL)
    print(f"  bf16, {n_params / 1e9:.2f}B parameters, EP=2 x batch "
          f"{EP_BATCH} x {TRAIN_SEQ}, capacity {EP_CAPACITY}: first loss "
          f"{l0.item():.4f} vs replicated {rl.item():.4f} (tol {LOSS_TOL}); "
          f"worst leaf's norm-relative gradient error {worst:.3e} (tol "
          f"{GRAD_REL_TOL:g}); first update p - lr g bitwise {applied}; "
          f"{SP_STEPS} steps {[round(x, 1) for x in ms]} ms; dropped "
          f"tokens {100 * dropped:.2f}% of {mc.routed} routings ("
          f"{cfg.n_layers} layers x 2 ranks; busiest expert "
          f"{100 * top_share:.1f}% of a rank's tokens against capacity "
          f"{100 * EP_CAPACITY / EP_BATCH / TRAIN_SEQ:.2f}%; one routing "
          f"{route_ms:.3f} ms wall, {cfg.n_layers} a rank and step); every slot "
          f"holds at most one token and kept = sum_e min(count_e, C) in "
          f"every call {slots_ok}; Alltoall payload rank 0 forward "
          f"{a2a_fwd / 2**20:.1f} MiB a step, the same again in the "
          f"backward; aux a layer {[round(a, 4) for a in aux]} (1 at "
          f"balance); "
          f"peak {peak:.2f} GiB; launches a step {per_step[0][0]}, all tc "
          f"{per_step[0][1]}; ranks identical after {SP_STEPS} steps "
          f"{ranks_same}  {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "EP MoE training failed a check")

    # Greedy generate() of the MoE model (dense experts) at TP=1, f32:
    # each token the argmax of forward over the sequence so far, but at a
    # near tie (top-2 gap within 1e-3, after which the streams may part).
    p32 = tree.tree_map(lambda t: t.float(), mparams)
    del mparams
    p_len = min(EP_PROMPT, tokens.shape[1] // 2)
    prompt = tokens[:1, :p_len]
    with torch.no_grad():
        gen = T.generate(mcfg, p32, prompt, 8)
        seq, match, gap = prompt, 0, None
        for i in range(8):
            logits = T.forward(mcfg, p32, seq)[0, -1]
            top2 = torch.topk(logits, 2).values
            if int(logits.argmax()) != int(gen[0, p_len + i]):
                gap = (top2[0] - top2[1]).item()
                break
            match += 1
            seq = gen[:, :p_len + i + 1]
    tie_ok = match == 8 or (gap is not None and gap <= 1e-3)
    print(f"  generate() 8 greedy tokens of the MoE config (f32, dense "
          f"experts): {match}/8 equal to the stepwise argmax of forward"
          + (f" (first divergence at a top-2 gap {gap:.2e}, tol 1e-3)"
             if gap is not None else "") + f"  {'ok' if tie_ok else 'FAIL'}",
          flush=True)
    check(tie_ok, "MoE generate() disagrees with forward")
    del p32
    return {"launches": per_step[0][0], "ms": float(np.mean(ms[1:])),
            "dropped": dropped, "top_share": top_share, "route_ms": route_ms,
            "a2a_fwd_bytes": a2a_fwd, "aux": aux,
            "peak_gb": peak, "bf16_rel": worst, "f32_rel": rel32}


def tp_layers_phase(P, kernels, flash):
    """tp_mlp and tp_attention (flash_attention) at the flagship widths on
    two rank threads, forward and backward, against the unsharded
    composition; one rendezvous each way; ms."""
    from mpi4torch_tpu_torch.parallel import tp

    dt, b, s, d, f, h = torch.bfloat16, TRAIN_BATCH, TRAIN_SEQ, 2048, 8192, 16
    g = torch.Generator(device="cuda").manual_seed(21)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(dt)

    x = rnd(b, s, d)
    w = rnd(b, s, d)
    mlp = [rnd(d, f, scale=d ** -0.5), rnd(f, scale=0.1),
           rnd(f, d, scale=f ** -0.5), rnd(d, scale=0.1)]
    att = [rnd(d, d, scale=d ** -0.5) for _ in range(4)]
    # Each rank's shards (axis), in the layers' argument order.
    layers = {
        "tp_mlp": (lambda c, xx, ws: tp.tp_mlp(c, xx, *ws), mlp,
                   (1, 0, 0, None)),
        "tp_attention": (lambda c, xx, ws: tp.tp_attention(
            c, *ws, xx, n_heads=h, attention_fn=flash.flash_attention),
            att, (1, 1, 1, 0))}
    out = {}
    for name, (fn, full, axes) in layers.items():
        def shards(c):
            return [t if a is None else tp.shard_axis(c, t, a)
                    for t, a in zip(full, axes)]

        def body(r):
            c = P.COMM_WORLD
            xx = x.detach().requires_grad_()
            ws = [t.detach().requires_grad_() for t in shards(c)]
            y = fn(c, xx, ws)
            # Every rank seeds 1 / size: the Allreduce's adjoint sums them.
            grads = torch.autograd.grad(
                (y.float() * w.float()).sum() / c.size, [xx] + ws)
            return y.detach(), grads

        def unsharded():
            xx = x.detach().requires_grad_()
            ws = [t.detach().requires_grad_() for t in full]
            if name == "tp_mlp":
                y = torch.nn.functional.gelu(
                    xx @ ws[0] + ws[1], approximate="tanh") @ ws[2] + ws[3]
            else:
                q, k, v = ((xx @ wt).reshape(b, s, h, d // h)
                           for wt in ws[:3])
                y = flash.flash_attention(q, k, v, causal=True).reshape(
                    b, s, d) @ ws[3]
            return y.detach(), torch.autograd.grad(
                (y.float() * w.float()).sum(), [xx] + ws)

        kernels.reset_launch_counts()
        with CollectiveNames() as cnt:
            (y0, g0), (y1, g1) = P.run_ranks(body, 2, device="cuda")
        colls = [x for x in cnt.names if x != "Allreduce.fold"]
        launches = {k: kernels.launch_counts[k]
                    for k in kernels.ATTENTION_KERNELS}
        ry, rg = unsharded()
        rel_y = ((y0.float() - ry.float()).norm() / ry.float().norm()).item()
        # dx: the two ranks' partials sum to the unsharded dx; shards: the
        # matching slice of the unsharded gradient; a replicated leaf (b2)
        # sums its two rank halves.
        errs = [((g0[0].float() + g1[0].float() - rg[0].float()).norm()
                 / rg[0].float().norm()).item()]
        for i, a in enumerate(axes):
            ref = rg[1 + i].float()
            if a is None:
                got = g0[1 + i].float() + g1[1 + i].float()
                errs.append(((got - ref).norm() / ref.norm()).item())
            else:
                for r, gr in enumerate((g0, g1)):
                    part = ref.narrow(a, r * ref.shape[a] // 2,
                                      ref.shape[a] // 2)
                    errs.append(((gr[1 + i].float() - part).norm()
                                 / part.norm()).item())
        same_y = torch.equal(y0, y1)
        del g0, g1, rg
        ms = [sync_ms(lambda: P.run_ranks(body, 2, device="cuda"))[0]
              for _ in range(3)]
        one_ms = [sync_ms(unsharded)[0] for _ in range(3)]
        want_l = 2 if name == "tp_attention" else 0
        ok = (same_y and rel_y <= TP_REL and max(errs) <= TP_REL
              and colls == ["Allreduce"] * 2
              and all(v == want_l for v in launches.values()))
        out[name] = {"ms": min(ms), "one_ms": min(one_ms),
                     "launches": launches, "collectives": colls}
        print(f"  {name:12s} TP=2 at ({b}, {s}, {d}) bf16, forward + "
              f"backward: output norm-relative {rel_y:.2e}, worst gradient "
              f"{max(errs):.2e} (tol {TP_REL:g}) against the unsharded "
              f"layer; ranks' outputs bitwise identical {same_y}; rank 0's "
              f"collectives {colls} (one Allreduce each way); "
              f"attention launches {launches}; {min(ms):.1f} ms on two rank "
              f"threads (runs {[round(v, 1) for v in ms]}) vs unsharded "
              f"{min(one_ms):.1f} ms  {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{name} disagrees with the unsharded layer")
    return out


# SP kernel shapes (kernels phase): (name, b, sq, sk, h, d, q_off, kv_off,
# what one SDPA call computes the same function as: "causal" (the block is
# its own causal diagonal), "full" (every pair live) or None).
SP_KERNEL_SHAPES = [
    ("ring_past", 8, 1024, 1024, 16, 128, 1024, 0, "full"),
    ("ring_diag", 8, 1024, 1024, 16, 128, 1024, 1024, "causal"),
    ("ring_masked", 8, 1024, 1024, 16, 128, 0, 1024, None),
    ("zigzag_half_past", 8, 512, 512, 16, 128, 1536, 512, "full"),
    ("ulysses", 8, 2048, 2048, 8, 128, 0, 0, "causal"),
    ("long_ring_past", 1, 8192, 8192, 16, 128, 8192, 0, "full"),
    ("long_ring_diag", 1, 8192, 8192, 16, 128, 8192, 8192, "causal")]


def sp_kernel_numbers(flash, kernels):
    """K2, K3 and K4 at the SP path's shapes, bf16 causal
    (:func:`attention_kernel_numbers`)."""
    return attention_kernel_numbers(
        flash, kernels, [(name, b, sq, sk, h, d, q_off, kv_off, True, lib)
                         for name, b, sq, sk, h, d, q_off, kv_off, lib
                         in SP_KERNEL_SHAPES], seed0=300)


# ---------------------------------------------------------------------------
# Slice 10 (phases 28-32): the bf16 codecs and the compressed Allgather,
# BASELINE config 4 (ResNet-18 DP=2), ViT-B/16, PP=2 on the flagship, and
# the kernel rows at their shapes.
# ---------------------------------------------------------------------------

AG_CODECS = ("q8", "q8_ef", "q8_ef_hop", "bf16", "bf16r")
# Per-element error of one bf16 encode, as a share of |x|: half an ulp of
# 8 significant bits (round to nearest even), or one ulp (stochastic).
BF16_REL = {"bf16": 2.0 ** -8, "bf16r": 2.0 ** -7}
# A gradient read back from one SGD step: lr a power of two, so lr * g is
# exact and the update's one rounding is 2^-24 of lr * g in float32 (2^-8
# in bf16); (p0 - p1) / lr in float64 is then the gradient the step
# applied, to that share.
GRAD_LR = 2.0 ** 20
# BASELINE config 4: ResNet-18 at its published CIFAR widths, batch 128 per
# rank, DP=2, three steps of each recipe.
RESNET_BATCH, RESNET_HW, RESNET_STEPS, RESNET_LR = 128, 32, 3, 0.05
RESNET_REL = 1e-5
# ViT-Base/16 (Dosovitskiy et al., ICLR 2021, Table 1; mean pool, no class
# token): bf16, batch 64 per rank; the f32 check at 2 layers and 8 images.
VIT_B16 = dict(image_hw=224, patch=16, d_model=768, n_heads=12,
               n_layers=12, d_ff=3072, num_classes=1000)
VIT_BATCH, VIT_F32_BATCH, VIT_LR = 64, 8, 1e-3
BF16_GRAD_REL, F32_GRAD_REL = 5e-2, 1e-4
# PP=2 on the flagship: 4 microbatches of 2 x 2048; the f32 check at 2
# layers with microbatches of 1 x 512.
PP_MB, PP_ROWS, PP_F32_SEQ = 4, 2, 512
# Kernel rows of this slice's paths: (name, b, sq, sk, h, d, q_off, kv_off,
# causal, the SDPA call computing the same block or None).
SLICE10_KERNEL_SHAPES = [
    ("vit", 64, 196, 196, 12, 64, 0, 0, False, "full"),
    ("vit_patch_block", 64, 98, 98, 12, 64, 0, 98, False, "full"),
    ("pp_microbatch", 2, 2048, 2048, 16, 128, 0, 0, True, "causal")]
AG_SHARD_BLOCKS = 65536          # K1 at the Allgather shard, hop-0 form


def rank_key(threefry, salt, rank, n):
    """The key of a rank's ``n``-th keyed encode in a world, as
    ``compress/eager._rank_key`` makes it."""
    key = threefry.fold_in(threefry.PRNGKey(0), salt)
    return threefry.fold_in(threefry.fold_in(key, rank), n)


class PlainCodec:
    """Each rank's encode-decode with the key that rank's call counter
    gives, for the plain recomputation of a compressed collective."""

    def __init__(self, threefry, codec, n):
        self.threefry, self.base, self.calls = threefry, codec.base(), [0] * n

    def roundtrip(self, v, rank, salt):
        key = None
        if self.base.stochastic:
            key = rank_key(self.threefry, salt, rank, self.calls[rank])
            self.calls[rank] += 1
        payload, meta = self.base.encode(v, key)
        return self.base.decode(payload, meta)


def plain_allreduce(C, pc, xs):
    """Value and gradient of ``vdot(y, y)`` through the rendezvous-codec
    Allreduce, recomputed: every rank's decoded payload folded in
    ascending rank order, forward and backward (cotangent 2y)."""
    n = len(xs)
    y = C.reduce_ordered(C.MPI_SUM, [pc.roundtrip(xs[r], r, 0)
                                     for r in range(n)])
    g = C.reduce_ordered(C.MPI_SUM, [pc.roundtrip(y + y, r, 0)
                                     for r in range(n)])
    return y, g


def allgather_run(P, xs, codec):
    """Each rank's (y, dx) of y = Allgather(x, 0, compression=codec) with
    the cotangent (rank + 1) * y."""
    def body(rank):
        x = xs[rank].clone().requires_grad_()
        y = P.COMM_WORLD.Allgather(x, 0, compression=codec)
        (g,) = torch.autograd.grad(y, x, y.detach() * (rank + 1))
        return y.detach(), g

    return P.run_ranks(body, len(xs), device="cuda")


def plain_allgather(C, pc, xs, rounds):
    """The compressed Allgather and its adjoint recomputed: each rank's
    decoded shards concatenated (and the error-feedback rounds), then
    every rank's decoded cotangent summed segment by segment in ascending
    rank order."""
    n = len(xs)
    dec = [pc.roundtrip(xs[r], r, 0) for r in range(n)]
    y = torch.cat(dec)
    for rd in range(1, rounds):
        more = [pc.roundtrip(xs[r] - dec[r], r, rd) for r in range(n)]
        y = y + torch.cat(more)
        dec = [d + m for d, m in zip(dec, more)]
    cots = [y * (r + 1) for r in range(n)]
    lens = [x.shape[0] for x in xs]
    offs = [sum(lens[:r]) for r in range(n)]
    own = [pc.roundtrip(cots[s], s, 100) for s in range(n)]
    segs = [C.reduce_ordered(C.MPI_SUM, [d.narrow(0, offs[r], lens[r])
                                         for d in own]) for r in range(n)]
    for rd in range(1, rounds):
        more = [pc.roundtrip(cots[s] - own[s], s, 100 + rd)
                for s in range(n)]
        segs = [seg + C.reduce_ordered(C.MPI_SUM, [
            d.narrow(0, offs[r], lens[r]) for d in more])
            for r, seg in enumerate(segs)]
        own = [o + m for o, m in zip(own, more)]
    return y, segs


def compression_phase(P, C, config, kernels, threefry):
    """Phase 28: the bf16 Allreduces and the compressed Allgather of every
    codec at the bench size, four rank threads x 2^24 float32.  Returns
    codec -> numbers."""
    n = BENCH_RANKS
    xs = bench_inputs()
    exact = xs[0].clone()
    for x in xs[1:]:
        exact += x
    sabs = sum(x.abs() for x in xs)
    res = {"allreduce": {}, "allgather": {}}
    tiny = 2.0 ** -24 * 2 * n
    q8_value_and_grad(P, xs, False, None)            # warm-up
    exact_ms = min(sync_ms(lambda: q8_value_and_grad(P, xs, False, None))[0]
                   for _ in range(2))
    for codec in ("bf16", "bf16r"):
        ms, got = sync_ms(lambda: q8_value_and_grad(P, xs, codec, None))
        ms = min([ms] + [sync_ms(lambda: q8_value_and_grad(
            P, xs, codec, None))[0] for _ in range(2)])
        pc = PlainCodec(threefry, P.compress.get_codec(codec), n)
        y_p, g_p = plain_allreduce(C, pc, xs)
        y, g = got[0]
        same = all(torch.equal(a, y) and torch.equal(b, g) for a, b in got)
        mism = bits_differ(y, y_p) + bits_differ(g, g_p)
        # Norm-relative: every element's error is at most BF16_REL of the
        # sum of the contributions' magnitudes, plus the folds' rounding.
        err = norm_rel1(y, exact)
        bnd = (BF16_REL[codec] + tiny) * sabs.double().norm().item() \
            / exact.double().norm().item()
        err_g = norm_rel1(g, 2 * n * y)
        bnd_g = BF16_REL[codec] + tiny
        ok = same and mism == 0 and err <= bnd and err_g <= bnd_g
        print(f"  Allreduce {codec:5s}: fwd+bwd {ms:8.2f} ms (exact "
              f"{exact_ms:.2f} ms); ranks identical {same}; vs plain "
              f"recomputation (decode, ordered fold) mismatched {mism}; "
              f"norm-relative error vs exact {err:.3e} (bound {bnd:.3e}), "
              f"grad {err_g:.3e} (bound {bnd_g:.3e})  "
              f"{'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"Allreduce with compression={codec} failed a check")
        res["allreduce"][codec] = {"ms": ms, "exact_ms": exact_ms}
        del got, y, g, y_p, g_p
    # Unbiased rounding: the mean signed error of one 2^24-element encode,
    # each error signed by its element's sign (a biased rounding, like
    # truncation, shows as a mean far from 0).
    x0 = xs[0]
    for codec in ("bf16", "bf16r"):
        c = P.compress.get_codec(codec)
        e = (c.roundtrip(x0, rank_key(threefry, 0, 0, 0)).double()
             - x0.double()) * torch.sign(x0.double())
        mean, se = e.mean().item(), (e.std() / e.numel() ** 0.5).item()
        ok = codec != "bf16r" or abs(mean) <= 4 * se
        verdict = "; within 4 se of 0: unbiased" if codec == "bf16r" else ""
        print(f"  {codec:5s} encode of {x0.numel()} elements: mean signed "
              f"error {mean:.3e}, standard error {se:.3e} ({mean / se:+.2f} "
              f"se){verdict}"
              f"  {'ok' if ok else 'FAIL'}")
        check(ok, "bf16r's mean signed error is not within 4 standard "
              "errors of 0")
        del e
    allgather_run(P, xs, False)                      # warm-up
    ag_exact_ms = min(sync_ms(lambda: allgather_run(P, xs, False))[0]
                      for _ in range(2))
    full = torch.cat(xs)
    for codec in AG_CODECS:
        c = P.compress.get_codec(codec)
        rounds = c.ef_rounds
        kernels.reset_launch_counts()
        ms, got = sync_ms(lambda: allgather_run(P, xs, codec))
        launches = dict(kernels.launch_counts)
        ms = min([ms] + [sync_ms(lambda: allgather_run(P, xs, codec))[0]
                         for _ in range(2)])
        config.set_quant_hop_impl("torch")
        try:
            y_p, segs = plain_allgather(C, PlainCodec(threefry, c, n), xs,
                                        rounds)
        finally:
            config.set_quant_hop_impl("auto")
        y = got[0][0]
        same = all(torch.equal(a, y) for a, _ in got)
        mism = bits_differ(y, y_p) + sum(bits_differ(g, s) for (_, g), s
                                         in zip(got, segs))
        q8 = c.base().hop_fused
        want_req = 2 * n * rounds if q8 else 0
        rel = norm_rel1(y, full)
        tri = n * (n + 1) / 2
        rel_g = max(norm_rel1(g, tri * y[sum(x.shape[0] for x in xs[:r]):]
                              [:xs[r].shape[0]])
                    for r, (_, g) in enumerate(got))
        bnd = CODEC_REL[codec] if q8 else BF16_REL[codec] + tiny
        ok = (same and mism == 0 and launches["q8_requant"] == want_req
              and launches["q8_hop"] == 0 and rel <= bnd and rel_g <= bnd)
        wire = c.wire_bytes((BENCH_NUMEL,), torch.float32)
        print(f"  Allgather {codec:9s}: fwd+bwd {ms:8.2f} ms (exact "
              f"{ag_exact_ms:.2f} ms, {ms / ag_exact_ms:.2f}x); wire "
              f"{wire} B a shard ({4 * BENCH_NUMEL / wire:.2f}x less than "
              f"f32); ranks identical {same}; vs plain recomputation "
              f"(plain requant, decode, ordered fold) mismatched {mism}; "
              f"K1 q8_requant launches {launches['q8_requant']}/{want_req} "
              f"(2 x {n} ranks x {rounds} rd); err vs exact {rel:.3e}, "
              f"grad {rel_g:.3e} (bound {bnd:.3e})  {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"compressed Allgather {codec} failed a check")
        res["allgather"][codec] = {"ms": ms, "exact_ms": ag_exact_ms,
                                   "wire_bytes": wire,
                                   "requant_launches": launches[
                                       "q8_requant"]}
        del got, y, y_p, segs
        torch.cuda.empty_cache()
    return res


def fused_bf16_line(P, T, tree, cfg, params, tokens, q8f, fused):
    """Phase 19's fused DP=2 step with compression="bf16" at 4 MiB: ranks
    identical; step ms beside phase 18's exact and phase 19's q8 step."""
    rows = TRAIN_BATCH // 2

    def step():
        def body(rank):
            x = tokens[rank * rows:(rank + 1) * rows]
            _, g = tree.value_and_grad(lambda q: T.lm_loss(cfg, q, x),
                                       params)
            return P.COMM_WORLD.Allreduce_tree(g, P.MPI_SUM, mean=True,
                                               compression="bf16")
        return P.run_ranks(body, 2, device="cuda")

    a, b = step()
    same = all(torch.equal(x, y) for x, y in zip(tree.tree_leaves(a),
                                                  tree.tree_leaves(b)))
    del a, b
    t = [sync_ms(step)[0] for _ in range(2)]
    print(f"  fused DP=2 step with compression='bf16' (4 MiB buckets): "
          f"{[round(x, 1) for x in t]} ms; ranks identical {same}; exact "
          f"(phase 18) {fused['ms']['fused']:.1f} ms, q8 (phase 19) "
          f"{q8f['4MiB']['ms']:.1f} ms")
    check(same, "the fused bf16 DP=2 step's ranks differ")
    return min(t)


def synthetic_images(n, hw, classes, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, hw, hw, 3), generator=g, device="cuda").to(dtype)
    y = torch.randint(0, classes, (n,), generator=g, device="cuda")
    return x, y


def step_grads(tree, p0, p1, lr=GRAD_LR):
    """The gradient one SGD step applied: (p0 - p1) / lr in float64."""
    return tree.tree_map(lambda a, b: (a.double() - b.double()) / lr,
                         p0, p1)


def tree_rel(tree, a, b):
    """||a - b|| / ||b|| over all the leaves of two trees together."""
    num = sum(((x.double() - y.double()) ** 2).sum().item()
              for x, y in zip(tree.tree_leaves(a), tree.tree_leaves(b)))
    den = sum((y.double() ** 2).sum().item() for y in tree.tree_leaves(b))
    return (num / max(den, 1e-300)) ** 0.5


def resnet_phase(P, R, data, tree):
    """Phase 29: BASELINE config 4, ResNet-18 DP=2 at batch 128 per rank,
    f32, fed by shard_batches_comm and prefetch_to_device."""
    cfg = R.ResNetConfig()
    n, bs = 2, RESNET_BATCH
    # One global batch, revisited each epoch under the (seed, epoch)
    # permutation, as the JAX package's ResNet example does, so the loss
    # of a training run falls.
    g = torch.Generator().manual_seed(4)
    images = torch.randn((n * bs, RESNET_HW, RESNET_HW, 3),
                         generator=g).numpy()
    labels = torch.randint(0, cfg.num_classes, (images.shape[0],),
                           generator=g).numpy()
    params, state = R.init_resnet(0, cfg, device="cuda")
    n_params = sum(t.numel() for t in tree.tree_leaves(params))

    def run(recipe, lr, steps, times=None):
        def body(rank):
            comm = P.COMM_WORLD
            p, s, losses = params, state, []
            batches = data.prefetch_to_device(
                (b for epoch in range(steps) for b in data.shard_batches_comm(
                    (images, labels), bs, comm, seed=7, epoch=epoch)),
                device="cuda")
            for batch in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, p, s = recipe(comm, cfg, p, s, batch, lr=lr)
                torch.cuda.synchronize()
                if rank == 0 and times is not None:
                    times.append((time.perf_counter() - t0) * 1e3)
                losses.append(loss.item())
            return p, s, losses
        return P.run_ranks(body, n, device="cuda")

    # The gradient each recipe applies, against the mean of the one-device
    # per-shard gradients (BN normalises each shard with its own stats).
    grads = {}
    for name in ("dp_grad_train_step", "dp_loss_train_step"):
        outs = run(getattr(R, name), GRAD_LR, 1)
        grads[name] = step_grads(tree, params, outs[0][0])
        del outs
    shard = []
    for r in range(n):
        x, y = next(data.shard_batches((images, labels), bs, rank=r, size=n,
                                       seed=7))
        batch = (torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
        _, gr = tree.value_and_grad(
            lambda p: R.local_loss(cfg, p, state, batch)[0], params)
        shard.append(gr)
    mean = tree.tree_map(lambda a, b: (a.double() + b.double()) / 2, *shard)
    rel_recipes = tree_rel(tree, grads["dp_loss_train_step"],
                           grads["dp_grad_train_step"])
    rel_mean = tree_rel(tree, grads["dp_grad_train_step"], mean)
    ok = rel_recipes <= RESNET_REL and rel_mean <= RESNET_REL
    print(f"  ResNet-18 (CIFAR widths {cfg.widths}, {n_params / 1e6:.2f}M "
          f"parameters, f32), DP=2 x batch {bs} of {RESNET_HW} x "
          f"{RESNET_HW} x 3: the recipes' gradients differ by "
          f"{rel_recipes:.2e}"
          f" norm-relative; the DP gradient vs the mean of one-device "
          f"per-shard gradients {rel_mean:.2e} (bound {RESNET_REL:g})  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "ResNet-18 DP=2 gradients disagree")
    del grads, shard, mean
    out = {}
    for name in ("dp_grad_train_step", "dp_loss_train_step"):
        times = []
        torch.cuda.reset_peak_memory_stats()
        (p0, s0, l0), (p1, s1, l1) = run(getattr(R, name), RESNET_LR,
                                         RESNET_STEPS, times)
        peak = torch.cuda.max_memory_allocated() / 2**30
        same = l0 == l1 and all(torch.equal(a, b) for a, b in zip(
            tree.tree_leaves((p0, s0)), tree.tree_leaves((p1, s1))))
        falls = all(np.isfinite(l0)) and l0[-1] < l0[0]
        ms = float(np.mean(times[1:]))
        wall, busy, _ = device_busy_ms(lambda: run(getattr(R, name),
                                                   RESNET_LR, 1))
        ok = same and falls
        print(f"  {name}: losses {[round(x, 4) for x in l0]} (falls "
              f"{falls}); ranks bitwise "
              f"identical (params, BN state, losses) {same}; step "
              f"{[round(x, 1) for x in times]} ms, {2 * bs / (ms / 1e3):.0f} "
              f"images/s; a profiled step: wall {wall:.1f} ms, device busy "
              f"{busy:.1f} ms (idle {100 - 100 * busy / wall:.0f}%); peak "
              f"memory {peak:.2f} GiB  {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"ResNet-18 DP=2 {name} failed a check")
        out[name] = {"ms": ms, "images_s": 2 * bs / (ms / 1e3),
                     "idle_pct": 100 - 100 * busy / wall, "peak_gib": peak,
                     "losses": l0}
        del p0, s0, p1, s1
    torch.cuda.empty_cache()
    return out


def vit_ce(logits, labels):
    logp = torch.nn.functional.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None])[:, 0].mean()


def vit_checks(P, V, tree, kernels, cfg, params, images, labels, tol,
               label):
    """DP=2 (dp_grad_train_step) and patch-parallel SP=2 against one
    device: the DP gradient against the global batch's, the SP logits and
    gradients against the whole sequence's, per leaf within ``tol``;
    ranks identical.  Returns the launch counts of the DP and SP runs."""
    n = 2
    bs = images.shape[0] // n

    def dp(rank):
        batch = (images[rank * bs:(rank + 1) * bs],
                 labels[rank * bs:(rank + 1) * bs])
        return V.dp_grad_train_step(P.COMM_WORLD, cfg, params, batch,
                                    lr=GRAD_LR)[1]

    kernels.reset_launch_counts()
    p_a, p_b = P.run_ranks(dp, n, device="cuda")
    dp_launches = dict(kernels.launch_counts)
    same = all(torch.equal(a, b) for a, b in zip(tree.tree_leaves(p_a),
                                                  tree.tree_leaves(p_b)))
    g_dp = step_grads(tree, params, p_a)
    del p_a, p_b
    _, g_one = tree.value_and_grad(
        lambda p: V.local_loss(cfg, p, (images, labels)), params)
    rel_dp = norm_rel(tree, g_dp, g_one)
    del g_dp, g_one
    # Patch-parallel: the first bs images, their patch axis halved.
    x, y = images[:bs], labels[:bs]
    patches = V.patchify(cfg, x)
    sl = cfg.n_patches // n

    def sp(rank):
        local = patches[:, rank * sl:(rank + 1) * sl]
        logits = {}

        def loss(p):
            logits["out"] = V.forward_patches(cfg, p, local,
                                              comm_sp=P.COMM_WORLD)
            return vit_ce(logits["out"], y)

        _, g = tree.value_and_grad(loss, params)
        out = logits["out"].detach()
        # Both ranks seed the replicated loss: the parameter Allreduce
        # sums two copies of the gradient.
        g = tree.tree_map(
            lambda t: P.COMM_WORLD.Allreduce(t, P.MPI_SUM) / n, g)
        return out, g

    kernels.reset_launch_counts()
    (o_a, g_a), (o_b, g_b) = P.run_ranks(sp, n, device="cuda")
    sp_launches = dict(kernels.launch_counts)
    same = same and torch.equal(o_a, o_b) and all(
        torch.equal(a, b) for a, b in zip(tree.tree_leaves(g_a),
                                          tree.tree_leaves(g_b)))
    one = V.forward(cfg, params, x).detach()
    _, g_one = tree.value_and_grad(
        lambda p: vit_ce(V.forward(cfg, p, x), y), params)
    rel_o = norm_rel(tree, [o_a], [one])
    rel_sp = norm_rel(tree, g_a, g_one)
    ok = same and max(rel_dp, rel_o, rel_sp) <= tol
    print(f"  {label}: DP=2 gradient vs one device (batch {2 * bs}) worst "
          f"leaf {rel_dp:.2e}; patch-parallel SP=2 ({sl} patches a rank) "
          f"logits {rel_o:.2e}, gradient worst leaf {rel_sp:.2e} (bound "
          f"{tol:g}); ranks bitwise identical {same}  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"ViT {label} disagrees with one device")
    return dp_launches, sp_launches


def vit_phase(P, V, kernels, tree):
    """Phase 30: ViT-B/16 in bf16, batch 64 per rank: DP=2 and
    patch-parallel SP=2 against one device, every attention launch tc at
    head dim 64; an f32 check at 2 layers; step ms, images/s and each
    rank's attention device ms."""
    f32_cfg = V.ViTConfig(**dict(VIT_B16, n_layers=2))
    f32_params = V.init_vit(1, f32_cfg, torch.float32, device="cuda")
    x32, y32 = synthetic_images(2 * VIT_F32_BATCH, f32_cfg.image_hw,
                                f32_cfg.num_classes, torch.float32, seed=31)
    vit_checks(P, V, tree, kernels, f32_cfg, f32_params, x32, y32,
               F32_GRAD_REL, "f32, 2 layers (simt kernels)")
    del f32_params, x32, y32
    cfg = V.ViTConfig(**VIT_B16)
    params = V.init_vit(0, cfg, torch.bfloat16, device="cuda")
    n_params = sum(t.numel() for t in tree.tree_leaves(params))
    images, labels = synthetic_images(2 * VIT_BATCH, cfg.image_hw,
                                      cfg.num_classes, torch.bfloat16,
                                      seed=32)
    dp_l, sp_l = vit_checks(P, V, tree, kernels, cfg, params, images,
                            labels, BF16_GRAD_REL,
                            f"bf16, ViT-B/16 ({n_params / 1e6:.1f}M "
                            "parameters)")
    layers = cfg.n_layers
    want = {"dp": 2 * layers, "sp": 2 * 2 * layers}
    counts = {"dp": {k: dp_l[k] for k in kernels.ATTENTION_KERNELS},
              "sp": {k: sp_l[k] for k in kernels.ATTENTION_KERNELS}}
    ok = attention_all_tc(kernels, dp_l) and attention_all_tc(kernels, sp_l) \
        and all(v == want[run] for run in counts
                for v in counts[run].values())
    print(f"  attention launches (K2, K3, K4): DP=2 step {counts['dp']} "
          f"(expected 2 ranks x {layers} layers each), SP=2 fwd+bwd "
          f"{counts['sp']} (2 ranks x {layers} layers x 2 ring blocks); "
          f"all tc at head dim {cfg.d_model // cfg.n_heads}  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "a ViT attention launch was not tc, or the counts differ")

    def step():
        def body(rank):
            batch = (images[rank * VIT_BATCH:(rank + 1) * VIT_BATCH],
                     labels[rank * VIT_BATCH:(rank + 1) * VIT_BATCH])
            return V.dp_grad_train_step(P.COMM_WORLD, cfg, params, batch,
                                        lr=VIT_LR)[0]
        return P.run_ranks(body, 2, device="cuda")

    step()
    torch.cuda.reset_peak_memory_stats()
    t = [sync_ms(step)[0] for _ in range(3)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = min(t)
    wall, busy, per_rank = profiled_rank_ms(P, kernels, step,
                                            "one ViT-B/16 DP=2 step", 2)
    print(f"  ViT-B/16 DP=2 step {[round(x, 1) for x in t]} ms, "
          f"{2 * VIT_BATCH / (ms / 1e3):.0f} images/s; peak memory "
          f"{peak:.2f} GiB", flush=True)
    del images, labels, params
    torch.cuda.empty_cache()
    return {"ms": ms, "images_s": 2 * VIT_BATCH / (ms / 1e3),
            "idle_pct": 100 - 100 * busy / wall, "rank_attention_ms":
            per_rank, "launches": counts, "peak_gib": peak}


class _Held:
    """A saved tensor held for a :class:`StashMeter`, released with the
    autograd graph that holds it."""

    __slots__ = ("t", "meter", "key")

    def __init__(self, t, meter, key):
        self.t, self.meter, self.key = t, meter, key

    def __del__(self):
        self.meter._release(self.key)


class StashMeter:
    """While entered on a rank thread, the bytes of the tensors that
    thread's autograd graphs hold for their backward (each storage counted
    once), and their peak: the activation stash of a pipeline stage.
    ``saved_tensors_hooks`` are thread-local, so each rank thread meters
    its own graphs."""

    def __init__(self):
        self.live = self.peak = 0
        self._refs = {}

    def _pack(self, t):
        st = t.untyped_storage()
        key = (st.data_ptr(), str(t.device), st.nbytes())
        if key not in self._refs:
            self._refs[key] = 0
            self.live += key[2]
            self.peak = max(self.peak, self.live)
        self._refs[key] += 1
        return _Held(t, self, key)

    def _release(self, key):
        self._refs[key] -= 1
        if self._refs[key] == 0:
            del self._refs[key]
            self.live -= key[2]

    def __enter__(self):
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda held: held.t)
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        return self._hooks.__exit__(*exc)


def pp_cuts(layers):
    """The layer ranges of the interleaved schedule's four global stages
    (2 chunks on each of 2 ranks; stage s on rank s % 2); a stage may hold
    no layer."""
    h, q = layers // 2, layers // 4
    return [(0, q), (q, h), (h, h + q), (h + q, layers)]


def pp_stage(params, lo, hi, first, last):
    stage = {"blocks": params["blocks"][lo:hi]}
    if first:
        stage["embed"], stage["pos"] = params["embed"], params["pos"]
    if last:
        stage["ln_f"], stage["unembed"] = params["ln_f"], params["unembed"]
    return stage


def pp_program(T, flash, cfg):
    """The user program of the PP phase: a stage applies the embedding if
    it holds it, its transformer blocks (K2 forward, K3/K4 backward), and
    the final norm and unembedding if it holds them; the loss is the
    microbatch's mean next-token cross entropy as ``lm_loss`` computes it
    (the last position masked)."""
    F = torch.nn.functional

    def apply_stage(p, x):
        if "embed" in p:
            x = F.embedding(x, p["embed"]) + p["pos"][None, :x.shape[1]]
        for blk in p["blocks"]:
            y = T._norm(cfg, x, blk["ln1"])
            q, k, v = T._split_qkv(cfg, blk, y)
            o = flash.flash_attention(q, k, v, causal=True)
            x = x + o.reshape(x.shape) @ blk["wo"]
            x, _ = T._ffn_residual(cfg, blk, x)
        if "unembed" in p:
            x = T._norm(cfg, x, p["ln_f"]) @ p["unembed"]
        return x

    def loss_fn_for(mbs):
        def loss_fn(logits, i):
            tok = mbs[i]
            b, s = tok.shape
            labels = torch.cat([tok[:, 1:], tok[:, :1]], dim=1)
            mask = (torch.arange(s, device=tok.device) < s - 1).to(
                logits.dtype)
            logp = F.log_softmax(logits, dim=-1)
            ce = -logp.gather(-1, labels[..., None])[..., 0]
            return torch.sum(ce * mask[None, :]) / (b * (s - 1))
        return loss_fn

    return apply_stage, loss_fn_for


def pp_runs(P, pp, kernels, apply_stage, loss_fn, params, cfg, mbs,
            schedules, timed=False):
    """Each schedule's (loss, per-rank grads, launches, rank stash peaks,
    device peak GiB, ms) on two rank threads."""
    layers = cfg.n_layers
    gpipe_stages = [pp_stage(params, 0, layers // 2, True, False),
                    pp_stage(params, layers // 2, layers, False, True)]
    cuts = pp_cuts(layers)
    chunks = [[pp_stage(params, *cuts[c * 2 + r], c * 2 + r == 0,
                        c * 2 + r == 3) for c in range(2)]
              for r in range(2)]
    like = torch.zeros((mbs[0].shape[0], mbs[0].shape[1], cfg.d_model),
                       dtype=params["embed"].dtype, device="cuda")
    fns = {"gpipe": (pp.pipeline_step, {}),
           "1f1b": (pp.pipeline_step_1f1b, {}),
           "1f1b_overlap": (pp.pipeline_step_1f1b, {"overlap": True}),
           "interleaved": (pp.pipeline_step_interleaved, {})}
    out = {}
    for name in schedules:
        fn, kw = fns[name]
        meters = [StashMeter(), StashMeter()]

        def body(rank):
            mine = chunks[rank] if name == "interleaved" \
                else gpipe_stages[rank]
            with meters[rank]:
                return fn(P.COMM_WORLD, apply_stage, mine, mbs, loss_fn,
                          recv_like=like, **kw)

        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        (l0, g0), (l1, g1) = P.run_ranks(body, 2, device="cuda")
        launches = dict(kernels.launch_counts)
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = None
        if timed:
            ms = min(sync_ms(lambda: P.run_ranks(
                lambda r: fn(P.COMM_WORLD, apply_stage, chunks[r]
                             if name == "interleaved" else gpipe_stages[r],
                             mbs, loss_fn, recv_like=like, **kw), 2,
                device="cuda"))[0] for _ in range(2))
        check(torch.equal(l0, l1), f"PP {name}: the ranks' losses differ")
        out[name] = {"loss": l0, "grads": (g0, g1), "launches": launches,
                     "stash": [m.peak for m in meters], "peak_gib": peak,
                     "ms": ms}
    return out


def pp_compare(tree, name, run, oracle, cfg):
    """Worst leaf's norm-relative error of a schedule's stage gradients
    against the one-device gradient."""
    layers = cfg.n_layers
    g0, g1 = run["grads"]
    pairs = []
    if name == "interleaved":
        for s, (lo, hi) in enumerate(pp_cuts(layers)):
            g = (g0, g1)[s % 2][s // 2]
            pairs += list(zip(g["blocks"], oracle["blocks"][lo:hi]))
            for k in ("embed", "pos", "ln_f", "unembed"):
                if k in g:
                    pairs.append((g[k], oracle[k]))
    else:
        h = layers // 2
        pairs += list(zip(g0["blocks"], oracle["blocks"][:h]))
        pairs += list(zip(g1["blocks"], oracle["blocks"][h:]))
        pairs += [(g0["embed"], oracle["embed"]), (g0["pos"], oracle["pos"]),
                  (g1["ln_f"], oracle["ln_f"]),
                  (g1["unembed"], oracle["unembed"])]
    n_oracle = len(tree.tree_leaves(oracle))
    got = [a for a, _ in pairs]
    check(len(tree.tree_leaves(got)) == n_oracle,
          f"PP {name}: the stages do not cover the model")
    return norm_rel(tree, got, [b for _, b in pairs])


def pp_phase(P, T, pp, kernels, flash, tree, cfg, params, tokens):
    """Phase 31: PP=2 on the flagship at full width (stage 0 the embedding
    and layers 0-3, stage 1 layers 4-7, the final norm, the unembedding and
    the loss), 4 microbatches of 2 x 2048 through GPipe, 1F1B (blocking
    and overlap=True) and the interleaved schedule (2 chunks of 2 layers a
    rank): stage gradients against one device (f32 at 2 layers within
    1e-4, bf16 within 5e-2), 1F1B blocking and overlapped bitwise, rank
    0's 1F1B stash no larger than GPipe's, every attention launch tc."""
    # f32 at 2 layers, microbatches of 1 x 512 (the simt kernels).
    cfg2 = T.TransformerConfig(vocab=cfg.vocab, d_model=cfg.d_model,
                               n_heads=cfg.n_heads, n_layers=2,
                               d_ff=cfg.d_ff, max_seq=cfg.max_seq)
    p2 = T.init_transformer(2, cfg2, torch.float32, device="cuda")
    mbs2 = [tokens[i:i + 1, :PP_F32_SEQ] for i in range(PP_MB)]
    apply_stage, loss_fn_for = pp_program(T, flash, cfg2)
    loss_fn = loss_fn_for(mbs2)
    o_loss, oracle = tree.value_and_grad(
        lambda p: sum(T.lm_loss(cfg2, p, mb) for mb in mbs2), p2)
    runs = pp_runs(P, pp, kernels, apply_stage, loss_fn, p2, cfg2,
                   mbs2, ("gpipe", "1f1b", "1f1b_overlap", "interleaved"))
    worst = max(pp_compare(tree, k, v, oracle, cfg2)
                for k, v in runs.items())
    bitwise = torch.equal(runs["1f1b"]["loss"], runs["1f1b_overlap"]["loss"]) \
        and all(torch.equal(a, b) for a, b in zip(
            tree.tree_leaves(runs["1f1b"]["grads"]),
            tree.tree_leaves(runs["1f1b_overlap"]["grads"])))
    loss_rel = max(abs(v["loss"].item() - o_loss.item()) / abs(o_loss.item())
                   for v in runs.values())
    ok = worst <= F32_GRAD_REL and loss_rel <= F32_GRAD_REL and bitwise
    print(f"  f32, 2 layers, {PP_MB} microbatches of 1 x {PP_F32_SEQ}: "
          f"stage gradients vs one device worst leaf {worst:.2e} (bound "
          f"{F32_GRAD_REL:g}), loss {loss_rel:.2e}; 1F1B blocking == "
          f"overlap=True bitwise {bitwise}  {'ok' if ok else 'FAIL'}",
          flush=True)
    check(ok, "PP f32 check failed")
    del p2, oracle, runs
    torch.cuda.empty_cache()

    # bf16 at full width.
    mbs = [tokens[i * PP_ROWS:(i + 1) * PP_ROWS] for i in range(PP_MB)]
    apply_stage, loss_fn_for = pp_program(T, flash, cfg)
    loss_fn = loss_fn_for(mbs)
    torch.cuda.reset_peak_memory_stats()
    o_loss, oracle = tree.value_and_grad(
        lambda p: sum(T.lm_loss(cfg, p, mb) for mb in mbs), params)
    one_peak = torch.cuda.max_memory_allocated() / 2**30
    runs = pp_runs(P, pp, kernels, apply_stage, loss_fn, params, cfg,
                   mbs, ("gpipe", "1f1b", "1f1b_overlap", "interleaved"),
                   timed=True)
    errs = {k: pp_compare(tree, k, v, oracle, cfg)
            for k, v in runs.items()}
    del oracle
    bitwise = torch.equal(runs["1f1b"]["loss"], runs["1f1b_overlap"]["loss"]) \
        and all(torch.equal(a, b) for a, b in zip(
            tree.tree_leaves(runs["1f1b"]["grads"]),
            tree.tree_leaves(runs["1f1b_overlap"]["grads"])))
    want = cfg.n_layers * PP_MB
    launches = {k: {n: v["launches"][n] for n in kernels.ATTENTION_KERNELS}
                for k, v in runs.items()}
    tc = all(attention_all_tc(kernels, v["launches"]) for v in runs.values())
    counted = all(x == want for v in launches.values() for x in v.values())
    stash_ok = runs["1f1b"]["stash"][0] <= runs["gpipe"]["stash"][0]
    ok = max(errs.values()) <= BF16_GRAD_REL and bitwise and tc and \
        counted and stash_ok
    for k, v in runs.items():
        print(f"  bf16 {k:12s}: loss {v['loss'].item():.4f} (one device "
              f"{o_loss.item():.4f}); stage gradients vs one device worst "
              f"leaf {errs[k]:.2e} (bound {BF16_GRAD_REL:g}); step "
              f"{v['ms']:.1f} ms; K2/K3/K4 launches {launches[k]} "
              f"(expected {cfg.n_layers} layers x {PP_MB} microbatches "
              f"each); saved activations per rank peak "
              f"{[round(x / 2**30, 2) for x in v['stash']]} GiB; device "
              f"peak {v['peak_gib']:.2f} GiB", flush=True)
    print(f"  one-device oracle (the summed microbatch losses) peak "
          f"{one_peak:.2f} GiB; 1F1B blocking == overlap=True bitwise "
          f"{bitwise}; all attention launches tc {tc}; rank 0's 1F1B "
          f"stash <= GPipe's {stash_ok}  {'ok' if ok else 'FAIL'}",
          flush=True)
    check(ok, "PP bf16 check failed")
    stages = [pp_stage(params, 0, cfg.n_layers // 2, True, False),
              pp_stage(params, cfg.n_layers // 2, cfg.n_layers, False, True)]
    like = torch.zeros((PP_ROWS, mbs[0].shape[1], cfg.d_model),
                       dtype=params["embed"].dtype, device="cuda")
    wall, busy, per_rank = profiled_rank_ms(
        P, kernels, lambda: P.run_ranks(lambda r: pp.pipeline_step_1f1b(
            P.COMM_WORLD, apply_stage, stages[r], mbs, loss_fn,
            recv_like=like), 2, device="cuda"), "one 1F1B PP=2 step", 2)
    out = {k: {"ms": v["ms"], "launches": launches[k],
               "stash_gib": [x / 2**30 for x in v["stash"]],
               "peak_gib": v["peak_gib"], "grad_rel": errs[k]}
           for k, v in runs.items()}
    out["1f1b"]["rank_attention_ms"] = per_rank
    out["1f1b"]["idle_pct"] = 100 - 100 * busy / wall
    del runs
    torch.cuda.empty_cache()
    return out


def attention_kernel_numbers(flash, kernels, shapes, seed0):
    """K2, K3 and K4 at ``shapes`` ((name, b, sq, sk, h, d, q_off, kv_off,
    causal, lib)), bf16: each held against its plain version with a live
    dlse; device ms beside the bound (a wholly masked block's: the bytes
    it must write, and for K2 read q), the plain version's ms and SDPA's
    where one call computes the block.  Returns name -> numbers, and the
    largest |kernel - plain| of each kernel."""
    dt = torch.bfloat16
    res, worst = {}, {k: 0.0 for k in kernels.ATTENTION_KERNELS}
    for i, (name, b, sq, sk, h, d, q_off, kv_off, causal, lib) in \
            enumerate(shapes):
        q, k, v = attention_inputs(dt, b, sq, sk, h, h, d, seed=seed0 + i)
        do = attention_inputs(dt, b, sq, sk, h, h, d,
                              seed=seed0 + 100 + i)[0]
        g = torch.Generator(device="cuda").manual_seed(seed0 + 200 + i)
        dlse = torch.randn((b, sq, h), generator=g, device="cuda")
        qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
        ko = torch.tensor(kv_off, dtype=torch.int32, device="cuda")
        out, lse = kernels.flash_fwd(q, k, v, q_off, kv_off, causal)
        dd = (do.float() * out.float()).sum(-1) - dlse
        got = [kernels.flash_bwd_dq(q, k, v, do, lse, dd, q_off, kv_off,
                                    causal),
               *kernels.flash_bwd_dkv(q, k, v, do, lse, dd, q_off, kv_off,
                                      causal)]
        p_out, p_lse = flash._torch_block(q, k, v, qo, ko, causal)
        want = flash._torch_block_bwd(q, k, v, out, lse, do, dlse, qo, ko,
                                      causal)
        torch.cuda.synchronize()
        err_o, _, err_l, ok = forward_errors(out, lse, p_out, p_lse, dt)
        errs = []
        for a, r in zip(got, want):
            e = (a.float() - r.float()).abs().max().item()
            errs.append(e)
            ok = ok and bool(torch.isfinite(a).all()) and \
                e <= BWD_BF16_REL * max(r.float().abs().max().item(), 1e-30)
        masked = kernels.block_masked(sq, sk, q_off, kv_off, causal)
        if masked:
            ok = ok and bool((out == 0).all()) and bool(
                (lse == flash.NEG_BIG).all()) and all(
                bool((t == 0).all()) for t in got) and max(errs) == 0.0
        worst["flash_fwd"] = max(worst["flash_fwd"], err_o)
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs[0])
        worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], *errs[1:])
        del got, want, p_out, p_lse
        check(ok, f"kernel shape {name} disagrees with the plain version")

        pairs = b * h * live_pairs(sq, sk, q_off, kv_off, 0, causal)
        qb, kb, st = b * sq * h * d * 2, b * sk * h * d * 2, b * sq * h * 4
        if masked:
            bounds = {"flash_fwd": bound(0.0, 2 * qb + st, dt),
                      "flash_bwd_dq": bound(0.0, qb, dt),
                      "flash_bwd_dkv": bound(0.0, 2 * kb, dt)}
        else:
            bounds = {"flash_fwd": bound(4.0 * d * pairs,
                                         2 * qb + 2 * kb + st, dt),
                      "flash_bwd_dq": bound(6.0 * d * pairs,
                                            3 * qb + 2 * kb + 2 * st, dt),
                      "flash_bwd_dkv": bound(8.0 * d * pairs,
                                             2 * qb + 4 * kb + 2 * st, dt)}
        it = 3 if b * sq * sk > 2**27 else 10
        ms = {"flash_fwd": event_ms(lambda: kernels.flash_fwd(
            q, k, v, q_off, kv_off, causal), iters=it),
            "flash_bwd_dq": event_ms(lambda: kernels.flash_bwd_dq(
                q, k, v, do, lse, dd, q_off, kv_off, causal), iters=it),
            "flash_bwd_dkv": event_ms(lambda: kernels.flash_bwd_dkv(
                q, k, v, do, lse, dd, q_off, kv_off, causal), iters=it)}

        def plain_bwd(parts):
            return event_ms(lambda: flash._torch_block_bwd(
                q, k, v, out, lse, do, dlse, qo, ko, causal, parts=parts),
                iters=2, warmup=1)

        plain = {"flash_fwd": event_ms(lambda: flash._torch_block(
            q, k, v, qo, ko, causal), iters=2, warmup=1),
            "flash_bwd_dq": plain_bwd(("dq",)),
            "flash_bwd_dkv": plain_bwd(("dkv",))}
        lib_ms = {"flash_fwd": None, "pair": None}
        if lib is not None:
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            dot = do.transpose(1, 2)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            is_causal = lib == "causal"
            lf = event_ms(lambda: sdpa(qt, kt, vt, is_causal=is_causal),
                          iters=it)
            lfb = event_ms(lambda: torch.autograd.grad(
                sdpa(qt, kt, vt, is_causal=is_causal), (qt, kt, vt), dot),
                iters=it)
            lib_ms = {"flash_fwd": lf, "pair": lfb - lf}
            del qt, kt, vt
        res[name] = {"ms": ms, "bound_ms": {n: x[0] for n, x in
                                            bounds.items()},
                     "bound_by": {n: x[1] for n, x in bounds.items()},
                     "plain_ms": plain, "library_ms": lib_ms,
                     "max_abs_err": {"flash_fwd": err_o,
                                     "flash_bwd_dq": errs[0],
                                     "flash_bwd_dkv": max(errs[1:])}}
        pair = ms["flash_bwd_dq"] + ms["flash_bwd_dkv"]
        print(f"  {name:16s} ({b}, {sq}, {h}, {d}) "
              f"{'causal' if causal else 'non-causal'} q_off {q_off} kv_off "
              f"{kv_off}{' masked' if masked else ''}: K2 {ms['flash_fwd']:.4f}"
              f" ms (bound {bounds['flash_fwd'][0]:.4f} "
              f"{bounds['flash_fwd'][1]}, plain {plain['flash_fwd']:.3f}"
              + (f", SDPA {lib_ms['flash_fwd']:.4f}" if lib else "")
              + f"), K3 {ms['flash_bwd_dq']:.4f} (bound "
              f"{bounds['flash_bwd_dq'][0]:.4f}, plain "
              f"{plain['flash_bwd_dq']:.3f}), K4 {ms['flash_bwd_dkv']:.4f} "
              f"(bound {bounds['flash_bwd_dkv'][0]:.4f}, plain "
              f"{plain['flash_bwd_dkv']:.3f})"
              + (f", pair {pair:.4f} vs SDPA backward {lib_ms['pair']:.4f}"
                 if lib else "")
              + f"; errors out {err_o:.2e} lse {err_l:.2e} dq/dk/dv "
              + "/".join(f"{e:.2e}" for e in errs) + " with dlse live  ok",
              flush=True)
        del q, k, v, do, out, lse, dd
        torch.cuda.empty_cache()
    return res, worst


def requant_numbers(qk):
    """K1 in its hop-0 form (``requant_blocks``, the block-q8 encode of
    the compressed Allgather) at the Allgather shard's (65536, 256)
    blocks: bitwise against the plain requant, then kernel ms, bound and
    plain ms.  The operands (84 MB) exceed the 50 MB L2."""
    nb = AG_SHARD_BLOCKS
    g = torch.Generator(device="cuda").manual_seed(77)
    mine = torch.randn((nb, 256), generator=g, device="cuda")
    q, s, _ = qk.dequant_accum_requant(None, None, mine, impl="cuda")
    pq, ps, _ = qk.dequant_accum_requant(None, None, mine, impl="torch")
    mism = bits_differ(q, pq) + bits_differ(s, ps)
    check(mism == 0, "K1 requant disagrees at the Allgather shard")
    k_ms = event_ms(lambda: qk.dequant_accum_requant(None, None, mine,
                                                     impl="cuda"),
                    iters=20, warmup=3)
    p_ms = event_ms(lambda: qk.dequant_accum_requant(None, None, mine,
                                                     impl="torch"),
                    iters=5, warmup=1)
    # mine read (4 B), q' written (1 B) per element, the scale (4 B) per
    # row; |x|, max, divide, round, clamp: 5 operations per element.
    nbytes = nb * 256 * 5 + nb * 4
    b_ms, b_by = bound(5.0 * nb * 256, nbytes, torch.float32)
    print(f"  q8_requant (K1 hop 0) at the Allgather shard ({nb}, 256): "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}, {nbytes / 1e6:.1f} MB), {100 * b_ms / k_ms:.1f}% of "
          f"bound; kernel vs plain mismatched elements {mism}; no single "
          "PyTorch call computes it (library_ms null)", flush=True)
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "blocks": nb}


# ---------------------------------------------------------------------------
# Slice 11: observability (obs/) and fault tolerance (resilience/) on the
# rank-thread world.

# Where the slice writes its Chrome trace and postmortem (git-ignored).
OBS_OUT = "smoke_out"
# The flight recorder's ring per rank in phase 34.
OBS_RING = 6
# Phase 37: a delay past the world timeout, rescued by retries (windows of
# RETRY_TIMEOUT, then RETRY_BACKOFF and 2 x RETRY_BACKOFF: 2.0 s of
# patience against a 0.8 s delay); and a chronically slow rank.
RETRY_TIMEOUT, RETRY_DELAY, RETRY_BACKOFF = 0.5, 0.8, 0.5
GRAY_NUMEL, GRAY_CALLS, GRAY_SLEEP = 1 << 20, 8, 0.05
# Phase 39: the two examples on the card (float32) against their CPU runs
# (float64) from the same initial weights.  Their losses agree within
# EXAMPLE_LOSS_REL and the ZeRO parameters within EXAMPLE_PARAM_REL
# (float32 rounding over the run: on the CPU, float32 against float64
# differs by 1.5e-7 in the loss and 1.3e-6 in the parameters); the
# generated tokens are equal.
EXAMPLE_STEPS, EXAMPLE_LOSS_REL, EXAMPLE_PARAM_REL = 40, 1e-4, 1e-4


def dp2_body(P, T, cfg, params, tokens):
    """Phase 18's fused exact DP=2 step (train_step, 4 MiB buckets) as a
    rank body."""
    rows = TRAIN_BATCH // 2

    def body(rank):
        x = tokens[rank * rows:(rank + 1) * rows]
        return T.train_step(cfg, params, x, comm_dp=P.COMM_WORLD, lr=LR)
    return body


def attributed(body):
    """``body`` returning each rank's outcome instead of raising: (error
    class name or "ok", the error's ranks, seconds to the outcome)."""
    def wrapped(rank):
        t0 = time.perf_counter()
        try:
            body(rank)
        except Exception as e:  # noqa: BLE001 — the outcome under test
            return (type(e).__name__, sorted(getattr(e, "ranks", ()) or ()),
                    time.perf_counter() - t0)
        return "ok", [], time.perf_counter() - t0
    return wrapped


def host_device_waits(fn):
    """(device-to-host copies, host synchronizations) in one call of
    ``fn`` under torch.profiler: the profiler's DtoH copy records, and its
    cudaStreamSynchronize / cudaDeviceSynchronize / cudaEventSynchronize
    calls (the closing synchronize of the window included)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    d2h = sum(e.count for e in ev if "DtoH" in e.key)
    syncs = sum(e.count for e in ev if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize"))
    return d2h, syncs


def traced_dp2_phase(P, T, tree, fuse, obs, kernels, config, cfg, params,
                     tokens, smi):
    """Phase 33: the fused DP=2 step untraced and traced: loss and
    parameters bitwise equal; events per step per rank; the censused
    all-reduce payload bytes per step equal to twice the bucket bytes
    plus twice the loss (forward and backward); step ms and idle share
    off and on; host us per event; device-to-host copies and syncs of one
    profiled step off and on (equal: the tracer reads no device value); a
    Chrome trace with one track per rank.  Then one traced fused q8 step
    (K1's hops).  Returns the numbers and the traced steps' launches."""
    import os

    body = dp2_body(P, T, cfg, params, tokens)
    layout = fuse.bucket_layout(params, config.DEFAULT_BUCKET_BYTES)
    itemsize = tree.tree_leaves(params)[0].element_size()
    bucket_bytes = sum(layout.bucket_sizes) * itemsize
    (l0, p0), (l1, p1) = P.run_ranks(body, 2, device="cuda")
    kernels.reset_launch_counts()
    with obs.trace() as t:
        (m0, q0), (m1, q1) = P.run_ranks(body, 2, device="cuda")
    launches = dict(kernels.launch_counts)
    same = (torch.equal(l0, m0) and torch.equal(l1, m1)
            and leaves_equal(tree, p0, q0) and leaves_equal(tree, p1, q1))
    loss_bytes = l0.numel() * l0.element_size()
    del p0, p1, q0, q1
    per_rank = {r: t.events_for(rank=r) for r in range(2)}
    wire = {r: sum(e.payload_bytes for e in evs if e.family == "all_reduce")
            for r, evs in per_rank.items()}
    want = 2 * (bucket_bytes + loss_bytes)
    labelled = {r: [e for e in evs if e.bucket] for r, evs in
                per_rank.items()}
    fwd_bytes = {r: sum(e.payload_bytes for e in evs
                        if e.family == "all_reduce")
                 for r, evs in labelled.items()}
    print(f"  {smi}")
    print(f"  traced DP=2 step: {len(per_rank[0])} / {len(per_rank[1])} "
          f"events on rank 0 / 1 ({layout.num_buckets} buckets of "
          f"{bucket_bytes} B in all); censused all-reduce bytes per rank "
          f"{wire[0]} / {wire[1]} (2 x (bucket bytes + a {loss_bytes} B "
          f"loss) = {want}), labelled forward bucket bytes {fwd_bytes[0]} "
          f"(= {bucket_bytes}); loss and parameters bitwise the untraced "
          f"step's: {same}; attention launches all tc "
          f"{attention_all_tc(kernels, launches)}")
    check(same, "tracing changed the DP=2 step's loss or parameters")
    check(all(w == want for w in wire.values())
          and all(b == bucket_bytes for b in fwd_bytes.values()),
          "the censused payload bytes are not the bucket bytes")
    check(attention_all_tc(kernels, launches), "an attention launch of the "
          "traced step was not tc")
    os.makedirs(OBS_OUT, exist_ok=True)
    path = obs.write_chrome_trace(os.path.join(OBS_OUT, "obs_dp2.json"),
                                  t.events)
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    tracks = {(e["pid"], e["tid"]) for e in doc["traceEvents"]
              if e["ph"] == "X"}
    print(f"  Chrome trace {path}: {len(doc['traceEvents'])} records, "
          f"tracks {sorted(tracks)}")
    check(tracks == {(0, 0), (0, 1)}, "the Chrome trace lacks one track "
          "per rank")
    n_events = len(per_rank[0])
    del t

    def run(traced):
        if not traced:
            return P.run_ranks(body, 2, device="cuda")
        with obs.trace():
            return P.run_ranks(body, 2, device="cuda")

    times = {False: [], True: []}
    for traced in (False, True, True, False):
        times[traced].append(sync_ms(lambda: run(traced))[0])
    idle, waits = {}, {}
    for traced in (False, True):
        label = "on" if traced else "off"
        wall, busy, _ = device_busy_ms(lambda: run(traced))
        idle[label] = 100 - 100 * busy / wall
        waits[label] = host_device_waits(lambda: run(traced))
    # The tracer's own host cost: begin + commit of one event at the
    # bucket payload, timed on the host.
    tr = obs.CommTracer()
    world = P.runtime.World(2)
    x = tree.tree_leaves(params)[0]
    sig = ("Allreduce", P.MPI_SUM, "ring", (tuple(x.shape), str(x.dtype)))
    reps = 20000
    t0 = time.perf_counter()
    for _ in range(reps):
        tr.commit(tr.begin(world, 0, "exchange", sig, x))
    us_event = (time.perf_counter() - t0) / reps * 1e6
    off_ms, on_ms = min(times[False]), min(times[True])
    print(f"  step ms off {[round(v, 1) for v in times[False]]}, on "
          f"{[round(v, 1) for v in times[True]]} (host clock); idle share "
          f"off {idle['off']:.0f}%, on {idle['on']:.0f}%; host us per "
          f"event: begin + commit {us_event:.2f} us, step difference "
          f"{1e3 * (on_ms - off_ms) / n_events:.1f} us over {n_events} "
          f"events; device-to-host copies / syncs in one profiled step: "
          f"off {waits['off']}, on {waits['on']}")
    check(waits["on"] == waits["off"], "the tracer added device-to-host "
          "copies or syncs")

    rows = TRAIN_BATCH // 2

    def q8_body(rank):
        x = tokens[rank * rows:(rank + 1) * rows]
        _, g = tree.value_and_grad(lambda q: T.lm_loss(cfg, q, x), params)
        return P.COMM_WORLD.Allreduce_tree(g, P.MPI_SUM, mean=True,
                                           compression="q8")

    kernels.reset_launch_counts()
    with obs.trace() as tq:
        s0, s1 = P.run_ranks(q8_body, 2, device="cuda")
    q8_launches = dict(kernels.launch_counts)
    codecs = {e.codec for e in tq.events_for(rank=0)
              if e.op == "Allreduce.q8hop"}
    same_q8 = leaves_equal(tree, s0, s1)
    del s0, s1
    print(f"  traced fused q8 DP=2 step: {len(tq.events_for(rank=0))} "
          f"events on rank 0, codecs {sorted(codecs)}, q8_hop launches "
          f"{q8_launches['q8_hop']}, ranks bitwise identical {same_q8}")
    check(same_q8 and codecs == {"q8"} and q8_launches["q8_hop"] > 0,
          "the traced fused q8 step went wrong")
    return {"launches": launches, "q8_launches": q8_launches,
            "events": n_events, "ms": {"off": off_ms, "on": on_ms},
            "idle_pct": idle, "us_event": us_event, "waits": waits}


def flight_phase(P, T, obs, resilience, fuse, config, cfg, params, tokens):
    """Phase 34: rank_death on rank 1 at the middle forward bucket of the
    DP=2 step: every survivor raises RankFailedError naming rank 1 well
    within the world timeout; the postmortem's per-rank tails."""
    import os

    nb = fuse.bucket_layout(params, config.DEFAULT_BUCKET_BYTES).num_buckets
    spec = resilience.FaultSpec("rank_death", rank=1, op="Allreduce",
                                index=nb // 2)
    body = attributed(dp2_body(P, T, cfg, params, tokens))
    with obs.trace(ring=OBS_RING) as t, \
            resilience.fault_scope([spec]) as plan:
        outs = P.run_ranks(body, 2, device="cuda")
    timeout = config.world_timeout()
    pm = t.last_postmortem()
    print(f"  outcomes (error, ranks, s): {outs}; world timeout "
          f"{timeout:.0f} s; fired {sorted(plan.fired_kinds())}")
    print("\n".join("  " + line for line in
                    obs.format_postmortem(pm).splitlines()))
    obs.dump_postmortem(pm, OBS_OUT, stem="obs_rank_death")
    check(all(o[0] == "RankFailedError" and o[1] == [1] for o in outs),
          "a survivor did not raise RankFailedError naming rank 1")
    check(outs[0][2] < timeout / 10, "the survivor waited for the world "
          "timeout instead of the attributed failure")
    check(pm["failed_ranks"] == [1] and all(pm["tails"].get(r)
                                            for r in (0, 1)),
          "the postmortem lacks a rank's tail")
    return outs


def guard_phase(P, T, tree, resilience, kernels, config, cfg, params,
                tokens, smi):
    """Phase 35: the finite guard on the DP=2 step: corrupt_nan on rank 1
    under "raise" raises IntegrityError naming rank 1 on every rank;
    "warn" completes; a clean guarded step is bitwise the unguarded one.
    The guard's ms on a 4 x 2^24 float32 Allreduce and on the step."""
    import warnings

    body = dp2_body(P, T, cfg, params, tokens)
    spec = resilience.FaultSpec("corrupt_nan", rank=1, op="Allreduce")
    try:
        config.set_comm_finite_guard("raise")
        with resilience.fault_scope([spec]):
            outs = P.run_ranks(attributed(body), 2, device="cuda")
        kernels.reset_launch_counts()
        (g0, q0), (g1, q1) = P.run_ranks(body, 2, device="cuda")
        launches = dict(kernels.launch_counts)
        config.set_comm_finite_guard("warn")
        with warnings.catch_warnings(record=True) as caught, \
                resilience.fault_scope([spec]):
            warnings.simplefilter("always")
            (w0, _), _ = P.run_ranks(body, 2, device="cuda")
    finally:
        config.set_comm_finite_guard("off")
    (l0, p0), (l1, p1) = P.run_ranks(body, 2, device="cuda")
    same = (torch.equal(g0, l0) and torch.equal(g1, l1)
            and leaves_equal(tree, q0, p0) and leaves_equal(tree, q1, p1))
    del q0, q1, p0, p1
    warned = [w for w in caught
              if issubclass(w.category, resilience.IntegrityWarning)]
    print(f"  {smi}")
    print(f"  corrupt_nan on rank 1, guard raise: {outs}; guard warn: "
          f"{len(warned)} IntegrityWarnings, the step completed (loss "
          f"{w0.item():.4f}); clean guarded step bitwise the unguarded "
          f"one: {same}")
    check(all(o[0] == "IntegrityError" and o[1] == [1] for o in outs),
          "the finite guard did not raise IntegrityError naming rank 1 on "
          "every rank")
    check(len(warned) >= 2, "guard warn did not warn on every rank")
    check(same, "the guarded clean step differs from the unguarded one")
    xs = bench_inputs()

    def allreduce():
        return P.run_ranks(lambda r: P.COMM_WORLD.Allreduce(xs[r],
                                                            P.MPI_SUM),
                           BENCH_RANKS, device="cuda")

    def guarded(fn, mode):
        config.set_comm_finite_guard(mode)
        try:
            return sync_ms(fn)[0]
        finally:
            config.set_comm_finite_guard("off")

    res = {}
    for label, fn in (("allreduce", allreduce),
                      ("dp2_step", lambda: P.run_ranks(body, 2,
                                                       device="cuda"))):
        fn()
        ms = {"off": [], "raise": []}
        for mode in ("off", "raise", "raise", "off"):
            ms[mode].append(guarded(fn, mode))
        res[label] = {k: min(v) for k, v in ms.items()}
        print(f"  {label}: guard off {[round(v, 2) for v in ms['off']]} "
              f"ms, on {[round(v, 2) for v in ms['raise']]} ms (host "
              f"clock); the guard's cost "
              f"{res[label]['raise'] - res[label]['off']:.2f} ms")
    del xs
    return {"launches": launches, "ms": res}


def checksum_phase(P, resilience, kernels, config, smi):
    """Phase 36: the wire checksum on the compressed q8 and bf16 Allgather
    at phase 28's size (4 rank threads x 2^24 float32): with the checksum
    on, value and gradient bitwise the unchecked run's; a corrupted wire
    on rank 1 raises IntegrityError naming rank 1 (q8: bitflip on the
    int8 blocks; bf16, a float wire a bit-flip cannot act on: a NaN);
    with the checksum off the same fault corrupts silently.  K1's
    requant launches under the checksum."""
    xs = bench_inputs()
    print(f"  {smi}")
    res = {}
    for codec, kind in (("q8", "bitflip"), ("bf16", "corrupt_nan")):
        clean = allgather_run(P, xs, codec)

        def timed(on):
            config.set_comm_wire_checksum(on)
            try:
                return sync_ms(lambda: allgather_run(P, xs, codec))
            finally:
                config.set_comm_wire_checksum(False)

        ms, same = {False: [], True: []}, True
        for on in (False, True, True, False):
            t_ms, out = timed(on)
            ms[on].append(t_ms)
            if on:
                same = same and all(torch.equal(a, b) for o, c in
                                    zip(out, clean) for a, b in zip(o, c))
        del out
        kernels.reset_launch_counts()
        timed(True)
        requant = kernels.launch_counts["q8_requant"]
        spec = resilience.FaultSpec(kind, rank=1, op="Allgather.c")
        config.set_comm_wire_checksum(True)
        try:
            with resilience.fault_scope([spec]):
                caught = P.run_ranks(
                    attributed(lambda r: P.COMM_WORLD.Allgather(
                        xs[r], 0, compression=codec)),
                    BENCH_RANKS, device="cuda")
        finally:
            config.set_comm_wire_checksum(False)
        with resilience.fault_scope([spec]) as plan:
            silent = allgather_run(P, xs, codec)
        corrupt = sum(bits_differ(s[0], c[0]) for s, c in zip(silent,
                                                              clean))
        inert = None
        if codec == "bf16":
            with resilience.fault_scope([resilience.FaultSpec(
                    "bitflip", rank=1, op="Allgather.c")]) as bplan:
                flipped = allgather_run(P, xs, codec)
            inert = (not bplan.fired_kinds() and all(
                torch.equal(f[0], c[0]) for f, c in zip(flipped, clean)))
            del flipped
        del silent, clean
        torch.cuda.empty_cache()
        res[codec] = {"ms_off": min(ms[False]), "ms_on": min(ms[True]),
                      "requant_launches": requant}
        print(f"  {codec}: checksum on bitwise the unchecked run (value "
              f"and gradient) {same}; ms off "
              f"{[round(v, 2) for v in ms[False]]}, on "
              f"{[round(v, 2) for v in ms[True]]} (host clock); "
              f"{kind} on rank 1 with the checksum: {caught[0][:2]} on rank "
              f"0, {[c[:2] for c in caught]}; without it the fault fired "
              f"({sorted(plan.fired_kinds())}) and corrupted {corrupt} "
              f"elements silently; q8_requant launches under the checksum "
              f"{requant}"
              + ("" if inert is None else
                 f"; a bitflip on the float bf16 wire is inert: {inert}"))
        check(same, f"{codec}: the checksummed Allgather differs")
        check(all(c[0] == "IntegrityError" and c[1] == [1] for c in caught),
              f"{codec}: the checksum did not name rank 1 on every rank")
        check(corrupt > 0 and plan.fired_kinds() == {kind},
              f"{codec}: the negative control did not corrupt")
        check(codec != "q8" or requant > 0, "the checksummed q8 Allgather "
              "launched no requant kernel")
        check(inert in (None, True), "a bitflip acted on the bf16 wire")
    del xs
    torch.cuda.empty_cache()
    return res


def retry_gray_phase(P, obs, resilience, config):
    """Phase 37: a delay on rank 1 longer than the world timeout, rescued
    under comm_retries=2 (retry_events > 0, mirrored by the metric,
    results bitwise the undelayed run's); a slow_rank on rank 1 named by
    the GrayFailureDetector."""
    g = torch.Generator(device="cuda").manual_seed(9)
    xs = [torch.randn(GRAY_NUMEL, generator=g, device="cuda")
          for _ in range(BENCH_RANKS)]
    worlds = []

    def body(rank):
        worlds.append(P.runtime.current_rank_context().world)
        y = xs[rank]
        for _ in range(GRAY_CALLS):
            y = P.COMM_WORLD.Allreduce(y, P.MPI_SUM) * 0.25
        return y

    clean = P.run_ranks(body, BENCH_RANKS, device="cuda")
    obs.reset_metrics()
    worlds.clear()
    config.set_comm_retries(2)
    config.set_comm_backoff(RETRY_BACKOFF)
    try:
        with resilience.fault_scope([resilience.FaultSpec(
                "delay", rank=1, op="Allreduce", seconds=RETRY_DELAY)]):
            t0 = time.perf_counter()
            got = P.run_ranks(body, BENCH_RANKS, timeout=RETRY_TIMEOUT,
                              device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        config.set_comm_retries(0)
        config.set_comm_backoff(0.05)
    used = worlds[0].retry_events
    metric = obs.snapshot()["counters"].get("comm_retry_events_total", 0)
    same = all(torch.equal(a, b) for a, b in zip(got, clean))
    print(f"  delay {RETRY_DELAY} s on rank 1, world timeout "
          f"{RETRY_TIMEOUT} s, comm_retries 2 (backoff {RETRY_BACKOFF} s): "
          f"completed in {wall:.2f} s, retry_events {used}, metric "
          f"comm_retry_events_total {metric}, results bitwise the "
          f"undelayed run's {same}")
    check(same and used > 0 and metric == used,
          "the delayed Allreduce was not rescued by the retries")
    # Every one of rank 1's rendezvous (each Allreduce above the fold-once
    # size is two) pays the tax.
    spec = resilience.FaultSpec("slow_rank", rank=1, op="Allreduce",
                                seconds=GRAY_SLEEP, count=2 * GRAY_CALLS)
    with obs.trace() as t, resilience.fault_scope([spec]):
        P.run_ranks(body, BENCH_RANKS, device="cuda")
    rep = resilience.GrayFailureDetector(t, floor_s=0.02).check()
    print(f"  slow_rank {GRAY_SLEEP} s x {GRAY_CALLS} calls on rank 1: "
          f"{rep.summary()} (host times)")
    check(rep.slow == frozenset({1}), "the gray-failure detector did not "
          "name rank 1")
    return {"retry_events": used, "gray_slow": sorted(rep.slow)}


def traced_serving_phase(P, T, serve, obs, kernels, cfg, params, prompts,
                         tp2):
    """Phase 38: phase 5's TP=2 serving traced: tokens and first logits
    equal to the untraced run's; serve.stats() and the mpi4torch_serve_*
    Prometheus lines agree with the engines' ServeStats.snapshot()."""
    engines = []
    lock = threading.Lock()

    def rank_body():
        with torch.inference_mode():
            eng = serve.Engine(cfg, params,
                               serve.ServeConfig(slots=SLOTS,
                                                 max_new=TP2_MAX_NEW),
                               device="cuda")
            with lock:
                engines.append(eng)
            for p in prompts[:TP2_REQUESTS]:
                eng.submit(p)
            eng.run()
            res = eng.results()
            return [res[i].tolist() for i in range(TP2_REQUESTS)]

    serve.reset_stats()
    kernels.reset_launch_counts()
    with obs.trace() as t:
        streams = P.run_ranks(rank_body, 2, device="cuda")
    launches = dict(kernels.launch_counts)
    want = tp2[0][0][1]
    agg = serve.stats()
    snaps = [e.stats.snapshot() for e in engines]
    text = obs.prometheus_text()
    keys = [k for k, v in agg.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)]
    agree = all(agg[k] == sum(s[k] for s in snaps)
                for k in keys if k not in ("n_engines", "occupancy"))
    lines = all(f"mpi4torch_serve_{k} {agg[k]:g}" in text for k in keys)
    labels = sorted({e.bucket.split(".")[1] for e in t.events
                     if e.bucket})
    print(f"  traced TP=2 serving: tokens equal to phase 5's untraced run "
          f"{streams[0] == want and streams[1] == want}; "
          f"{len(t.events_for(rank=0))} events on rank 0 over "
          f"{snaps[0]['steps']} decode steps, labels {labels}; serve.stats() "
          f"over {agg['n_engines']} engines agrees with the snapshots "
          f"{agree}; every mpi4torch_serve_* line matches {lines}")
    check(streams[0] == want and streams[1] == want,
          "tracing changed the served tokens")
    check(agg["n_engines"] == 2 and agree and lines,
          "serve.stats() or the Prometheus lines disagree with ServeStats")
    del engines
    serve.reset_stats()
    return launches


def means_body(P, rank, device):
    """The DP mean, Allreduce_tree's mean (per leaf, fused, pipelined),
    the reduce-scatter mean and ZeRO-1 with adam, at 3 ranks (1/3 is
    inexact, so a reciprocal multiplication would show)."""
    from mpi4torch_tpu_torch import fuse
    from mpi4torch_tpu_torch.parallel import all_average_tree, zero
    from mpi4torch_tpu_torch.parallel.dp import dp_loss
    from mpi4torch_tpu_torch.utils import optim
    from mpi4torch_tpu_torch.utils.tree import tree_leaves, value_and_grad

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


def examples_means_phase(P, T, tree, kernels, kv_ex, zero_ex):
    """Phase 39: generate_kv_cache and zero_sharded_optimizer on the card
    (float32; attention on the simt kernels) against their CPU runs
    (float64), and the 3-rank means bitwise against the CPU run."""
    p64 = T.init_transformer(0, kv_ex.CFG, torch.float64, device="cpu")
    p32 = tree.tree_map(lambda t: t.to("cuda", torch.float32), p64)
    kernels.reset_launch_counts()
    ms, (loss, _, gen, want) = sync_ms(lambda: kv_ex.run(
        2, device="cuda", steps=EXAMPLE_STEPS, params=p32))
    launches = dict(kernels.launch_counts)
    c_loss, _, c_gen, _ = kv_ex.run(2, device="cpu", steps=EXAMPLE_STEPS,
                                    params=p64)
    rel = abs(loss - c_loss) / abs(c_loss)
    print(f"  generate_kv_cache, 2 ranks x {EXAMPLE_STEPS} steps: card "
          f"(f32) loss {loss:.6f}, CPU (f64) {c_loss:.6f} (rel {rel:.2e}, "
          f"tol {EXAMPLE_LOSS_REL:g}); tokens {gen.tolist()} (CPU "
          f"{c_gen.tolist()}, pattern {want.tolist()}); attention launches "
          + ", ".join(f"{k} {launches[k]} ({launches[f'{k}.simt']} simt)"
                      for k in kernels.ATTENTION_KERNELS)
          + f"; {ms:.0f} ms")
    check(rel <= EXAMPLE_LOSS_REL and np.array_equal(gen, c_gen),
          "generate_kv_cache on the card differs from its CPU run")
    check(all(launches[k] == launches[f"{k}.simt"] > 0
              for k in kernels.ATTENTION_KERNELS),
          "generate_kv_cache's f32 attention did not run on simt")
    p1, p3, _ = zero_ex.run(4, device="cuda")
    c1, c3, _ = zero_ex.run(4, device="cpu")
    worst = max(float(((a[k].double().cpu() - b[k]).abs()
                       / b[k].abs().clamp_min(1e-12)).max())
                for a, b in ((p1, c1), (p3, c3)) for k in ("w", "b"))
    print(f"  zero_sharded_optimizer, 4 ranks: ZeRO-1 and ZeRO-3 on the "
          f"card match their oracle (checked inside) and the CPU run "
          f"within {worst:.2e} (tol {EXAMPLE_PARAM_REL:g})")
    check(worst <= EXAMPLE_PARAM_REL, "zero_sharded_optimizer on the card "
          "differs from its CPU run")
    got = P.run_ranks(lambda r: means_body(P, r, torch.device("cuda")), 3,
                      device="cuda")
    cpu = P.run_ranks(lambda r: means_body(P, r, torch.device("cpu")), 3,
                      device="cpu")
    same = all(torch.equal(a.cpu(), b) and a.is_cuda
               for gr, cr in zip(got, cpu) for a, b in zip(gr, cr))
    print(f"  3-rank means (DP mean, Allreduce_tree per leaf / fused / "
          f"pipelined, reduce-scatter mean, ZeRO-1 adam): card bitwise "
          f"the CPU run {same} ({sum(len(g) for g in got)} tensors)")
    check(same, "a 3-rank mean on the card differs from the CPU run")
    return launches


# Phases 40-44: the reshard planner at full width, the ZeRO-3 -> TP
# serving handoff, checkpoint and preemption, the planned MoE rebalance,
# and the checkpoint_resume example.
RESHARD_RANKS, RESHARD_MESH = 8, (2, 4)
RESHARD_REPEATS = 3
# Phase 42 keeps its checkpoints under smoke_out/ckpt and deletes them
# after; phase 40 its migration checkpoint under smoke_out/migrate.
CKPT_KEEP = 2
# Phase 44: the example's float32 card run against its float64 CPU run.
CKPT_EXAMPLE_REL = 1e-4


def reshard_specs(rs, params, n, mesh):
    """The flagship's tree in the (n,) row layout and in the ``mesh``
    layout, by partition rules: 2-D leaves rows, then (rows, columns);
    1-D leaves (the norms) over every mesh axis."""
    src = rs.match_partition_rules(
        [(r"(^|/)ln", rs.layout((n,), 0)), (r".*", rs.layout((n,), 0, None))],
        params)
    dst = rs.match_partition_rules(
        [(r"(^|/)ln", rs.layout(mesh, (0, 1))),
         (r".*", rs.layout(mesh, 0, 1))], params)
    return src, dst


def tree_plans(rs, tree, params, src, dst, strategy):
    """Each leaf's plan; the per-rank wire bytes of the tree; its per-rank
    peak estimate (every leaf's input and output shards live, plus the
    largest step buffers of any one leaf); the step kinds per leaf rank."""
    plans = tree.tree_leaves(tree.tree_map(
        lambda x, a, b: rs.plan_reshard(a, b, x.shape, x.dtype, strategy),
        params, src, dst))
    isz = params["embed"].element_size()
    io = [(np.prod(p.in_shape) + np.prod(p.out_shape)) * isz for p in plans]
    peak = int(sum(io) + max(p.peak_bytes - b for p, b in zip(plans, io)))
    kinds = {}
    for p in plans:
        kinds.setdefault(f"{len(p.in_shape)}-D", set()).add(
            " + ".join(s.kind for s in p.steps) or "(none)")
    return plans, sum(p.wire_bytes for p in plans), peak, \
        {k: sorted(v) for k, v in kinds.items()}


def tie_rule_tokens(T, cfg, params, prompts, results, n_new):
    """Each request's tokens against generate()'s step loop under the
    near-tie rule, the first token included: equal up to the first
    difference, which must fall at a step whose top-2 logit gap is within
    TIE_TOL.  Returns (near-tie divergences, oracle near-tie steps)."""
    divergences, tie_steps = 0, 0
    for rid, prompt in enumerate(prompts):
        got = results[rid][len(prompt):].tolist()
        want, gaps, _ = oracle_stream(T, cfg, params, prompt, n_new)
        check(len(got) == n_new, f"request {rid} was cut short")
        tie_steps += sum(g <= TIE_TOL for g in gaps)
        first = next((i for i, (a, b) in enumerate(zip(got, want))
                      if a != b), None)
        if first is not None:
            check(gaps[first] <= TIE_TOL,
                  f"request {rid}: token {first} differs from generate() "
                  f"without a near tie (top-2 gap {gaps[first]:.4f} > "
                  f"{TIE_TOL})")
            divergences += 1
    return divergences, tie_steps


def rank_barrier(P):
    """A rendezvous of every rank thread (one tiny Allreduce)."""
    P.COMM_WORLD.Allreduce(torch.zeros(1, device=P.COMM_WORLD.device),
                           P.MPI_SUM)


def timed_on_rank0(P, fn, repeats=1):
    """``fn()`` on every rank, ``repeats`` times after a warm-up, each
    between a barrier and a synchronisation: (last result, rank 0's ms
    per repeat, rank 0's peak bytes above the allocation at the barrier
    over the timed repeats)."""
    out = fn()
    ms, peak = [], 0
    for _ in range(repeats):
        del out
        rank_barrier(P)
        torch.cuda.synchronize()
        if P.COMM_WORLD.rank == 0:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        rank_barrier(P)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        rank_barrier(P)
        torch.cuda.synchronize()
        if P.COMM_WORLD.rank == 0:
            peak = max(peak, torch.cuda.max_memory_allocated() - base)
    return out, ms, peak


def reshard_phase(P, T, tree, rs, config, kernels, cfg, params, smi):
    """The flagship's bf16 tree, (8,) rows -> (2, 4), on eight rank
    threads: auto and gather bitwise the sliced tree, ms, wire bytes,
    peak against the plan's estimate; the backward bitwise the reverse
    reshard; restore_resharded of the saved tree; the compressed wide hop
    on the f32 embedding."""
    import os
    import shutil

    from mpi4torch_tpu_torch.utils import restore_resharded, save_checkpoint

    n = RESHARD_RANKS
    src, dst = reshard_specs(rs, params, n, RESHARD_MESH)
    in_bytes = sum(t.numel() * t.element_size()
                   for t in tree.tree_leaves(params)) // n
    print(smi)
    numbers = {}
    for strategy in (None, "gather"):
        label = strategy or "auto"
        plans, wire, est, kinds = tree_plans(rs, tree, params, src, dst,
                                             strategy)

        def body(rank, strategy=strategy):
            c = P.COMM_WORLD
            mine = rs.shard_of(params, src, rank)
            want = rs.shard_of(params, dst, rank)
            got, ms, peak = timed_on_rank0(
                P, lambda: c.Reshard(mine, src, dst, strategy=strategy),
                RESHARD_REPEATS)
            same = leaves_equal(tree, got, want)
            del got
            # The backward: cotangents in the (2, 4) layout come back in
            # the (8,) layout, bitwise the reverse reshard of them.
            x = tree.tree_map(lambda t: t.detach().requires_grad_(), mine)
            y = c.Reshard(x, src, dst, strategy=strategy)
            w = tree.tree_map(lambda t: t.detach() * 2, y)
            g = torch.autograd.grad(tree.tree_leaves(y), tree.tree_leaves(x),
                                    tree.tree_leaves(w))
            rev = c.Reshard(w, dst, src, strategy=strategy)
            back = all(torch.equal(a, b)
                       for a, b in zip(g, tree.tree_leaves(rev)))
            return same, back, ms, peak

        torch.cuda.synchronize()
        out = P.run_ranks(body, n, timeout=300.0, device="cuda")
        same = all(o[0] for o in out)
        back = all(o[1] for o in out)
        ms, peak = out[0][2], out[0][3]
        # The transition's live set: the eight input trees (allocated
        # before the barrier) and what the call added at its peak.
        live = peak + n * in_bytes
        numbers[label] = dict(ms=ms, wire=wire, est=n * est, peak=live,
                              kinds=kinds, same=same, back=back)
        print(f"  {label}: steps per leaf {kinds}; {np.mean(ms):.1f} ms a "
              f"tree (runs {[round(x, 1) for x in ms]}); wire "
              f"{wire / 1e6:.2f} MB a rank (plan); peak live "
              f"{live / 1e9:.3f} GB on the card (inputs + the call's peak "
              f"{peak / 1e9:.3f} GB) vs 8 x the plan's per-rank peak "
              f"{n * est / 1e9:.3f} GB; bitwise the sliced tree {same}; "
              f"backward bitwise the reverse reshard {back}", flush=True)
        check(same and back, f"the {label} reshard is not bitwise the "
              "sliced tree, or its backward not the reverse reshard")
        torch.cuda.empty_cache()
    a, g = numbers["auto"], numbers["gather"]
    print(f"  auto vs gather: {np.mean(a['ms']):.1f} vs "
          f"{np.mean(g['ms']):.1f} ms, peak {a['peak'] / 1e9:.3f} vs "
          f"{g['peak'] / 1e9:.3f} GB, wire {a['wire'] / 1e6:.1f} vs "
          f"{g['wire'] / 1e6:.1f} MB a rank")
    check(a["peak"] < g["peak"], "the planned reshard peaked above gather")

    # restore_resharded: rank 0 saves the global tree; every rank restores
    # its (8,) shard and reshards it to (2, 4) on the card.
    path = os.path.join(OBS_OUT, "migrate")
    shutil.rmtree(path, ignore_errors=True)
    meta = tree.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                               device="meta"), params)

    def migrate(rank):
        c = P.COMM_WORLD
        if rank == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_checkpoint(path, params)
            save_s = time.perf_counter() - t0
        rank_barrier(P)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = restore_resharded(path, meta, dst, saved_layout=src, comm=c)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = leaves_equal(tree, got, rs.shard_of(params, dst, rank))
        return same, (save_s if rank == 0 else None), restore_s

    out = P.run_ranks(migrate, n, timeout=300.0, device="cuda")
    shutil.rmtree(path, ignore_errors=True)
    nbytes = n * in_bytes
    numbers["migrate"] = dict(save_s=out[0][1],
                              restore_s=max(o[2] for o in out))
    print(f"  restore_resharded from (8,) to (2, 4): {nbytes / 1e9:.3f} GB "
          f"saved by rank 0 in {out[0][1]:.2f} s "
          f"({nbytes / out[0][1] / 1e9:.2f} GB/s); eight ranks restored and "
          f"resharded in {numbers['migrate']['restore_s']:.2f} s; bitwise "
          f"the sliced tree {all(o[0] for o in out)}", flush=True)
    check(all(o[0] for o in out), "restore_resharded differs from the "
          "sliced tree")

    # The compressed wide hop: the f32 embedding under strategy="gather"
    # with compression="q8" rides the compressed Allgather (K1's requant
    # form), bitwise the plain recomputation of that gather.
    emb = params["embed"].float()
    l8, l24 = rs.layout((n,), 0, None), rs.layout(RESHARD_MESH, 0, 1)

    def hop(rank):
        x = rs.slice_shard(emb, l8, rank)
        return P.COMM_WORLD.Reshard(x, l8, l24, strategy="gather",
                                    compression="q8")

    kernels.reset_launch_counts()
    ms, got = sync_ms(lambda: P.run_ranks(hop, n, device="cuda"))
    requant = kernels.launch_counts["q8_requant"]
    config.set_quant_hop_impl("torch")
    try:
        kernels.reset_launch_counts()
        want = P.run_ranks(hop, n, device="cuda")
        plain_requant = kernels.launch_counts["q8_requant"]
    finally:
        config.set_quant_hop_impl("auto")
    bitwise = all(bits_differ(a, b) == 0 for a, b in zip(got, want))
    err = max((a - rs.slice_shard(emb, l24, r)).abs().max().item()
              for r, a in enumerate(got))
    numbers["wide_hop"] = dict(requant=requant, ms=ms, err=err)
    print(f"  compressed wide hop (q8, gather) on the f32 embedding "
          f"{tuple(emb.shape)}: {requant} q8_requant launches ({plain_requant}"
          f" on the plain hop), bitwise the plain recomputation {bitwise}, "
          f"max |err| vs exact {err:.3e}, {ms:.1f} ms", flush=True)
    check(requant == n and bitwise, "the compressed wide hop did not run "
          "one requant a rank, or differs from its plain recomputation")
    del emb, got, want
    torch.cuda.empty_cache()
    return numbers


def handoff_phase(P, T, tree, serve, kv, kernels, cfg, params, tokens,
                  prompts):
    """ZeRO-3 DP=2 Adam steps, admit_zero3 into TP=2 bf16 serving shards
    (bitwise shard_params_tp(zero3_params)), the handoff's ms and peak
    against the gather-everything route, then TP=2 serving on the
    admitted shards against generate() on the gathered parameters."""
    from mpi4torch_tpu_torch.parallel import zero as Z
    from mpi4torch_tpu_torch.utils import optim

    rows = TRAIN_BATCH // 2

    def train(rank):
        c = P.COMM_WORLD
        x = tokens[rank * rows:(rank + 1) * rows]
        opt = optim.adam(ADAM_LR)
        shards, st = Z.zero3_init(c, opt, params)
        for _ in range(ZERO_STEPS):
            _, shards, st = T.zero3_train_step(cfg, shards, params, x, opt,
                                               st, c)
        return shards

    kernels.reset_launch_counts()
    shards = P.run_ranks(train, 2, device="cuda")
    train_launches = dict(kernels.launch_counts)
    torch.cuda.empty_cache()

    def handoff(route):
        def body(rank):
            c = P.COMM_WORLD
            if route == "admit":
                fn = lambda: kv.admit_zero3(cfg, c, shards[rank], params,  # noqa: E731
                                            dtype=torch.bfloat16)
            else:
                fn = lambda: kv.shard_params_tp(  # noqa: E731
                    cfg, Z.zero3_params(c, shards[rank], params), c)
            out, ms, peak = timed_on_rank0(P, fn, 2)
            return out, ms, peak
        return P.run_ranks(body, 2, device="cuda")

    admitted = handoff("admit")
    gathered_route = handoff("gather")
    same = all(leaves_equal(tree, a[0], b[0])
               for a, b in zip(admitted, gathered_route))
    ms_a, ms_g = admitted[0][1], gathered_route[0][1]
    peak_a, peak_g = admitted[0][2], gathered_route[0][2]
    print(f"  admit_zero3 after {ZERO_STEPS} ZeRO-3 Adam steps: TP=2 bf16 "
          f"serving shards bitwise shard_params_tp(zero3_params) {same}; "
          f"handoff {[round(x, 1) for x in ms_a]} ms, peak {peak_a / 1e9:.3f}"
          f" GB on the card, against the gather-everything route "
          f"{[round(x, 1) for x in ms_g]} ms, peak {peak_g / 1e9:.3f} GB",
          flush=True)
    check(same, "admit_zero3 differs from shard_params_tp(zero3_params)")
    serve_shards = [a[0] for a in admitted]
    del gathered_route, admitted
    full = P.run_ranks(lambda r: Z.zero3_params(P.COMM_WORLD, shards[r],
                                                params), 2,
                       device="cuda")[0]
    del shards
    torch.cuda.empty_cache()

    def serve_body(rank):
        with torch.inference_mode():
            eng = serve.Engine(cfg, None,
                               serve.ServeConfig(slots=SLOTS,
                                                 max_new=MAX_NEW),
                               device="cuda", shards=serve_shards[rank])
            for p in prompts:
                eng.submit(p)
            eng.run()
            return eng.results()

    kernels.reset_launch_counts()
    ms, out = sync_ms(lambda: P.run_ranks(serve_body, 2, device="cuda"))
    serve_launches = dict(kernels.launch_counts)
    same_ranks = all(np.array_equal(out[0][i], out[1][i])
                     for i in range(len(prompts)))
    with torch.inference_mode():
        divergences, ties = tie_rule_tokens(T, cfg, full, prompts, out[0],
                                            MAX_NEW)
    tc = serve_launches["flash_fwd"] == serve_launches["flash_fwd.tc"] > 0
    print(f"  TP=2 Engine on the admitted shards: {len(prompts)} requests x "
          f"{MAX_NEW} tokens in {ms / 1e3:.2f} s, ranks identical "
          f"{same_ranks}; tokens vs generate() on the gathered parameters: "
          f"near-tie divergences {divergences} (oracle near-tie steps "
          f"{ties}); flash_fwd launches {serve_launches['flash_fwd']}, all "
          f"tc {tc}", flush=True)
    check(same_ranks and tc, "the TP=2 ranks disagree, or prefill left the "
          "tc kernel")
    del serve_shards, full, out
    torch.cuda.empty_cache()
    return dict(train_launches=train_launches,
                serve_launches=serve_launches, ms=ms_a, gather_ms=ms_g,
                peak=peak_a, gather_peak=peak_g)


def checkpoint_phase(P, T, tree, resilience, kernels, cfg, params, tokens,
                     smi):
    """Phase 20's replicated DP=2 Adam: rank 0 saves after steps 0, 1, 2
    (max_to_keep=2), truncate_save tears step 2's save, restore_or_init
    returns step 1 with step 2 skipped, Bcast_ to rank 1, step 2 again:
    bitwise the pre-crash step-2 state.  State bytes, save and restore
    GB/s, free disk; a template of another layout raises CommError."""
    import os
    import shutil

    from mpi4torch_tpu_torch.reshard import layout, shard_template
    from mpi4torch_tpu_torch.utils import (CheckpointManager, optim,
                                           restore_checkpoint)
    from mpi4torch_tpu_torch.utils.optim import AdamState

    workdir = os.path.join(OBS_OUT, "ckpt")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(OBS_OUT, exist_ok=True)
    free = shutil.disk_usage(OBS_OUT).free
    print(smi)
    rows = TRAIN_BATCH // 2

    def state_of(p, st):
        return {"params": p, "mu": st.mu, "nu": st.nu,
                "count": torch.tensor(st.count, device="cuda")}

    def body(rank):
        c = P.COMM_WORLD
        x = tokens[rank * rows:(rank + 1) * rows]
        opt = optim.adam(ADAM_LR)

        def step(p, st):
            _, g = tree.value_and_grad(lambda q: T.lm_loss(cfg, q, x), p)
            g = c.Allreduce_tree(g, P.MPI_SUM, mean=True)
            with torch.no_grad():
                upd, st = opt.update(g, st, p)
                return tree.tree_map(torch.add, p, upd), st

        mgr = CheckpointManager(workdir, max_to_keep=CKPT_KEEP) \
            if rank == 0 else None
        p, st = params, opt.init(params)
        save_s = []
        for s in range(3):
            p, st = step(p, st)
            if rank == 0:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mgr.save(s, state_of(p, st))
                save_s.append(time.perf_counter() - t0)
        pre = state_of(p, st)
        nbytes = sum(t.numel() * t.element_size()
                     for t in tree.tree_leaves(pre))
        del p, st
        # The crash: every rank drops its state; rank 0 resumes from disk.
        template = state_of(params, opt.init(params))
        restored, skipped, restore_s = template, None, None
        if rank == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = resilience.restore_or_init(workdir, template=template)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            restored, skipped = res.state, (res.step, res.skipped)
        restored = tree.tree_map(lambda a: c.Bcast_(a, 0), restored)
        p = restored["params"]
        st = AdamState(int(restored["count"]), restored["mu"],
                       restored["nu"])
        p, st = step(p, st)
        same = leaves_equal(tree, state_of(p, st), pre)
        guard = None
        if rank == 0:
            wrong = shard_template(template, tree.tree_map(
                lambda t: layout((2,), *((0,) + (None,) * (t.dim() - 1)))
                if t.dim() else layout((2,)), template))
            try:
                restore_checkpoint(os.path.join(workdir, "1"), wrong)
            except P.CommError as e:
                guard = "restore_resharded" in str(e)
        return same, skipped, nbytes, save_s, restore_s, guard

    spec = resilience.FaultSpec("truncate_save", rank=0, op="ckpt_save",
                                index=2)
    kernels.reset_launch_counts()
    with resilience.fault_scope([spec]) as plan:
        out = P.run_ranks(body, 2, timeout=600.0, device="cuda")
    launches = dict(kernels.launch_counts)
    kept = sorted(os.listdir(workdir))
    shutil.rmtree(workdir, ignore_errors=True)
    same, (step, skipped), nbytes, save_s, restore_s, guard = out[0]
    fired = "truncate_save" in plan.fired_kinds()
    ok = same and out[1][0] and step == 1 and \
        [s.step for s in skipped] == [2] and fired and guard
    print(f"  free disk before the phase {free / 1e9:.1f} GB; state "
          f"(params, Adam mu and nu, count) {nbytes / 1e9:.3f} GB; saves "
          f"{[round(s, 2) for s in save_s]} s ("
          f"{', '.join(f'{nbytes / s / 1e9:.2f}' for s in save_s)} GB/s); "
          f"steps on disk {kept} (max_to_keep {CKPT_KEEP}); truncate_save "
          f"fired {fired}; restore_or_init returned step {step}, skipped "
          f"{[(s.step, s.reason.split(':')[0]) for s in skipped]}, in "
          f"{restore_s:.2f} s ({nbytes / restore_s / 1e9:.2f} GB/s); step 2 "
          f"redone on both ranks bitwise the pre-crash state {same} / "
          f"{out[1][0]}; a template of another layout raised CommError "
          f"naming restore_resharded {guard}; attention launches "
          f"{launches['flash_fwd']} / {launches['flash_bwd_dq']} / "
          f"{launches['flash_bwd_dkv']}", flush=True)
    check(ok, "checkpoint and preemption: the resumed state differs, the "
          "torn step was not skipped, or the layout guard did not raise")
    torch.cuda.empty_cache()
    return dict(launches=launches, bytes=nbytes, save_s=save_s,
                restore_s=restore_s, free=free)


def moe_rebalance_phase(P, T, tree, cfg, tokens):
    """Phase 26's EP=2 MoE experts rebalanced by router load: the planned
    block permutation under auto and rounds bitwise the permuted experts;
    the gradient of the moved experts is the inverse move (the experts
    themselves, for a cotangent of the output).  Each route runs once
    untimed before its timed run."""
    import dataclasses

    from mpi4torch_tpu_torch import reshard as rs
    from mpi4torch_tpu_torch.parallel import moe

    mcfg = dataclasses.replace(cfg, n_experts=EP_EXPERTS,
                               capacity=EP_CAPACITY)
    mparams = T.init_transformer(0, mcfg, torch.bfloat16, device="cuda")
    blk0 = mparams["blocks"][0]["moe"]
    h = mparams["embed"][tokens[:EP_BATCH]].reshape(-1, cfg.d_model)
    loads = torch.bincount((h @ blk0["gate"]).argmax(-1),
                           minlength=EP_EXPERTS).tolist()
    perm = moe.balanced_assignment(loads, 2)
    epr = EP_EXPERTS // 2
    keys = ("w1", "b1", "w2", "b2")
    experts = [{k: blk["moe"][k] for k in keys} for blk in mparams["blocks"]]
    lay = rs.Layout((2,), ((0,), (), ()))
    plan = rs.plan_permutation(lay, 0, perm, experts[0]["w1"].shape,
                               torch.bfloat16)

    def body(rank):
        c = P.COMM_WORLD
        mine = tree.tree_map(
            lambda t: t[rank * epr:(rank + 1) * epr].clone(), experts)
        want = tree.tree_map(
            lambda t: t[list(perm)][rank * epr:(rank + 1) * epr], experts)
        out = {}
        for strategy in ("auto", "rounds"):
            moe.rebalance_experts(c, mine, perm, strategy=strategy)
            x = tree.tree_map(lambda t: t.detach().requires_grad_(), mine)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = moe.rebalance_experts(c, x, perm, strategy=strategy)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            g = torch.autograd.grad(tree.tree_leaves(y), tree.tree_leaves(x),
                                    [t.detach() for t in
                                     tree.tree_leaves(y)])
            out[strategy] = (
                leaves_equal(tree, y, want),
                all(torch.equal(a, b)
                    for a, b in zip(g, tree.tree_leaves(mine))), ms)
        refused = False
        try:
            moe.rebalance_experts(c, mine, perm, strategy="permute")
        except P.CommError as e:
            refused = "cannot serve" in str(e)
        return out, refused

    out = P.run_ranks(body, 2, device="cuda")
    ok = all(v[0] and v[1] for o in out for v in o[0].values()) and \
        all(o[1] for o in out)
    moved = sum(t.numel() * t.element_size()
                for t in tree.tree_leaves(experts)) // 2
    print(f"  {EP_EXPERTS} experts x {mcfg.n_layers} layers, router loads "
          f"{loads} -> assignment {perm}; auto plans {plan.strategy} "
          f"({[s.kind for s in plan.steps]}, {plan.wire_bytes / 1e6:.1f} MB "
          f"a rank of w1 on the wire); per route (bitwise the permuted "
          f"experts, gradient = the inverse move, ms on rank 0): "
          + "; ".join(f"{k} {v[0]}/{v[1]} {v[2]:.1f} ms"
                      for k, v in out[0][0].items())
          + f"; {moved / 1e9:.3f} GB of experts a rank; \"permute\" refused "
          f"(no whole-shard bijection) {all(o[1] for o in out)}",
          flush=True)
    check(ok, "a rebalance route differs from the permuted experts, or its "
          "gradient from the inverse move")
    del mparams, experts
    torch.cuda.empty_cache()
    return {k: v[2] for k, v in out[0][0].items()}


def ckpt_example_phase(ckpt_ex):
    """The checkpoint_resume example on the card (float32) against its
    CPU run (float64): within CKPT_EXAMPLE_REL; each run checks itself
    bitwise against its own uninterrupted run."""
    import os
    import shutil

    dirs = [os.path.join(OBS_OUT, f"ckpt_example_{d}")
            for d in ("card", "cpu")]
    for d in dirs:
        for p in (d, d + "_ref"):
            shutil.rmtree(p, ignore_errors=True)
    card = ckpt_ex.run(2, device="cuda", workdir=dirs[0])
    cpu = ckpt_ex.run(2, device="cpu", workdir=dirs[1])
    for d in dirs:
        for p in (d, d + "_ref"):
            shutil.rmtree(p, ignore_errors=True)
    rel = ((card[0].double().cpu() - cpu[0]).abs().max()
           / cpu[0].abs().max()).item()
    lrel = max(abs(a - b) / abs(b) for a, b in zip(card[1], cpu[1]))
    print(f"  2 ranks: resumed run bitwise its uninterrupted run on the "
          f"card and on the CPU; card params {card[0].cpu().numpy()} vs "
          f"CPU {cpu[0].numpy()}: {rel:.2e} relative, losses {lrel:.2e} "
          f"(tol {CKPT_EXAMPLE_REL:g})", flush=True)
    check(rel <= CKPT_EXAMPLE_REL and lrel <= CKPT_EXAMPLE_REL,
          "the checkpoint_resume example on the card left its CPU run")
    return rel


# ------------------------------------------------ the process transport
# Phases 45-48: run_ranks(backend="process") on the card.  Every rank
# body below is a closure of this script, shipped to the workers by value
# (transport/_ship.py); it returns what the parent checks, since each
# worker has its own launch counts, profiler and memory statistics.

PROC_RANKS = 3
PROC_NUMEL = 1 << 20            # phase 45's Allreduce bodies, float32
PROC_TREE = (3 << 20, 1 << 20, 4097)    # the fused body's leaves
PROC_BUCKET = 4 << 20
PROC_STEPS = 2                  # phase 46: a warm step, then a timed one
LAT_ITERS, LAT_RANKS = 200, (2, 4)
SPAWN_RANKS = 4
CTX_FREED_MIN = 100 << 20       # phase 47: bytes a killed worker returns


def tree_bytes_differ(tree, a, b):
    """Differing bytes between two result trees (every leaf a tensor of
    the same dtype and shape; None leaves must match); -1 on a structure
    or dtype mismatch."""
    la, lb = tree.tree_leaves(a), tree.tree_leaves(b)
    if len(la) != len(lb):
        return -1
    n = 0
    for x, y in zip(la, lb):
        if not isinstance(x, torch.Tensor):
            if x != y:
                return -1
            continue
        if x.dtype != y.dtype or x.shape != y.shape:
            return -1
        bx = x.detach().reshape(-1).contiguous()
        by = y.detach().reshape(-1).contiguous().to(bx.device)
        if bx.dtype == torch.bool:
            bx, by = bx.to(torch.uint8), by.to(torch.uint8)
        n += int((bx.view(torch.uint8) != by.view(torch.uint8)).sum())
    return n


def proc_meta(kernels, before):
    """What a rank body reports about itself: its PID, its current CUDA
    device and its process's kernel launches since ``before``."""
    return (os.getpid(), torch.cuda.current_device(),
            {k: v - before.get(k, 0)
             for k, v in kernels.launch_counts.items()})


def proc_parity_bodies(P, kernels, rs):
    """``{name: (nranks, body)}`` of phase 45: each body returns (its
    value and gradient, ``proc_meta``)."""
    comm = P.COMM_WORLD

    def seeded(rank, n, salt):
        g = torch.Generator(device="cuda").manual_seed(1000 * salt + rank)
        return torch.randn(n, generator=g, device="cuda")

    def weights(y):
        return torch.cos(torch.arange(y.numel(), device=y.device,
                                      dtype=y.dtype)).reshape(y.shape)

    def value_and_grad(x, op):
        x = x.clone().requires_grad_()
        y = op(x)
        (g,) = torch.autograd.grad(
            torch.vdot(y.reshape(-1), weights(y).reshape(-1)), x)
        return y.detach(), g

    def reported(fn):
        def body(rank):
            before = dict(kernels.launch_counts)
            out = fn(rank)
            torch.cuda.synchronize()
            return out, proc_meta(kernels, before)
        return body

    def plain(rank):
        return value_and_grad(seeded(rank, PROC_NUMEL, 1),
                              lambda x: comm.Allreduce(x, P.MPI_SUM))

    def det(rank):
        with P.config.deterministic_mode(True):
            return plain(rank)

    def fused(rank):
        leaves = {k: seeded(rank, n, 2 + i).requires_grad_()
                  for i, (k, n) in enumerate(zip("abc", PROC_TREE))}
        out = comm.Allreduce_tree(leaves, P.MPI_SUM,
                                  bucket_bytes=PROC_BUCKET)
        loss = sum(torch.vdot(out[k], weights(out[k])) for k in out)
        grads = torch.autograd.grad(loss, [leaves[k] for k in "abc"])
        return {k: v.detach() for k, v in out.items()}, grads

    def q8(rank):
        return value_and_grad(seeded(rank, PROC_NUMEL, 5), lambda x:
                              comm.Allreduce(x, P.MPI_SUM, compression="q8",
                                             algorithm="ring"))

    def p2p(rank):
        n = comm.size
        a = seeded(rank, 4096, 6).requires_grad_()
        h = comm.Isend(a, (rank + 1) % n, 0)
        buf = P.JoinDummies(torch.empty_like(a), [h.dummy])
        b = comm.Recv(buf, (rank - 1) % n, 0)
        done = comm.Wait(P.JoinDummiesHandle(h, [b]))
        res = P.JoinDummies(a + b, [done])
        (g,) = torch.autograd.grad(torch.vdot(res, weights(res)), a)
        return res.detach(), g

    src, dst = rs.layout((8,), 0, None), rs.layout((2, 4), 0, 1)
    shard = src.shard_shape((1024, 256))

    def migrate(rank):
        x = seeded(rank, shard[0] * shard[1], 7).reshape(shard)
        return value_and_grad(x, lambda v: comm.Reshard(v, src, dst))

    cases = {"plain Allreduce": (PROC_RANKS, plain),
             "deterministic mode": (PROC_RANKS, det),
             "Allreduce_tree, 4 MiB buckets": (PROC_RANKS, fused),
             "q8 Allreduce on ring": (PROC_RANKS, q8),
             "Isend/Recv/Wait ring": (PROC_RANKS, p2p),
             "(8,) -> (2, 4) reshard": (8, migrate)}
    return {k: (n, reported(fn)) for k, (n, fn) in cases.items()}


def process_parity_phase(P, tree, kernels, rs, transport, smi):
    """Phase 45: each body on CUDA rank threads and on CUDA workers:
    values and gradients bitwise alike, one process per rank (none the
    launcher), each on the world's device; K1's launches in the workers
    equal to the schedule's and to the rank threads'."""
    launcher, world_dev = os.getpid(), torch.cuda.current_device()
    out = {}
    for name, (n, body) in proc_parity_bodies(P, kernels, rs).items():
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        want = P.run_ranks(body, n, device="cuda", backend="thread")
        thread_s = time.perf_counter() - t0
        thread_launches = dict(kernels.launch_counts)
        t0 = time.perf_counter()
        got = P.run_ranks(body, n, device="cuda", backend="process")
        proc_s = time.perf_counter() - t0
        stats = transport.get_transport("process").last_stats
        differ = tree_bytes_differ(tree, [r[0] for r in want],
                                   [r[0] for r in got])
        pids = [r[1][0] for r in got]
        devs = [r[1][1] for r in got]
        launches = {k: sum(r[1][2][k] for r in got)
                    for k in ("q8_hop", "q8_requant")}
        print(f"  {name}: {n} workers, pids {pids} (launcher {launcher}), "
              f"devices {devs}; value and gradient bytes differing from "
              f"the rank threads {differ}; run {proc_s:.2f} s (threads "
              f"{thread_s:.2f} s); {stats['rendezvous']} rendezvous, "
              f"{stats['messages']} messages, payload bytes into / out of "
              f"the parent {stats['payload_bytes_in']} / "
              f"{stats['payload_bytes_out']}; K1 launches in the workers "
              f"{launches}, on the rank threads "
              f"{ {k: thread_launches[k] for k in launches} }", flush=True)
        check(differ == 0, f"{name}: the process backend is not bitwise "
              "the thread backend")
        check(len(set(pids)) == n and launcher not in pids,
              f"{name}: the ranks did not run in processes of their own")
        check(devs == [world_dev] * n,
              f"{name}: a worker ran on another device than the world's")
        if name.startswith("q8"):
            want_hops, want_req = 2 * n * (n - 1), 2 * n
            check(launches == {"q8_hop": want_hops, "q8_requant": want_req}
                  and all(thread_launches[k] == v
                          for k, v in launches.items()),
                  f"K1 launches in the workers {launches}, expected "
                  f"{want_hops} hops and {want_req} requants as on the "
                  "rank threads")
            out["q8"] = launches
        del want, got
    return out


# The tensor-core attention kernels' names in a profile, by launcher.
TC_PROFILE_NAMES = {"flash_fwd": "flash_fwd_tc_kernel",
                    "flash_bwd_dq": "flash_bwd_dq_tc_kernel",
                    "flash_bwd_dkv": "flash_bwd_dkv_tc_kernel"}


def device_busy_split(fn, kernels):
    """One call of ``fn`` under torch.profiler: (wall ms, device busy ms,
    copy ms, kernel ms, {launcher: [tc kernels the profile holds,
    launches the wrapper counted]}).  Busy is split into copies and
    memsets against kernels; the counts say whether the profile caught
    every attention launch of the call (in a worker the profiler starts
    on the rank body's thread, not the thread that made the context)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    before = dict(kernels.launch_counts)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not e.is_user_annotation and e.self_device_time_total > 0]
    copy_ms = sum(e.self_device_time_total for e in ev
                  if e.key.startswith(("Memcpy", "Memset"))) / 1e3
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    seen = {k: [sum(e.count for e in ev if name in e.key),
                kernels.launch_counts[k] - before.get(k, 0)]
            for k, name in TC_PROFILE_NAMES.items()}
    return wall_ms, busy_ms, copy_ms, busy_ms - copy_ms, seen


def proc_flagship_body(P, T, kernels, profile):
    """Phase 46's rank body: the flagship's DP=2 ``train_step`` from
    seeded parameters and tokens, a warm step then a timed one (each
    between a rendezvous and a synchronisation), then (``profile``) one
    more step profiled on rank 0.  Returns ((loss, parameters after the
    two steps), (pid, device, launches, step ms, the profiled step's
    ``device_busy_split``))."""
    def body(rank):
        cfg = flagship_config(T)
        params = T.init_transformer(0, cfg, torch.bfloat16, device="cuda")
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ))).to("cuda")
        rows = TRAIN_BATCH // 2
        x = tokens[rank * rows:(rank + 1) * rows]
        before = dict(kernels.launch_counts)
        p, ms = params, []
        del params
        for _ in range(PROC_STEPS):
            rank_barrier(P)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, p = T.train_step(cfg, p, x, comm_dp=P.COMM_WORLD, lr=LR)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        meta = proc_meta(kernels, before)
        prof = None
        if profile:
            def step():
                return T.train_step(cfg, p, x, comm_dp=P.COMM_WORLD, lr=LR)
            rank_barrier(P)
            if rank == 0:
                prof = device_busy_split(step, kernels)
            else:
                step()
            torch.cuda.synchronize()
        return (loss, p), meta + (ms, prof)
    return body


def process_flagship_phase(P, T, tree, kernels, transport, cfg, smi):
    """Phase 46: the flagship's DP=2 training on two CUDA workers, two
    steps: ranks bitwise identical and bitwise the rank threads' run of
    the same steps from the same seed; every attention launch in each
    worker ``tc``; step ms on threads and on processes, the wire bytes a
    step through the parent, the idle share of a step profiled in worker
    0."""
    runs = {}
    for backend in ("thread", "process"):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        runs[backend] = P.run_ranks(proc_flagship_body(P, T, kernels, True),
                                    2, device="cuda", backend=backend)
        runs[backend + "_s"] = time.perf_counter() - t0
        if backend == "thread":
            runs["thread_launches"] = dict(kernels.launch_counts)
        torch.cuda.empty_cache()
    stats = transport.get_transport("process").last_stats
    (th0, thm0), (th1, _) = runs["thread"]
    (pr0, prm0), (pr1, prm1) = runs["process"]
    ranks_same = tree_bytes_differ(tree, pr0, pr1)
    vs_threads = tree_bytes_differ(tree, [th0, th1], [pr0, pr1])
    want = PROC_STEPS * cfg.n_layers
    per_worker = [{k: m[2][k] for k in kernels.ATTENTION_KERNELS
                   + tuple(f"{k}.tc" for k in kernels.ATTENTION_KERNELS)}
                  for m in (prm0, prm1)]
    # The run holds PROC_STEPS + 1 steps (the profiled one last), each
    # after one one-float barrier.
    nsteps = PROC_STEPS + 1
    steps = (stats["rendezvous"] - nsteps) / nsteps
    step_bytes = (stats["payload_bytes_in"] + stats["payload_bytes_out"]) \
        / nsteps
    idle = {b: 100 * (1 - prof[1] / prof[0]) for b, prof in
            (("thread", thm0[4]), ("process", prm0[4]))}
    print(smi)
    print(f"  {PROC_STEPS} steps at batch {TRAIN_BATCH // 2} x {TRAIN_SEQ} "
          f"a rank, full width ({cfg.n_layers} layers, not cut): loss "
          f"{pr0[0].item():.4f}; workers {[prm0[0], prm1[0]]} on devices "
          f"{[prm0[1], prm1[1]]}; parameter bytes differing between the "
          f"ranks {ranks_same}, from the rank threads' run {vs_threads}; "
          f"attention launches per worker {per_worker} (expected {want} "
          f"each, all tc)")
    print(f"  step ms (warm, timed) on rank 0: threads "
          f"{[round(x, 1) for x in thm0[3]]}, processes "
          f"{[round(x, 1) for x in prm0[3]]}; a profiled step on rank 0: "
          f"threads {thm0[4][0]:.1f} ms wall, {thm0[4][1]:.1f} ms busy "
          f"(idle {idle['thread']:.0f}%), processes {prm0[4][0]:.1f} ms "
          f"wall, {prm0[4][1]:.1f} ms busy (idle {idle['process']:.0f}%); "
          f"through the parent a step: {steps:.1f} rendezvous, "
          f"{step_bytes / 1e6:.1f} MB of payload (in + out, its barrier "
          "included); whole run "
          f"threads {runs['thread_s']:.1f} s, processes "
          f"{runs['process_s']:.1f} s (spawn, CUDA contexts, seeding and "
          "the returned parameters included)", flush=True)
    for b, prof in (("threads", thm0[4]), ("processes", prm0[4])):
        print(f"  the profiled step on {b}: busy {prof[1]:.1f} ms = copies "
              f"and memsets {prof[2]:.1f} + kernels {prof[3]:.1f}; tc "
              "attention kernels in the profile / launched in its process "
              f"{prof[4]}", flush=True)
    check(ranks_same == 0, "the two DP workers disagree")
    check(vs_threads == 0,
          "the process run is not bitwise the rank threads' run")
    check(all(v == want for w in per_worker for v in w.values()),
          "a worker ran an attention launch off the tc kernels")
    launches = {k: sum(w[k] for w in per_worker)
                for k in kernels.ATTENTION_KERNELS}
    return {"launches": launches,
            "thread_ms": thm0[3][-1], "process_ms": prm0[3][-1],
            "idle_pct": idle, "step_bytes": step_bytes,
            "profile": {"thread": thm0[4], "process": prm0[4]}}


def process_signals_phase(P, transport, resilience, obs, smi):
    """Phase 47: a real SIGKILL (the ``rank_death`` cell on CUDA workers),
    a real SIGTERM, and a traced process run."""
    from mpi4torch_tpu_torch.resilience.matrix import run_cell
    from mpi4torch_tpu_torch.transport.pool import shared_pool

    def touch(rank):
        torch.ones(1 << 20, device="cuda").sum().item()
        return os.getpid()

    print(smi)
    # A pool of exactly the world's size, whose workers hold a context
    # and little else: one kill then costs one respawn, and frees about
    # a context's bytes.
    transport.shutdown()
    pids = P.run_ranks(touch, PROC_RANKS, device="cuda", backend="process")
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    rec = run_cell("rank_death", "plain", nranks=PROC_RANKS,
                   backend="process", device="cuda")
    gone = True
    try:
        os.kill(pids[1], 0)
        gone = False
    except ProcessLookupError:
        pass
    t0, gained = time.perf_counter(), 0
    while time.perf_counter() - t0 < 20.0:
        gained = torch.cuda.mem_get_info()[0] - free0
        if gained >= CTX_FREED_MIN:
            break
        time.sleep(0.1)
    back_s = time.perf_counter() - t0
    before = shared_pool().spawned_total
    P.run_ranks(touch, PROC_RANKS, device="cuda", backend="process")
    respawned = shared_pool().spawned_total - before
    print(f"  rank_death cell on CUDA workers: {rec['status']}, "
          f"{rec['detail']}, fired {rec['fired']}, backend "
          f"{rec['backend']}; rank 1's pid {pids[1]} gone: {gone}; the card "
          f"got {gained / 2**20:.0f} MiB back within {back_s:.2f} s of "
          f"the run's end; respawns on the next run "
          f"{respawned}", flush=True)
    check(rec["status"] == "ok" and rec["fired"] == ["rank_death"]
          and "rank [1]" in rec["detail"] and rec["backend"] == "process",
          f"the rank_death cell failed: {rec}")
    check(gone, "the killed worker's process is still there")
    check(gained >= CTX_FREED_MIN,
          "the killed worker's card memory did not come back")
    check(respawned == 1, f"{respawned} respawns after one kill")

    def sigterm(rank):
        if rank == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        x = torch.full((1 << 16,), float(rank + 1), device="cuda")
        return P.COMM_WORLD.Allreduce(x, P.MPI_SUM), os.getpid()

    got = P.run_ranks(sigterm, PROC_RANKS, device="cuda", backend="process")
    board = transport.external_preemptions()
    pending = resilience.pending_preemptions()
    total = float(PROC_RANKS * (PROC_RANKS + 1) // 2)
    right = all(torch.equal(y, torch.full_like(y, total)) for y, _ in got)
    alive = got[1][1] in shared_pool().pids()
    transport.clear_external_preemption(1)
    print(f"  SIGTERM to rank 1 (pid {got[1][1]}): board {board}, "
          f"pending_preemptions {pending}, values right {right}, the "
          f"worker lives on {alive}", flush=True)
    check(board.get(1) == 64 and pending.get(1) == 64 and right and alive,
          "the real SIGTERM did not reach the preemption board as a "
          "64-op notice, or the run's values are wrong")

    def traced(rank):
        x = torch.arange(4096.0, device="cuda") * (rank + 1)
        tot = P.COMM_WORLD.Allreduce(x, P.MPI_SUM)
        for _ in range(3):
            tot = P.COMM_WORLD.Allreduce(tot / PROC_RANKS, P.MPI_SUM)
        return tot

    counts = {}
    for backend in ("thread", "process"):
        with obs.trace() as t:
            P.run_ranks(traced, PROC_RANKS, device="cuda", backend=backend)
        evs = list(t.events)
        in_order = [e.seq for e in evs] == sorted(e.seq for e in evs)
        counts[backend] = ({r: len(t.events_for(rank=r))
                            for r in range(PROC_RANKS)}, in_order)
    print(f"  traced runs: events per rank (in seq order) on threads "
          f"{counts['thread']}, on processes {counts['process']}",
          flush=True)
    check(counts["process"] == counts["thread"]
          and counts["process"][1] and all(counts["process"][0].values()),
          "the traced process run's events differ from the thread run's")
    return {"freed_mib": gained / 2**20}


def process_numbers_phase(P, transport, smi):
    """Phase 48: rendezvous latency on 2 and 4 ranks, the bench-size
    Allreduce through the parent, cold spawn and warm lease seconds, and
    the card memory a worker's CUDA context takes."""
    from mpi4torch_tpu_torch.transport.pool import shared_pool

    print(smi)

    def latency(rank):
        x = torch.ones(2, device="cuda")
        for _ in range(20):
            P.COMM_WORLD.Allreduce(x, P.MPI_SUM)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LAT_ITERS):
            x = P.COMM_WORLD.Allreduce(x, P.MPI_SUM) / P.COMM_WORLD.size
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / LAT_ITERS * 1e6

    lat = {}
    for n in LAT_RANKS:
        for backend in ("thread", "process"):
            lat[(n, backend)] = P.run_ranks(latency, n, device="cuda",
                                            backend=backend)[0]
    print("  rendezvous latency (one 8-byte Allreduce, rank 0, mean of "
          f"{LAT_ITERS}, us): " + "; ".join(
              f"{n} ranks threads {lat[(n, 'thread')]:.1f}, processes "
              f"{lat[(n, 'process')]:.1f}" for n in LAT_RANKS), flush=True)

    def bench(rank):
        g = torch.Generator(device="cuda").manual_seed(5 + rank)
        x = torch.randn(BENCH_NUMEL, generator=g, device="cuda")
        P.COMM_WORLD.Allreduce(x, P.MPI_SUM)
        ms = []
        for _ in range(3):
            rank_barrier(P)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            P.COMM_WORLD.Allreduce(x, P.MPI_SUM)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return min(ms)

    bench_ms = {}
    for backend in ("thread", "process"):
        bench_ms[backend] = P.run_ranks(bench, BENCH_RANKS, device="cuda",
                                        backend=backend)[0]
    st = transport.get_transport("process").last_stats
    # Four Allreduces (a warm one and three timed), two rendezvous each
    # (the fold-once share), and three one-float barriers.
    per_ar = (st["payload_bytes_in"] + st["payload_bytes_out"]) / 4
    gbs = per_ar / (bench_ms["process"] / 1e3) / 1e9
    print(f"  Allreduce of {BENCH_RANKS} x {BENCH_NUMEL} float32 (rank 0, "
          f"best of 3): threads {bench_ms['thread']:.2f} ms, processes "
          f"{bench_ms['process']:.2f} ms; the parent moves "
          f"{per_ar / 1e9:.3f} GB of payload an Allreduce (in + out), "
          f"{gbs:.2f} GB/s", flush=True)

    transport.shutdown()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    shared_pool().lease(SPAWN_RANKS)
    spawn_s = time.perf_counter() - t0

    def touch(rank):
        torch.ones(1 << 18, device="cuda").sum().item()

    t0 = time.perf_counter()
    P.run_ranks(touch, SPAWN_RANKS, device="cuda", backend="process")
    first_s = time.perf_counter() - t0
    ctx = (free0 - torch.cuda.mem_get_info()[0]) / SPAWN_RANKS
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        P.run_ranks(touch, SPAWN_RANKS, device="cuda", backend="process")
        warm.append(time.perf_counter() - t0)
    print(f"  {SPAWN_RANKS} workers: cold spawn (interpreter and imports, "
          f"to hello) {spawn_s:.2f} s; first run (CUDA contexts) "
          f"{first_s:.2f} s; warm run {min(warm) * 1e3:.1f} ms (best of "
          f"5); card memory a worker {ctx / 2**20:.0f} MiB (its CUDA "
          "context and a 2 MiB allocator block)", flush=True)
    check(ctx > 0 and spawn_s > 0, "no worker memory or spawn time seen")
    return {"latency_us": {f"{n}_{b}": v for (n, b), v in lat.items()},
            "bench_ms": bench_ms, "parent_gb_s": gbs, "spawn_s": spawn_s,
            "first_run_s": first_s, "warm_run_ms": min(warm) * 1e3,
            "context_mib": ctx / 2**20}


MODE_A_NUMEL = 1 << 20          # phase 49: a rank's row, float32
MODE_A_WORLDS = (3, 8)
MODE_A_BENCH_NUMEL = 1 << 26    # phase 50: bench.py's Allreduce size
MODE_A_BENCH_RANKS = (2, 4)
MODE_A_STEPS = 20               # phase 50: timed steps a form
MODE_A_DP2_STEPS = 3            # phase 51
MODE_A_ALGOS = ("ring", "rhd", "tree", "hier", "bidir", "torus")


def mode_a_table(P, n):
    """``name -> op(comm, t)`` of phase 49 on an ``n``-rank axis: the
    Allreduce on every registered algorithm that serves ``n`` ranks, the op
    table of ``tests/test_torch_spmd.py`` (roots, algorithms, the
    split-phase starts) and its p2p programs (the ring's orderings, a
    longer shift, a butterfly, a reversal and a 3-cycle table, a
    self-send)."""
    S = P.MPI_SUM
    ops = {}
    for algo in algos_for(n):
        ops[f"allreduce_{algo}"] = (
            lambda a: lambda c, t: c.Allreduce(t, S, algorithm=a))(algo)

    def rows(t):
        return t[:n * (t.numel() // n)].reshape(n, -1)

    def exchange(dest, src):
        def prog(c, t):
            h = c.Isend(t, dest(c), 0)
            b = c.Recv(P.JoinDummies(torch.empty_like(t), [h.dummy]),
                       src(c), 0)
            return P.JoinDummies(b, [c.Wait(P.JoinDummiesHandle(h, [b]))])
        return prog

    def ring_isendirecv(c, t):
        # Isend, Irecv, both Waits (the first of the test's orderings).
        req = c.Isend(t, (c.rank + 1) % c.size, 0)
        req2 = c.Irecv(P.JoinDummies(torch.empty_like(t), [req.dummy]),
                       (c.rank + c.size - 1) % c.size, 0)
        res = c.Wait(P.JoinDummiesHandle(req, [req2.dummy]))
        return c.Wait(P.JoinDummiesHandle(req2, [res])) * (1.0 + c.rank)

    def ring_irecvsend(c, t):
        # Irecv, blocking Send, Wait (the third ordering).
        req = c.Irecv(P.JoinDummies(torch.empty_like(t), [t]),
                      (c.rank + c.size - 1) % c.size, 0)
        res = c.Send(t, (c.rank + 1) % c.size, 0)
        return c.Wait(P.JoinDummiesHandle(req, [res])) * (1.0 + c.rank)

    cycle = list(range(n))
    cycle[0], cycle[1], cycle[2] = 1, 2, 0        # 0->1->2->0
    cycle_src = [cycle.index(r) for r in range(n)]

    ops.update({
        "bcast_ring": lambda c, t: c.Bcast_(t, 1, algorithm="ring"),
        "bcast_tree": lambda c, t: c.Bcast_(t, n - 1, algorithm="tree"),
        "reduce_ring": lambda c, t: c.Reduce_(t, S, 1, algorithm="ring"),
        "reduce_tree": lambda c, t: c.Reduce_(t, S, 2 % n,
                                              algorithm="tree"),
        "allgather": lambda c, t: c.Allgather(t.reshape(2, -1), 1),
        "gather": lambda c, t: c.Gather(t, 0, n - 1),
        "scatter": lambda c, t: c.Scatter(rows(t), 0, 1, 1),
        "alltoall": lambda c, t: c.Alltoall(rows(t), 1, 0, 1),
        "reduce_scatter": lambda c, t: c.Reduce_scatter(rows(t), S, 0),
        "allreduce_start": lambda c, t: c.Wait(c.Allreduce_start(t, S)),
        "ring_shift": exchange(lambda c: (c.rank + 1) % c.size,
                               lambda c: (c.rank - 1) % c.size),
        "table": exchange(lambda c: [n - 1 - r for r in range(n)],
                          lambda c: [n - 1 - r for r in range(n)]),
        "ring_isendirecv": ring_isendirecv,
        "ring_irecvsend": ring_irecvsend,
        "shift_3": exchange(lambda c: (c.rank + 3) % c.size,
                            lambda c: (c.rank - 3) % c.size),
        "cycle_table": exchange(lambda c: cycle, lambda c: cycle_src),
        "self_send": exchange(lambda c: c.rank, lambda c: c.rank),
        "reduce_scatter_start": lambda c, t: c.Wait(c.Reduce_scatter_start(
            rows(t), S, 0)),
        "allgather_start": lambda c, t: c.Wait(c.Allgather_start(t, 0)),
    })
    if n % 2 == 0:
        ops["butterfly"] = exchange(lambda c: c.rank ^ 1,
                                    lambda c: c.rank ^ 1)
    return ops


def mode_a_value_and_grad(P, fn, x, seed, **kw):
    """A ``run_spmd`` call of ``fn(v)`` on the stacked rows ``x`` (moved to
    the run's device), and the gradient of ``vdot(out, w)`` taken from
    outside it, ``w`` seeded on the CPU from the output's shape: ``(out,
    grad, w)`` on the CPU."""
    f = P.run_spmd(fn, **kw)
    dev = kw["mesh"].devices.reshape(-1)[0] if "mesh" in kw \
        else P.resolve_device(kw.get("device"))
    xt = x.to(dev).requires_grad_()
    out = f(xt)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed))
    (g,) = torch.autograd.grad(
        torch.vdot(out.reshape(-1), w.to(dev).reshape(-1)), xt)
    return out.detach().cpu(), g.cpu(), w


def mode_b_value_and_grad(P, op, n, x, w):
    """The same op on the card's Mode B (``run_ranks``): per rank
    ``(out, grad of vdot(out, w[r]))`` on the CPU."""
    comm = P.COMM_WORLD

    def body(r):
        t = x[r].to("cuda").clone().requires_grad_()
        o = op(comm, t)
        (g,) = torch.autograd.grad(
            torch.vdot(o.reshape(-1), w[r].to("cuda").reshape(-1)), t)
        return o.detach().cpu(), g.cpu()

    return P.run_ranks(body, n, device="cuda")


def mode_a_ops_phase(P, tree):
    """Phase 49: on the card under deterministic mode, every op of
    :func:`mode_a_table` (and the (2, 4) mesh's tier-stack and per-axis
    ops) under ``run_spmd``, values and gradients from outside bitwise
    equal to the same body under ``run_ranks`` on the card and to the
    port's CPU Mode A run."""
    from mpi4torch_tpu_torch import config

    comm = P.COMM_WORLD
    worst = 0
    for n in MODE_A_WORLDS:
        x = torch.from_numpy(np.random.default_rng(n).standard_normal(
            (n, MODE_A_NUMEL)).astype(np.float32))
        table = mode_a_table(P, n)
        bad = []
        t0 = time.perf_counter()
        for i, (name, op) in enumerate(table.items()):
            def fn(v, op=op):
                return op(comm, v[comm.rank])
            with config.deterministic_mode(True):
                card = mode_a_value_and_grad(P, fn, x, i, nranks=n,
                                             device="cuda")
                cpu = mode_a_value_and_grad(P, fn, x, i, nranks=n,
                                            device="cpu")
            ranks = mode_b_value_and_grad(P, op, n, x, card[2])
            diff = (tree_bytes_differ(tree, card[:2], cpu[:2])
                    + sum(tree_bytes_differ(tree, (card[0][r], card[1][r]),
                                            ranks[r]) for r in range(n)))
            worst = max(worst, diff)
            if diff:
                bad.append((name, diff))
        print(f"  ({n},): {len(table)} bodies ({', '.join(table)}) in "
              f"{time.perf_counter() - t0:.1f} s; bytes differing from "
              f"run_ranks and from the CPU Mode A run: {bad or 0}",
              flush=True)
        check(not bad, f"Mode A on ({n},) differs: {bad}")
    # The (2, 4) mesh: the tier stack over both axes (hier, torus, ring)
    # against run_ranks' hier/torus with a group of 4 (under
    # deterministic mode the 2-axis ring is the grouped fold, as in the
    # JAX package), and the per-axis Allreduce and Alltoall against the
    # CPU run.
    shape = {"dp": 2, "tp": 4}
    card_mesh = P.device_mesh(shape)
    cpu_mesh = P.device_mesh(shape, devices=["cpu"] * 8)
    x = torch.from_numpy(np.random.default_rng(24).standard_normal(
        (8, MODE_A_NUMEL)).astype(np.float32))

    def mesh_ops(mesh):
        tier = P.comm_from_mesh(mesh, ("dp", "tp"))
        dp_c = P.comm_from_mesh(mesh, "dp")
        tp_c = P.comm_from_mesh(mesh, "tp")
        ops = {f"tier_{a}": (lambda a: lambda v: tier.Allreduce(
            v[tier.rank], P.MPI_SUM, algorithm=a))(a)
            for a in ("hier", "torus", "ring")}
        ops["dp_allreduce"] = lambda v: dp_c.Allreduce(
            v[dp_c.rank * 4 + tp_c.rank], P.MPI_SUM)
        ops["tp_allreduce"] = lambda v: tp_c.Allreduce(
            v[dp_c.rank * 4 + tp_c.rank], P.MPI_SUM)
        ops["tp_alltoall"] = lambda v: tp_c.Alltoall(
            v[dp_c.rank * 4 + tp_c.rank].reshape(4, -1), 1, 0, 1)
        return ops

    bad = []
    card_ops, cpu_ops = mesh_ops(card_mesh), mesh_ops(cpu_mesh)
    config.set_hier_group_size(4)
    try:
        for i, name in enumerate(card_ops):
            with config.deterministic_mode(True):
                card = mode_a_value_and_grad(P, card_ops[name], x, 100 + i,
                                             mesh=card_mesh, axis_name="dp")
                cpu = mode_a_value_and_grad(P, cpu_ops[name], x, 100 + i,
                                            mesh=cpu_mesh, axis_name="dp")
            diff = tree_bytes_differ(tree, card[:2], cpu[:2])
            if name.startswith("tier_"):
                algo = {"ring": "hier"}.get(name[5:], name[5:])
                ranks = mode_b_value_and_grad(
                    P, lambda c, t, a=algo: c.Allreduce(t, P.MPI_SUM,
                                                        algorithm=a),
                    8, x, card[2])
                diff += sum(tree_bytes_differ(
                    tree, (card[0][r], card[1][r]), ranks[r])
                    for r in range(8))
            worst = max(worst, diff)
            if diff:
                bad.append((name, diff))
    finally:
        config.set_hier_group_size(None)
    print(f"  (2, 4) mesh: {len(card_ops)} bodies ({', '.join(card_ops)}); "
          f"bytes differing: {bad or 0}")
    check(not bad, f"Mode A on the (2, 4) mesh differs: {bad}")
    return worst


def mode_a_bench_phase(P, tree, config):
    """Phase 50: bench.py's Allreduce body under ``run_spmd`` (the default
    native form and the deterministic ring fold) and under ``run_ranks``
    at 2^26 float32 a rank: bitwise alike; median ms of ``MODE_A_STEPS``
    interleaved steps, bench's GB/s accounting, rank 0's rendezvous a
    step.  Returns ``{nranks: {form: numbers}}``."""
    comm = P.COMM_WORLD

    def loss(v):
        y = comm.Allreduce(v, P.MPI_SUM)
        return torch.vdot(y, y)

    def body(v):
        return tree.value_and_grad(loss, v)

    x = torch.ones(MODE_A_BENCH_NUMEL, device="cuda")
    nbytes = x.numel() * x.element_size()
    out = {}
    for n in MODE_A_BENCH_RANKS:
        def spmd(det, n=n):
            with config.deterministic_mode(det):
                v, g = P.run_spmd(body, nranks=n)(x)
            return v, g

        def ranks(n=n):
            res = P.run_ranks(lambda: body(x), n, device="cuda")
            return (torch.stack([r[0] for r in res]),
                    torch.stack([r[1] for r in res]))

        forms = {"run_spmd": lambda: spmd(False),
                 "run_spmd_deterministic": lambda: spmd(True),
                 "run_ranks": ranks}
        ref = ranks()
        same = {k: tree_bytes_differ(tree, f(), ref) == 0
                for k, f in forms.items() if k != "run_ranks"}
        del ref
        rdv = {}
        for k, f in forms.items():
            with ExchangeCounter() as cnt:
                f()
            rdv[k] = cnt.exchanges
        times = {k: [] for k in forms}
        for _ in range(MODE_A_STEPS):
            for k, f in forms.items():
                times[k].append(sync_ms(f)[0])
        wire = 2.0 * (n - 1) / n * nbytes
        out[n] = {}
        for k in forms:
            ms = float(np.median(times[k]))
            out[n][k] = {"ms": ms, "rendezvous": rdv[k],
                         "gb_s": 2.0 * wire / (ms / 1e3) / 1e9}
            print(f"  {n} ranks {k:23s}: median {ms:9.2f} ms of "
                  f"{MODE_A_STEPS} (min {min(times[k]):.2f}, max "
                  f"{max(times[k]):.2f}); {out[n][k]['gb_s']:.2f} GB/s by "
                  f"bench's accounting (2 x 2(n-1)/n x {nbytes >> 20} MiB "
                  f"a step; rank threads on one card, not a wire); "
                  f"{rdv[k]} rendezvous a step", flush=True)
        print(f"  {n} ranks: value and gradient bitwise the run_ranks "
              f"body's: {same}")
        check(all(same.values()),
              f"bench's Allreduce body under run_spmd differs from "
              f"run_ranks on {n} ranks: {same}")
    return out


def first_differing_leaf(tree, a, b):
    """``(index, largest ulp distance)`` of the first leaf whose bits
    differ between two trees of floating tensors, or None."""
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    for i, (x, y) in enumerate(zip(tree.tree_leaves(a),
                                   tree.tree_leaves(b))):
        xi = x.detach().contiguous().view(ints[x.element_size()])
        yi = y.detach().contiguous().view(ints[y.element_size()])
        if not torch.equal(xi, yi):
            return i, int((xi.long() - yi.long()).abs().max())
    return None


def mode_a_dp2_phase(P, T, tree, dp, kernels, config, cfg, params,
                     tokens):
    """Phase 51: the flagship's DP=2 step, ``dp_value_and_grad`` plus the
    SGD update, each rank taking its ``TRAIN_BATCH // 2`` rows by
    ``comm.rank``, for ``MODE_A_DP2_STEPS`` steps under ``run_spmd`` (outside
    and inside deterministic mode) and under ``run_ranks``: losses and
    parameters bitwise alike; attention launches of the run_spmd run
    (counted from 0 just before it); step ms, rendezvous a step and the
    idle share."""
    rows = TRAIN_BATCH // 2
    comm = P.COMM_WORLD

    def step(p, x):
        loss, g = dp.dp_value_and_grad(
            comm, lambda q, b: T.lm_loss(cfg, q, b))(p, x)
        with torch.no_grad():
            return loss, tree.tree_map(lambda a, b: a - LR * b, p, g)

    spmd_body = dp2_spmd_body(P, T, tree, dp, cfg)

    def spmd_step(p, det):
        with config.deterministic_mode(det):
            loss, new = P.run_spmd(spmd_body, nranks=2)(p, tokens)
        same = torch.equal(loss[0], loss[1]) and leaves_equal(
            tree, tree.tree_map(lambda t: t[0], new),
            tree.tree_map(lambda t: t[1], new))
        return loss[0], tree.tree_map(lambda t: t[0], new), same

    def ranks_step(p):
        (l0, p0), (l1, p1) = P.run_ranks(
            lambda r: step(p, tokens[r * rows:(r + 1) * rows]), 2,
            device="cuda")
        return l0, p0, torch.equal(l0, l1) and leaves_equal(tree, p0, p1)

    def steps(fn, label):
        p, losses, ms, same = params, [], [], True
        for _ in range(MODE_A_DP2_STEPS):
            t_ms, (loss, p, ok) = sync_ms(lambda: fn(p))
            losses.append(loss)
            ms.append(t_ms)
            same = same and ok
        print(f"  {label:28s}: step ms {[round(t, 1) for t in ms]}; ranks "
              f"bitwise identical {same}; losses "
              f"{[round(float(v), 4) for v in losses]}", flush=True)
        return losses, p, ms, same

    ranks = steps(ranks_step, "run_ranks")
    kernels.reset_launch_counts()
    spmd = steps(lambda p: spmd_step(p, False), "run_spmd")
    launches = dict(kernels.launch_counts)
    spmd_det = steps(lambda p: spmd_step(p, True),
                     "run_spmd, deterministic")
    want = 2 * MODE_A_DP2_STEPS * cfg.n_layers
    results = {}
    for label, run in (("run_spmd", spmd), ("run_spmd_deterministic",
                                            spmd_det)):
        same_loss = all(torch.equal(a, b) for a, b in zip(run[0], ranks[0]))
        same_params = leaves_equal(tree, run[1], ranks[1])
        results[label] = same_loss and same_params and run[3]
        if not (same_loss and same_params):
            print(f"  {label}: first differing parameter leaf (index, "
                  f"largest ulp distance): "
                  f"{first_differing_leaf(tree, run[1], ranks[1])}")
        print(f"  {label}: losses bitwise run_ranks' {same_loss}, "
              f"parameters after {MODE_A_DP2_STEPS} steps bitwise "
              f"{same_params}")
    # Steps 2.. of each run (the first pays one-time costs).
    ms = {k: float(np.mean(run[2][1:])) for k, run in (
        ("spmd", spmd), ("spmd_deterministic", spmd_det), ("ranks", ranks))}
    del spmd, spmd_det
    print(f"  attention launches of the run_spmd steps {launches} "
          f"(expected {want} each, all tc: 8 a step on each rank)")
    check(all(results.values()),
          f"the DP=2 step under run_spmd differs from run_ranks: {results}")
    check(all(launches[k] == launches[f"{k}.tc"] == want
              for k in kernels.ATTENTION_KERNELS),
          "the run_spmd DP=2 steps did not launch every attention kernel "
          "8 times a step on each rank on tc")
    p1 = ranks[1]
    rdv = {}
    for label, fn in (("spmd", lambda: spmd_step(p1, False)),
                      ("spmd_deterministic", lambda: spmd_step(p1, True)),
                      ("ranks", lambda: ranks_step(p1))):
        with ExchangeCounter() as cnt:
            fn()
        rdv[label] = cnt.exchanges
    wall, busy, _ = profile_top(lambda: spmd_step(p1, False),
                                "one DP=2 step under run_spmd", n_top=4)
    idle = 100 - 100 * busy / wall
    print(f"  step ms (steps 2-{MODE_A_DP2_STEPS}): run_spmd "
          f"{ms['spmd']:.1f}, deterministic {ms['spmd_deterministic']:.1f}, "
          f"run_ranks {ms['ranks']:.1f}; rank 0's rendezvous a step: "
          f"{rdv}; device idle {idle:.1f}% of the profiled run_spmd step")
    return {"launches": launches, "rendezvous": rdv, "ms": ms,
            "idle_pct": idle}


def mode_a_misuse_phase(P):
    """Phase 52: Mode A's misuse guards on the card, and gradients taken
    from outside ``run_spmd`` through an Allreduce, an Allgather and a
    ring program bitwise equal to the CPU run."""
    comm = P.COMM_WORLD

    def lonely(x):
        comm.Isend(x, (comm.rank + 1) % comm.size, 0)
        return x

    msg = ""
    try:
        P.run_spmd(lonely, nranks=3)(torch.ones(4, device="cuda"))
    except P.DeadlockError as e:
        msg = str(e)
    print(f"  unmatched Isend: DeadlockError {msg[:120]!r}...")
    check("unmatched" in msg and "ring shift 1" in msg,
          "an unmatched Isend did not raise DeadlockError naming the shift")
    raised = []

    def concrete(x):
        try:
            int(comm.rank)
        except P.CommError:
            raised.append(True)
        return x

    P.run_spmd(concrete, nranks=2)(torch.ones(1, device="cuda"))
    print(f"  int(comm.rank) raised CommError on {len(raised)} of 2 ranks")
    check(len(raised) == 2, "int(comm.rank) did not raise on every rank")

    def ring(c, t):
        h = c.Isend(t, (c.rank + 1) % c.size, 0)
        b = c.Recv(P.JoinDummies(torch.empty_like(t), [h.dummy]),
                   (c.rank - 1) % c.size, 0)
        return P.JoinDummies(b, [c.Wait(P.JoinDummiesHandle(h, [b]))]) \
            * (1.0 + c.rank)

    ops = {"allreduce": lambda c, t: c.Allreduce(t, P.MPI_SUM),
           "allgather": lambda c, t: c.Allgather(t, 0),
           "ring": ring}
    x = torch.from_numpy(np.random.default_rng(52).standard_normal(
        (4, 4096)).astype(np.float32))
    same = {}
    for i, (name, op) in enumerate(ops.items()):
        def fn(v, op=op):
            return op(comm, v[comm.rank])
        card = mode_a_value_and_grad(P, fn, x, i, nranks=4, device="cuda")
        cpu = mode_a_value_and_grad(P, fn, x, i, nranks=4, device="cpu")
        same[name] = all(torch.equal(a.view(torch.int32),
                                     b.view(torch.int32))
                         for a, b in zip(card[:2], cpu[:2]))
    print(f"  gradients from outside run_spmd, card vs CPU bitwise: {same}")
    check(all(same.values()), f"a Mode A gradient differs from the CPU "
          f"run: {same}")


def vte_phase():
    """Phase 53: the ``variable_token_exchange`` example (butterfly p2p
    and the packed Alltoall under ``run_spmd``, 8 ranks, float64) on the
    card, checked against its own oracle inside ``run`` and against its
    CPU run with tolerance 0 (data movement and integer-valued sums)."""
    from mpi4torch_tpu_torch.examples import variable_token_exchange as vte

    t0 = time.perf_counter()
    card = vte.run(8, device="cuda")
    card_s = time.perf_counter() - t0
    cpu = vte.run(8, device="cpu")
    diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(card, cpu))
    print(f"  8 ranks on the card in {card_s:.2f} s: spans and per-rank "
          f"gradients match the token-id oracle; max |card - CPU| over "
          f"tokens, spans and gradients {diff} (tolerance 0)")
    check(diff == 0, "the example's card run differs from its CPU run")


# Phases 55-59 (Mode A's users): the compressed SPMD collectives at
# bench's size, the SPMD engine, pipeline_spmd and the SPMD reshard.
# Phase 55 holds bf16's Mode A ring bitwise to the same body on the CPU
# at this many elements a rank (the ring re-encodes every hop, Mode B
# folds once: the two modes are not one schedule for bf16).
SPMD_CHECK_NUMEL = 1 << 20
SPMD_AG_CODECS = ("q8", "bf16")
# Phase 56's engine forms: the dense greedy engine, the paged engine with
# phase 23's pages and prefill chunks, and the sampled dense engine with
# phase 23's temperature and top-k (request i's key PRNGKey(1000 + i)).
SPMD_SERVE_FORMS = {
    "dense_greedy": {},
    "paged_chunked": dict(block_size=PAGED["block_size"], prefix_cache=True,
                          prefill_chunk=PAGED["prefill_chunk"]),
    "sampled": dict(temperature=PAGED["temperature"], top_k=PAGED["top_k"]),
}
SPMD_RESHARD_REPEATS = 2
# Phase 55 times each compressed collective this many times on each side
# and keeps the fastest (the first run of a pair carries its warm-up).
SPMD_COMP_REPEATS = 3


def spmd_value_and_grad(P, stacked, compression, algo):
    """Under ``run_spmd``: each rank's (y, dL/dx) for L = vdot(y, y),
    y = Allreduce(x) of its row x: the body of ``q8_value_and_grad``."""
    comm = P.COMM_WORLD

    def body(v):
        x = v[comm.rank].clone().requires_grad_()
        y = comm.Allreduce(x, P.MPI_SUM, compression=compression,
                           algorithm=algo)
        (g,) = torch.autograd.grad(torch.vdot(y, y), x)
        return y.detach(), g

    return P.run_spmd(body, nranks=stacked.shape[0],
                      device=stacked.device)(stacked)


def allgather_value_and_grad(P, x, compression, rank=None):
    """One rank's (y, dL/dx) for L = vdot(y, y), y = Allgather(x) along 0
    (``rank`` None: under ``run_spmd``, ``x`` the stacked rows)."""
    comm = P.COMM_WORLD
    t = (x[comm.rank] if rank is None else x).clone().requires_grad_()
    y = comm.Allgather(t, 0, compression=compression)
    (g,) = torch.autograd.grad(torch.vdot(y, y), t)
    return y.detach(), g


def spmd_compressed_phase(P, T, tree, fuse, kernels, config, cfg, params,
                          tokens, q8f):
    """Phase 55: the compressed collectives under ``run_spmd`` at bench's
    size; then phase 19's fused q8 DP=2 step under ``run_spmd(nranks=2)``
    against the same step under ``run_ranks``."""
    n = BENCH_RANKS
    xs = bench_inputs()
    stacked = torch.stack(xs)
    exact = xs[0].clone()
    for x in xs[1:]:
        exact += x
    spmd_value_and_grad(P, stacked, False, None)            # warm-ups
    spmd_value_and_grad(P, stacked, "q8", "ring")
    exact_ms = min(sync_ms(lambda: spmd_value_and_grad(
        P, stacked, False, None))[0] for _ in range(2))
    k1 = {"q8_hop": 0, "q8_requant": 0}
    res = {}
    pairs = [(c, a) for c in Q8_CODECS for a in Q8_ALGOS] + \
        [("bf16", "ring"), ("bf16r", "ring")]
    for codec, algo in pairs:
        kernels.reset_launch_counts()
        ms, (y, g) = sync_ms(lambda: spmd_value_and_grad(P, stacked, codec,
                                                         algo))
        hops = kernels.launch_counts["q8_hop"]
        reqs = kernels.launch_counts["q8_requant"]
        k1["q8_hop"] += hops
        k1["q8_requant"] += reqs
        ms = min([ms] + [sync_ms(lambda: spmd_value_and_grad(
            P, stacked, codec, algo))[0]
            for _ in range(SPMD_COMP_REPEATS - 1)])
        ranks_ms, ranks = sync_ms(lambda: q8_value_and_grad(P, xs, codec,
                                                            algo))
        ranks_ms = min([ranks_ms] + [sync_ms(lambda: q8_value_and_grad(
            P, xs, codec, algo))[0] for _ in range(SPMD_COMP_REPEATS - 1)])
        same_ranks = all(torch.equal(y[r], y[0]) and torch.equal(g[r], g[0])
                         for r in range(n))
        mism = sum(bits_differ(y[r], ranks[r][0])
                   + bits_differ(g[r], ranks[r][1]) for r in range(n))
        rel = norm_rel1(y[0], exact)
        # Every rank's cotangent is 2y, so the exact backward is 2n y.
        rel_g = norm_rel1(g[0], 2 * n * y[0])
        extra = ""
        if codec in Q8_CODECS:
            chans = 1 if algo == "ring" else 2
            rounds = EF_ROUNDS[codec]
            want_hops = 2 * chans * rounds * n * (n - 1)
            want_req = 2 * chans * rounds * n
            bound_rel = CODEC_REL[codec]
            ok = (same_ranks and mism == 0 and hops == want_hops
                  and reqs == want_req and rel <= bound_rel
                  and rel_g <= bound_rel)
            extra = (f"; K1 hop {hops}/{want_hops} requant {reqs}/"
                     f"{want_req}")
        else:
            # The ring re-encodes every hop's partial sum: n - 1 hops and
            # the gather encode, each within BF16_REL of what it encodes.
            bound_rel = n * BF16_REL[codec]
            ok = same_ranks and rel <= bound_rel and rel_g <= bound_rel
            if codec == "bf16":
                small = stacked[:, :SPMD_CHECK_NUMEL].contiguous()
                card = spmd_value_and_grad(P, small, codec, algo)
                cpu = spmd_value_and_grad(P, small.cpu(), codec, algo)
                cmism = sum(bits_differ(a.cpu(), b) for a, b in
                            zip(card, cpu))
                ok = ok and cmism == 0
                extra = (f"; at {SPMD_CHECK_NUMEL} a rank vs the CPU run "
                         f"mismatched {cmism}")
            else:
                err = (y[0].double() - exact.double())
                se = (err.std() / err.numel() ** 0.5).item()
                mean = err.mean().item()
                ok = ok and abs(mean) <= 4 * se
                extra = f"; mean signed error {mean:.3e} (4 se {4 * se:.3e})"
        print(f"  {codec:9s} {algo:5s}: fwd+bwd {ms:8.2f} ms under run_spmd "
              f"({ranks_ms:8.2f} ms run_ranks; each the best of "
              f"{SPMD_COMP_REPEATS}); ranks identical "
              f"{same_ranks}; vs run_ranks mismatched {mism}{extra}; err "
              f"vs exact {rel:.3e}, grad {rel_g:.3e} (bound {bound_rel:g})"
              f"  {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"compressed Allreduce {codec}/{algo} under run_spmd "
              "failed a check")
        res[(codec, algo)] = {"ms": ms, "ranks_ms": ranks_ms, "hops": hops,
                              "requant": reqs, "mismatch_mode_b": mism}
        del y, g, ranks
        if (codec, algo) == ("q8", "bidir"):
            # Where Mode A's time goes: one q8 bidir fwd+bwd profiled.
            wall, busy, _ = profile_top(
                lambda: spmd_value_and_grad(P, stacked, codec, algo),
                "one q8 bidir fwd+bwd under run_spmd", n_top=4)
            res[(codec, algo)]["idle_pct"] = 100 - 100 * busy / wall
    print(f"  exact Allreduce under run_spmd, same world and size: fwd+bwd "
          f"{exact_ms:.2f} ms")
    ag = {}
    for codec in SPMD_AG_CODECS:
        def ag_spmd():
            return P.run_spmd(lambda v: allgather_value_and_grad(P, v, codec),
                              nranks=n)(stacked)

        kernels.reset_launch_counts()
        ms, (y, g) = sync_ms(ag_spmd)
        reqs = kernels.launch_counts["q8_requant"]
        k1["q8_requant"] += reqs
        ms = min([ms] + [sync_ms(ag_spmd)[0]
                         for _ in range(SPMD_COMP_REPEATS - 1)])
        ranks = P.run_ranks(lambda r: allgather_value_and_grad(
            P, xs[r], codec, r), n, device="cuda")
        m = xs[0].numel()
        fwd_mism = sum(bits_differ(y[r], ranks[r][0]) for r in range(n))
        same = all(torch.equal(y[r], y[0]) for r in range(n))
        # The adjoint, a compressed reduce-scatter of the cotangents 2y:
        # the quantized ring here, the rendezvous fold under run_ranks.
        rel_g = max(norm_rel1(g[r], 2 * n * y[0][r * m:(r + 1) * m])
                    for r in range(n))
        rel_b = max(norm_rel1(g[r], ranks[r][1]) for r in range(n))
        bound_rel = CODEC_REL["q8"] if codec == "q8" \
            else n * BF16_REL[codec]
        want_req = n * n if codec == "q8" else 0
        ok = fwd_mism == 0 and same and rel_g <= bound_rel and \
            reqs == want_req
        print(f"  Allgather[{codec}] fwd+bwd {ms:.2f} ms (the best of "
              f"{SPMD_COMP_REPEATS}): forward vs "
              f"run_ranks mismatched {fwd_mism}, ranks identical {same}; "
              f"adjoint vs exact {rel_g:.3e} (bound {bound_rel:g}), vs "
              f"run_ranks' rendezvous fold {rel_b:.3e}; K1 requant {reqs}/"
              f"{want_req}  {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"the compressed Allgather[{codec}] under run_spmd failed")
        ag[codec] = {"ms": ms, "requant": reqs}
        del y, g, ranks
    del stacked, xs, exact
    torch.cuda.empty_cache()

    # Phase 19's fused q8 DP=2 step at 4 MiB buckets under run_spmd.
    rows = TRAIN_BATCH // 2
    comm = P.COMM_WORLD
    bb = config.DEFAULT_BUCKET_BYTES
    nbk = fuse.bucket_layout(params, bb).num_buckets

    def dp_body(p, x):
        loss, g = tree.value_and_grad(lambda q: T.lm_loss(cfg, q, x), p)
        synced = comm.Allreduce_tree(g, P.MPI_SUM, mean=True,
                                     compression="q8", bucket_bytes=bb)
        with torch.no_grad():
            return loss, tree.tree_map(lambda a, s: a - LR * s, p, synced)

    def spmd_body(p, toks):
        idx = comm.rank * rows + torch.arange(rows, device=toks.device)
        return dp_body(p, toks.index_select(0, idx))

    def spmd_step():
        return P.run_spmd(spmd_body, nranks=2)(params, tokens)

    kernels.reset_launch_counts()
    loss, new = spmd_step()
    launches = dict(kernels.launch_counts)
    (l0, p0), (l1, p1) = P.run_ranks(
        lambda r: dp_body(params, tokens[r * rows:(r + 1) * rows]), 2,
        device="cuda")
    same = torch.equal(loss[0], l0) and torch.equal(loss[1], l1) and \
        leaves_equal(tree, tree.tree_map(lambda t: t[0], new), p0) and \
        leaves_equal(tree, tree.tree_map(lambda t: t[1], new), p1)
    del new, p0, p1
    tc = attention_all_tc(kernels, launches)
    att = all(launches[k] == 2 * cfg.n_layers
              for k in kernels.ATTENTION_KERNELS)
    ok = same and tc and att and launches["q8_hop"] == 2 * nbk and \
        launches["q8_requant"] == 2 * nbk
    t = [sync_ms(spmd_step)[0] for _ in range(2)]
    wall, busy, _ = profile_top(spmd_step, "one fused q8 DP=2 step under "
                                "run_spmd", n_top=4)
    idle = 100 - 100 * busy / wall
    print(f"  fused q8 DP=2 step under run_spmd ({nbk} buckets of "
          f"<= {bb} bytes): loss and parameters bitwise run_ranks' {same}; "
          f"K1 a step: hop {launches['q8_hop']} requant "
          f"{launches['q8_requant']} (expected 2 x {nbk} each); K2/K3/K4 "
          f"{[launches[k] for k in kernels.ATTENTION_KERNELS]} (expected "
          f"{2 * cfg.n_layers} each), all tc {tc}; step "
          f"{[round(x, 1) for x in t]} ms (phase 19 under run_ranks "
          f"{q8f['4MiB']['ms']:.1f} ms); device idle {idle:.1f}%  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "the fused q8 DP=2 step under run_spmd failed a check")
    torch.cuda.empty_cache()
    return {"allreduce": res, "exact_ms": exact_ms, "allgather": ag,
            "k1": k1, "dp2": {"launches": launches, "ms": min(t),
                              "idle_pct": idle, "buckets": nbk}}


# The device kernels that copy memory: ``clone``/``copy_`` (the SPMD
# engine's private row copies) and ``torch.stack``/``cat`` (``run_spmd``'s
# restacking of the outputs), and the runtime's copies.
COPY_KERNELS = ("direct_copy_kernel", "CatArrayBatchedCopy", "Memcpy")


def drive_engine(eng, reqs, keys, profile=False):
    """Submit ``reqs`` (with ``keys``), run the engine to the end timing
    every step, and keep a reference to every logits table it chose from.
    Returns (results, logits rows per request, decode ms and tokens over
    decode-only steps, the decode-only step ms, TTFT p50 s, and with
    ``profile`` the copy kernels of one decode-only step run under
    torch.profiler: {copy_ms, copies, busy_ms, wall_ms}, else None).  The
    profiled step is left out of the decode time and tokens."""
    for p, k in zip(reqs, keys):
        eng.submit(p, key=k)
    rows = {}
    select = eng._select

    def keep_rows(reqs_, logits):
        for r, lrow in zip(reqs_, logits):
            if r is not None:
                rows.setdefault(r.rid, []).append(lrow)
        return select(reqs_, logits)

    eng._select = keep_rows
    decode_ms, decode_tok, step_ms = 0.0, 0, []
    copies = None
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    while eng.pending():
        before = eng.stats.counters["prefill_tokens"]
        # After two decode-only steps the next is most likely one too.
        prof = profile and copies is None and len(step_ms) >= 2
        if prof:
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as pr:
                t0 = time.perf_counter()
                ev = eng.step()
                dt = (time.perf_counter() - t0) * 1e3
        else:
            t0 = time.perf_counter()
            ev = eng.step()           # ends in a host read of the tokens
            dt = (time.perf_counter() - t0) * 1e3
        if ev["admitted"] or \
                eng.stats.counters["prefill_tokens"] != before:
            continue
        if prof:
            dev = [e for e in pr.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation
                   and e.self_device_time_total > 0]
            cp = [e for e in dev if any(k in e.key for k in COPY_KERNELS)]
            copies = {"copy_ms": sum(e.self_device_time_total
                                     for e in cp) / 1e3,
                      "copies": sum(e.count for e in cp),
                      "busy_ms": sum(e.self_device_time_total
                                     for e in dev) / 1e3,
                      "wall_ms": dt}
            continue
        decode_ms += dt
        decode_tok += len(ev["emitted"])
        step_ms.append(dt)
    ttft = eng.stats.snapshot().get("ttft_s", {}).get("p50", float("nan"))
    return eng.results(), rows, decode_ms, decode_tok, step_ms, ttft, copies


def sampled_divergences(T, threefry, cfg, params, reqs, results, rows):
    """Sampled tokens against each request's sampled ``generate()`` loop:
    equal but at a near tie, by phase 23's rule (``sampled_tie``)."""
    divergences = 0
    for rid, prompt in enumerate(reqs):
        got = results[rid][len(prompt):].tolist()
        want, subs, grows = sampled_oracle(
            T, threefry, cfg, params, prompt, TP2_MAX_NEW,
            threefry.PRNGKey(1000 + rid))
        first = next((i for i, (a, b) in enumerate(zip(got, want))
                      if a != b), None)
        if first is not None:
            m = sampled_tie(T, rows[rid][first], grows[first], subs[first],
                            got[first], want[first])
            check(m and min(m.values()) <= 1.0,
                  f"sampled request {rid}: token {first} differs from "
                  f"generate() without a near tie ({m})")
            divergences += 1
    return divergences


def spmd_engine_phase(P, T, serve, kernels, threefry, tree, cfg, params,
                      prompts, tp2_rate):
    """Phase 56: ``Engine(spmd=True, nranks=2)`` at full width on phase 5's
    requests, dense greedy, paged with chunked prefill, and sampled: tokens
    equal the ``run_ranks`` TP=2 engine's and ``generate()``'s (near ties
    excepted), every K2 launch ``tc``; TTFT, decode tokens/s, and the
    device time of the copies in one profiled decode step (the body's
    private copy of its row of the stacked state, then ``run_spmd``'s
    restack)."""
    reqs = prompts[:TP2_REQUESTS]
    out = {}
    k2 = {"flash_fwd": 0, "flash_fwd.tc": 0}
    for form, extra in SPMD_SERVE_FORMS.items():
        scfg = serve.ServeConfig(slots=SLOTS, max_new=TP2_MAX_NEW, **extra)
        keys = [threefry.PRNGKey(1000 + i) for i in range(len(reqs))] \
            if scfg.temperature > 0 else [None] * len(reqs)
        with torch.no_grad():
            eng = serve.Engine(cfg, params, scfg, spmd=True, nranks=2)
            kernels.reset_launch_counts()
            res, rows, dec_ms, dec_tok, step_ms, ttft, cp = drive_engine(
                eng, reqs, keys, profile=True)
            launches = (kernels.launch_counts["flash_fwd"],
                        kernels.launch_counts["flash_fwd.tc"])
            k2["flash_fwd"] += launches[0]
            k2["flash_fwd.tc"] += launches[1]
            state = sum(t.numel() * t.element_size()
                        for t in tree.tree_leaves(eng._cache))
            got = [res[i].tolist() for i in range(len(reqs))]

            def ranks_body():
                with torch.inference_mode():
                    e = serve.Engine(cfg, params, scfg, device="cuda")
                    r, _, d_ms, d_tok, _, t, _ = drive_engine(e, reqs,
                                                              keys)
                    return [r[i].tolist() for i in range(len(reqs))], \
                        d_tok / (d_ms / 1e3) if d_ms else float("nan"), t

            ranks = P.run_ranks(ranks_body, 2, device="cuda")
            same = ranks[0][0] == ranks[1][0] == got
            b_rate, b_ttft = ranks[0][1], ranks[0][2]
            if scfg.temperature > 0:
                div = sampled_divergences(T, threefry, cfg, params, reqs,
                                          res, rows)
                ties = None
            else:
                div, ties = tie_rule_tokens(T, cfg, params, reqs, res,
                                            TP2_MAX_NEW)
        step = float(np.mean(step_ms)) if step_ms else float("nan")
        rate = dec_tok / (dec_ms / 1e3) if dec_ms else float("nan")
        ok = same and launches[0] == launches[1] > 0 and cp is not None
        cp = cp or {"copy_ms": float("nan"), "copies": 0,
                    "busy_ms": float("nan"), "wall_ms": float("nan")}
        print(f"  {form:13s}: tokens equal the run_ranks TP=2 engine's "
              f"{same}; near-tie divergences from generate() {div}"
              + ("" if ties is None else f" (oracle near-tie steps {ties})")
              + f"; flash_fwd launches {launches[0]}, tc {launches[1]}; "
              f"TTFT p50 {ttft * 1e3:.1f} ms (the run_ranks engine "
              f"{b_ttft * 1e3:.1f}); decode {rate:.1f} tokens/s (the "
              f"run_ranks engine {b_rate:.1f}, phase 5's TP=2 engine "
              f"{tp2_rate:.1f}); stacked cache "
              f"{state / 1e9:.3f} GB, copied twice a decode step (the "
              f"body's private row copies, then run_spmd's stack); one "
              f"profiled decode step: copy kernels {cp['copy_ms']:.2f} ms "
              f"({cp['copies']} launches) of {cp['busy_ms']:.2f} ms device "
              f"busy in a {cp['wall_ms']:.1f} ms step, "
              f"{100 * cp['copy_ms'] / step:.1f}% of the mean "
              f"{step:.1f} ms step  {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"the SPMD engine ({form}) failed a check")
        out[form] = {"launches": launches[0], "ttft_s": ttft,
                     "decode_tok_s": rate, "ranks_ttft_s": b_ttft,
                     "ranks_decode_tok_s": b_rate, "step_ms": step,
                     "state_bytes": state, "copy_ms": cp["copy_ms"],
                     "divergences": div}
        del eng, rows, res
        torch.cuda.empty_cache()
    out["k2"] = k2
    return out


def pp_spmd_phase(P, T, pp, kernels, flash, tree, cfg, params, tokens,
                  pipe):
    """Phase 57: ``pipeline_spmd`` PP=2 at full width: PP_MB microbatches
    of PP_ROWS x 2048 embedded tokens, 4 flagship blocks a stage, the LM
    loss (final norm, unembedding, masked next-token cross entropy) in
    ``loss_fn``; against ``pipeline_step`` (phase 31's GPipe) on the same
    inputs."""
    F = torch.nn.functional
    n, per = 2, cfg.n_layers // 2
    mbs = [tokens[i * PP_ROWS:(i + 1) * PP_ROWS] for i in range(PP_MB)]
    with torch.no_grad():
        xs = [F.embedding(t, params["embed"])
              + params["pos"][None, :t.shape[1]] for t in mbs]
    labels = torch.stack([torch.cat([t[:, 1:], t[:, :1]], dim=1)
                          for t in mbs])
    seq = mbs[0].shape[1]
    mask = (torch.arange(seq, device="cuda") < seq - 1).to(
        params["embed"].dtype)

    def stage(p, x):
        for blk in p["blocks"]:
            y = T._norm(cfg, x, blk["ln1"])
            q, k, v = T._split_qkv(cfg, blk, y)
            o = flash.flash_attention(q, k, v, causal=True)
            x = x + o.reshape(x.shape) @ blk["wo"]
            x, _ = T._ffn_residual(cfg, blk, x)
        return x

    def loss_fn(y, i):
        lab = labels.index_select(
            0, torch.as_tensor(i, device="cuda").reshape(1))[0]
        logits = T._norm(cfg, y, params["ln_f"]) @ params["unembed"]
        ce = -F.log_softmax(logits, dim=-1).gather(-1, lab[..., None])[
            ..., 0]
        return torch.sum(ce * mask[None, :]) / (PP_ROWS * (seq - 1))

    stages = [{"blocks": params["blocks"][r * per:(r + 1) * per]}
              for r in range(n)]
    stacked = tree.tree_map(lambda a, b: torch.stack([a, b]), *stages)
    comm = P.COMM_WORLD

    def body(st):
        local = tree.tree_map(lambda a: a[comm.rank], st)
        return pp.pipeline_spmd(comm, stage, local, xs, loss_fn)

    def run():
        leaves = [t.detach().requires_grad_()
                  for t in tree.tree_leaves(stacked)]
        out = P.run_spmd(body, nranks=n)(tree.tree_unflatten(stacked,
                                                             leaves))
        grads = torch.autograd.grad(out.sum(), leaves)
        return out.detach(), grads

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = run()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: kernels.launch_counts[k]
                for k in kernels.ATTENTION_KERNELS}
    tc = attention_all_tc(kernels, dict(kernels.launch_counts))
    want = (PP_MB + n - 1) * per * n
    t = [sync_ms(run)[0] for _ in range(2)]
    like = torch.zeros_like(xs[0])
    (l0, g0), (l1, g1) = P.run_ranks(lambda r: pp.pipeline_step(
        comm, stage, stages[r], xs, loss_fn, recv_like=like), n,
        device="cuda")
    # From outside, each rank's unit cotangent sums through the loss
    # Allreduce's adjoint: every stage gradient is twice the loss's.
    rows = [tree.tree_unflatten(stacked, [g[r] / 2 for g in grads])
            for r in range(n)]
    errs = [norm_rel(tree, rows[r], (g0, g1)[r]) for r in range(n)]
    loss_rel = abs(loss[0].double().item() - l0.item()) / abs(l0.item())
    ok = torch.equal(loss[0], loss[1]) and max(errs) <= BF16_GRAD_REL and \
        loss_rel <= BF16_GRAD_REL and tc and \
        all(v == want for v in launches.values())
    print(f"  loss {loss[0].item():.4f} (bitwise across ranks "
          f"{torch.equal(loss[0], loss[1])}) vs pipeline_step "
          f"{l0.item():.4f}, rel {loss_rel:.2e}; stage gradients vs "
          f"pipeline_step worst leaf {max(errs):.2e} (bound "
          f"{BF16_GRAD_REL:g}); K2/K3/K4 launches {launches} (expected "
          f"{want}: {PP_MB + n - 1} steps x {per} blocks x {n} ranks), all "
          f"tc {tc}; step {[round(x, 1) for x in t]} ms, peak {peak:.2f} "
          f"GiB (phase 31's GPipe under run_ranks {pipe['gpipe']['ms']:.1f}"
          f" ms, peak {pipe['gpipe']['peak_gib']:.2f} GiB)  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "pipeline_spmd failed a check")
    del grads, g0, g1, rows, xs
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": min(t), "peak_gib": peak,
            "grad_rel": max(errs)}


def spmd_reshard_phase(P, tree, rs, config, kernels, params, resharded):
    """Phase 58: phase 40's flagship tree (8,) -> (2, 4) under
    ``run_spmd(nranks=8)``, planned and ``gather``: bitwise the eager
    executor's result on rank threads, one VJP bitwise the reverse
    reshard, ms and rendezvous a tree; the q8 compressed gather hop on the
    f32 embedding bitwise the eager one, with its K1 requant launches."""
    n = RESHARD_RANKS
    comm = P.COMM_WORLD
    src, dst = reshard_specs(rs, params, n, RESHARD_MESH)
    stacked = tree.tree_map(lambda *s: torch.stack(s),
                            *[rs.shard_of(params, src, r) for r in range(n)])
    out = {}
    for strategy in (None, "gather"):
        label = strategy or "auto"

        def body(st, strategy=strategy):
            return comm.Reshard(tree.tree_map(lambda a: a[comm.rank], st),
                                src, dst, strategy=strategy)

        call = P.run_spmd(body, nranks=n)
        got = call(stacked)
        eager = P.run_ranks(lambda r: comm.Reshard(
            rs.shard_of(params, src, r), src, dst, strategy=strategy), n,
            timeout=300.0, device="cuda")
        same = all(leaves_equal(tree, tree.tree_map(lambda t: t[r], got),
                                eager[r]) for r in range(n))
        del got, eager
        ms = [sync_ms(lambda: call(stacked))[0]
              for _ in range(SPMD_RESHARD_REPEATS)]
        with ExchangeCounter() as cnt:
            call(stacked)
        back = None
        if strategy is None:
            leaves = [t.detach().requires_grad_()
                      for t in tree.tree_leaves(stacked)]
            y = call(tree.tree_unflatten(stacked, leaves))
            w = tree.tree_map(lambda t: t.detach() * 2, y)
            g = torch.autograd.grad(tree.tree_leaves(y), leaves,
                                    tree.tree_leaves(w))
            rev = P.run_spmd(lambda v: comm.Reshard(
                tree.tree_map(lambda a: a[comm.rank], v), dst, src),
                nranks=n)(w)
            back = all(torch.equal(a, b)
                       for a, b in zip(g, tree.tree_leaves(rev)))
            del y, w, g, rev
        ok = same and back is not False
        print(f"  {label}: bitwise the eager executor {same}"
              + ("" if back is None else
                 f"; the VJP bitwise the reverse reshard {back}")
              + f"; {np.mean(ms):.1f} ms a tree (runs "
              f"{[round(x, 1) for x in ms]}), rank 0's rendezvous a tree "
              f"{cnt.exchanges} (phase 40's eager executor "
              f"{np.mean(resharded[label]['ms']):.1f} ms)  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"the SPMD reshard ({label}) failed a check")
        out[label] = {"ms": ms, "rendezvous": cnt.exchanges}
        torch.cuda.empty_cache()
    del stacked
    emb = params["embed"].float()
    l8, l24 = rs.layout((n,), 0, None), rs.layout(RESHARD_MESH, 0, 1)
    shards = torch.stack([rs.slice_shard(emb, l8, r) for r in range(n)])
    kernels.reset_launch_counts()
    ms, got = sync_ms(lambda: P.run_spmd(lambda v: comm.Reshard(
        v[comm.rank], l8, l24, strategy="gather", compression="q8"),
        nranks=n)(shards))
    requant = kernels.launch_counts["q8_requant"]
    eager = P.run_ranks(lambda r: comm.Reshard(
        rs.slice_shard(emb, l8, r), l8, l24, strategy="gather",
        compression="q8"), n, device="cuda")
    bitwise = all(bits_differ(got[r], eager[r]) == 0 for r in range(n))
    ok = bitwise and requant == n
    print(f"  compressed wide hop (q8, gather) on the f32 embedding under "
          f"run_spmd: {requant} q8_requant launches (one a rank), bitwise "
          f"the eager hop {bitwise}, {ms:.1f} ms  {'ok' if ok else 'FAIL'}",
          flush=True)
    check(ok, "the SPMD compressed wide hop failed a check")
    out["wide_hop"] = {"requant": requant, "ms": ms}
    del emb, shards, got, eager
    torch.cuda.empty_cache()
    return out


def cli_phase():
    """Phase 59: the two Mode A smoke CLIs as subprocesses on the card."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    for mod in ("mpi4torch_tpu_torch.compress",
                "mpi4torch_tpu_torch.reshard"):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", mod, "--smoke"],
                              capture_output=True, text=True, timeout=300,
                              cwd=root, env=env)
        for line in proc.stdout.splitlines():
            print("    " + line)
        if proc.returncode:
            print(proc.stderr[-4000:])
        print(f"  python -m {mod} --smoke: exit {proc.returncode} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        check(proc.returncode == 0, f"python -m {mod} --smoke failed")


# ---------------------------------------------------------------------------
# Phase 60: the schedule IR on the card
# ---------------------------------------------------------------------------

IR_WORLDS = MODE_A_WORLDS       # (3,) and (8,) rank-thread worlds
IR_NUMEL = MODE_A_NUMEL         # a rank's row, float32 (phase 49's size)
IR_MESH = {"dp": 2, "tp": 4}
IR_Q8_RANKS = 4                 # the q8 family (torus's inner group 2)
IR_BENCH_RANKS = 4              # bench's Allreduce body, as phase 50
IR_Q8_ROUNDS = 10               # alternating rounds of the q8 bidir A/B


class HandWrittenAllreduce(torch.autograd.Function):
    """The hand-written Allreduce dispatch of ``ops/spmd.py``
    (``_handwritten_allreduce_value``), forward and adjoint (``bidir``'s
    halves swapped): the reference phase 60 holds the IR route to."""

    @staticmethod
    def forward(fctx, x, ctx, op, algo):
        from mpi4torch_tpu_torch.ops import spmd

        fctx.ctx, fctx.algo = ctx, algo
        return spmd._handwritten_allreduce_value(ctx, x, op, algo)

    @staticmethod
    def backward(fctx, g):
        from mpi4torch_tpu_torch import constants as C
        from mpi4torch_tpu_torch.ops import spmd

        return (spmd._handwritten_allreduce_value(
            fctx.ctx, g.contiguous(), C.MPI_SUM, fctx.algo, reverse=True),
            None, None, None)


def hand_written_bcast(ctx, x, root, algo):
    """The hand-written Bcast_ dispatch: the binomial tree, or the
    root-masked psum, by ``algo`` and ``config.bcast_tree_max_bytes``."""
    from mpi4torch_tpu_torch import config
    from mpi4torch_tpu_torch import constants as C
    from mpi4torch_tpu_torch.ops import spmd

    if ctx.size == 1:
        return x
    nbytes = x.numel() * x.element_size()
    if algo == "tree" or (algo != "ring"
                          and nbytes <= config.bcast_tree_max_bytes()):
        return spmd._tree_bcast_value(ctx, x, root)
    return spmd._psum(ctx, spmd._mask_to_root(ctx, x, root), C.MPI_SUM)


def hand_written_reduce(ctx, x, op, root, algo):
    """The hand-written Reduce_ dispatch: the binomial reduce, or the ring
    allreduce with a root mask."""
    from mpi4torch_tpu_torch.ops import spmd

    if algo == "tree":
        return spmd._tree_reduce_value(ctx, x, op, root)
    return spmd._mask_to_root(
        ctx, spmd._handwritten_allreduce_value(ctx, x, op, "ring"), root)


class HandWrittenRooted(torch.autograd.Function):
    """Bcast_ / Reduce_ by the hand-written dispatch, each the other's
    adjoint."""

    @staticmethod
    def forward(fctx, x, ctx, kind, op, root, algo):
        fctx.args = (ctx, kind, root, algo)
        if kind == "bcast":
            return hand_written_bcast(ctx, x, root, algo)
        return hand_written_reduce(ctx, x, op, root, algo)

    @staticmethod
    def backward(fctx, g):
        from mpi4torch_tpu_torch import constants as C

        ctx, kind, root, algo = fctx.args
        g = g.contiguous()
        out = (hand_written_reduce(ctx, g, C.MPI_SUM, root, algo)
               if kind == "bcast" else hand_written_bcast(ctx, g, root,
                                                          algo))
        return out, None, None, None, None, None


class HandComposedQ8(torch.autograd.Function):
    """The hand-composed block-q8 Allreduce
    (``compress/spmd._fused_allreduce_value``), forward and adjoint: the
    reference of the codec-rewritten IR route."""

    @staticmethod
    def forward(fctx, x, ctx, codec, algo):
        from mpi4torch_tpu_torch.compress import spmd as cspmd

        fctx.args = (ctx, codec, algo)
        return cspmd._fused_allreduce_value(ctx, x, codec, algo, False)

    @staticmethod
    def backward(fctx, g):
        from mpi4torch_tpu_torch.compress import spmd as cspmd

        ctx, codec, algo = fctx.args
        return (cspmd._fused_allreduce_value(ctx, g.contiguous(), codec,
                                             algo, True), None, None, None)


def ir_run(P, fn, x, w, **kw):
    """``run_spmd(fn)`` on the stacked rows ``x`` (moved to the run's
    device): ``(out, grad of vdot(out, w) from outside or None, rank 0's
    exchanges forward, backward)``, tensors on the CPU."""
    dev = kw["mesh"].devices.reshape(-1)[0] if "mesh" in kw else "cuda"
    f = P.run_spmd(fn, **kw)
    xt = x.to(dev).requires_grad_(w is not None)
    with ExchangeCounter() as fwd:
        out = f(xt)
    if w is None:
        return out.detach().cpu(), None, fwd.seq, []
    with ExchangeCounter() as bwd:
        (g,) = torch.autograd.grad(
            torch.vdot(out.reshape(-1), w.to(dev).reshape(-1)), xt)
    return out.detach().cpu(), g.cpu(), fwd.seq, bwd.seq


def ir_differs(a, b):
    """Bytes differing between two ``ir_run`` results (values and
    gradients), or -1 when their exchange sequences differ."""
    if a[2] != b[2] or a[3] != b[3]:
        return -1
    n = bits_differ(a[0], b[0])
    if a[1] is not None:
        n += bits_differ(a[1], b[1])
    return n


def algos_for(n):
    return [a for a in MODE_A_ALGOS
            if not (a == "rhd" and n & (n - 1))
            and not (a in ("hier", "torus")
                     and all(n % g for g in range(2, n)))]


def csched_phase(P, tree, config, kernels, mode_a_bench, spmd_comp):
    """Phase 60: every Mode A Allreduce, Bcast_ and Reduce_ through the
    schedule IR against its hand-written form on the card, bitwise, with
    the same exchanges; the interpreter against deterministic Mode A; the
    q8 family's IR route against the hand-composed pipeline with K1's
    launches equal; bench's Allreduce body timed on both routes."""
    from mpi4torch_tpu_torch import csched
    from mpi4torch_tpu_torch.compress import get_codec
    from mpi4torch_tpu_torch.ops import spmd

    comm = P.COMM_WORLD
    ops = {"SUM": P.MPI_SUM, "MAX": P.MPI_MAX, "PROD": P.MPI_PROD}
    out = {"bodies": 0, "exchanges": 0, "bad": []}

    def compare(label, a, b):
        diff = ir_differs(a, b)
        out["bodies"] += 1
        out["exchanges"] += len(a[2]) + len(a[3])
        if diff:
            out["bad"].append((label, diff))

    def interp_check(label, a, x, prog, op, groups):
        """The interpreter on the card's rows of each group against every
        member's deterministic Mode A value."""
        xs = x.to("cuda")
        for grp in groups:
            ref = csched.interpret_allreduce(
                prog, op, [xs[r] for r in grp]).cpu()
            if any(bits_differ(a[0][r], ref) for r in grp):
                out["bad"].append((label + " interpreter", 1))
                return

    t0 = time.perf_counter()
    for n in IR_WORLDS:
        rng = np.random.default_rng(60 + n)
        x = torch.from_numpy(rng.standard_normal(
            (n, IR_NUMEL)).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal(
            (n, IR_NUMEL)).astype(np.float32))
        for algo in algos_for(n):
            for det in (False, True):
                for opname, op in ops.items():
                    ww = w if op == P.MPI_SUM else None
                    with config.deterministic_mode(det):
                        a = ir_run(P, lambda v: comm.Allreduce(
                            v[comm.rank], op, algorithm=algo), x, ww,
                            nranks=n)
                        b = ir_run(P, lambda v: HandWrittenAllreduce.apply(
                            v[comm.rank], spmd.current_spmd_context(), op,
                            algo), x, ww, nranks=n)
                    label = f"({n},) {algo} {opname} det={det}"
                    compare(label, a, b)
                    if det:
                        prog = csched.allreduce_program(
                            algo, n, op, deterministic=True,
                            nelems=IR_NUMEL, itemsize=4)
                        interp_check(label, a, x, prog, op, [range(n)])
        for root in range(n):
            for algo in (None, "ring", "tree"):
                for kind, opname in (("bcast", "SUM"), ("reduce", "SUM"),
                                     ("reduce", "MAX"), ("reduce", "PROD")):
                    if opname != "SUM" and root != 1:
                        continue
                    op = ops[opname]
                    for det in (False, True):
                        ww = w if op == P.MPI_SUM else None

                        def ir(v):
                            t = v[comm.rank]
                            if kind == "bcast":
                                return comm.Bcast_(t, root, algorithm=algo)
                            return comm.Reduce_(t, op, root, algorithm=algo)

                        def hw(v):
                            return HandWrittenRooted.apply(
                                v[comm.rank], spmd.current_spmd_context(),
                                kind, op, root, algo)

                        with config.deterministic_mode(det):
                            a = ir_run(P, ir, x, ww, nranks=n)
                            b = ir_run(P, hw, x, ww, nranks=n)
                        compare(f"({n},) {kind} root {root} {algo} "
                                f"{opname} det={det}", a, b)
        print(f"  ({n},): {out['bodies']} bodies so far; bytes differing "
              f"or exchange sequences apart: {out['bad'] or 0}", flush=True)
    # The (2, 4) mesh, per axis.
    mesh = P.device_mesh(IR_MESH)
    dp_c, tp_c = P.comm_from_mesh(mesh, "dp"), P.comm_from_mesh(mesh, "tp")
    rng = np.random.default_rng(68)
    x = torch.from_numpy(rng.standard_normal((8, IR_NUMEL)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((8, IR_NUMEL)).astype(
        np.float32))
    tp_n = IR_MESH["tp"]
    for axis, c in (("dp", dp_c), ("tp", tp_c)):
        groups = ([[i * tp_n + j for j in range(tp_n)]
                   for i in range(IR_MESH["dp"])] if axis == "tp" else
                  [[j + i * tp_n for i in range(IR_MESH["dp"])]
                   for j in range(tp_n)])
        for algo in algos_for(c.size):
            for det in (False, True):
                def ir(v):
                    return c.Allreduce(v[dp_c.rank * tp_n + tp_c.rank],
                                       P.MPI_SUM, algorithm=algo)

                def hw(v):
                    return HandWrittenAllreduce.apply(
                        v[dp_c.rank * tp_n + tp_c.rank],
                        spmd._current_region().ctx(axis), P.MPI_SUM, algo)

                with config.deterministic_mode(det):
                    a = ir_run(P, ir, x, w, mesh=mesh, axis_name="dp")
                    b = ir_run(P, hw, x, w, mesh=mesh, axis_name="dp")
                label = f"(2, 4) {axis} {algo} det={det}"
                compare(label, a, b)
                if det:
                    prog = csched.allreduce_program(
                        algo, c.size, P.MPI_SUM, deterministic=True,
                        nelems=IR_NUMEL, itemsize=4)
                    interp_check(label, a, x, prog, P.MPI_SUM, groups)
    ops_s = time.perf_counter() - t0
    print(f"  exact route: {out['bodies']} bodies (Allreduce on every "
          f"algorithm x default/deterministic x SUM/MAX/PROD on "
          f"{IR_WORLDS} worlds, Bcast_/Reduce_ at every root, the (2, 4) "
          f"mesh per axis) in {ops_s:.1f} s, {out['exchanges']} exchanges "
          f"on rank 0 for the IR forms; bytes differing from the "
          f"hand-written forms, exchange sequences apart, or the "
          f"interpreter apart from deterministic Mode A: "
          f"{out['bad'] or 0}", flush=True)
    check(not out["bad"], f"the IR route differs on the card: {out['bad']}")

    # The q8 family: the codec-rewritten program against the hand-composed
    # pipeline, with K1's launches.
    n = IR_Q8_RANKS
    rng = np.random.default_rng(69)
    x = torch.from_numpy(rng.standard_normal((n, IR_NUMEL)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((n, IR_NUMEL)).astype(
        np.float32))
    k1 = {"q8_hop": 0, "q8_requant": 0}
    q8_bad = []
    for codec in Q8_CODECS:
        cobj = get_codec(codec)
        for algo in Q8_ALGOS:
            runs, counts = [], []
            for route in ("ir", "hand"):
                kernels.reset_launch_counts()
                if route == "ir":
                    runs.append(ir_run(P, lambda v: comm.Allreduce(
                        v[comm.rank], P.MPI_SUM, compression=codec,
                        algorithm=algo), x, w, nranks=n))
                else:
                    runs.append(ir_run(P, lambda v: HandComposedQ8.apply(
                        v[comm.rank], spmd.current_spmd_context(), cobj,
                        algo), x, w, nranks=n))
                counts.append((kernels.launch_counts["q8_hop"],
                               kernels.launch_counts["q8_requant"]))
            chans = 1 if algo == "ring" else 2
            rounds = EF_ROUNDS[codec]
            want = (2 * chans * rounds * n * (n - 1),
                    2 * chans * rounds * n)
            diff = ir_differs(runs[0], runs[1])
            k1["q8_hop"] += counts[0][0]
            k1["q8_requant"] += counts[0][1]
            ok = diff == 0 and counts[0] == counts[1] == want
            if not ok:
                q8_bad.append((codec, algo, diff, counts))
            print(f"  {codec:9s} {algo:5s}: IR route vs hand-composed, bytes"
                  f" differing {diff} (-1: exchanges apart), "
                  f"{len(runs[0][2]) + len(runs[0][3])} exchanges; K1 "
                  f"(hop, requant) {counts[0]} vs {counts[1]} (the "
                  f"schedule's {want})  {'ok' if ok else 'FAIL'}",
                  flush=True)
    check(not q8_bad, f"the q8 IR route differs on the card: {q8_bad}")

    # The IR's host cost: bench's Allreduce body at 2^26 f32 on 4 ranks
    # (default and deterministic) and phase 55's q8 bidir body at 2^24,
    # each with only the lowering swapped: the op's autograd Function on
    # the IR route against the hand-written one, both called past the
    # facade's checks, in alternating order (ABBA).
    from mpi4torch_tpu_torch.compress import spmd as cspmd

    n = IR_BENCH_RANKS
    xb = torch.ones(MODE_A_BENCH_NUMEL, device="cuda")
    q8 = get_codec("q8")

    def exact_body(route):
        def loss(v):
            ctx = spmd.current_spmd_context()
            fn = spmd._Allreduce if route == "ir" else HandWrittenAllreduce
            y = fn.apply(v, ctx, P.MPI_SUM, "ring")
            return torch.vdot(y, y)
        return lambda v: tree.value_and_grad(loss, v)

    def q8_body(route):
        def body(v):
            x = v[comm.rank].clone().requires_grad_()
            ctx = spmd.current_spmd_context()
            fn = cspmd._CompressedAllreduce if route == "ir" \
                else HandComposedQ8
            y = fn.apply(x, ctx, q8, "bidir")
            (g,) = torch.autograd.grad(torch.vdot(y, y), x)
            return y.detach(), g
        return body

    def exact_run(route, det):
        with config.deterministic_mode(det):
            return P.run_spmd(exact_body(route), nranks=n)(xb)

    stacked = torch.stack(bench_inputs())
    forms = {"exact": {r: (lambda r=r: exact_run(r, False))
                       for r in ("ir", "hand_written")},
             "exact_deterministic": {r: (lambda r=r: exact_run(r, True))
                                     for r in ("ir", "hand_written")},
             "q8_bidir": {r: (lambda r=r: P.run_spmd(
                 q8_body(r), nranks=BENCH_RANKS)(stacked))
                 for r in ("ir", "hand_written")}}
    rounds = {"exact": MODE_A_STEPS, "exact_deterministic": MODE_A_STEPS,
              "q8_bidir": IR_Q8_ROUNDS}
    bench, same, rdv_ok = {}, {}, True
    for body, pair in forms.items():
        same[body] = tree_bytes_differ(tree, pair["ir"](),
                                       pair["hand_written"]()) == 0
        rdv = {}
        for route, f in pair.items():
            with ExchangeCounter() as cnt:
                f()
            rdv[route] = cnt.exchanges
        rdv_ok = rdv_ok and rdv["ir"] == rdv["hand_written"]
        times = {route: [] for route in pair}
        order = list(pair)
        for r in range(rounds[body]):
            for route in (order if r % 2 == 0 else order[::-1]):
                times[route].append(sync_ms(pair[route])[0])
        bench[body] = {}
        for route in pair:
            t = times[route]
            bench[body][route] = {
                "ms": float(np.median(t)), "min_ms": min(t),
                "max_ms": max(t), "rendezvous": rdv[route]}
        a, b = bench[body]["ir"], bench[body]["hand_written"]
        print(f"  {body:19s}: IR route median {a['ms']:8.2f} ms (min "
              f"{a['min_ms']:.2f}, max {a['max_ms']:.2f}), hand-written "
              f"{b['ms']:8.2f} ms (min {b['min_ms']:.2f}, max "
              f"{b['max_ms']:.2f}) of {rounds[body]} alternating rounds; "
              f"IR / hand-written {a['ms'] / b['ms']:.3f}; rendezvous a step"
              f" {rdv['ir']} / {rdv['hand_written']}; bitwise alike "
              f"{same[body]}", flush=True)
    del stacked
    p50 = mode_a_bench[n]
    q8b = spmd_comp["allreduce"][("q8", "bidir")]
    print(f"  through the facade in this run (IR route): phase 50's bench "
          f"body {p50['run_spmd']['ms']:.2f} ms, deterministic "
          f"{p50['run_spmd_deterministic']['ms']:.2f} ms; phase 55's q8 "
          f"bidir {q8b['ms']:.2f} ms (run_ranks {q8b['ranks_ms']:.2f}); "
          "the hand-written route's earlier card readings (PERF.md): "
          "12.74-13.05 ms, 132.06-154.16 ms and 59.29 ms (run_ranks "
          "10.67)")
    check(all(same.values()) and rdv_ok,
          "a timed body differs between the IR route and the hand-written "
          "one")
    return {"bodies": out["bodies"], "k1": k1, "bench": bench,
            "q8_bidir_ms": q8b["ms"]}


# ---------------------------------------------------------------------------
# Phase 61: the flagship on a 2-D mesh
# ---------------------------------------------------------------------------

MESH2D = {"dp": 2, "sp": 2}
MESH2D_ATTNS = ("ring", "ulysses")
MESH2D_F32_LAYERS = 2
# f32 at 2 layers against the one-rank full-batch step on the card: the
# relative error of the loss and the norm-relative error of every updated
# leaf.  The steps take lr = GRAD_LR, so each new parameter is dominated
# by lr * g and the leaf check holds the gradient.
MESH2D_F32_RTOL = 1e-5
# ZeRO-1 with SP against one-rank Adam on the full batch: Adam's first
# update is lr * g / (|g| + eps), about lr * sign(g), so an element whose
# gradient sums to near zero may flip sign between two summation orders.
# The update (new - p, in f64) is held at MESH2D_F32_RTOL norm-relative
# only where the one-rank |g| is above this share of its leaf's largest.
MESH2D_ADAM_G_FLOOR = 1e-3
# DP x EP (phase 61): the MoE at 2 layers, 4 experts, capacity 1.25 x a
# rank's tokens / experts (batch 2 x 2048 a rank).
MESH2D_EP_LAYERS = 2
MESH2D_EP_CAPACITY = 1280


def mesh_local(P, cd, cs, ce, toks):
    """This mesh position's tokens: rows by the dp (and ep) rank, the
    sequence by the sp rank, each through its axis's symbolic rank."""
    dp, ep = cd.size, (ce.size if ce is not None else 1)
    sp = cs.size if cs is not None else 1
    bl, sl = toks.shape[0] // (dp * ep), toks.shape[1] // sp
    r_b = cd.rank * ep + ce.rank if ce is not None else cd.rank
    rows = toks.narrow(0, r_b * bl, bl)
    return rows.narrow(1, cs.rank * sl, sl) if cs is not None else rows


def mesh_step(P, T, cfg, params, tokens, attn, axes, lr, zero_opt=None):
    """One step on every position of the mesh ``axes``: ``train_step``, or
    with ``zero_opt`` a ZeRO-1 step from a fresh state; returns the
    stacked ``(loss, new_params)``."""
    from mpi4torch_tpu_torch.parallel.zero import zero_init

    mesh = P.device_mesh(axes)
    cd = P.comm_from_mesh(mesh, "dp")
    cs = P.comm_from_mesh(mesh, "sp") if "sp" in axes else None
    ce = P.comm_from_mesh(mesh, "ep") if "ep" in axes else None

    def body(p, toks):
        local = mesh_local(P, cd, cs, ce, toks)
        if zero_opt is None:
            return T.train_step(cfg, p, local, comm_sp=cs, comm_dp=cd,
                                comm_ep=ce, attn=attn, lr=lr)
        loss, new, _ = T.zero_train_step(
            cfg, p, local, zero_opt, zero_init(cd, zero_opt, p), cd,
            comm_sp=cs, attn=attn, comm_ep=ce)
        return loss, new

    return P.run_spmd(body, mesh=mesh, axis_name="dp")(params, tokens)


def mesh_replicated_adam(P, T, tree, cfg, params, tokens, attn, axes,
                         opt):
    """Replicated-DP Adam on every position of the mesh ``axes`` (dp x
    sp): each rank's gradient of its sp-averaged local loss, the dp mean
    through ``Allreduce_tree(mean=True)``, one Adam update from a fresh
    state; the form ZeRO-1 is bitwise equal to (phase 20).  Returns the
    stacked ``(loss, new_params)``."""
    from mpi4torch_tpu_torch.constants import divide
    from mpi4torch_tpu_torch.parallel import dp as dp_mod

    mesh = P.device_mesh(axes)
    cd = P.comm_from_mesh(mesh, "dp")
    cs = P.comm_from_mesh(mesh, "sp")

    def body(p, toks):
        local = mesh_local(P, cd, cs, None, toks)
        loss, g = tree.value_and_grad(lambda q: T.lm_loss(
            cfg, dp_mod.all_average_tree(cs, q), local, cs, attn), p)
        g = cd.Allreduce_tree(g, P.MPI_SUM, mean=True)
        with torch.no_grad():
            upd, _ = opt.update(g, opt.init(p), p)
            new = tree.tree_map(torch.add, p, upd)
        return divide(cd.Allreduce(loss, P.MPI_SUM, compression=False),
                      cd.size), new

    return P.run_spmd(body, mesh=mesh, axis_name="dp")(params, tokens)


def held_update_rel(tree, p, new, ref_new, g):
    """The worst leaf's ||(new - p) - (ref_new - p)|| / ||ref_new - p||
    in f64 over the elements whose |g| is above MESH2D_ADAM_G_FLOOR of
    the leaf's largest, and the share of all elements held."""
    worst, held, total = 0.0, 0, 0
    for q, x, r, gl in zip(*(tree.tree_leaves(t)
                             for t in (p, new, ref_new, g))):
        a = gl.abs()
        m = a > MESH2D_ADAM_G_FLOOR * a.max()
        q64 = q.double()[m]
        d = x.double()[m] - r.double()[m]
        u = r.double()[m] - q64
        worst = max(worst, (d.norm() / u.norm().clamp_min(1e-300)).item())
        held += int(m.sum().item())
        total += m.numel()
    return worst, held / total


def positions_identical(tree, loss, new):
    n = loss.shape[0]
    return all(torch.equal(loss[i], loss[0]) for i in range(n)) and all(
        torch.equal(t[i], t[0]) for t in tree.tree_leaves(new)
        for i in range(n))


def mesh2d_phase(P, T, tree, kernels, cfg, params, tokens, sp, dp_ms,
                 ep_ms):
    """Phase 61: the flagship's train_step on DP=2 x SP=2 (ring, Ulysses)
    and ZeRO-1 with SP on the same mesh, four rank threads under
    ``run_spmd(mesh=)``: f32 at 2 layers against the one-rank full-batch
    step, then full width bf16 (a warm step, a timed one, a profiled
    one), K2-K4 launches; DP=2 x EP=2 with the MoE at 2 layers."""
    import dataclasses

    from mpi4torch_tpu_torch.utils import optim

    n_ranks = MESH2D["dp"] * MESH2D["sp"]
    res = {"launches": {}, "ms": {}, "tokens_s": {}, "idle_pct": {},
           "f32_rel": {}, "rendezvous": {}}
    # f32 at 2 layers against one rank.
    c2 = dataclasses.replace(cfg, n_layers=MESH2D_F32_LAYERS)
    p32 = tree.tree_map(lambda t: t.float(), dict(
        params, blocks=params["blocks"][:MESH2D_F32_LAYERS]))
    ref_l, ref_p = T.train_step(c2, p32, tokens, lr=GRAD_LR)
    for form in MESH2D_ATTNS:
        loss, new = mesh_step(P, T, c2, p32, tokens, form, MESH2D, GRAD_LR)
        same = positions_identical(tree, loss, new)
        rel_l = abs(loss[0].item() - ref_l.item()) / abs(ref_l.item())
        worst = norm_rel(tree, tree.tree_map(lambda t: t[0], new), ref_p)
        res["f32_rel"][form] = max(rel_l, worst)
        ok = same and rel_l <= MESH2D_F32_RTOL and worst <= MESH2D_F32_RTOL
        print(f"  f32, {MESH2D_F32_LAYERS} layers, DP=2 x SP=2 {form:10s}: "
              f"loss {loss[0].item():.6f} vs one rank at batch "
              f"{TRAIN_BATCH} {ref_l.item():.6f} (rel {rel_l:.2e}); worst "
              f"updated leaf's norm-relative error {worst:.2e} (tol "
              f"{MESH2D_F32_RTOL:g}, lr {GRAD_LR:g}); the {n_ranks} mesh "
              f"positions bitwise identical {same}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"the f32 2-D mesh step ({form}) disagrees with one rank")
        del loss, new
    del ref_p
    # ZeRO-1 with SP: bitwise replicated-DP Adam on the same mesh, and
    # one-rank Adam on the full batch where |g| is well above rounding
    # (MESH2D_ADAM_G_FLOOR); the loss against the one-rank step's.
    adam = optim.adam(ADAM_LR)
    loss, new = mesh_step(P, T, c2, p32, tokens, "ring", MESH2D, None,
                          zero_opt=adam)
    r_loss, r_new = mesh_replicated_adam(P, T, tree, c2, p32, tokens,
                                         "ring", MESH2D, adam)
    same = positions_identical(tree, loss, new)
    rel_l = abs(loss[0].item() - ref_l.item()) / abs(ref_l.item())
    diff = tree_bytes_differ(tree, (loss, new), (r_loss, r_new))
    del r_loss, r_new
    _, g1 = tree.value_and_grad(lambda q: T.lm_loss(c2, q, tokens), p32)
    with torch.no_grad():
        upd, _ = adam.update(g1, adam.init(p32), p32)
        one_new = tree.tree_map(torch.add, p32, upd)
    del upd
    worst, held = held_update_rel(
        tree, p32, tree.tree_map(lambda t: t[0], new), one_new, g1)
    del g1, one_new
    res["f32_rel"]["zero1_ring"] = max(rel_l, worst)
    ok = (same and rel_l <= MESH2D_F32_RTOL and diff == 0
          and worst <= MESH2D_F32_RTOL)
    print(f"  f32, {MESH2D_F32_LAYERS} layers, DP=2 x SP=2 ZeRO-1 (Adam, lr "
          f"{ADAM_LR:g}): loss {loss[0].item():.6f} vs one rank "
          f"{ref_l.item():.6f} (rel {rel_l:.2e}); loss and parameters, bytes "
          f"differing from replicated-DP Adam on the mesh: {diff}; the "
          f"update against one-rank Adam on the full batch, worst leaf's "
          f"norm-relative error {worst:.2e} (tol {MESH2D_F32_RTOL:g}) over "
          f"the {100 * held:.2f}% of elements whose |g| is above "
          f"{MESH2D_ADAM_G_FLOOR:g} of its leaf's largest; positions "
          f"bitwise identical {same}  {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "the f32 2-D mesh ZeRO-1 step disagrees")
    del loss, new, p32

    # Full width, bf16.
    adam_bf16 = optim.adam(ADAM_LR)
    for form in MESH2D_ATTNS + ("zero1_ring",):
        attn = "ring" if form == "zero1_ring" else form
        opt = adam_bf16 if form == "zero1_ring" else None

        def step():
            return mesh_step(P, T, cfg, params, tokens, attn, MESH2D, LR,
                             zero_opt=opt)

        sync_ms(step)                                   # warm
        kernels.reset_launch_counts()
        with ExchangeCounter() as cnt:
            ms, (loss, new) = sync_ms(step)
        counts, all_tc = attention_counts(kernels, kernels.launch_counts)
        res["rendezvous"][form] = (cnt.exchanges, cnt.sends)
        same = positions_identical(tree, loss, new)
        if opt is not None:
            # ZeRO-1 at full width: bitwise replicated-DP Adam.
            r_out = mesh_replicated_adam(P, T, tree, cfg, params, tokens,
                                         attn, MESH2D, opt)
            same = same and tree_bytes_differ(tree, (loss, new), r_out) == 0
            del r_out
        del new
        wall, busy, _ = profile_top(step, f"one DP=2 x SP=2 {form} step",
                                    n_top=4)
        idle = 100 - 100 * busy / wall
        blocks, off, masked = SP_BLOCKS[attn]
        want = (MESH2D["dp"] * cfg.n_layers * blocks,
                MESH2D["dp"] * cfg.n_layers * off,
                MESH2D["dp"] * cfg.n_layers * masked)
        counts_ok = all_tc and all(c == want for c in counts.values())
        res["launches"][form] = counts
        res["ms"][form] = ms
        res["tokens_s"][form] = TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3)
        res["idle_pct"][form] = idle
        sp_ms = sp["ms"].get(attn)
        ok = same and counts_ok and np.isfinite(loss[0].float().item())
        print(f"  bf16 full width, DP=2 x SP=2 {form:10s}: step {ms:.1f} ms "
              f"({res['tokens_s'][form]:.0f} tokens/s at {TRAIN_BATCH} x "
              f"{TRAIN_SEQ}); rank 0's rendezvous and p2p sends a step "
              f"{res['rendezvous'][form]}; device idle {idle:.1f}% of the "
              f"profiled step;"
              f" phase 24's SP=2 {attn} step {sp_ms:.1f} ms and phase 9's "
              f"DP=2 step {dp_ms:.1f} ms in this run; loss "
              f"{loss[0].float().item():.4f}; launches (all, offset, "
              f"masked) {counts} (expected {want} each), all tc {all_tc}; "
              f"the {n_ranks} mesh positions bitwise identical"
              + (" and bitwise replicated-DP Adam" if opt is not None
                 else "") + f" {same}  {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"the 2-D mesh step ({form}) failed a check")
        del loss

    # DP=2 x EP=2 with the MoE at 2 layers: f32 against the replicated
    # dense-expert form, then bf16 steps.
    mcfg = dataclasses.replace(cfg, n_layers=MESH2D_EP_LAYERS,
                               n_experts=EP_EXPERTS,
                               capacity=MESH2D_EP_CAPACITY)
    mparams = T.init_transformer(0, mcfg, torch.bfloat16, device="cuda")
    axes = {"dp": 2, "ep": 2}
    shards = 4
    bl = TRAIN_BATCH // shards
    m32 = tree.tree_map(lambda t: t.float(), mparams)
    rl, rg = tree.value_and_grad(lambda q: sum(
        T.lm_loss(mcfg, q, tokens[r * bl:(r + 1) * bl])
        for r in range(shards)) / shards, m32)
    with torch.no_grad():
        rp = tree.tree_map(lambda p, g: p - GRAD_LR * g, m32, rg)
    del rg
    loss, new = mesh_step(P, T, mcfg, m32, tokens, "ring", axes, GRAD_LR)
    same32 = positions_identical(tree, loss, new)
    rel_l = abs(loss[0].item() - rl.item()) / rl.item()
    worst = norm_rel(tree, tree.tree_map(lambda t: t[0], new), rp)
    res["f32_rel"]["dp_ep"] = max(rel_l, worst)
    del new, rp, m32
    ok32 = same32 and rel_l <= SP_F32_REL and worst <= SP_F32_REL
    print(f"  f32, {MESH2D_EP_LAYERS} layers, DP=2 x EP=2 MoE ("
          f"{EP_EXPERTS} experts, capacity {MESH2D_EP_CAPACITY}): loss "
          f"{loss[0].item():.6f} vs the replicated dense-expert mean over "
          f"{shards} shards {rl.item():.6f} (rel {rel_l:.2e}); worst updated "
          f"leaf's norm-relative error {worst:.2e} (tol {SP_F32_REL:g}, "
          f"phase 26's bound); positions bitwise identical {same32}  "
          f"{'ok' if ok32 else 'FAIL'}", flush=True)
    check(ok32, "the f32 DP x EP step disagrees with the replicated form")

    def ep_step():
        return mesh_step(P, T, mcfg, mparams, tokens, "ring", axes, LR)

    sync_ms(ep_step)
    kernels.reset_launch_counts()
    ms, (loss, new) = sync_ms(ep_step)
    counts, all_tc = attention_counts(kernels, kernels.launch_counts)
    same = positions_identical(tree, loss, new)
    del new, mparams
    want = (shards * MESH2D_EP_LAYERS, 0, 0)
    ok = same and all_tc and all(c == want for c in counts.values())
    res["launches"]["dp_ep"] = counts
    res["ms"]["dp_ep"] = ms
    print(f"  bf16 full width at {MESH2D_EP_LAYERS} layers, DP=2 x EP=2 "
          f"MoE: step {ms:.1f} ms (phase 26's EP=2 step at "
          f"{cfg.n_layers} layers {ep_ms:.1f} ms); launches {counts} "
          f"(expected {want} each), all tc {all_tc}; positions bitwise "
          f"identical {same}  {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "the DP x EP step failed a check")
    return res


# ---------------------------------------------------------------------------
# Phase 62: algorithm selection, the autotuner and schedule synthesis
# ---------------------------------------------------------------------------

# The phase's tune cache (git-ignored), never the user's ~/.cache.
TUNE_OUT = os.path.join("smoke_out", "tune")
TUNE_RANKS = 4                  # the sweep's rank threads
TUNE_DEVICE = "cuda"            # B's fresh process tunes for the card
TUNE_ITERS = 5                  # min of 5 a size and algorithm
SYNTH_RANKS = 8
SYNTH_SIZES = (1 << 10, 1 << 14, 1 << 18)
# E: a skewed three-tier stack, the outer tier 32x slower than the inner.
TIER_STACK, TIER_BANDWIDTHS = (2, 2, 2), (100.0, 25.0, 3.125)
TIER_NUMEL = 1 << 12            # 16 KiB of float32 a rank: a swept bucket
# C: bench's Allreduce body at phase 50's size (past the swept sizes: the
# crossovers decide) and at the largest swept size (the cache decides).
TUNE_BENCH_NUMELS = (MODE_A_BENCH_NUMEL, 1 << 24)


class SelectorLog:
    """Records every ``tune.select_auto`` pick while entered:
    ``{(nbytes, nranks, deterministic, codec): algorithm}``."""

    def __init__(self, tune):
        self._tune = tune
        self.picks = {}

    def __enter__(self):
        tune, picks = self._tune, self.picks
        self._saved = saved = tune.select_auto

        def select_auto(**kw):
            algo = saved(**kw)
            codec = kw.get("codec")
            picks[(kw["nbytes"], kw["nranks"], kw.get("deterministic"),
                   None if codec is None else codec.name)] = algo
            return algo

        tune.select_auto = select_auto
        return self

    def __exit__(self, *exc):
        self._tune.select_auto = self._saved
        return False


def spmd_value_grad(P, n, rows, w, **kw):
    """Value and gradient from outside of one Allreduce under
    ``run_spmd(nranks=n)``: each rank reduces its row of ``rows``; the
    loss is ``sum(out * w)``.  Returns (value, gradient, forward
    exchanges)."""
    x = rows.detach().clone().requires_grad_()

    def body(v):
        return P.COMM_WORLD.Allreduce(v[P.COMM_WORLD.rank], P.MPI_SUM, **kw)

    with ExchangeCounter() as cnt:
        out = P.run_spmd(body, nranks=n)(x)
    (g,) = torch.autograd.grad((out * w).sum(), x)
    return out.detach(), g, cnt.exchanges


def ranks_value_grad(P, n, rows, w, **kw):
    """The same Allreduce and gradient on ``run_ranks`` (Mode B)."""
    def body(r):
        x = rows[r].detach().clone().requires_grad_()
        y = P.COMM_WORLD.Allreduce(x, P.MPI_SUM, **kw)
        (g,) = torch.autograd.grad((y * w[r]).sum(), x)
        return y.detach(), g

    res = P.run_ranks(body, n, device="cuda")
    return torch.stack([r[0] for r in res]), torch.stack([r[1] for r in res])


def tune_sweep(P, tune, kernels, config):
    """A: the sweep, with K1's launches during its q8 leg held to the
    count the per-call launches of each q8 candidate imply."""
    from mpi4torch_tpu_torch.compress import codec_applicable, get_codec

    q8 = get_codec("q8")
    sizes = tune.autotuner.DEFAULT_SIZES
    q8_algos = [a for a in tune.available_algorithms()
                if tune.get_algorithm(a).applicable(TUNE_RANKS)
                and codec_applicable(q8, torch.float32, algorithm=a)]
    per_call = {}
    for nbytes in sizes:
        x = torch.ones(nbytes // 4, device="cuda")
        for a in q8_algos:
            kernels.reset_launch_counts()
            P.run_spmd(lambda v, a=a: P.COMM_WORLD.Allreduce(
                v, P.MPI_SUM, compression="q8", algorithm=a),
                nranks=TUNE_RANKS)(x)
            per_call[(nbytes, a)] = kernels.launch_counts["q8_hop"]
        del x
    want = (2 + TUNE_ITERS) * sum(per_call.values())
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rep = tune.autotune_allreduce(nranks=TUNE_RANKS, codecs=(None, "q8"),
                                  iters=TUNE_ITERS)
    secs = time.perf_counter() - t0
    hops = kernels.launch_counts["q8_hop"]
    for size, ent in rep["entries"].items():
        for label, e in (("exact", ent), ("q8", ent["codecs"]["q8"])):
            cells = ", ".join(
                f"{a} {v['seconds_per_step'] * 1e3:.3f}"
                if "seconds_per_step" in v else f"{a} {v['error']}"
                for a, v in e["algorithms"].items())
            print(f"  {int(size):>9d} B {label:5s}: min ms of {TUNE_ITERS}: "
                  f"{cells}; winner {e.get('winner')}", flush=True)
    print(f"  latency crossover {rep['crossover_bytes']}, bandwidth "
          f"crossover {rep['bandwidth_crossover_bytes']} (applied to the "
          f"config); sweep {secs:.1f} s on {TUNE_RANKS} rank threads of one "
          f"card; K1 q8_hop launches during the q8 sweep {hops} (the "
          f"candidates' per-call launches x {2 + TUNE_ITERS} calls: {want})")
    errors = [(s, a) for s, ent in rep["entries"].items()
              for e in (ent, ent["codecs"]["q8"])
              for a, v in e["algorithms"].items() if "error" in v]
    check(not errors, f"sweep candidates failed: {errors}")
    check(hops == want > 0, "the q8 sweep's K1 launches differ from the "
          "count its calls imply")
    check(config.latency_crossover_bytes() == rep["crossover_bytes"]
          and config.bandwidth_crossover_bytes()
          == rep["bandwidth_crossover_bytes"],
          "the sweep did not apply its crossovers")
    return rep, secs, hops


def tune_round_trip(rep, cache):
    """B: a fresh process with the same cache serves the sweep's winners
    from the file, with no rendezvous; the cache CLI prints them."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    sizes = tuple(int(k) for k in rep["entries"])
    code = (
        "import json\n"
        "from mpi4torch_tpu_torch import runtime, tune\n"
        "n = [0]\n"
        "saved = runtime.World.exchange\n"
        "def exchange(w, rank, sig, *a, **k):\n"
        "    n[0] += 1\n"
        "    return saved(w, rank, sig, *a, **k)\n"
        "runtime.World.exchange = exchange\n"
        f"rep = tune.ensure_tuned_allreduce(sizes={sizes!r}, "
        f"nranks={TUNE_RANKS}, device={TUNE_DEVICE!r})\n"
        "print(json.dumps({'tuned_from_cache': rep['tuned_from_cache'],"
        " 'from_disk': rep.get('from_disk'), 'rendezvous': n[0],"
        " 'winners': {k: v['winner'] for k, v in rep['entries'].items()},"
        " 'crossover_bytes': rep['crossover_bytes'],"
        " 'bandwidth_crossover_bytes': rep['bandwidth_crossover_bytes']}))\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=root, env=env)
    if proc.returncode:
        print(proc.stderr[-4000:])
    check(proc.returncode == 0, "the cache round trip's process failed")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    want = {k: v["winner"] for k, v in rep["entries"].items()}
    ok = (got["tuned_from_cache"] and got["from_disk"]
          and got["winners"] == want and got["rendezvous"] == 0
          and got["crossover_bytes"] == rep["crossover_bytes"]
          and got["bandwidth_crossover_bytes"]
          == rep["bandwidth_crossover_bytes"])
    print(f"  a fresh process on {cache}: {got} in "
          f"{time.perf_counter() - t0:.1f} s  {'ok' if ok else 'FAIL'}")
    check(ok, "the fresh process did not serve the sweep's winners from "
          "the file without rendezvous")
    proc = subprocess.run([sys.executable, "-m", "mpi4torch_tpu_torch.tune",
                           "--show"], capture_output=True, text=True,
                          timeout=120, cwd=root, env=env)
    for line in proc.stdout.splitlines():
        print("    " + line)
    print(f"  python -m mpi4torch_tpu_torch.tune --show: exit "
          f"{proc.returncode}")
    check(proc.returncode == 0, "the cache CLI failed")


def tune_selection(P, T, tree, dp, tune, kernels, config, cfg, params,
                   tokens, rep):
    """C: auto selection on the main path: bench's Allreduce body bitwise
    its explicit pick with the same exchanges; the flagship's fused DP=2
    step under run_spmd tuned against untuned; scopes in the rank body."""
    comm = P.COMM_WORLD
    res = {}
    for numel in TUNE_BENCH_NUMELS:
        x = torch.ones(numel, device="cuda")
        pick = tune.select_auto(nbytes=numel * 4, dtype=torch.float32,
                                nranks=TUNE_RANKS)

        def body(v, algo=None):
            def loss(u):
                y = comm.Allreduce(u, P.MPI_SUM, algorithm=algo)
                return torch.vdot(y, y)
            return tree.value_and_grad(loss, v)

        runs = {}
        for label, algo in (("auto", None), ("explicit", pick)):
            def call(algo=algo):
                return P.run_spmd(lambda v: body(v, algo),
                                  nranks=TUNE_RANKS)(x)
            call()      # warm: the first call grows the allocator
            with ExchangeCounter() as cnt:
                ms, out = sync_ms(call)
            runs[label] = (out, cnt.exchanges, ms)
        same = tree_bytes_differ(tree, runs["auto"][0],
                                 runs["explicit"][0]) == 0
        winner = rep["entries"].get(str(numel * 4), {}).get("winner")
        ok = same and runs["auto"][1] == runs["explicit"][1] and (
            winner is None or winner == pick)
        print(f"  bench's Allreduce body at {TUNE_RANKS} x {numel} float32: "
              f"auto picks {pick!r} (the sweep's winner at this size: "
              f"{winner}); value and gradient bitwise algorithm={pick!r}: "
              f"{same}; rendezvous {runs['auto'][1]} / "
              f"{runs['explicit'][1]}; ms {runs['auto'][2]:.2f} / "
              f"{runs['explicit'][2]:.2f}  {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"auto selection at {numel} float32 differs from its "
              "explicit pick")
        res[numel] = {"pick": pick, "rendezvous": runs["auto"][1]}
        del runs, x

    rows = TRAIN_BATCH // 2

    def step(p, x):
        loss, g = dp.dp_value_and_grad(
            comm, lambda p_, x_: T.lm_loss(cfg, p_, x_))(p, x)
        with torch.no_grad():
            return loss, tree.tree_map(lambda a, b: a - LR * b, p, g)

    def spmd_body(p, toks):
        idx = comm.rank * rows + torch.arange(rows, device=toks.device)
        return step(p, toks.index_select(0, idx))

    tuned_x = (config.latency_crossover_bytes(),
               config.bandwidth_crossover_bytes())

    def dp2(tuned):
        x = tuned_x if tuned else (None, None)
        config.set_latency_crossover_bytes(x[0])
        config.set_bandwidth_crossover_bytes(x[1])
        t, (loss, new) = sync_ms(lambda: P.run_spmd(
            spmd_body, nranks=2)(params, tokens))
        same = torch.equal(loss[0], loss[1]) and leaves_equal(
            tree, tree.tree_map(lambda t: t[0], new),
            tree.tree_map(lambda t: t[1], new))
        return float(loss[0]), t, same

    # Untuned (no crossovers; the cache holds no 2-rank winner) and tuned
    # steps in the order U T T U after a warm untuned step; the tuned
    # steps' attention launches and selector picks are recorded.
    runs = {False: [], True: []}
    launches = {}
    log = SelectorLog(tune)
    dp2(False)
    for tuned in (False, True, True, False):
        kernels.reset_launch_counts()
        if tuned:
            with log:
                runs[True].append(dp2(True))
            for k, v in kernels.launch_counts.items():
                launches[k] = launches.get(k, 0) + v
        else:
            runs[False].append(dp2(False))
    config.set_latency_crossover_bytes(tuned_x[0])
    config.set_bandwidth_crossover_bytes(tuned_x[1])
    base, tuned = ((r[0][0], min(x[1] for x in r), all(x[2] for x in r))
                   for r in (runs[False], runs[True]))
    picks = {}
    for (nbytes, n, _det, codec), algo in sorted(log.picks.items()):
        if n == 2 and codec is None:
            picks.setdefault(algo, []).append(nbytes)
    want = 2 * 2 * cfg.n_layers
    ok = (base[2] and tuned[2] and abs(tuned[0] - base[0]) <= LOSS_TOL
          and all(launches[k] == launches[f"{k}.tc"] == want
                  for k in kernels.ATTENTION_KERNELS))
    print(f"  the flagship's fused DP=2 step under run_spmd (4 MiB "
          f"buckets, bf16): tuned picks by payload bytes "
          + "; ".join(f"{a}: {len(v)} sizes {min(v)}-{max(v)} B"
                      for a, v in picks.items())
          + f"; step {tuned[1]:.1f} ms tuned vs {base[1]:.1f} ms untuned "
          f"(the faster of two each, U T T U); "
          f"ranks bitwise alike {tuned[2]} / {base[2]}; loss "
          f"{tuned[0]:.4f} vs {base[0]:.4f} (tol {LOSS_TOL}); attention "
          f"launches of the two tuned steps "
          + ", ".join(f"{k} {launches[k]} (tc {launches[k + '.tc']})"
                      for k in kernels.ATTENTION_KERNELS)
          + f" (expected {want} each)  {'ok' if ok else 'FAIL'}",
          flush=True)
    check(ok, "the tuned DP=2 step failed a check")
    res["dp2"] = {"ms": tuned[1], "untuned_ms": base[1],
                  "launches": launches,
                  "picks": {a: sorted(v) for a, v in picks.items()}}

    def scoped(n, scope=None, algo=None):
        def body(v):
            if scope is None:
                return comm.Allreduce(v, P.MPI_SUM, algorithm=algo)
            with config.algorithm_scope(scope):
                return comm.Allreduce(v, P.MPI_SUM, algorithm=algo)

        with ExchangeCounter() as cnt:
            out = P.run_spmd(body, nranks=n)(torch.ones(1024,
                                                        device="cuda"))
        return out, cnt.exchanges

    c = {"auto": scoped(4)[1], "rhd": scoped(4, algo="rhd")[1],
         "scope_rhd": scoped(4, scope="rhd")[1],
         "auto_3": scoped(3)[1], "scope_rhd_3": scoped(3, scope="rhd")[1],
         "scope_tree": scoped(4, scope="tree")[1],
         "tree": scoped(4, algo="tree")[1]}
    try:
        scoped(3, algo="rhd")
        raised = None
    except P.CommError as e:
        raised = str(e)[:60]
    ok = (c["scope_rhd"] == c["rhd"] and c["scope_tree"] == c["tree"]
          and c["scope_rhd_3"] == c["auto_3"] and raised is not None)
    print(f"  algorithm_scope in the rank body, rendezvous on 4 / 3 ranks: "
          f"{c}; algorithm='rhd' on 3 ranks raises CommError: "
          f"{raised!r}  {'ok' if ok else 'FAIL'}")
    check(ok, "an algorithm scope did not take, or did not degrade")
    return res


def tune_synthesis(P, tune, csched, kernels, config):
    """D: the synthesis leg; a deterministic auto Allreduce on eight rank
    threads takes the recorded winner at each size, bitwise the
    interpreter and Mode B in value and gradient, with its census's
    exchanges."""
    rep = csched.autotune_synthesis(nranks=SYNTH_RANKS, sizes=SYNTH_SIZES)
    out = {}
    g = torch.Generator(device="cuda").manual_seed(62)
    for nbytes in SYNTH_SIZES:
        ent = rep["entries"][str(nbytes)]
        name = ent["winner"]
        prog = csched.installed_program(name, SYNTH_RANKS)
        numel = nbytes // 4
        rows = torch.randn(SYNTH_RANKS, numel, device="cuda", generator=g)
        w = torch.randn(SYNTH_RANKS, numel, device="cuda", generator=g)
        with config.deterministic_mode(True), SelectorLog(tune) as log:
            val, grad, fwd = spmd_value_grad(P, SYNTH_RANKS, rows, w)
        picks = set(log.picks.values())
        oracle = csched.interpret_allreduce(prog, P.MPI_SUM, list(rows))
        goracle = csched.interpret_allreduce(csched.transpose(prog),
                                             P.MPI_SUM, list(w))
        bval, bgrad = ranks_value_grad(P, SYNTH_RANKS, rows, w,
                                       algorithm=name)
        census = sum(csched.program_census(prog, numel, 4)["hlo"].values())
        ok = (ent.get("recorded") and picks == {name}
              and all(torch.equal(val[r], oracle)
                      and torch.equal(grad[r], goracle)
                      and torch.equal(bval[r], oracle)
                      and torch.equal(bgrad[r], goracle)
                      for r in range(SYNTH_RANKS))
              and fwd == census)
        print(f"  {nbytes:>7d} B: recorded {name} (chain {ent['chain']}, "
              f"wire {ent['census']['wire_bytes_per_rank']} B a rank vs the "
              f"ordered ring's {ent['ring_census']['wire_bytes_per_rank']}); "
              f"deterministic auto picked {sorted(picks)}; value and "
              f"gradient bitwise the interpreter and run_ranks; forward "
              f"rendezvous {fwd} (census {census})  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"the synthesized Allreduce at {nbytes} B failed a check")
        out[nbytes] = {"winner": name, "rendezvous": fwd}
    return out


def tune_tiers(P, tune, csched, overlap, kernels, config):
    """E: tier synthesis on a skewed stack: the exact and the q8-slow
    winners, each named explicitly, bitwise their interpretation; K1's
    requant launches those of the q8-slow program's q8_level_fold steps;
    the tier window."""
    config.set_tier_stack(TIER_STACK)
    config.set_tier_bandwidths(TIER_BANDWIDTHS)
    rep = csched.autotune_tier_synthesis(nranks=SYNTH_RANKS)
    ent = rep["entries"][str(TIER_NUMEL * 4)]
    g = torch.Generator(device="cuda").manual_seed(63)
    rows = torch.randn(SYNTH_RANKS, TIER_NUMEL, device="cuda", generator=g)
    w = torch.randn(SYNTH_RANKS, TIER_NUMEL, device="cuda", generator=g)
    out = {}
    for label, name in (("exact", ent["exact_winner"]),
                        ("q8-slow", ent["winner"])):
        prog = csched.installed_program(name, SYNTH_RANKS)
        q8_steps = sum(s.kind == "q8_level_fold" for ph in prog.phases
                       for s in ph.steps)
        kernels.reset_launch_counts()
        val, grad, fwd = spmd_value_grad(P, SYNTH_RANKS, rows, w,
                                         algorithm=name)
        requant = kernels.launch_counts["q8_requant"]
        oracle = csched.interpret_allreduce(prog, P.MPI_SUM, list(rows))
        goracle = csched.interpret_allreduce(csched.transpose(prog),
                                             P.MPI_SUM, list(w))
        want = 2 * SYNTH_RANKS * q8_steps
        ok = (all(torch.equal(val[r], oracle) and torch.equal(grad[r],
                                                               goracle)
                  for r in range(SYNTH_RANKS)) and requant == want)
        print(f"  {label:7s} {name}: q8_level_fold steps {q8_steps}; "
              f"value and gradient "
              f"bitwise the interpreter; K1 q8_requant launches {requant} "
              f"(2 x {SYNTH_RANKS} ranks x {q8_steps}: {want}); forward "
              f"rendezvous {fwd}  {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"the {label} tier winner failed a check")
        out[label] = {"winner": name, "requant": requant}
    depth = overlap.tier_window_depth()
    want = int(-(-max(TIER_BANDWIDTHS) // min(TIER_BANDWIDTHS))) + 1
    print(f"  weighted cost {ent['weighted_cost']:.1f} ({ent['composition']}"
          f") and {ent['exact_weighted_cost']:.1f} (exact) against flat "
          f"bidir's {ent['bidir_weighted_cost']:.1f}, tier wire "
          f"{ent['tier_wire']} vs {ent['bidir_tier_wire']}; "
          f"overlap.tier_window_depth() = {depth} (ceil(max/min) + 1 = "
          f"{want})")
    check(ent["beats_bidir"] and ent["composition"] == "q8-slow"
          and depth == want, "the tier synthesis verdict or the tier "
          "window is off")
    config.set_tier_stack(None)
    config.set_tier_bandwidths(None)
    return out


def tune_serving(P, serve, tune, kernels, config, cfg, params, prompts):
    """F: serving's latency report and the SPMD TP=2 dense greedy engine
    under tuned selection against the untuned run."""
    scfg = serve.ServeConfig(slots=SLOTS, max_new=TP2_MAX_NEW)
    report = serve.latency_report(cfg, scfg, 2, dtype=torch.bfloat16)
    print(f"  latency_report at TP=2: {report}")
    reqs = prompts[:TP2_REQUESTS]

    def run():
        with torch.no_grad():
            eng = serve.Engine(cfg, params, scfg, spmd=True, nranks=2)
            res, _, dec_ms, dec_tok, _, _, _ = drive_engine(
                eng, reqs, [None] * len(reqs))
        return ([res[i].tolist() for i in range(len(reqs))],
                dec_tok / (dec_ms / 1e3) if dec_ms else float("nan"))

    with SelectorLog(tune) as log:
        tuned, rate = run()
    picks = sorted({a for (_b, n, _d, _c), a in log.picks.items() if n == 2})
    x = (config.latency_crossover_bytes(), config.bandwidth_crossover_bytes())
    config.set_latency_crossover_bytes(None)
    config.set_bandwidth_crossover_bytes(None)
    base, base_rate = run()
    config.set_latency_crossover_bytes(x[0])
    config.set_bandwidth_crossover_bytes(x[1])
    ok = tuned == base
    print(f"  Engine(spmd=True, nranks=2) dense greedy, {len(reqs)} "
          f"requests: tuned picks {picks}; tokens identical to the "
          f"untuned run {ok}; decode {rate:.1f} tokens/s tuned, "
          f"{base_rate:.1f} untuned  {'ok' if ok else 'FAIL'}")
    check(ok, "tuned selection changed the served tokens")
    return {"report": report, "tok_s": rate, "untuned_tok_s": base_rate,
            "picks": picks}


def tune_phase(P, T, tree, dp, serve, kernels, config, cfg, params, tokens,
               prompts):
    """Phase 62 (A-F) under its own cache file, the process state saved
    before and restored after, so later phases see the default knobs."""
    from mpi4torch_tpu_torch import csched, overlap, tune
    from mpi4torch_tpu_torch.csched import synth

    state = config.snapshot_process_state()
    installed = synth.installed()
    env = tune.autotuner.CACHE_ENV
    saved_env = os.environ.get(env)
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, TUNE_OUT), exist_ok=True)
    cache = os.path.join(root, TUNE_OUT, "tune_cache.json")
    for f in (cache, cache + ".lock"):
        if os.path.exists(f):
            os.remove(f)
    os.environ[env] = cache
    tune.clear()
    out = {}
    try:
        t0 = time.perf_counter()
        print("  A. the sweep", flush=True)
        rep, out["sweep_s"], out["q8_hop"] = tune_sweep(P, tune, kernels,
                                                        config)
        print("  B. the cache round trip", flush=True)
        tune_round_trip(rep, cache)
        print("  C. selection on the main path", flush=True)
        out["selection"] = tune_selection(P, T, tree, dp, tune, kernels,
                                          config, cfg, params, tokens, rep)
        print("  D. synthesis in deterministic mode", flush=True)
        out["synth"] = tune_synthesis(P, tune, csched, kernels, config)
        print("  E. tier synthesis", flush=True)
        out["tiers"] = tune_tiers(P, tune, csched, overlap, kernels, config)
        print("  F. serving", flush=True)
        out["serve"] = tune_serving(P, serve, tune, kernels, config, cfg,
                                    params, prompts)
        out["winners"] = {k: v.get("winner")
                          for k, v in rep["entries"].items()}
        out["crossovers"] = (rep["crossover_bytes"],
                             rep["bandwidth_crossover_bytes"])
        print(f"  phase 62 A-F in {time.perf_counter() - t0:.1f} s")
    finally:
        config.apply_process_state(state)
        synth.restore_installed(installed)
        if saved_env is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = saved_env
        tune.clear()
    return out



# ---------------------------------------------------------------------------
# Phase 63: the elastic runtime, degraded mode, the chaos matrix and the
# self-tuning controller on the card (legs A-F).
# ---------------------------------------------------------------------------

ELASTIC_PROBE_S = 0.6           # consensus probe timeout (JAX's matrix)
ELASTIC_W, ELASTIC_M = 4, 2     # leg A: (4,) -> (2,) ZeRO-1 drain
SPARE_DATA = 2                  # leg B: 2 data ranks + 1 hot spare
SERVE_W = 4                     # leg C: TP=4 -> TP=2 serving
SERVE_NEW = 16                  # leg C: tokens a request
SERVE_STEPS = 3                 # leg C: steps before the preemption
DETECT_MIN_FLOOR_S = 2e-3       # leg D: the detector's floor, at least
FAILOVER_RANKS, FAILOVER_SLOW = 4, 2    # leg D: bench.py's Allreduce size
ELASTIC_FAST = [("preempt", "plain", "shrink"),
                ("rank_death", "plain", "spare"),
                ("preempt", "zero", "shrink"),
                ("rank_death", "moe", "shrink")]
CHAOS_FAST = [("slow_rank", "plain"), ("jitter", "plain"),
              ("flaky_link", "overlap"), ("flaky_link", "plain")]
RECORD_KEYS = ("kind", "subsystem", "action", "expected", "status", "fired",
               "fallback", "epoch", "algorithm", "slots")


class WireCounter(ExchangeCounter):
    """:class:`ExchangeCounter` that also sums the payload bytes rank 0
    deposits at its rendezvous (``obs.events.payload_nbytes``)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __enter__(self):
        from mpi4torch_tpu_torch.obs.events import payload_nbytes

        super().__enter__()
        counted = self._world.exchange
        counter = self

        def exchange(w, rank, signature, payload, *a, **kw):
            if rank == 0:
                counter.bytes += payload_nbytes(payload)
            return counted(w, rank, signature, payload, *a, **kw)

        self._world.exchange = exchange
        return self


def rank_rows(tokens, pos, n):
    rows = TRAIN_BATCH // n
    return tokens[pos * rows:(pos + 1) * rows]


def to_host(x):
    """``x`` with every tensor copied to the host (dicts, lists, tuples
    and named tuples such as ``AdamState`` kept)."""
    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return type(x)(*(to_host(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x


def adam_state_equal(tree, a, b):
    return a.count == b.count and leaves_equal(tree, a.mu, b.mu) \
        and leaves_equal(tree, a.nu, b.nu)


def gathered_slice(tree, shards, template, size, pos):
    """The ZeRO flat shard ``pos`` of a ``size``-way deal of the state
    gathered from ``shards`` (one shard tree a rank, any world size)."""
    def one(tmpl, *parts):
        n = tmpl.numel()
        flat = torch.cat(parts)[:n]
        per = -(-n // size)
        flat = torch.nn.functional.pad(flat, (0, per * size - n))
        return flat[pos * per:(pos + 1) * per].clone()
    return tree.tree_map(one, template, *shards)


def elastic_drain_leg(P, T, tree, kernels, cfg, params, tokens):
    """A. Preempt -> planned drain of ZeRO-1 training: one step on (4,),
    a preempt notice on id 3, ``drain(leaving=[2, 3])`` re-laying the Adam
    shards with ``replan_zero``, one step on (2,): the drained shards are
    bitwise the slices of the gathered pre-drain state, and the next step
    bitwise a fresh ZeRO-1 DP=2 step from that state."""
    from mpi4torch_tpu_torch import elastic as E
    from mpi4torch_tpu_torch.parallel import zero as Z
    from mpi4torch_tpu_torch.reshard import plan_resize
    from mpi4torch_tpu_torch.resilience import FaultSpec, fault_scope
    from mpi4torch_tpu_torch.utils import optim

    opt = optim.adam(ADAM_LR)
    rt = E.ElasticRuntime(ELASTIC_W, probe_timeout=ELASTIC_PROBE_S,
                          device="cuda")
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()

    def step1(pos, rid):
        st = Z.zero_init(P.COMM_WORLD, opt, params)
        _, p, st = T.zero_train_step(cfg, params, rank_rows(
            tokens, pos, ELASTIC_W), opt, st, P.COMM_WORLD)
        return (p if pos == 0 else tree.tree_leaves(p)[0].clone()), st

    spec = FaultSpec("preempt", rank=3, op=None, index=0, count=100_000)
    with fault_scope([spec]) as plan:
        res1 = rt.run_phase(step1)
        notices = rt.pending_preemptions()
        p1, states = res1[0][0], [r[1] for r in res1]
        same1 = all(torch.equal(r[0], tree.tree_leaves(p1)[0])
                    for r in res1[1:])
        del res1
        # The expected post-drain shards, from the gathered state.
        want = [optim.AdamState(states[0].count,
                                gathered_slice(tree, [s.mu for s in states],
                                               params, ELASTIC_M, j),
                                gathered_slice(tree, [s.nu for s in states],
                                               params, ELASTIC_M, j))
                for j in range(ELASTIC_M)]
        times = {}
        t_drain = time.perf_counter()

        def replan(pos, rid, old, new):
            torch.cuda.synchronize()
            times.setdefault("consensus_ms",
                             (time.perf_counter() - t_drain) * 1e3)
            t0 = time.perf_counter()
            st = states[pos]
            mu = E.replan_zero(P.COMM_WORLD, st.mu, params, old, new,
                               mode="drain")
            nu = E.replan_zero(P.COMM_WORLD, st.nu, params, old, new,
                               mode="drain")
            torch.cuda.synchronize()
            times.setdefault("replan_ms", []).append(
                (time.perf_counter() - t0) * 1e3)
            return optim.AdamState(st.count, mu, nu)

        drained = rt.drain(replan, leaving=[2, 3])
    times["drain_ms"] = (time.perf_counter() - t_drain) * 1e3
    view = rt.view
    del states
    new_states = [drained[0], drained[1]]
    del drained
    torch.cuda.empty_cache()
    sliced = all(adam_state_equal(tree, new_states[j], want[j])
                 for j in range(ELASTIC_M))

    def step2(pos, rid):
        _, p, st = T.zero_train_step(cfg, p1, rank_rows(
            tokens, pos, ELASTIC_M), opt, new_states[pos], P.COMM_WORLD)
        return p, st

    res2 = rt.run_phase(step2, view=view)
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del new_states
    torch.cuda.empty_cache()
    oracle = P.run_ranks(lambda pos: T.zero_train_step(
        cfg, p1, rank_rows(tokens, pos, ELASTIC_M), opt, want[pos],
        P.COMM_WORLD)[1:], ELASTIC_M, device="cuda")
    ranks_alike = leaves_equal(tree, res2[0][0], res2[1][0])
    fresh = all(leaves_equal(tree, res2[j][0], oracle[j][0])
                and adam_state_equal(tree, res2[j][1], oracle[j][1])
                for j in range(ELASTIC_M))
    del res2, oracle, want, p1
    torch.cuda.empty_cache()
    # The plan's census for the Adam state (mu and nu, bf16) against the
    # gather baseline.
    census = {"auto": [0, 0], "gather": [0, 0]}
    for leaf in tree.tree_leaves(params):
        for strategy in ("auto", "gather"):
            pl = plan_resize(leaf.numel(), (), ELASTIC_W, ELASTIC_M,
                             leaf.dtype, embed_from=tuple(range(ELASTIC_W)),
                             embed_to=(0, 1), exec_size=ELASTIC_W,
                             strategy=None if strategy == "auto"
                             else "gather")
            census[strategy][0] += 2 * pl.wire_bytes
            census[strategy][1] = max(census[strategy][1], pl.peak_bytes)
    tc = attention_all_tc(kernels, launches)
    ok = (same1 and 3 in notices and view.alive == (0, 1)
          and view.epoch == 1 and sliced and ranks_alike and fresh and tc
          and "preempt" in plan.fired_kinds())
    print(f"  A. ZeRO-1 Adam, batch {TRAIN_BATCH} x {TRAIN_SEQ}: step on "
          f"(4,) (ranks identical {same1}); notice board {notices}; "
          f"drain(leaving=[2, 3]) -> {view.describe()}: consensus "
          f"{times['consensus_ms']:.1f} ms, replan "
          f"{max(times['replan_ms']):.1f} ms, drain {times['drain_ms']:.1f} "
          f"ms; shards bitwise the gathered slices {sliced}; step on (2,): "
          f"ranks identical {ranks_alike}, bitwise the fresh-start DP=2 "
          f"oracle {fresh}; plan wire {census['auto'][0]} B (gather "
          f"{census['gather'][0]} B), largest leaf peak "
          f"{census['auto'][1]} B (gather {census['gather'][1]} B); peak "
          f"{peak:.2f} GiB; K2/K3/K4 launches "
          f"{[launches[k] for k in kernels.ATTENTION_KERNELS]} all tc {tc}  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "leg A: the planned drain or the next step is not bitwise its "
          "oracle")
    return {"launches": launches, "peak_gib": peak, "census": census,
            **times}


def spare_leg(P, T, tree, kernels, cfg, params, tokens):
    """B. Rank death -> hot-spare takeover: a (3,) world of 2 data ranks
    and a spare (zero_spare_step) against a DP=2 world without one (the
    data ranks' parameters bitwise, rank 0's rendezvous and bytes equal);
    a rank_death on data rank 1 in step 2, consensus, takeover_shard, the
    redone step bitwise the unfaulted one."""
    from mpi4torch_tpu_torch import elastic as E
    from mpi4torch_tpu_torch.resilience import FaultSpec, fault_scope
    from mpi4torch_tpu_torch.utils import optim

    opt = optim.adam(ADAM_LR)
    world = SPARE_DATA + 1

    def grads(pos, p, slot):
        if slot is None:
            return tree.tree_map(torch.zeros_like, p)
        _, g = tree.value_and_grad(lambda q: T.lm_loss(
            cfg, q, rank_rows(tokens, slot, SPARE_DATA)), p)
        return g

    def run(n, p, states, slots, steps=1):
        def body(pos, rid=None):
            slot = slots[pos]
            q, st = p, states[pos]
            for _ in range(steps):
                q, st = E.zero_spare_step(
                    P.COMM_WORLD, opt, q, grads(pos, q, slot), st,
                    n_data=SPARE_DATA, slot=slot, slots=slots)
            return q, st
        return body

    slots3, slots2 = (0, 1, None), (0, 1)
    kernels.reset_launch_counts()
    init3 = [E.zero_spare_init(opt, params, SPARE_DATA, s) for s in slots3]
    init2 = init3[:SPARE_DATA]
    # The spare's cost: two steps with and without it.
    with WireCounter() as c3:
        with_spare = P.run_ranks(run(world, params, init3, slots3, 2), world,
                                 device="cuda")
    with WireCounter() as c2:
        without = P.run_ranks(run(2, params, init2, slots2, 2), 2,
                              device="cuda")
    free = (all(leaves_equal(tree, with_spare[j][0], without[j][0])
                for j in range(SPARE_DATA))
            and (c3.exchanges, c3.bytes) == (c2.exchanges, c2.bytes))
    mirror_ok = all(leaves_equal(tree, E.takeover_shard(
        with_spare[2][1].mu, s, SPARE_DATA, params), without[s][1].mu)
        for s in range(SPARE_DATA))
    del with_spare
    torch.cuda.empty_cache()
    # Step 1 on the spare world, then step 2 with a death on data rank 1.
    rt = E.ElasticRuntime(world, probe_timeout=ELASTIC_PROBE_S,
                          device="cuda")
    step1 = rt.run_phase(run(world, params, init3, slots3))
    p1, st1 = step1[0][0], [s[1] for s in step1]
    del step1
    ops = c2.exchanges // 2          # rank 0's rendezvous a step
    err, attributed = None, False
    # The death lands mid-step: data rank 1's (ops // 2)-th wire op of
    # step 2.
    spec = FaultSpec("rank_death", rank=1, op=None, index=ops // 2)
    with fault_scope([spec]) as plan:
        t_death = time.perf_counter()
        try:
            rt.run_phase(run(world, p1, st1, slots3))
        except P.RankFailedError as e:
            err, attributed = e, 1 in e.ranks
        t_caught = time.perf_counter()
        view = rt.consensus()
        t_view = time.perf_counter()
    mu = E.takeover_shard(st1[2].mu, 1, SPARE_DATA, params)
    nu = E.takeover_shard(st1[2].nu, 1, SPARE_DATA, params)
    taken = optim.AdamState(st1[2].count, mu, nu)
    torch.cuda.synchronize()
    t_take = time.perf_counter()
    redo = rt.run_phase(run(2, p1, [st1[0], taken], slots2), view=view)
    resume_ms = (t_take - t_caught) * 1e3
    # The unfaulted step 2 is the no-spare world's second step.
    bitwise = all(leaves_equal(tree, redo[j][0], without[j][0])
                  and adam_state_equal(tree, redo[j][1], without[j][1])
                  for j in range(SPARE_DATA))
    launches = dict(kernels.launch_counts)
    del redo, st1, taken, p1, init3, init2
    # Leg D's spare_demote compares against the unfaulted steps: kept on
    # the host, off the card's memory.
    without = to_host(without)
    torch.cuda.empty_cache()
    tc = attention_all_tc(kernels, launches)
    ok = (free and mirror_ok and err is not None and attributed
          and view.alive == (0, 2) and bitwise and tc
          and "rank_death" in plan.fired_kinds())
    print(f"  B. hot spare (2 data ranks + 1 spare, Adam): data ranks "
          f"bitwise the DP=2 run without a spare with the same rank-0 "
          f"rendezvous and bytes ({c3.exchanges} / {c3.bytes} B vs "
          f"{c2.exchanges} / {c2.bytes} B) {free}; the spare's mirror "
          f"slices bitwise the owners' state {mirror_ok}; rank_death on "
          f"data rank 1 at op {ops // 2} of {ops}: RankFailedError naming "
          f"{sorted(err.ranks) if err else None} after "
          f"{(t_caught - t_death) * 1e3:.1f} ms; death-to-resume "
          f"{resume_ms:.1f} ms (consensus {(t_view - t_caught) * 1e3:.1f} "
          f"ms, of it the probe timeout {ELASTIC_PROBE_S * 1e3:.0f} ms = "
          f"{100 * ELASTIC_PROBE_S * 1e3 / resume_ms:.0f}%; takeover "
          f"{(t_take - t_view) * 1e3:.1f} ms) -> {view.describe()}; the "
          f"redone step bitwise the unfaulted step {bitwise}; attention all "
          f"tc {tc}  {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "leg B: the spare cost wire, or the takeover step is not "
          "bitwise the unfaulted step")
    return {"launches": launches, "resume_ms": resume_ms,
            "consensus_ms": (t_view - t_caught) * 1e3,
            "takeover_ms": (t_take - t_view) * 1e3, "without": without}


def elastic_serve_leg(P, T, serve, kernels, cfg, params, prompts):
    """C. Elastic serving: a paged TP=4 engine on four rank threads, a
    preempt on id 1 after 3 steps, ``consensus(leaving=[1, 3])``,
    ``drain_tickets``, ``readmit`` on a TP=2 engine, ``stitched_results``
    against generate() under the near-tie rule; a ticket's pages found
    again through the prefix index of its own pool; a disabled controller
    changes neither tokens nor rendezvous."""
    from mpi4torch_tpu_torch import ctl
    from mpi4torch_tpu_torch import elastic as E
    from mpi4torch_tpu_torch.resilience import FaultSpec, fault_scope

    scfg = serve.ServeConfig(slots=SLOTS, max_new=SERVE_NEW, block_size=16)
    rt = E.ElasticRuntime(SERVE_W, probe_timeout=ELASTIC_PROBE_S,
                          device="cuda")
    kernels.reset_launch_counts()

    def decode_rate(eng, steps):
        """Run ``steps`` steps (all while pending when None): decode
        tokens/s over the steps that admitted nothing, and the seconds
        of those that did."""
        dec_s, dec_n, adm_s, n = 0.0, 0, 0.0, 0
        while eng.pending() and (steps is None or n < steps):
            t0 = time.perf_counter()
            ev = eng.step()
            dt = time.perf_counter() - t0
            n += 1
            if ev["admitted"]:
                adm_s += dt
            else:
                dec_s += dt
                dec_n += sum(len(v) for v in ev["emitted"].values())
        return dec_n / dec_s if dec_s else float("nan"), adm_s

    def phase1(pos, rid):
        eng = serve.Engine(cfg, params, scfg, device="cuda")
        for i, p in enumerate(prompts):
            eng.submit(p, rid=i)
        rate, _ = decode_rate(eng, SERVE_STEPS)
        t0 = time.perf_counter()
        tickets, done = E.drain_tickets(eng)
        drain_s = time.perf_counter() - t0
        # A ticket's pages come back through the prefix index of its own
        # pool: re-admit one ticket here and take one step.
        tk = next(t_ for t_ in tickets if t_.pages and t_.pages["block_ids"])
        E.readmit(eng, [tk])
        eng.step()
        j = next(j for j, r in enumerate(eng._slot_req)
                 if r is not None and r.rid == tk.rid)
        full = tk.pages["n_tokens"] // scfg.block_size
        reused = full > 0 and eng._table[j, :full].tolist() == \
            tk.pages["block_ids"][:full]
        eng.drain()
        return tickets, done, reused, rate, drain_s

    with fault_scope([FaultSpec("preempt", rank=1, op=None, index=0,
                                count=100_000)]) as plan:
        res1 = rt.run_phase(phase1)
        notices = rt.pending_preemptions()
        tickets, done, reused, rate_before, drain_s = res1[0]
        t0 = time.perf_counter()
        view = rt.consensus(leaving=[1, 3])
        consensus_ms = (time.perf_counter() - t0) * 1e3
    alike = all([t.emitted for t in r[0]] == [t.emitted for t in tickets]
                and r[2] for r in res1)
    del res1
    k2_before = kernels.launch_counts["flash_fwd"]

    def phase2(pos, rid):
        eng = serve.Engine(cfg, params, scfg, device="cuda")
        t0 = time.perf_counter()
        E.readmit(eng, tickets)
        readmit_s = time.perf_counter() - t0
        rate, reprefill_s = decode_rate(eng, None)
        res = E.stitched_results({**done, **eng.results()}, tickets)
        return res, rate, readmit_s, reprefill_s, eng.stats.snapshot()

    res2 = rt.run_phase(phase2, view=view)
    k2_readmit = kernels.launch_counts["flash_fwd"] - k2_before
    launches = dict(kernels.launch_counts)
    results, rate_after, readmit_s, reprefill_s, snap = res2[0]
    same_ranks = all(all(np.array_equal(results[i], r[0][i])
                         for i in range(len(prompts))) for r in res2)
    del res2
    divergences, tie_steps = tie_rule_tokens(T, cfg, params, prompts,
                                             results, SERVE_NEW)

    # A disabled controller attached: tokens and rendezvous unchanged
    # (phase 5's TP=2 requests).
    def tp2(attach):
        def body(rank):
            eng = serve.Engine(cfg, params, serve.ServeConfig(
                slots=SLOTS, max_new=TP2_MAX_NEW), device="cuda")
            if attach:
                eng.attach_controller(ctl.SelfTuningController(
                    n_ranks=2, tiers=(2,), device="cuda"))
            for p in prompts[:TP2_REQUESTS]:
                eng.submit(p)
            return {k: v.tolist() for k, v in eng.run().items()}
        with ExchangeCounter() as c:
            out = P.run_ranks(body, 2, device="cuda")
        return out, c.exchanges
    off, on = tp2(False), tp2(True)
    inert = off == on
    f32_bitwise = elastic_serve_f32(P, T, serve, prompts)
    ttft = snap.get("ttft_s", {}).get("p50", float("nan"))
    ok = (1 in notices and view.alive == (0, 2) and view.epoch == 1
          and alike and reused and same_ranks and inert and f32_bitwise
          and launches["flash_fwd"] == launches["flash_fwd.tc"]
          and k2_readmit > 0 and "preempt" in plan.fired_kinds())
    print(f"  C. paged TP=4 serving, {len(prompts)} requests x {SERVE_NEW} "
          f"tokens, {SERVE_STEPS} steps (decode {rate_before:.1f} tokens/s)"
          f"; notice board {notices}; consensus(leaving=[1, 3]) "
          f"{consensus_ms:.1f} ms -> {view.describe()}; {len(tickets)} "
          f"tickets ({sum(len(t.emitted) for t in tickets)} tokens emitted "
          f"before the drain); drain {drain_s * 1e3:.1f} ms + readmit "
          f"{readmit_s * 1e3:.1f} ms; a ticket's pages found again in its "
          f"pool {reused}; TP=2 re-prefill {reprefill_s * 1e3:.1f} ms with "
          f"{k2_readmit} K2 launches, TTFT p50 of the re-admitted "
          f"{ttft * 1e3:.1f} ms, decode {rate_after:.1f} tokens/s after; "
          f"stitched streams vs generate(): near-tie divergences "
          f"{divergences} (oracle near ties {tie_steps}); at 2 layers in "
          f"f32 bitwise generate()'s {f32_bitwise}; ranks identical "
          f"{same_ranks}; disabled controller: tokens and rank-0 "
          f"rendezvous ({off[1]}) unchanged {inert}; K2 launches "
          f"{launches['flash_fwd']} all tc  {'ok' if ok else 'FAIL'}",
          flush=True)
    check(ok, "leg C: elastic serving failed a check")
    return {"launches": launches, "k2_readmit": k2_readmit,
            "consensus_ms": consensus_ms, "drain_ms": drain_s * 1e3,
            "readmit_ms": readmit_s * 1e3, "reprefill_ms": reprefill_s * 1e3,
            "ttft_p50_ms": ttft * 1e3, "decode_tok_s": (rate_before,
                                                          rate_after)}


def elastic_serve_f32(P, T, serve, prompts):
    """Leg C's drain and re-admission at 2 layers in f32 (the flagship's
    widths): TP=4 -> TP=2 stitched streams bitwise generate()'s."""
    from mpi4torch_tpu_torch import elastic as E

    cfg = T.TransformerConfig(vocab=32768, d_model=2048, n_heads=16,
                              n_layers=2, d_ff=8192, max_seq=2048)
    params = T.init_transformer(0, cfg, torch.float32, device="cuda")
    reqs, n_new = prompts[:TP2_REQUESTS], TP2_MAX_NEW
    scfg = serve.ServeConfig(slots=SLOTS, max_new=n_new, block_size=16)
    rt = E.ElasticRuntime(SERVE_W, probe_timeout=ELASTIC_PROBE_S,
                          device="cuda")

    def phase1(pos, rid):
        eng = serve.Engine(cfg, params, scfg, device="cuda")
        for i, p in enumerate(reqs):
            eng.submit(p, rid=i)
        for _ in range(SERVE_STEPS):
            eng.step()
        return E.drain_tickets(eng)

    tickets, done = rt.run_phase(phase1)[0]
    view = rt.consensus(leaving=[1, 3])

    def phase2(pos, rid):
        eng = serve.Engine(cfg, params, scfg, device="cuda")
        E.readmit(eng, tickets)
        return E.stitched_results({**done, **eng.run()}, tickets)

    got = rt.run_phase(phase2, view=view)[0]
    same = all(np.array_equal(got[i], T.generate(
        cfg, params, torch.as_tensor(p, device="cuda")[None],
        n_new)[0].cpu().numpy()) for i, p in enumerate(reqs))
    del params
    torch.cuda.empty_cache()
    return same


def local_latency_spread(report):
    """The largest per-rank mean local latency of an unfaulted report
    (the noise the detector's floor must clear)."""
    return max(s.local_s for s in report.stats)


def degrade_leg(P, T, tree, kernels, qk, fuse, config, cfg, params, tokens,
                spare):
    """D. Degraded mode under gray faults: codec_escalate on the fused
    DP=2 step at 4 MiB buckets (brownout on rank 1), schedule_failover at
    4 x 2^24 float32 (slow_rank on rank 2), spare_demote on leg B's
    world (slow_rank on data rank 1)."""
    from mpi4torch_tpu_torch import obs
    from mpi4torch_tpu_torch import elastic as E
    from mpi4torch_tpu_torch.resilience import (DegradeController,
                                                FaultSpec,
                                                GrayFailureDetector,
                                                fault_scope)
    from mpi4torch_tpu_torch.resilience import degrade
    from mpi4torch_tpu_torch.utils import optim

    bb = config.DEFAULT_BUCKET_BYTES
    nbk = fuse.bucket_layout(params, bb).num_buckets
    out = {}

    def step(pos, rid=None, keep=False):
        x = rank_rows(tokens, pos, 2)
        _, g = tree.value_and_grad(lambda q: T.lm_loss(cfg, q, x), params)
        synced = P.COMM_WORLD.Allreduce_tree(g, P.MPI_SUM, mean=True,
                                             bucket_bytes=bb)
        codec = config.default_compression()
        return (getattr(codec, "name", codec), (g if keep else None),
                synced)

    # Warm every path (exact and q8) before any timed detector window.
    exact = P.run_ranks(step, 2, device="cuda")
    with config.compression_scope("q8"):
        P.run_ranks(step, 2, device="cuda")
    def two(pos, rid=None):
        return [step(pos) for _ in range(2)][-1]

    # A zero-rate brownout on rank 1 censuses the bytes the throttle will
    # see, without sleeping.
    with obs.trace() as tr, fault_scope([FaultSpec(
            "brownout", rank=1, op=None, per_byte_s=0.0,
            count=10 ** 6)]) as census:
        P.run_ranks(two, 2, device="cuda")
        calm = GrayFailureDetector(tr).report()
    spread = local_latency_spread(calm)
    floor = max(5 * spread, DETECT_MIN_FLOOR_S)
    step_bytes = sum(f.info["bytes"] for f in census.fired) // 2
    # The throttle adds about a second to an exact step.
    per_byte_s = 1.0 / step_bytes
    ctl = DegradeController(n_ranks=2, device="cuda")
    stale = ctl.runtime.view
    spec = FaultSpec("brownout", rank=1, op=None, per_byte_s=per_byte_s,
                     count=10 ** 6)
    kernels.reset_launch_counts()
    try:
        with fault_scope([spec]) as plan, obs.trace() as tr:
            t0 = time.perf_counter()
            ctl.runtime.run_phase(two)
            exact_s = (time.perf_counter() - t0) / 2
            report = GrayFailureDetector(tr, floor_s=floor).check()
            n_exact = len(plan.fired)
            tr_ = ctl.apply("codec_escalate", report)
            launches0 = dict(kernels.launch_counts)
            t0 = time.perf_counter()
            q8 = ctl.runtime.run_phase(
                lambda pos, rid: step(pos, keep=True), view=ctl.runtime.view)
            q8_s = time.perf_counter() - t0
            fired = plan.fired
        hops = kernels.launch_counts["q8_hop"] - launches0["q8_hop"]
        try:
            ctl.runtime.run_phase(step, view=stale)
            fenced = False
        except E.StaleEpochError:
            fenced = True
    finally:
        ctl.reset()
    launches = dict(kernels.launch_counts)
    after = P.run_ranks(step, 2, device="cuda")
    reset_exact = all(leaves_equal(tree, a[2], b[2])
                      for a, b in zip(after, exact))
    del exact
    lockstep = {(c, ctl.runtime.epoch) for c, _g, _s in q8} == \
        {("q8", tr_.epoch)}
    (_, g0, y0), (_, g1, y1) = q8
    errs, same, _ = bucket_q8_bounds(qk, fuse, g0, g1, y0, y1, bb)
    tight = max(e / b for e, b in errs)
    del q8, g0, g1, y0, y1, after
    torch.cuda.empty_cache()
    sleep_exact = sum(f.info.get("sleep_s", 0.0) for f in fired[:n_exact]
                      if f.kind == "brownout") / 2
    sleep_q8 = sum(f.info.get("sleep_s", 0.0) for f in fired[n_exact:]
                   if f.kind == "brownout")
    ok = (report is not None and 1 in report.slow and tr_.epoch == 1
          and lockstep and hops == 2 * nbk and same and tight <= 1.0
          and fenced and reset_exact and config.default_compression() is None
          and sleep_exact > 0 and sleep_q8 > 0)
    print(f"  D. codec_escalate, fused DP=2 at {bb} B buckets ({nbk}): the "
          f"unfaulted step's largest per-rank local latency {spread * 1e3:.3f}"
          f" ms a call -> detector floor {floor * 1e3:.3f} ms; brownout "
          f"per_byte_s {per_byte_s:.3e} on rank 1 ({step_bytes} B of its "
          f"wire a step); detector names {sorted(report.slow) if report else None}; "
          f"escalated at epoch {tr_.epoch}, ranks report "
          f"{{('q8', {tr_.epoch})}} {lockstep}; q8_hop launches {hops} "
          f"(expected 2 x {nbk}); ranks bitwise alike {same}; largest "
          f"bucket error / q8 bound {tight:.3f}; stale phase fenced "
          f"{fenced}; reset bitwise exact {reset_exact}; throttled "
          f"{sleep_exact:.3f} s a step exact vs {sleep_q8:.3f} s q8 (steps "
          f"{exact_s:.2f} s vs {q8_s:.2f} s; the rank-thread q8 Allreduce "
          "deposits full-width rows, as JAX's Mode B does, so its "
          f"censused bytes do not shrink)  {'ok' if ok else 'FAIL'}",
          flush=True)
    check(ok, "leg D: codec_escalate failed a check")
    out["codec_escalate"] = {"hops": hops, "launches": launches,
                             "floor_s": floor, "spread_s": spread,
                             "per_byte_s": per_byte_s,
                             "sleep_s": (sleep_exact, sleep_q8)}

    # schedule_failover at bench.py's size.
    nbytes = BENCH_NUMEL * 4
    xs = [torch.randn(BENCH_NUMEL, device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(70 + r)) for r in range(FAILOVER_RANKS)]

    def allreduce(pos, rid=None, algorithm=None):
        return P.COMM_WORLD.Allreduce(xs[pos], P.MPI_SUM,
                                      algorithm=algorithm)

    def three(pos, rid=None):
        return [allreduce(pos) for _ in range(3)][-1]

    P.run_ranks(three, FAILOVER_RANKS, device="cuda")
    with obs.trace() as tr:
        P.run_ranks(three, FAILOVER_RANKS, device="cuda")
        calm = GrayFailureDetector(tr).report()
    floor = max(5 * local_latency_spread(calm), DETECT_MIN_FLOOR_S)
    ctl = DegradeController(n_ranks=FAILOVER_RANKS, device="cuda")
    try:
        with fault_scope([FaultSpec("slow_rank", rank=FAILOVER_SLOW,
                                    op="Allreduce", seconds=2 * floor,
                                    count=10 ** 6)]), \
                obs.trace() as tr:
            ctl.runtime.run_phase(three)
            report = GrayFailureDetector(tr, floor_s=floor).check()
        tr_ = ctl.apply("schedule_failover", report, nbytes=nbytes)
        pick = tr_.action["algorithm"]
        auto = ctl.runtime.run_phase(lambda pos, rid: allreduce(pos),
                                     view=ctl.runtime.view)
    finally:
        ctl.reset()
    explicit = P.run_ranks(lambda pos: allreduce(pos, algorithm=pick),
                           FAILOVER_RANKS, device="cuda")
    win, table = degrade.failover_schedule(FAILOVER_SLOW, FAILOVER_RANKS,
                                           nbytes)
    bitwise = all(torch.equal(a, b) for a, b in zip(auto, explicit))
    sb = tr_.action["slow_rank_bytes"]
    ok = (report is not None and FAILOVER_SLOW in report.slow
          and pick == win and bitwise and sb[pick] < sb["ring"])
    print(f"  D. schedule_failover, {FAILOVER_RANKS} x {BENCH_NUMEL} "
          f"float32, slow_rank on rank {FAILOVER_SLOW} (detector floor "
          f"{floor * 1e3:.3f} ms, names {sorted(report.slow) if report else None}): pick "
          f"{pick} (failover_schedule {win}); bytes through rank "
          f"{FAILOVER_SLOW}: ring {sb['ring']} vs {pick} {sb[pick]}; "
          f"{ {a: t[FAILOVER_SLOW] for a, t in table.items()} }; the next "
          f"Allreduce bitwise its explicit pick {bitwise}  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "leg D: schedule_failover failed a check")
    out["schedule_failover"] = {"pick": pick, "slow_rank_bytes": sb}
    del xs, auto, explicit
    torch.cuda.empty_cache()

    # spare_demote on leg B's world: a slow data rank 1 hands its slot to
    # the spare; the next step's data ranks bitwise the unfaulted step.
    opt = optim.adam(ADAM_LR)
    init3 = [E.zero_spare_init(opt, params, SPARE_DATA, s)
             for s in (0, 1, None)]

    def zbody(slots, states, p):
        def body(pos, rid):
            slot = slots[pos]
            if slot is None:
                g = tree.tree_map(torch.zeros_like, p)
            else:
                _, g = tree.value_and_grad(lambda q: T.lm_loss(
                    cfg, q, rank_rows(tokens, slot, SPARE_DATA)), p)
            q, st = E.zero_spare_step(P.COMM_WORLD, opt, p, g,
                                      states[pos], n_data=SPARE_DATA,
                                      slot=slot, slots=slots)
            # The parameters are replicated: rank 0's copy is kept.
            return (q if pos == 0 else None), st
        return body

    ctl = DegradeController(n_ranks=SPARE_DATA + 1, device="cuda")
    slots_a = (0, 1, None)
    with obs.trace() as tr:
        ctl.runtime.run_phase(zbody(slots_a, init3, params))
        calm = GrayFailureDetector(tr).report()
    floor = max(5 * local_latency_spread(calm), DETECT_MIN_FLOOR_S)
    try:
        with fault_scope([FaultSpec("slow_rank", rank=1, op=None,
                                    seconds=2 * floor, count=10 ** 6)]), \
                obs.trace() as tr:
            res = ctl.runtime.run_phase(zbody(slots_a, init3, params))
            report = GrayFailureDetector(tr, floor_s=floor).check()
        tr_ = ctl.apply("spare_demote", report, n_data=SPARE_DATA,
                        slots=slots_a)
        slots_b = tr_.action["slots"]
        st = [r[1] for r in res]
        taken = optim.AdamState(
            st[tr_.action["promoted"]].count,
            E.takeover_shard(st[tr_.action["promoted"]].mu,
                             tr_.action["slot"], SPARE_DATA, params),
            E.takeover_shard(st[tr_.action["promoted"]].nu,
                             tr_.action["slot"], SPARE_DATA, params))
        states_b = [taken if p == tr_.action["promoted"] else
                    E.zero_spare_init(opt, params, SPARE_DATA, None)
                    if p == tr_.action["demoted"] else st[p]
                    for p in range(SPARE_DATA + 1)]
        del st
        outs = ctl.runtime.run_phase(zbody(slots_b, states_b, res[0][0]),
                                     view=ctl.runtime.view)
    finally:
        ctl.reset()
    want = spare["without"]
    host = to_host(outs)
    del outs
    bitwise = leaves_equal(tree, host[0][0], want[0][0]) and all(
        adam_state_equal(tree, host[p][1], want[s][1])
        for p, s in enumerate(slots_b) if s is not None)
    ok = (report is not None and 1 in report.slow and tr_.epoch == 1
          and slots_b == (0, None, 1) and bitwise)
    print(f"  D. spare_demote on leg B's world (slow_rank on data rank 1, "
          f"detector floor {floor * 1e3:.3f} ms, names "
          f"{sorted(report.slow) if report else None}): slots {slots_a} -> "
          f"{slots_b} at epoch {tr_.epoch}; the next step's data ranks "
          f"bitwise the unfaulted step {bitwise}  {'ok' if ok else 'FAIL'}",
          flush=True)
    check(ok, "leg D: spare_demote failed a check")
    del res, host, states_b, taken, init3
    torch.cuda.empty_cache()
    return out


def controller_leg(P, kernels, config):
    """E. The controller: closed_loop_episode(n=8, tiers=(2, 2, 2)) on CUDA
    rank threads, its watermarks derived from this wire's healthy q8/exact
    goodput; the escalation installs the synth_q8 winner at a consensus
    epoch; in the escalated configuration one Allreduce of that winner at
    its bucket, bitwise the interpreter of the installed program, its K1
    requants counted alone; escalated and recovered runs bitwise their
    oracles, the pre-switch view fenced, the ledger's tier wire and
    winners the CPU run's, its weighted costs the census of the live
    vector it ratified."""
    import numpy as np

    from mpi4torch_tpu_torch import csched
    from mpi4torch_tpu_torch.ctl import __main__ as cmain

    probe = {}

    def on_escalated(ctl):
        # The counts from the episode's start are kept aside: this
        # Allreduce's launches alone, then the episode's total goes on
        # (the interpreter's, the oracle, are not counted).
        before = dict(kernels.launch_counts)
        kernels.reset_launch_counts()
        run = cmain.installed_allreduce(ctl)
        torch.cuda.synchronize()
        probe.update(kernels.launch_counts)
        if run is not None:
            run["oracle"] = cmain.installed_oracle(run)
        for k, v in before.items():
            kernels.launch_counts[k] = v + probe[k]
        return run

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ev = cmain.closed_loop_episode(n=8, tiers=(2, 2, 2), backend="thread",
                                   device="cuda", on_escalated=on_escalated)
    episode_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    probs = cmain.closed_loop_problems(ev)
    esc = ev["escalation"]
    inst = ev.get("on_escalated")
    cpu = cmain.closed_loop_episode(n=8, tiers=(2, 2, 2), backend="thread",
                                    device="cpu")
    cesc = cpu["escalation"]
    census = False
    if esc is not None and cesc is not None:
        res = csched.synthesize_tiers(
            8, 4096, 4, tiers=(2, 2, 2),
            tier_bandwidths=(1.0, 1.0, max(esc.ratio, 1e-6)), codec="q8")
        census = (esc.new.get("installed") == res["winner"]
                  == cesc.new.get("installed")
                  and esc.new["tier_wire"] == tuple(res["tier_wire"])
                  == cesc.new["tier_wire"]
                  and esc.old["tier_wire"] == cesc.old["tier_wire"]
                  and esc.new["weighted_cost"] == res["weighted_cost"]
                  and esc.old["weighted_cost"]
                  == res["exact_weighted_cost"])
    # Below the fold-once size every rank folds all 8 contributions, one
    # K1 requant each, at each q8_level_fold step.
    want_requant = 8 * 8 * inst["q8_steps"] if inst else None
    inst_ok = (inst is not None and esc is not None
               and inst["name"] == esc.new.get("installed")
               and inst["slot"] == "synth_q8"
               and all(np.array_equal(r, inst["oracle"])
                       for r in inst["results"])
               and probe.get("q8_requant") == want_requant)
    h = ev["healthy"]
    ok = not probs and census and inst_ok
    print(f"  E. closed loop on 8 CUDA rank threads, tiers (2, 2, 2): "
          f"healthy exact / q8 event {h['exact']['duration_ms']:.3f} / "
          f"{h['q8']['duration_ms']:.3f} ms (barrier wait "
          f"{h['exact']['wait_ms']:.3f} / {h['q8']['wait_ms']:.3f} ms; q8 "
          f"encode {h['codec']['encode_ms']:.3f} ms, decode "
          f"{h['codec']['decode_ms']:.3f} ms a rank), "
          f"q8/exact goodput {h['ratio']:.3f} -> watermarks "
          f"({h['watermarks'][0]:.4f}, {h['watermarks'][1]:.4f}); brownout "
          f"per_byte_s {ev['per_byte_s']:.3e} ({cmain.BROWNOUT_S} s an exact "
          f"run); {ev['ledger'].triggers()} at epochs {ev['epochs']}; "
          f"installed {esc.new.get('installed') if esc else None}; weighted "
          f"cost {esc.old.get('weighted_cost') if esc else None} -> "
          f"{esc.new.get('weighted_cost') if esc else None}, tier wire "
          f"{esc.old.get('tier_wire') if esc else None} -> "
          f"{esc.new.get('tier_wire') if esc else None}; winners and wire "
          f"the CPU run's, costs the census of the ratified live vector "
          f"{census}; episode {episode_s:.1f} s, K1 q8_requant launches "
          f"{launches['q8_requant']}; problems {probs}  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    print(f"  E. escalated: one Allreduce of the installed "
          f"{inst['name'] if inst else None} ({inst['slot'] if inst else None}"
          f" slot, named: auto selection never reads it) at 4096 B on 8 "
          f"ranks bitwise the interpreter of the installed program, K1 "
          f"q8_requant launches {probe.get('q8_requant')} (8 ranks x 8 "
          f"contributions x {inst['q8_steps'] if inst else None} "
          f"q8_level_fold: {want_requant})  {'ok' if inst_ok else 'FAIL'}",
          flush=True)
    check(ok, f"leg E: the closed loop failed: {probs}")
    return {"launches": launches, "installed_launches": probe,
            "thresholds": h["watermarks"], "healthy": h,
            "episode_s": episode_s, "per_byte_s": ev["per_byte_s"],
            "installed": esc.new.get("installed")}


def matrices_leg(P):
    """F. The matrices on the card: the fast elastic and chaos subsets,
    both consensus cells, the three degrade cells and one storm on CUDA,
    each record equal to the same cell's on the CPU; the process-backend
    reruns on CUDA worker processes (a killed worker's replacement spawned
    mid-cell), each record equal to the cell's on CPU rank threads."""
    from mpi4torch_tpu_torch.elastic import matrix as em
    from mpi4torch_tpu_torch.resilience import chaos

    def rec(r):
        return {k: r.get(k) for k in RECORD_KEYS}

    cells = [("elastic", c) for c in ELASTIC_FAST] + \
        [("consensus", (k,)) for k in ("disagree", "second_failure")] + \
        [("chaos", c) for c in CHAOS_FAST] + \
        [("chaos", c) for c in sorted(chaos.DEGRADE_COVERED)
         if c not in CHAOS_FAST] + [("storm", (1,))]
    rows, ok = [], True
    for kind, args in cells:
        fn = {"elastic": em.run_cell, "consensus": em.run_consensus_cell,
              "chaos": chaos.run_chaos_cell, "storm": chaos.run_storm}[kind]
        t0 = time.perf_counter()
        card = fn(*args, device="cuda")
        dt = time.perf_counter() - t0
        cpu = fn(*args, device="cpu")
        keys = ("status", "fired") if kind == "storm" else RECORD_KEYS
        same = {k: card.get(k) for k in keys} == \
            {k: cpu.get(k) for k in keys}
        good = card["status"] == "ok" and same
        ok = ok and good
        rows.append((kind, args, card["status"], same, dt))
        print(f"  F. {kind} {args}: card {card['status']} "
              f"({card.get('detail', '')[:70]}), equal to the CPU record "
              f"{same}, {dt:.1f} s  {'ok' if good else 'FAIL'}", flush=True)
    from mpi4torch_tpu_torch import transport
    from mpi4torch_tpu_torch.transport.pool import shared_pool

    # The rank_death cell's SIGKILL leaves the pool one worker short: the
    # consensus after it runs on a worker spawned in its place.
    for kind, args in [("elastic", ("rank_death", "plain", "shrink")),
                       ("elastic", ("preempt", "plain", "shrink")),
                       ("chaos", ("slow_rank", "plain"))]:
        fn = em.run_cell if kind == "elastic" else chaos.run_chaos_cell
        with P.config.transport_scope("process"):
            spawned = shared_pool().spawned_total
            t0 = time.perf_counter()
            r = fn(*args, device="cuda")
            dt = time.perf_counter() - t0
            spawned = shared_pool().spawned_total - spawned
        cpu = fn(*args, device="cpu")
        same = {k: r.get(k) for k in RECORD_KEYS} == \
            {k: cpu.get(k) for k in RECORD_KEYS}
        good = r["status"] == "ok" and same and (
            kind == "chaos" or args[0] in r["fired"])
        ok = ok and good
        rows.append((f"{kind}/process", args, r["status"], same, dt))
        print(f"  F. {kind} {args} on CUDA worker processes: "
              f"{r['status']} ({r.get('detail', '')[:70]}), equal to the "
              f"CPU record {same}, workers spawned {spawned}, {dt:.1f} s  "
              f"{'ok' if good else 'FAIL'}", flush=True)
    transport.shutdown()
    check(ok, "leg F: a matrix cell failed on the card or differs from its "
          "CPU record")
    return rows


def item6_phase(P, T, tree, serve, kernels, qk, fuse, config, cfg, params,
                tokens, prompts, smi):
    """Phase 63 (A-F), the process state saved before and restored after."""
    from mpi4torch_tpu_torch.csched import synth

    state = config.snapshot_process_state()
    installed = synth.installed()
    out = {}
    try:
        t0 = time.perf_counter()
        out["drain"] = elastic_drain_leg(P, T, tree, kernels, cfg, params,
                                         tokens)
        torch.cuda.empty_cache()
        out["spare"] = spare_leg(P, T, tree, kernels, cfg, params, tokens)
        torch.cuda.empty_cache()
        with torch.inference_mode():
            out["serve"] = elastic_serve_leg(P, T, serve, kernels, cfg,
                                             params, prompts)
        torch.cuda.empty_cache()
        out["degrade"] = degrade_leg(P, T, tree, kernels, qk, fuse, config,
                                     cfg, params, tokens, out["spare"])
        out["spare"].pop("without")
        torch.cuda.empty_cache()
        out["ctl"] = controller_leg(P, kernels, config)
        # The process reruns' workers each take a CUDA context.
        torch.cuda.empty_cache()
        print(smi)
        out["matrices"] = matrices_leg(P)
        print(f"  phase 63 A-F in {time.perf_counter() - t0:.1f} s")
    finally:
        config.apply_process_state(state)
        synth.restore_installed(installed)
    return out


# ---------------------------------------------------------------------------
# Phase 64: the multi-process runtime.  Two OS processes on the one card
# rendezvous through init_distributed (gloo over loopback) and run
# run_spmd across them; this script is their program, run again with
# --dist-worker.  Launch "abc" has one rank a process (legs A-C), launch
# "de" two (legs D and E).
# ---------------------------------------------------------------------------

# Leg B: deterministic mode of each of the flagship's DP=2 steps.
DIST_STEPS = (False, False, True)
# Leg C: float32 per rank of the q8 ring Allreduce (4 x 2^20).
DIST_Q8_NUMEL = 4 << 20
# Leg D: the deterministic fold's rows (JAX's sin rows of 513 float32).
DIST_FOLD_NUMEL = 513
# The workers' world timeout (gloo's), which bounds leg E, and each
# launch's wall-clock limit.
DIST_TIMEOUT_S = 30
DIST_LAUNCH_S = 300


def digest(*tensors) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous().reshape(-1)
        t = t.to(torch.uint8) if t.dtype == torch.bool \
            else t.view(torch.uint8)
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def dp2_spmd_body(P, T, tree, dp, cfg):
    """Phase 51's DP=2 step as a run_spmd body: ``dp_value_and_grad`` and
    the SGD update, each rank taking its ``TRAIN_BATCH // 2`` rows by
    ``comm.rank``."""
    rows = TRAIN_BATCH // 2
    comm = P.COMM_WORLD

    def body(p, toks):
        idx = comm.rank * rows + torch.arange(rows, device=toks.device)
        loss, g = dp.dp_value_and_grad(
            comm, lambda q, x: T.lm_loss(cfg, q, x))(
                p, toks.index_select(0, idx))
        with torch.no_grad():
            return loss, tree.tree_map(lambda a, b: a - LR * b, p, g)
    return body


def q8_spmd_body(P):
    """Leg C: the q8 ``ring`` Allreduce, value and gradient of
    ``vdot(y, y)``, each rank on its row."""
    comm = P.COMM_WORLD

    def body(xs):
        x = xs[comm.rank].detach().requires_grad_()
        y = comm.Allreduce(x, P.MPI_SUM, compression="q8", algorithm="ring")
        (g,) = torch.autograd.grad(torch.vdot(y, y), x)
        return y, g
    return body


def q8_rows():
    g = torch.Generator(device="cuda").manual_seed(5)
    return torch.randn(2, DIST_Q8_NUMEL, generator=g, device="cuda")


def fold_rows(n):
    return torch.from_numpy(np.stack([
        np.sin(np.arange(DIST_FOLD_NUMEL, dtype=np.float32) * (r + 1))
        for r in range(n)]).astype(np.float32)).to("cuda")


def dist_worker_abc(P, T, tree, dp, kernels, config, tdist, pid):
    """Legs A-C in one worker process (one rank)."""
    comm = P.COMM_WORLD
    out = {}
    # A: JAX's _WORKER shape.
    def body():
        x = ((comm.rank + 1.0) * torch.ones(4, device="cuda")
             ).requires_grad_()
        y = comm.Allreduce(x, P.MPI_SUM)
        (g,) = torch.autograd.grad(torch.vdot(y, torch.ones_like(y)), x)
        return y, g
    y, g = P.run_spmd(body)()
    ranks, yv = P.local_values(y)
    _, gv = P.local_values(g)
    fake = types.ModuleType("mpi4py")
    fake.MPI = types.SimpleNamespace()
    sys.modules["mpi4py"] = fake

    class FakeComm:
        def Get_rank(self):
            return pid

        def Get_size(self):
            return 2

        def bcast(self, v, root=0):
            raise AssertionError("the runtime is initialized: no rendezvous")
    c = P.comm_from_mpi4py(FakeComm())
    inside = P.run_spmd(lambda: c.Allreduce(torch.ones(3, device="cuda"),
                                            P.MPI_SUM))()
    out["a"] = {"ranks": ranks.tolist(), "y": yv.tolist(), "g": gv.tolist(),
                "mpi4py": [c.rank, c.size, inside.tolist()]}

    # B: phase 51's DP=2 step, its two ranks in two processes.
    cfg = flagship_config(T)
    params = T.init_transformer(0, cfg, torch.bfloat16, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ))).to("cuda")
    out["params0"] = digest(*tree.tree_leaves(params))
    out["tokens"] = digest(tokens)
    step = P.run_spmd(dp2_spmd_body(P, T, tree, dp, cfg))
    p, steps = params, []
    del params
    kernels.reset_launch_counts()
    for i, det in enumerate(DIST_STEPS):
        tdist.reset_stats()
        with config.deterministic_mode(det):
            if i == 1 and pid == 0:
                # Worker 0's second step runs under the profiler, for its
                # idle share; worker 1's is timed alike without one.
                got = {}
                ms, busy, _ = profile_top(
                    lambda: got.update(r=step(p, tokens)),
                    "worker 0's DP=2 step", n_top=4)
                loss, new = got.pop("r")
                idle = 100 - 100 * busy / ms
            else:
                ms, (loss, new) = sync_ms(lambda: step(p, tokens))
        p = tree.tree_map(lambda t: t[0], new)
        del new
        steps.append({"det": det, "ms": ms, "loss": float(loss[0]),
                      "loss_digest": digest(loss[0]),
                      "params_digest": digest(*tree.tree_leaves(p)),
                      "wire": tdist.stats()})
    out["b"] = {"steps": steps,
                "launches": {k: v for k, v in kernels.launch_counts.items()
                             if k.startswith("flash")}}
    if pid == 0:
        out["b"]["idle_pct"] = idle
    del p
    torch.cuda.empty_cache()

    # C: K1 on the new path.
    xs = q8_rows()
    kernels.reset_launch_counts()
    ms, (y, g) = sync_ms(lambda: P.run_spmd(q8_spmd_body(P))(xs))
    out["c"] = {"ms": ms, "y": digest(y[0]), "g": digest(g[0]),
                "launches": {k: kernels.launch_counts[k]
                             for k in ("q8_hop", "q8_requant")}}
    return out


def dist_worker_de(P, config, pid):
    """Legs D and E in one worker process (two ranks)."""
    out = {}
    # D: JAX's _HYBRID_WORKER shape at 2 processes x 2 ranks.
    m = P.hybrid_mesh({"tp": 2}, {"dp": 2})
    ctp = P.comm_from_mesh(m, "tp")
    cdp = P.comm_from_mesh(m, "dp")

    def body():
        one = torch.ones((), device="cuda")
        tp_sum = ctp.Allreduce(one * (ctp.rank + 1.0), P.MPI_SUM)
        dp_sum = cdp.Allreduce(one * (cdp.rank + 1.0), P.MPI_SUM)
        x = ((cdp.rank + 1.0) * torch.ones(2, device="cuda")
             ).requires_grad_()
        y = cdp.Allreduce(x, P.MPI_SUM)
        (g,) = torch.autograd.grad(torch.vdot(y, torch.ones_like(y)), x)
        return tp_sum, dp_sum, g
    tp_sum, dp_sum, g = P.run_spmd(body, mesh=m, axis_name="dp")()
    data = fold_rows(4)
    comm = P.COMM_WORLD
    folds = {}
    prev = (config.ordered_fold_gather_max_bytes(),
            config.ordered_ring_chunk_bytes())
    try:
        for fold in ("gather", "ring"):
            if fold == "ring":
                config.set_ordered_fold_gather_max_bytes(0)
                config.set_ordered_ring_chunk_bytes(256)
            with config.deterministic_mode(True):
                o = P.run_spmd(lambda d: comm.Allreduce(d[comm.rank],
                                                        P.MPI_SUM))(data)
            ranks, vals = P.local_values(o)
            folds[fold] = {int(r): digest(v) for r, v in zip(ranks, vals)}
    finally:
        config.set_ordered_fold_gather_max_bytes(prev[0])
        config.set_ordered_ring_chunk_bytes(prev[1])
    out["d"] = {"axis_names": list(m.axis_names),
                "process_rows": m.process_index.tolist(),
                "tp_sum": tp_sum.tolist(), "dp_sum": dp_sum.tolist(),
                "dp_grad": g.tolist(), "folds": folds}
    # E: worker 1 leaves before its next Allreduce.
    if pid == 1:
        out["e"] = "left"
        return out
    t0 = time.perf_counter()
    try:
        P.run_spmd(lambda: comm.Allreduce(torch.ones(2, device="cuda"),
                                          P.MPI_SUM))()
        out["e"] = {"error": None}
    except P.CommError as e:
        out["e"] = {"error": type(e).__name__,
                    "ranks": sorted(getattr(e, "ranks", ()) or ()),
                    "s": time.perf_counter() - t0, "message": str(e)[:200]}
    return out


def dist_worker(argv) -> int:
    """``chip_smoke.py --dist-worker LEG PID NPROC PORT``: one worker of
    phase 64.  Prints its result as a JSON object on its last line; leg
    E's leaving worker exits without finalizing."""
    leg, pid, nproc, port = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch import config
    from mpi4torch_tpu_torch.models import transformer as T
    from mpi4torch_tpu_torch.ops import _kernels as kernels
    from mpi4torch_tpu_torch.parallel import dp
    from mpi4torch_tpu_torch.transport import dist as tdist
    from mpi4torch_tpu_torch.utils import tree

    t0 = time.perf_counter()
    info = P.init_distributed(
        coordinator_address=f"127.0.0.1:{port}", num_processes=nproc,
        process_id=pid, local_device_ids=[0] if leg == "abc" else [0, 0])
    res = {"pid": os.getpid(), "info": [info.process_id, info.process_count,
                                        info.n_devices, info.n_local_devices],
           "init_s": time.perf_counter() - t0}
    if leg == "abc":
        res.update(dist_worker_abc(P, T, tree, dp, kernels, config, tdist,
                                   pid))
    else:
        res.update(dist_worker_de(P, config, pid))
    res["s"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)
    if res.get("e") == "left":
        os._exit(0)
    if leg == "abc":
        # Launch "de"'s world is torn by leg E: nothing to finalize.
        P.finalize_distributed()
    return 0


def dist_launch(leg, nproc=2):
    """Run ``nproc`` workers of ``leg`` on the card; print their output
    and return each one's JSON result.  Any worker failure fails."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, MPI4TORCH_TPU_WORLD_TIMEOUT=str(DIST_TIMEOUT_S))
    script = os.path.abspath(__file__)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, script, "--dist-worker", leg, str(pid), str(nproc),
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=os.path.dirname(script))
        for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=DIST_LAUNCH_S)
            outs.append(out)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"phase 64 launch {leg!r} did not end within "
                           f"{DIST_LAUNCH_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        lines = out.strip().splitlines()
        for line in lines[:-1]:
            if "hostname of the client socket" not in line:
                print(f"    [{leg} worker {pid}] {line}")
        check(p.returncode == 0 and lines,
              f"phase 64 worker {pid} of launch {leg!r} failed "
              f"(exit {p.returncode}):\n" + "\n".join(lines[-30:]))
        results.append(json.loads(lines[-1]))
    print(f"  launch {leg!r}: {nproc} workers in "
          f"{time.perf_counter() - t0:.1f} s (spawn, imports, CUDA "
          "contexts and seeding included)", flush=True)
    return results


def dist_phase(P, T, tree, dp, kernels, config, cfg, params, tokens, smi):
    """Phase 64: the references in this process (phase 51's DP=2 steps
    and the q8 ring Allreduce under ``run_spmd(nranks=2)``, the
    ``run_ranks(4)`` fold oracle), then launches "abc" and "de"."""
    torch.cuda.empty_cache()
    body = P.run_spmd(dp2_spmd_body(P, T, tree, dp, cfg), nranks=2)
    ref = {"params0": digest(*tree.tree_leaves(params)),
           "tokens": digest(tokens), "steps": []}
    p = params
    for det in DIST_STEPS:
        with config.deterministic_mode(det):
            ms, (loss, new) = sync_ms(lambda: body(p, tokens))
        p = tree.tree_map(lambda t: t[0], new)
        del new
        ref["steps"].append({"ms": ms, "loss_digest": digest(loss[0]),
                             "params_digest": digest(*tree.tree_leaves(p))})
    del p
    torch.cuda.empty_cache()
    xs = q8_rows()
    kernels.reset_launch_counts()
    y, g = P.run_spmd(q8_spmd_body(P), nranks=2)(xs)
    ref["q8"] = [(digest(y[r]), digest(g[r])) for r in range(2)]
    ref["q8_launches"] = {k: kernels.launch_counts[k]
                          for k in ("q8_hop", "q8_requant")}
    del xs, y, g
    data = fold_rows(4)
    oracle = P.run_ranks(lambda r: P.COMM_WORLD.Allreduce(data[r],
                                                          P.MPI_SUM),
                         4, device="cuda")
    ref["fold"] = {r: digest(o) for r, o in enumerate(oracle)}
    del data, oracle
    torch.cuda.empty_cache()
    print(f"  references: run_spmd(nranks=2) DP=2 step ms "
          f"{[round(s['ms'], 1) for s in ref['steps']]}; q8 K1 launches "
          f"{ref['q8_launches']}", flush=True)

    abc = dist_launch("abc")
    de = dist_launch("de")

    # A.
    for pid, w in enumerate(abc):
        a = w["a"]
        print(f"  A worker {pid}: info {w['info']} (init {w['init_s']:.2f} "
              f"s); local_values ranks {a['ranks']}, y {a['y']}, grad "
              f"{a['g']}; comm_from_mpi4py rank/size {a['mpi4py'][:2]}, its "
              f"Allreduce {a['mpi4py'][2]}")
        check(w["info"] == [pid, 2, 2, 1], "leg A: wrong layout")
        check(a["ranks"] == [pid] and a["y"] == [[3.0] * 4]
              and a["g"] == [[2.0] * 4], "leg A: Allreduce values wrong")
        check(a["mpi4py"] == [pid, 2, [[2.0] * 3]],
              "leg A: comm_from_mpi4py on the initialized runtime")
    # B.
    want = len(DIST_STEPS) * cfg.n_layers
    same_seed = all(w["params0"] == ref["params0"]
                    and w["tokens"] == ref["tokens"] for w in abc)
    print(f"  B: parameters and tokens from the seed identical in both "
          f"workers and here: {same_seed}")
    check(same_seed, "leg B: the workers' seeded parameters differ")
    bitwise = []
    print(smi)
    for i, r in enumerate(ref["steps"]):
        got = [w["b"]["steps"][i] for w in abc]
        ok = all(s["loss_digest"] == r["loss_digest"]
                 and s["params_digest"] == r["params_digest"] for s in got)
        bitwise.append(ok)
        wire = got[0]["wire"]
        print(f"  B step {i + 1} ("
              f"{'deterministic' if DIST_STEPS[i] else 'default'}): loss "
              f"{got[0]['loss']:.4f}; ms per worker "
              f"{[round(s['ms'], 1) for s in got]} (one process "
              f"{r['ms']:.1f}); worker 0 sent {wire['sent_bytes'] / 1e9:.3f}"
              f" GB and received {wire['received_bytes'] / 1e9:.3f} GB in "
              f"{wire['rounds']} gloo all-gathers; loss and parameters "
              f"bitwise phase 51's run_spmd(nranks=2): {ok}", flush=True)
    launches = [{k: w["b"]["launches"].get(k, 0)
                 for k in kernels.ATTENTION_KERNELS
                 + tuple(f"{k}.tc" for k in kernels.ATTENTION_KERNELS)}
                for w in abc]
    wires = [w["b"]["steps"][1]["wire"] for w in abc]
    # Step 1 is timed alike in both workers; worker 0's step 2 runs under
    # the profiler, and worker 1's reading of it includes the profiler's
    # start in worker 0.
    step_ms = [w["b"]["steps"][0]["ms"] for w in abc]
    idle = abc[0]["b"]["idle_pct"]
    print(f"  B: step 1 ms {[round(x, 1) for x in step_ms]}; worker 0's "
          f"step 2 under the profiler {abc[0]['b']['steps'][1]['ms']:.1f} "
          f"ms, device idle {idle:.1f}%; attention launches per worker "
          f"{launches} (expected {want} each, all tc: 8 a step on its one "
          "rank)", flush=True)
    check(all(bitwise), "leg B: a step is not bitwise phase 51's")
    check(all(v == want for w in launches for v in w.values()),
          "leg B: a worker ran an attention launch off the tc kernels")
    # C.
    c_ok = all(w["c"]["y"] == ref["q8"][pid][0]
               and w["c"]["g"] == ref["q8"][pid][1]
               for pid, w in enumerate(abc))
    k1 = {k: sum(w["c"]["launches"][k] for w in abc)
          for k in ("q8_hop", "q8_requant")}
    print(f"  C: q8 ring Allreduce of {DIST_Q8_NUMEL} float32 a rank, fwd + "
          f"bwd: ms per worker {[round(w['c']['ms'], 1) for w in abc]}; "
          f"value and gradient bitwise run_spmd(nranks=2): {c_ok}; K1 "
          f"launches per worker {[w['c']['launches'] for w in abc]} (one "
          f"process, both ranks: {ref['q8_launches']})", flush=True)
    check(c_ok, "leg C: the q8 Allreduce is not bitwise the one-process run")
    check(all(w["c"]["launches"][k] > 0 for w in abc for k in k1)
          and k1 == ref["q8_launches"],
          "leg C: K1's launches are missing or differ from the one-process "
          "run's")
    # D.
    folds_ok = {}
    for fold in ("gather", "ring"):
        got = {int(r): d for w in de for r, d in w["d"]["folds"][fold].items()}
        folds_ok[fold] = got == ref["fold"]
    for pid, w in enumerate(de):
        d = w["d"]
        print(f"  D worker {pid}: info {w['info']}; mesh {d['axis_names']} "
              f"processes by row {d['process_rows']}; tp sums {d['tp_sum']}, "
              f"dp sums {d['dp_sum']}, dp grads {d['dp_grad']}")
        check(w["info"] == [pid, 2, 4, 2], "leg D: wrong layout")
        check(d["axis_names"] == ["dp", "tp"]
              and d["process_rows"] == [[0, 0], [1, 1]],
              "leg D: a tp row crosses processes")
        check(d["tp_sum"] == [3.0, 3.0] and d["dp_sum"] == [3.0, 3.0]
              and d["dp_grad"] == [[2.0, 2.0]] * 2,
              "leg D: the tp or dp sum or the dp gradient is wrong")
    print(f"  D: deterministic fold bitwise run_ranks(4): {folds_ok}")
    check(all(folds_ok.values()), "leg D: a deterministic fold differs")
    # E.
    e = de[0]["e"]
    print(f"  E: worker 1 left; worker 0 raised {e.get('error')} naming ranks "
          f"{e.get('ranks')} after {e.get('s', float('nan')):.3f} s (world "
          f"timeout {DIST_TIMEOUT_S} s): {e.get('message')}", flush=True)
    check(de[1]["e"] == "left" and e.get("error") == "RankFailedError"
          and e.get("ranks") == [2, 3] and e["s"] < DIST_TIMEOUT_S,
          "leg E: the survivor did not raise its typed error in time")
    return {"launches": {k: sum(w[k] for w in launches)
                         for k in kernels.ATTENTION_KERNELS},
            "k1": k1, "step_ms": step_ms, "wire": wires[0],
            "idle_pct": idle, "one_process_ms": ref["steps"][0]["ms"]}


ANALYZE_MAX_NEW = 4            # phase 65 D's decode budget a request


def fused_q8_spmd_body(P, T, tree, cfg, bucket_bytes):
    """Phase 19's fused q8 DP=2 step as a run_spmd body: the local loss's
    gradient, ``Allreduce_tree(compression="q8", mean=True)`` at
    ``bucket_bytes`` buckets, and the SGD update, each rank taking its
    ``TRAIN_BATCH // 2`` rows by ``comm.rank``."""
    rows = TRAIN_BATCH // 2
    comm = P.COMM_WORLD

    def body(p, toks):
        idx = comm.rank * rows + torch.arange(rows, device=toks.device)
        x = toks.index_select(0, idx)
        loss, g = tree.value_and_grad(lambda q: T.lm_loss(cfg, q, x), p)
        synced = comm.Allreduce_tree(g, P.MPI_SUM, mean=True,
                                     compression="q8",
                                     bucket_bytes=bucket_bytes)
        with torch.no_grad():
            return loss, tree.tree_map(lambda a, s: a - LR * s, p, synced)
    return body


def signature_bytes(sig):
    """Payload bytes of a Mode A exchange signature (its last element is
    the payload's ``(shape, dtype)``)."""
    shape, dtype = sig[-1]
    return math.prod(shape) * getattr(torch, str(dtype).split(".")[-1]) \
        .itemsize


def analyze_phase(P, T, tree, dp, serve, kernels, config, fuse, cfg,
                  params, tokens, prompts):
    """Phase 65: the collective-schedule verifier on the card.  A: the
    registry-wide sweep and the seeded-defect corpus recorded on CUDA rank
    threads over the (8,), (3,), (1,) and (2, 4) worlds: no violation, no
    registry drift, every defect caught by its named lint.  B: phase 51's
    full-width DP=2 step lowered: clean lints, its collectives and their
    payload bytes those ``ExchangeCounter`` counts in one step, K2-K4
    ``custom_call`` events 8 a rank and equal to the launches; the
    recording's seconds against the step's, ``peak_live_bytes`` beside
    ``max_memory_allocated``.  C: the fused q8 DP=2 step lowered: its
    ``q8_hop``/``q8_requant`` events equal the launches and
    ``int8_rotation_census`` sees both rotations.  D:
    ``Engine(spmd=True, nranks=2)`` at full width: ``lower_step``'s
    exposure below 1.0 with overlap, 1.0 blocking, and lowering before
    every step leaves the tokens as they were."""
    from mpi4torch_tpu_torch import analyze
    from mpi4torch_tpu_torch.analyze.__main__ import _corpus_programs

    out = {}
    # A: the sweep and the defect corpus.
    t0 = time.perf_counter()
    cases = skipped = 0
    for world in analyze.sweep_worlds(8):
        t1 = time.perf_counter()
        res = analyze.run_sweep(world, include_serve=(world == (8,)),
                                device="cuda")
        torch.cuda.synchronize()
        cases += res["n_cases"]
        skipped += res["n_skipped"]
        exposure = {r["case"]: r["scheduled_exposure"]
                    for r in res["records"] if "scheduled_exposure" in r}
        print(f"  sweep {world}: {res['n_cases']} cases, "
              f"{res['n_skipped']} skipped, {len(res['violations'])} "
              f"violations, {len(res['problems'])} registry problems; "
              f"exposure {exposure}; {time.perf_counter() - t1:.1f} s",
              flush=True)
        check(not res["violations"] and not res["problems"],
              f"the sweep of {world} on the card: {res['violations'][:3]} "
              f"{res['problems'][:3]}")
    sweep_s = time.perf_counter() - t0
    records = analyze.run_defect_corpus(_corpus_programs(8, "cuda"))
    caught = sum(r["clean_ok"] and r["fired"] for r in records)
    corpus_s = time.perf_counter() - t0 - sweep_s
    print(f"  defect corpus on 8 CUDA rank threads: {caught} of "
          f"{len(records)} defects caught by their named lint "
          f"({', '.join(r['defect'] + ' -> ' + r['lint'] for r in records)}"
          f"); sweep {sweep_s:.1f} s, corpus {corpus_s:.1f} s", flush=True)
    check(caught == len(records) == len(analyze.DEFECTS)
          and not analyze.defect_ledger_problems(records),
          "a seeded defect was not caught on the card")
    out["sweep"] = {"s": sweep_s, "corpus_s": corpus_s, "cases": cases,
                    "skipped": skipped, "defects": caught}

    # B: phase 51's DP=2 step, lowered.
    call = P.run_spmd(dp2_spmd_body(P, T, tree, dp, cfg), nranks=2)
    step_ms = [sync_ms(lambda: call(params, tokens))[0]]
    with ExchangeCounter() as cnt:
        step_ms.append(sync_ms(lambda: call(params, tokens))[0])
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    prog = analyze.lower(call, params, tokens)
    torch.cuda.synchronize()
    lower_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    max_alloc = torch.cuda.max_memory_allocated()
    parsed = analyze.parse_program(prog)
    mine = parsed.kernel_events()
    lints = analyze.run_lints(parsed)
    peak = analyze.peak_live_bytes(parsed)
    wire, census = analyze.wire_bytes_per_device(parsed)
    rec_bytes = sum(op.payload_bytes for op in parsed.collectives)
    cnt_bytes = sum(signature_bytes(sig) for sig in cnt.seq)
    # Rank 0's recorded events (one a layer) are the evidence; that both
    # ranks' events equal ``launch_counts`` is bookkeeping, since one
    # line of ``_launch`` counts both.
    events_ok = all(mine.get(k) == cfg.n_layers
                    and prog.kernels().get(k) == launches[k]
                    == 2 * cfg.n_layers for k in kernels.ATTENTION_KERNELS)
    ok = not lints and len(parsed.collectives) == cnt.exchanges \
        and rec_bytes == cnt_bytes and events_ok
    print(f"  phase 51's DP=2 step lowered: {len(parsed.events)} events on "
          f"rank 0, {len(parsed.collectives)} collectives {census} "
          f"(ExchangeCounter: {cnt.exchanges} exchanges a step), payload "
          f"{rec_bytes} B (ExchangeCounter {cnt_bytes} B), wire "
          f"{wire} B a device; lints {[str(v) for v in lints][:3]}; "
          f"custom_call events on rank 0 "
          f"{ {k: mine.get(k, 0) for k in kernels.ATTENTION_KERNELS} }, "
          f"on both {prog.kernels()}, launches "
          f"{ {k: launches[k] for k in kernels.ATTENTION_KERNELS} }; "
          f"lowering {lower_s:.2f} s against the step's "
          f"{[round(t, 1) for t in step_ms]} ms "
          f"({1e3 * lower_s / min(step_ms):.1f}x); peak_live_bytes "
          f"{peak / 2**30:.3f} GiB (rank 0's program) beside "
          f"max_memory_allocated {max_alloc / 2**30:.3f} GiB ("
          f"{(max_alloc - base) / 2**30:.3f} GiB above the allocation "
          f"before the step, both ranks)  {'ok' if ok else 'FAIL'}",
          flush=True)
    check(ok, "the lowered DP=2 step failed a check")
    # The recording stays for phase 66 (it holds no tensor).
    out["dp2"] = {"launches": prog.kernels(), "lower_s": lower_s,
                  "step_ms": min(step_ms), "peak_live_bytes": peak,
                  "max_memory_allocated": max_alloc,
                  "above_base": max_alloc - base,
                  "collectives": len(parsed.collectives), "wire": wire,
                  "events": len(parsed.events), "program": prog}
    del prog, parsed, call
    torch.cuda.empty_cache()

    # C: the fused q8 DP=2 step, lowered.
    bb = config.DEFAULT_BUCKET_BYTES
    nbk = fuse.bucket_layout(params, bb).num_buckets
    kernels.reset_launch_counts()
    prog = analyze.lower(P.run_spmd(
        fused_q8_spmd_body(P, T, tree, cfg, bb), nranks=2), params, tokens)
    launches = dict(kernels.launch_counts)
    parsed = analyze.parse_program(prog)
    mine = parsed.kernel_events()
    seen, fwd, bwd = P.compress.int8_rotation_census(prog, 2)
    lints = analyze.run_lints(parsed)
    # As in B: rank 0's events (one a bucket) are the evidence, the
    # equality with ``launch_counts`` bookkeeping.
    ok = not lints and fwd in seen and bwd in seen and all(
        prog.kernels().get(k) == launches[k] == 2 * nbk
        and mine.get(k) == nbk for k in ("q8_hop", "q8_requant"))
    print(f"  fused q8 DP=2 step lowered ({nbk} buckets): q8_hop / "
          f"q8_requant events {prog.kernels().get('q8_hop')} / "
          f"{prog.kernels().get('q8_requant')} (launches "
          f"{launches['q8_hop']} / {launches['q8_requant']}, rank 0 "
          f"{mine.get('q8_hop')} / {mine.get('q8_requant')}); int8 permute "
          f"tables {sorted(seen)}, forward {fwd} and backward {bwd} "
          f"rotations seen {fwd in seen and bwd in seen}; wire "
          f"{analyze.wire_bytes_per_device(parsed)}; lints "
          f"{[str(v) for v in lints][:3]}  {'ok' if ok else 'FAIL'}",
          flush=True)
    check(ok, "the lowered fused q8 DP=2 step failed a check")
    out["q8"] = {"hop": prog.kernels().get("q8_hop"),
                 "requant": prog.kernels().get("q8_requant"),
                 "buckets": nbk, "program": prog}
    del prog, parsed
    torch.cuda.empty_cache()

    # D: the SPMD engine's decode step.
    reqs = prompts[:SLOTS]

    def drive(overlap, lower_each_step):
        scfg = serve.ServeConfig(slots=SLOTS, max_new=ANALYZE_MAX_NEW,
                                 overlap=overlap)
        with torch.no_grad():
            eng = serve.Engine(cfg, params, scfg, spmd=True, nranks=2)
            for p in reqs:
                eng.submit(p, max_new=ANALYZE_MAX_NEW)
            eng.step()
            first = eng.lower_step()
            progs = [first]
            while eng.pending():
                if lower_each_step and eng.occupancy():
                    progs.append(eng.lower_step())
                eng.step()
            res = eng.results()
        return {i: res[i].tolist() for i in res}, progs

    plain, _ = drive(True, False)
    lowered, progs = drive(True, True)
    blocking, bprogs = drive(False, False)
    ov = analyze.scheduled_exposure(progs[0])
    bl = analyze.scheduled_exposure(bprogs[0])
    lints = [v for p in progs + bprogs for v in analyze.run_lints(p)]
    wire = {name: analyze.wire_bytes_per_device(p)
            for name, p in (("overlap", progs[0]),
                            ("blocking", bprogs[0]))}
    ok = not lints and plain == lowered == blocking \
        and bl["exposed_fraction"] == 1.0 \
        and ov["exposed_fraction"] < 1.0 \
        and wire["overlap"][0] == wire["blocking"][0]
    print(f"  Engine(spmd=True, nranks=2) decode step: exposure overlap "
          f"({ov['n_buckets']} buckets) {ov['exposed_fraction']}, "
          f"blocking ({bl['n_buckets']}) {bl['exposed_fraction']}; wire "
          f"{wire}; {len(progs)} lowerings, one before every step, leave "
          f"the tokens as they were {plain == lowered} (blocking's the "
          f"same {plain == blocking}); lints {len(lints)}  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "the SPMD engine's lowered decode step failed a check")
    out["serve"] = {"overlap": ov["exposed_fraction"],
                    "blocking": bl["exposed_fraction"],
                    "buckets": (ov["n_buckets"], bl["n_buckets"]),
                    "wire": wire["overlap"][0]}
    return out


# ---------------------------------------------------------------------------
# Phase 66: the runtime census against the recorded programs, and the CLIs
# ---------------------------------------------------------------------------

RECONCILE_SLOTS = 2          # phase 66 B: the two requests of JAX's case 1d
RECONCILE_MAX_NEW = 3        # phase 66 B's decode budget a request


def reconcile_report(rep):
    """One line of an ``obs.reconcile`` report: measured and predicted
    wire bytes and counts, and the verdicts."""
    m, p = rep["measured"], rep["predicted"]
    return (f"measured {m['wire_bytes']} B {m['counts']}, predicted "
            f"{p['wire_bytes']} B {p['counts']}; {m['logical_events']} "
            f"logical events a rank, ranks consistent "
            f"{m['per_rank_consistent']}, dropped {rep['dropped_events']}, "
            f"excluded {m['excluded']}; exposure "
            f"{p['scheduled_exposure']}")


def reconcile_phase(P, T, tree, dp, kernels, config, cfg, params, tokens,
                    prompts, verifier):
    """Phase 66: ``obs.reconcile`` on the card at full width, and the
    smoke CLIs.  A: phase 51's exact DP=2 step and the fused q8 DP=2 step
    traced under ``run_ranks`` and reconciled against phase 65's
    recordings of their ``run_spmd`` twins (B and C; not recorded again):
    wire bytes and per-kind counts exact, every rank consistent, nothing
    dropped; the q8 buckets priced through equivalent recordings, whose
    K1 launches are counted.  B: the TP=2 overlap decode step (JAX's
    ``obs --smoke`` case 1d at the flagship's width): a traced Mode B
    engine step after admission, behind a barrier sentinel, reconciled
    against ``Engine(spmd=True, nranks=2, overlap=True).lower_step()``
    at exposure 0.0.  C: ``overlap --smoke``, ``obs --smoke``, ``csched
    --smoke``, ``csched --tiers`` and ``serve --smoke`` in this process
    on the card, each exiting 0."""
    import importlib
    import io

    from mpi4torch_tpu_torch import obs
    from mpi4torch_tpu_torch.obs.__main__ import serve_decode_reconcile

    # The module (the package's ``reconcile`` is the function): its cache
    # of equivalent recordings counts them.
    rec = importlib.import_module("mpi4torch_tpu_torch.obs.reconcile")
    out = {}
    rows = TRAIN_BATCH // 2
    comm = P.COMM_WORLD
    bb = config.DEFAULT_BUCKET_BYTES

    def exact_step(r):
        x = tokens[r * rows:(r + 1) * rows]
        loss, g = dp.dp_value_and_grad(
            comm, lambda q, b: T.lm_loss(cfg, q, b))(params, x)
        with torch.no_grad():
            tree.tree_map(lambda a, b: a - LR * b, params, g)
        return loss

    def q8_step(r):
        x = tokens[r * rows:(r + 1) * rows]
        loss, g = tree.value_and_grad(lambda q: T.lm_loss(cfg, q, x),
                                      params)
        synced = comm.Allreduce_tree(g, P.MPI_SUM, mean=True,
                                     compression="q8", bucket_bytes=bb)
        with torch.no_grad():
            tree.tree_map(lambda a, s: a - LR * s, params, synced)
        return loss

    # A: the two DP=2 steps against phase 65's recordings.
    for name, body, program, want in (
            ("exact", exact_step, verifier["dp2"]["program"],
             kernels.ATTENTION_KERNELS),
            ("fused_q8", q8_step, verifier["q8"]["program"],
             kernels.ATTENTION_KERNELS + ("q8_hop", "q8_requant"))):
        kernels.reset_launch_counts()
        with obs.trace() as t:
            step_ms, _ = sync_ms(lambda: P.run_ranks(body, 2,
                                                     device="cuda"))
        launches = dict(kernels.launch_counts)
        n0 = len(rec._equiv_program_cache)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rep = obs.reconcile(t, program)
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        eq = {"lowerings": len(rec._equiv_program_cache) - n0,
              "launches": {k: kernels.launch_counts[k]
                           for k in ("q8_hop", "q8_requant")}}
        ok = rep["ok"] and rep["dropped_events"] == 0 \
            and rep["measured"]["per_rank_consistent"] \
            and all(launches[k] > 0 for k in want)
        if name == "fused_q8":
            ok = ok and eq["lowerings"] > 0 \
                and eq["launches"]["q8_hop"] > 0
        print(f"  {name} DP=2 step traced on run_ranks: "
              f"{reconcile_report(rep)}; the traced step {step_ms:.1f} ms, "
              f"launches { {k: launches[k] for k in want} }; reconcile "
              f"{rec_s:.2f} s, its {eq['lowerings']} equivalent "
              f"recordings included (their K1 launches "
              f"{eq['launches']})  {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"phase 66: the {name} DP=2 step did not reconcile "
                  f"exactly: {rep['matches']}")
        out[name] = {"step_ms": step_ms, "reconcile_s": rec_s,
                     "wire": rep["measured"]["wire_bytes"],
                     "counts": rep["measured"]["counts"],
                     "launches": {k: launches[k] for k in want},
                     "equivalent": eq}
        del t
    torch.cuda.empty_cache()

    # B: the TP=2 overlap decode step at full width.
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rep = serve_decode_reconcile(cfg, params, prompts[:RECONCILE_SLOTS], 2,
                                 "cuda", max_new=RECONCILE_MAX_NEW)
    torch.cuda.synchronize()
    leg_s = time.perf_counter() - t0
    k2 = {k: kernels.launch_counts[k] for k in ("flash_fwd",
                                                "flash_fwd.tc")}
    ok = rep["ok"] and rep["predicted"]["scheduled_exposure"] == 0.0 \
        and k2["flash_fwd"] > 0
    print(f"  TP=2 overlap decode step (slots {RECONCILE_SLOTS}, prompts "
          f"{[len(p) for p in prompts[:RECONCILE_SLOTS]]}): "
          f"{reconcile_report(rep)}; K2 launches in the leg {k2} (the "
          f"Mode B prefills on both ranks, the Mode A engine's and its "
          f"recorded step); {leg_s:.1f} s  {'ok' if ok else 'FAIL'}",
          flush=True)
    check(ok, "phase 66: the TP=2 decode step did not reconcile exactly "
              f"at exposure 0.0: {rep['matches']}, exposure "
              f"{rep['predicted']['scheduled_exposure']}")
    out["serve"] = {"wire": rep["measured"]["wire_bytes"],
                    "counts": rep["measured"]["counts"], "k2": k2,
                    "s": leg_s}
    torch.cuda.empty_cache()

    # C: the smoke CLIs, in this process on the card.
    from mpi4torch_tpu_torch.csched import __main__ as csched_cli
    from mpi4torch_tpu_torch.obs import __main__ as obs_cli
    from mpi4torch_tpu_torch.overlap import __main__ as overlap_cli
    from mpi4torch_tpu_torch.serve import __main__ as serve_cli

    out["cli_s"] = {}
    for name, fn in (("overlap --smoke", overlap_cli.smoke),
                     ("obs --smoke", obs_cli.smoke),
                     ("csched --smoke", csched_cli.smoke),
                     ("csched --tiers", csched_cli.tiers),
                     ("serve --smoke", serve_cli.smoke)):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = fn("cuda")
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        text = buf.getvalue()
        if name.startswith("csched"):
            report = json.loads(text)
            keep = ("ok", "failures", "synthesis", "reconcile",
                    "two_level", "registry_problems")
            lines = [json.dumps({k: report[k] for k in keep
                                 if k in report and k != "synthesis"})]
            if name == "csched --smoke":
                syn = report["synthesis"]
                lines.append(f"synthesis {syn['winner']} chain "
                             f"{syn['chain']}: recorded census "
                             f"{syn['census_recorded']}, predicted "
                             f"{syn['census_predicted']}")
        else:
            lines = text.splitlines()
        for ln in (text.splitlines() if rc else lines):
            print("    " + ln)
        print(f"  python -m mpi4torch_tpu_torch.{name} --device cuda "
              f"(in process): exit {rc} in {cli_s:.1f} s", flush=True)
        check(rc == 0, f"phase 66: {name} failed on the card")
        out["cli_s"][name] = cli_s
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
    from mpi4torch_tpu_torch.utils import threefry
    from mpi4torch_tpu_torch.models import resnet as R
    from mpi4torch_tpu_torch.models import vit as V
    from mpi4torch_tpu_torch.parallel import pp
    from mpi4torch_tpu_torch.utils import data
    from mpi4torch_tpu_torch import obs, resilience
    from mpi4torch_tpu_torch.examples import generate_kv_cache as kv_ex
    from mpi4torch_tpu_torch.examples import zero_sharded_optimizer \
        as zero_ex
    from mpi4torch_tpu_torch import reshard as rs
    from mpi4torch_tpu_torch.examples import checkpoint_resume as ckpt_ex

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
    # local memory (no spills); the forward fits two blocks (eight MMA
    # warps) per SM, each backward block (a producer warpgroup and two
    # wgmma consumer warpgroups that take its registers) one.
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
            want = 2 if kname == "flash_fwd" else 1
            check(pr["local_bytes"] == 0 and pr["blocks_per_sm"] >= want,
                  f"{kname} tc spills or fits fewer than {want} blocks per "
                  "SM")
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

    phase(23, "paged, sampled serving of the flagship transformer: "
          "prefix cache, copy-on-write, chunked prefill on K2, preemption")
    print(smi)
    paged = paged_phase(P, T, serve, kv, kernels, flash, threefry, cfg,
                        params, prompts, results)

    phase(24, "sequence-parallel training of the flagship transformer: "
          "SP=2 rank threads, ring, zigzag and ulysses")
    print(smi)
    sp = sp_phase(P, T, tree, dp, kernels, cfg, params, tokens, mean_ms)

    phase(25, f"long-context SP: 1 x {LONG_SEQ} tokens with rope, SP=2 "
          "rank threads, ring and zigzag")
    long_ctx = long_context_phase(P, T, tree, dp, kernels, cfg, params)

    phase(26, f"expert-parallel MoE training of the flagship: "
          f"{EP_EXPERTS} experts, capacity {EP_CAPACITY}, EP=2 rank threads")
    ep = ep_phase(P, T, tree, dp, kernels, cfg, tokens)

    phase(27, "tensor-parallel layers: tp_mlp and tp_attention "
          "(flash_attention), TP=2 rank threads")
    tp_layers = tp_layers_phase(P, kernels, flash)

    phase(28, f"the bf16 codecs and the compressed Allgather, "
          f"{BENCH_RANKS} rank threads x {BENCH_NUMEL} float32")
    print(smi)
    compressed = compression_phase(P, C, config, kernels, threefry)
    compressed["fused_bf16_ms"] = fused_bf16_line(
        P, T, tree, cfg, params, tokens, q8f, fused)

    phase(29, f"BASELINE config 4: ResNet-18 DP=2, batch {RESNET_BATCH} a "
          f"rank, {RESNET_HW} x {RESNET_HW} x 3, f32")
    resnet = resnet_phase(P, R, data, tree)

    phase(30, f"ViT-B/16, bf16, batch {VIT_BATCH} a rank: DP=2 and "
          "patch-parallel SP=2")
    vit = vit_phase(P, V, kernels, tree)

    phase(31, f"PP=2 on the flagship at full width: {PP_MB} microbatches "
          f"of {PP_ROWS} x {TRAIN_SEQ}, GPipe, 1F1B, interleaved")
    pipe = pp_phase(P, T, pp, kernels, flash, tree, cfg, params, tokens)

    phase(32, "kernel rows at this slice's shapes: K2/K3/K4 at the ViT, "
          "its patch-parallel block and the PP microbatch; K1 at the "
          "Allgather shard")
    print(smi)
    s10_shapes, s10_worst = attention_kernel_numbers(
        flash, kernels, SLICE10_KERNEL_SHAPES, seed0=600)
    requant = requant_numbers(qk)

    phase(33, "observability: the traced fused DP=2 step of the flagship "
          "(batch 8 x 2048, bf16, 4 MiB buckets)")
    traced = traced_dp2_phase(P, T, tree, fuse, obs, kernels, config, cfg,
                              params, tokens, smi)

    phase(34, "flight recorder: rank_death on rank 1 mid-step")
    print(smi)
    flight_phase(P, T, obs, resilience, fuse, config, cfg, params, tokens)

    phase(35, "finite guard on the DP=2 step and a 4 x 2^24 Allreduce")
    guard = guard_phase(P, T, tree, resilience, kernels, config, cfg,
                        params, tokens, smi)

    phase(36, f"wire checksum on the compressed Allgather, {BENCH_RANKS} "
          f"rank threads x {BENCH_NUMEL} float32")
    checksum = checksum_phase(P, resilience, kernels, config, smi)

    phase(37, "retries and gray failure")
    print(smi)
    retry_gray_phase(P, obs, resilience, config)

    phase(38, "traced TP=2 serving and the serving metrics")
    print(smi)
    serve_launches = traced_serving_phase(P, T, serve, obs, kernels, cfg,
                                          params, prompts, tp2)

    phase(39, "the generate_kv_cache and zero_sharded_optimizer examples "
          "on the card, and the 3-rank means")
    print(smi)
    example_launches = examples_means_phase(P, T, tree, kernels, kv_ex,
                                            zero_ex)

    phase(40, f"the reshard planner at full width: the flagship's bf16 tree "
          f"on {RESHARD_RANKS} rank threads, (8,) rows -> (2, 4)")
    resharded = reshard_phase(P, T, tree, rs, config, kernels, cfg, params,
                              smi)

    phase(41, "the train -> serve handoff: ZeRO-3 DP=2 Adam, admit_zero3 "
          "into TP=2 bf16 shards, TP=2 serving on them")
    print(smi)
    handoff = handoff_phase(P, T, tree, serve, kv, kernels, cfg, params,
                            tokens, prompts)

    phase(42, "checkpoint and preemption at full width: replicated DP=2 "
          "Adam, truncate_save, restore_or_init, Bcast_")
    ckpt = checkpoint_phase(P, T, tree, resilience, kernels, cfg, params,
                            tokens, smi)

    phase(43, f"MoE rebalance: EP=2, {EP_EXPERTS} experts, the planned "
          "block permutation under auto and rounds")
    print(smi)
    rebalance = moe_rebalance_phase(P, T, tree, cfg, tokens)

    phase(44, "the checkpoint_resume example on the card")
    print(smi)
    ckpt_example_phase(ckpt_ex)

    # The process transport: each rank its own worker process, CUDA
    # context and stream.  The parent frees what its caching allocator
    # holds first: the workers share the card with it.
    from mpi4torch_tpu_torch import transport
    torch.cuda.empty_cache()

    phase(45, f"the process transport: parity on ({PROC_RANKS},) worlds of "
          "CUDA workers against rank threads")
    print(smi)
    proc_parity = process_parity_phase(P, tree, kernels, rs, transport, smi)

    phase(46, "the flagship's DP=2 training on two worker processes")
    proc_train = process_flagship_phase(P, T, tree, kernels, transport, cfg,
                                         smi)

    phase(47, "real signals: SIGKILL, SIGTERM and a traced process run")
    process_signals_phase(P, transport, resilience, obs, smi)

    phase(48, "process transport numbers")
    proc_numbers = process_numbers_phase(P, transport, smi)
    transport.shutdown()

    phase(49, "Mode A (A): the op table and p2p programs under run_spmd at "
          f"2^20 float32 on {MODE_A_WORLDS} worlds and the (2, 4) mesh")
    print(smi)
    mode_a_ops_phase(P, tree)

    phase(50, f"Mode A (B): bench.py's Allreduce body at 2^26 float32 on "
          f"{MODE_A_BENCH_RANKS} rank threads")
    print(smi)
    mode_a_bench = mode_a_bench_phase(P, tree, config)

    phase(51, "Mode A (C): the flagship's DP=2 step under run_spmd")
    print(smi)
    mode_a_dp2 = mode_a_dp2_phase(P, T, tree, dp, kernels, config, cfg,
                                  params, tokens)

    phase(52, "Mode A (D): misuse and gradients from outside on the card")
    mode_a_misuse_phase(P)

    phase(53, "the variable_token_exchange example under run_spmd")
    vte_phase()

    phase(55, f"Mode A's users (A): the compressed collectives under "
          f"run_spmd at {BENCH_RANKS} x 2^24 float32, and phase 19's fused "
          "q8 DP=2 step under run_spmd(nranks=2)")
    print(smi)
    spmd_comp = spmd_compressed_phase(P, T, tree, fuse, kernels, config,
                                      cfg, params, tokens, q8f)

    phase(56, "Mode A's users (B): Engine(spmd=True, nranks=2) at full "
          "width, dense, paged with chunked prefill, and sampled")
    print(smi)
    spmd_eng = spmd_engine_phase(P, T, serve, kernels, threefry, tree, cfg,
                                 params, prompts, tp2_rate)

    phase(57, f"Mode A's users (C): pipeline_spmd PP=2 at full width, "
          f"{PP_MB} microbatches of {PP_ROWS} x 2048")
    print(smi)
    pps = pp_spmd_phase(P, T, pp, kernels, flash, tree, cfg, params, tokens,
                        pipe)

    phase(58, "Mode A's users (D): the SPMD reshard of the flagship tree "
          "(8,) -> (2, 4) under run_spmd(nranks=8)")
    print(smi)
    spmd_rs = spmd_reshard_phase(P, tree, rs, config, kernels, params,
                                 resharded)

    phase(59, "Mode A's users (E): the compress and reshard smoke CLIs")
    print(smi)
    cli_phase()

    phase(60, "the schedule IR on the card: every Mode A Allreduce, "
          "Bcast_, Reduce_ and the q8 family through csched against the "
          "hand-written forms")
    print(smi)
    ir = csched_phase(P, tree, config, kernels, mode_a_bench, spmd_comp)

    phase(61, "the flagship on a 2-D mesh: DP=2 x SP=2 (ring, ulysses), "
          "ZeRO-1 with SP and DP=2 x EP=2 on four rank threads under "
          "run_spmd(mesh=)")
    print(smi)
    mesh2d = mesh2d_phase(P, T, tree, kernels, cfg, params, tokens, sp,
                          dp_ms, ep["ms"])

    phase(62, "algorithm selection on the card: the autotuner's sweep "
          "and cache, auto selection and scopes on the main path, schedule "
          "synthesis, tier synthesis and the tier window, serving")
    print(smi)
    tuned = tune_phase(P, T, tree, dp, serve, kernels, config, cfg, params,
                       tokens, prompts)

    phase(63, "the elastic runtime, degraded mode, the chaos matrix and "
          "the self-tuning controller: a ZeRO-1 drain (4,) -> (2,), a "
          "hot-spare takeover, elastic TP=4 -> TP=2 serving, the degrade "
          "policies under gray faults, the closed loop, the matrices")
    print(smi)
    item6 = item6_phase(P, T, tree, serve, kernels, qk, fuse, config, cfg,
                        params, tokens, prompts, smi)

    phase(64, "the multi-process runtime: init_distributed and run_spmd "
          "across two worker processes on the card (A, JAX's worker "
          "shape; B, phase 51's DP=2 step; C, the q8 ring Allreduce; D, "
          "hybrid_mesh over process granules; E, a worker that leaves)")
    print(smi)
    dist = dist_phase(P, T, tree, dp, kernels, config, cfg, params, tokens,
                      smi)

    phase(65, "the collective-schedule verifier on the card: the sweep "
          "and the defect corpus on (8,), (3,), (1,) and (2, 4) worlds, "
          "phase 51's DP=2 step and the fused q8 DP=2 step lowered, "
          "Engine(spmd=True, nranks=2).lower_step()")
    print(smi)
    verifier = analyze_phase(P, T, tree, dp, serve, kernels, config, fuse,
                             cfg, params, tokens, prompts)

    phase(66, "the runtime census against the recorded programs: "
          "phase 51's exact DP=2 step and the fused q8 DP=2 step traced "
          "and reconciled with obs.reconcile at full width, the TP=2 "
          "overlap decode step, and the overlap, obs, csched and serve "
          "smoke CLIs on the card")
    print(smi)
    reconciled = reconcile_phase(P, T, tree, dp, kernels, config, cfg,
                                 params, tokens, prompts, verifier)

    phase(67, "kernels")
    print(smi)
    sp_shapes, sp_worst = sp_kernel_numbers(flash, kernels)
    # flash_fwd: launches on the serving path (phase 4), times at the
    # flagship prefill shape, its error the worst of the serving and the
    # training shape; "variant" is the one every serving launch took
    # (phase 4 checks that it is tc), "simt_ms" the CUDA-core kernel on
    # the same inputs, called by name, and "train_*" its numbers at the
    # training shape (phase 10); "paged_*" its launches in phase 23's
    # sampled run (all, at a q offset above 0) and greedy twin, "chunks"
    # its numbers at the chunked-prefill shapes (SDPA with a lower-right
    # causal mask as the library call).  flash_bwd_*: launches in the TP=1 training run
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
        "max_abs_err": max([errs["flagship_prefill"], train_err["flash_fwd"]]
                           + [c["max_abs_err"] for c in paged["chunks"]]),
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "simt_ms": simt_ms_prefill,
        "simt_source": src["flash_fwd"]["simt"],
        "train_launches": train_launches["flash_fwd"],
        "train_ms": k_ms["flash_fwd"], "train_simt_ms": simt_ms["flash_fwd"],
        "train_plain_ms": plain["flash_fwd"],
        "train_bound_ms": bounds["flash_fwd"][0],
        "train_library_ms": lib["flash_fwd"],
        "paged_launches": paged["launches"]["flash_fwd"],
        "paged_q_off_launches": paged["launches"]["flash_fwd.q_off"],
        "paged_greedy_launches": paged["greedy_launches"]["flash_fwd"],
        "chunks": paged["chunks"]}] + [{
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
    # This slice's paths: each attention kernel's launches per step under
    # each SP strategy (phase 24; all, at a nonzero offset, wholly
    # masked), per long-context step (phase 25), per EP step (phase 26)
    # and in one TP attention forward + backward (phase 27); its numbers
    # at the SP shapes (sp_shapes: a ring chunk's past, diagonal and
    # masked blocks, a zigzag half, Ulysses' full sequence, the long
    # context's ring blocks; the backward with a live dlse), and its
    # error the worst over those too.
    for entry in line["kernels"][:3]:
        kname = entry["name"]
        for key, i in (("sp_launches", 0), ("sp_offset_launches", 1),
                       ("sp_masked_launches", 2)):
            entry[key] = {a: sp["launches"][a][kname][i] for a in SP_ATTNS}
        entry["long_context_launches"] = {
            a: v[kname][0] for a, v in long_ctx["launches"].items()}
        entry["ep_launches"] = ep["launches"][kname][0]
        entry["tp_launches"] = tp_layers["tp_attention"]["launches"][kname]
        entry["sp_shapes"] = {
            name: {"ms": v["ms"][kname], "bound_ms": v["bound_ms"][kname],
                   "bound_by": v["bound_by"][kname],
                   "plain_ms": v["plain_ms"][kname],
                   "library_ms": v["library_ms"]["flash_fwd"]
                   if kname == "flash_fwd" else None,
                   "pair_library_ms": None if kname == "flash_fwd"
                   else v["library_ms"]["pair"],
                   "max_abs_err": v["max_abs_err"][kname]}
            for name, v in sp_shapes.items()}
        entry["max_abs_err"] = max(entry["max_abs_err"], sp_worst[kname])
    check(all(sp["launches"][a][k][0] > 0 for a in SP_ATTNS
              for k in kernels.ATTENTION_KERNELS)
          and all(sp["launches"][a][k][1] > 0 and sp["launches"][a][k][2] > 0
                  for a in ("ring", "zigzag")
                  for k in kernels.ATTENTION_KERNELS),
          "an SP strategy launched no attention kernel, or none at an "
          "offset or on a masked block")
    # This slice's paths: each attention kernel's launches in a ViT-B/16
    # DP=2 step and SP=2 forward + backward (phase 30) and in a PP=2 step
    # of each schedule (phase 31); its numbers at the ViT, patch-parallel
    # block and PP microbatch shapes (phase 32).  q8_hop: K1's requant
    # launches in each compressed Allgather (phase 28), its numbers at the
    # Allgather shard in the hop-0 form (phase 32).
    for entry in line["kernels"][:3]:
        kname = entry["name"]
        entry["vit_launches"] = {k: v[kname]
                                 for k, v in vit["launches"].items()}
        entry["pp_launches"] = {k: v["launches"][kname]
                                for k, v in pipe.items()}
        entry["slice10_shapes"] = {
            name: {"ms": v["ms"][kname], "bound_ms": v["bound_ms"][kname],
                   "bound_by": v["bound_by"][kname],
                   "plain_ms": v["plain_ms"][kname],
                   "library_ms": v["library_ms"]["flash_fwd"]
                   if kname == "flash_fwd" else None,
                   "pair_library_ms": None if kname == "flash_fwd"
                   else v["library_ms"]["pair"],
                   "max_abs_err": v["max_abs_err"][kname]}
            for name, v in s10_shapes.items()}
        entry["max_abs_err"] = max(entry["max_abs_err"], s10_worst[kname])
    hop_entry["allgather_requant_launches"] = {
        k: v["requant_launches"] for k, v in compressed["allgather"].items()}
    hop_entry["allgather_shard"] = requant
    check(all(v["requant_launches"] > 0 for k, v in
              compressed["allgather"].items() if k.startswith("q8")),
          "a compressed q8 Allgather launched no requant kernel")
    check(all(v[k] > 0 for v in vit["launches"].values()
              for k in kernels.ATTENTION_KERNELS)
          and all(v["launches"][k] > 0 for v in pipe.values()
                  for k in kernels.ATTENTION_KERNELS),
          "a ViT or PP run launched no attention kernel")
    # This slice's paths: each attention kernel's launches in the traced
    # DP=2 step (phase 33) and traced TP=2 serving (phase 38), under
    # obs_launches; in the clean guarded DP=2 step (phase 35) and the
    # generate_kv_cache example on the card (phase 39, f32: the simt
    # kernels), under resilience_launches and examples_launches.  q8_hop:
    # its hop launches in the traced fused q8 step (phase 33) and its
    # requant launches in the checksummed q8 Allgather (phase 36).
    for entry in line["kernels"][:3]:
        kname = entry["name"]
        entry["obs_launches"] = {"dp2_step": traced["launches"][kname]}
        if kname == "flash_fwd":
            entry["obs_launches"]["tp2_serving"] = serve_launches[kname]
        entry["resilience_launches"] = {
            "guarded_dp2_step": guard["launches"][kname]}
        entry["examples_launches"] = {
            "generate_kv_cache": example_launches[kname],
            "generate_kv_cache_simt": example_launches[f"{kname}.simt"]}
    hop_entry["obs_launches"] = {
        "fused_q8_step": traced["q8_launches"]["q8_hop"]}
    hop_entry["resilience_launches"] = {
        "checksummed_q8_allgather_requant":
            checksum["q8"]["requant_launches"]}
    check(all(v > 0 for e in line["kernels"]
              for key in ("obs_launches", "resilience_launches")
              for v in e[key].values()),
          "a kernel of this slice's paths was launched no time")
    # This slice's paths: each attention kernel's launches in the ZeRO-3
    # training before the handoff (phase 41) and in the DP=2 Adam run
    # that saves, resumes and redoes its last step (phase 42); flash_fwd's
    # in the TP=2 serving on the admitted shards (phase 41).  q8_hop: its
    # requant launches in the compressed wide hop of the reshard (phase
    # 40).
    for entry in line["kernels"][:3]:
        kname = entry["name"]
        entry["handoff_launches"] = {
            "zero3_train": handoff["train_launches"][kname]}
        if kname == "flash_fwd":
            entry["handoff_launches"]["tp2_serving"] = \
                handoff["serve_launches"][kname]
        entry["checkpoint_launches"] = {"dp2_adam": ckpt["launches"][kname]}
    hop_entry["reshard_launches"] = {
        "compressed_wide_hop_requant": resharded["wide_hop"]["requant"]}
    check(all(v > 0 for e in line["kernels"]
              for key in ("handoff_launches", "checkpoint_launches",
                          "reshard_launches") if key in e
              for v in e[key].values()),
          "a kernel of this slice's paths was launched no time")
    # This slice's paths: each attention kernel's launches in the two
    # workers of the flagship's DP=2 steps (phase 46), K1's in the three
    # workers of the q8 Allreduce (phase 45), counted in the workers and
    # returned by the rank bodies.
    for entry in line["kernels"][:3]:
        entry["process_launches"] = {
            "flagship_dp2_workers": proc_train["launches"][entry["name"]]}
    hop_entry["process_launches"] = {
        "q8_allreduce_workers": proc_parity["q8"]["q8_hop"],
        "q8_allreduce_workers_requant": proc_parity["q8"]["q8_requant"]}
    check(all(v > 0 for e in line["kernels"]
              for v in e["process_launches"].values()),
          "a kernel of this slice's paths was launched no time")
    # Mode A: each attention kernel's launches in the three DP=2 steps of
    # the flagship under run_spmd (phase 51, both ranks, outside
    # deterministic mode).
    for entry in line["kernels"][:3]:
        entry["mode_a_launches"] = {
            "flagship_dp2_run_spmd": mode_a_dp2["launches"][entry["name"]]}
    check(all(e["mode_a_launches"]["flagship_dp2_run_spmd"] > 0
              for e in line["kernels"][:3]),
          "a kernel of this slice's paths was launched no time")
    # Mode A's users (phases 55-58): each attention kernel's launches in
    # the fused q8 DP=2 step under run_spmd (phase 55) and the
    # pipeline_spmd step (phase 57); flash_fwd's in the SPMD engine's
    # three runs (phase 56, prefill and chunks); K1's hop and requant
    # launches in the compressed Allreduces and Allgathers (phase 55,
    # forward and backward), in the DP=2 step, and its requant launches
    # in the SPMD reshard's compressed gather hop (phase 58).
    for entry in line["kernels"][:3]:
        kname = entry["name"]
        entry["mode_a_launches"]["fused_q8_dp2_run_spmd"] = \
            spmd_comp["dp2"]["launches"][kname]
        entry["mode_a_launches"]["pipeline_spmd_pp2"] = \
            pps["launches"][kname]
        if kname == "flash_fwd":
            entry["mode_a_launches"]["engine_spmd_tp2"] = \
                spmd_eng["k2"]["flash_fwd"]
    hop_entry["mode_a_launches"] = {
        "compressed_collectives_hop": spmd_comp["k1"]["q8_hop"],
        "compressed_collectives_requant": spmd_comp["k1"]["q8_requant"],
        "fused_q8_dp2_hop": spmd_comp["dp2"]["launches"]["q8_hop"],
        "fused_q8_dp2_requant": spmd_comp["dp2"]["launches"]["q8_requant"],
        "reshard_wide_hop_requant": spmd_rs["wide_hop"]["requant"]}
    check(all(v > 0 for e in line["kernels"]
              for v in e["mode_a_launches"].values())
          and spmd_eng["k2"]["flash_fwd"] == spmd_eng["k2"]["flash_fwd.tc"],
          "a kernel of Mode A's users was launched no time, or an SPMD "
          "engine prefill left the tc kernel")
    # The schedule IR and the 2-D mesh (phases 60-61): K1's hop and
    # requant launches on the q8 IR route (forward and backward, the nine
    # codec x algorithm pairs), each attention kernel's launches in the
    # timed full-width step of each 2-D form.
    for entry in line["kernels"][:3]:
        entry["mesh_2d_launches"] = {
            form: counts[entry["name"]][0]
            for form, counts in mesh2d["launches"].items()}
    hop_entry["csched_launches"] = {
        "q8_ir_route_hop": ir["k1"]["q8_hop"],
        "q8_ir_route_requant": ir["k1"]["q8_requant"]}
    check(all(v > 0 for e in line["kernels"][:3]
              for v in e["mesh_2d_launches"].values())
          and all(v > 0 for v in hop_entry["csched_launches"].values()),
          "a kernel of the schedule IR or 2-D mesh paths was launched no "
          "time")
    # Algorithm selection (phase 62): each attention kernel's launches in
    # the two tuned DP=2 steps under run_spmd; K1's hop launches during
    # the q8 sweep and its requant launches on the q8-slow tier program.
    for entry in line["kernels"][:3]:
        entry["tune_launches"] = {
            "tuned_dp2": tuned["selection"]["dp2"]["launches"][
                entry["name"]]}
    hop_entry["tune_launches"] = {
        "q8_sweep_hop": tuned["q8_hop"],
        "q8_slow_tier_requant": tuned["tiers"]["q8-slow"]["requant"]}
    check(all(v > 0 for e in line["kernels"][:3]
              for v in e["tune_launches"].values())
          and all(v > 0 for v in hop_entry["tune_launches"].values()),
          "a kernel of the algorithm-selection path was launched no time")
    # The elastic runtime, degraded mode and the controller (phase 63):
    # each attention kernel's launches in leg A's two ZeRO-1 steps, leg
    # B's spare and takeover steps and leg D's escalated fused DP=2 steps;
    # flash_fwd's in leg C's TP=4 and TP=2 serving; K1's hop launches in
    # the q8 step after codec_escalate and its requant launches in the
    # controller's escalated runs.
    for entry in line["kernels"][:3]:
        kname = entry["name"]
        entry["item6_launches"] = {
            "zero1_drain": item6["drain"]["launches"][kname],
            "spare_takeover": item6["spare"]["launches"][kname],
            "codec_escalate_dp2": item6["degrade"]["codec_escalate"][
                "launches"][kname]}
        if kname == "flash_fwd":
            entry["item6_launches"]["elastic_serving"] = \
                item6["serve"]["launches"][kname]
    hop_entry["item6_launches"] = {
        "codec_escalate_hop": item6["degrade"]["codec_escalate"]["hops"],
        "controller_requant": item6["ctl"]["launches"]["q8_requant"],
        "controller_installed_requant":
            item6["ctl"]["installed_launches"]["q8_requant"]}
    check(all(v > 0 for e in line["kernels"]
              for v in e["item6_launches"].values()),
          "a kernel of the elastic, degrade or controller paths was "
          "launched no time")
    # The multi-process runtime (phase 64): each attention kernel's
    # launches in the two workers of leg B's three DP=2 steps under
    # run_spmd across processes; K1's hop and requant launches in leg C's
    # two workers.
    for entry in line["kernels"][:3]:
        entry["dist_launches"] = {
            "flagship_dp2_two_processes": dist["launches"][entry["name"]]}
    hop_entry["dist_launches"] = {
        "q8_ring_two_processes_hop": dist["k1"]["q8_hop"],
        "q8_ring_two_processes_requant": dist["k1"]["q8_requant"]}
    check(all(v > 0 for e in line["kernels"]
              for v in e["dist_launches"].values()),
          "a kernel of the multi-process path was launched no time")
    # The verifier (phase 65): each kernel's custom_call events, on both
    # ranks, in the recorded programs (equal to its launches during the
    # recording): the attention kernels' in phase 51's lowered DP=2 step,
    # K1's in the lowered fused q8 DP=2 step.
    for entry in line["kernels"][:3]:
        entry["analyze_launches"] = {
            "flagship_dp2_lowered": verifier["dp2"]["launches"][
                entry["name"]]}
    hop_entry["analyze_launches"] = {
        "fused_q8_dp2_lowered_hop": verifier["q8"]["hop"],
        "fused_q8_dp2_lowered_requant": verifier["q8"]["requant"]}
    check(all(v > 0 for e in line["kernels"]
              for v in e["analyze_launches"].values()),
          "a kernel of the verifier's recorded programs was launched no "
          "time")
    # The runtime census (phase 66): each attention kernel's launches in
    # the traced exact and fused q8 DP=2 steps, flash_fwd's in the TP=2
    # decode leg; K1's hop and requant launches in the traced q8 step and
    # its hop launches in the equivalent recordings of its buckets.
    for entry in line["kernels"][:3]:
        entry["reconcile_launches"] = {
            f"{leg}_dp2_traced": reconciled[leg]["launches"][entry["name"]]
            for leg in ("exact", "fused_q8")}
        if entry["name"] == "flash_fwd":
            entry["reconcile_launches"]["tp2_decode_leg"] = \
                reconciled["serve"]["k2"]["flash_fwd"]
    hop_entry["reconcile_launches"] = {
        "fused_q8_dp2_traced_hop":
            reconciled["fused_q8"]["launches"]["q8_hop"],
        "fused_q8_dp2_traced_requant":
            reconciled["fused_q8"]["launches"]["q8_requant"],
        "equivalent_recordings_hop":
            reconciled["fused_q8"]["equivalent"]["launches"]["q8_hop"]}
    check(all(v > 0 for e in line["kernels"]
              for v in e["reconcile_launches"].values()),
          "a kernel of the reconciled steps was launched no time")
    print(json.dumps(line))
    print(f"  process transport: DP=2 step "
          f"{proc_train['process_ms']:.1f} ms on workers vs "
          f"{proc_train['thread_ms']:.1f} ms on threads; rendezvous "
          f"{proc_numbers['latency_us']['4_process']:.1f} us on 4 workers; "
          f"the parent wire {proc_numbers['parent_gb_s']:.2f} GB/s")
    print(f"  ResNet-18 DP=2 step {resnet['dp_grad_train_step']['ms']:.1f} "
          f"ms; ViT-B/16 DP=2 step {vit['ms']:.1f} ms; PP=2 1F1B step "
          f"{pipe['1f1b']['ms']:.1f} ms; reshard auto / gather "
          f"{np.mean(resharded['auto']['ms']):.1f} / "
          f"{np.mean(resharded['gather']['ms']):.1f} ms a tree; handoff "
          f"{handoff['ms'][-1]:.1f} ms; checkpoint save "
          f"{ckpt['bytes'] / min(ckpt['save_s']) / 1e9:.2f} GB/s, restore "
          f"{ckpt['bytes'] / ckpt['restore_s'] / 1e9:.2f} GB/s; MoE "
          f"rebalance {rebalance}")
    print(f"  Mode A: DP=2 step {mode_a_dp2['ms']['spmd']:.1f} ms under "
          f"run_spmd vs {mode_a_dp2['ms']['ranks']:.1f} ms under run_ranks "
          f"({mode_a_dp2['rendezvous']['spmd']} vs "
          f"{mode_a_dp2['rendezvous']['ranks']} rendezvous a step); bench "
          "Allreduce at 4 x 2^26 float32 "
          + ", ".join(f"{k} {v['ms']:.2f} ms" for k, v in
                      mode_a_bench[4].items()))
    print(f"  Mode A's users: fused q8 DP=2 step "
          f"{spmd_comp['dp2']['ms']:.1f} ms under run_spmd; SPMD engine "
          "decode "
          + ", ".join(f"{k} {v['decode_tok_s']:.1f}" for k, v in
                      spmd_eng.items() if k != "k2")
          + f" tokens/s; pipeline_spmd step {pps['ms']:.1f} ms; SPMD "
          f"reshard auto / gather {np.mean(spmd_rs['auto']['ms']):.1f} / "
          f"{np.mean(spmd_rs['gather']['ms']):.1f} ms a tree")
    print("  schedule IR, IR route / hand-written (median ms): "
          + ", ".join(f"{k} {v['ir']['ms']:.2f} / "
                      f"{v['hand_written']['ms']:.2f}"
                      for k, v in ir["bench"].items())
          + f"; phase 55's q8 bidir {ir['q8_bidir_ms']:.2f} ms; 2-D mesh "
          "steps " + ", ".join(f"{k} {v:.1f} ms"
                               for k, v in mesh2d["ms"].items()))
    print(f"  algorithm selection: sweep {tuned['sweep_s']:.1f} s, "
          f"crossovers {tuned['crossovers']}; tuned DP=2 step under "
          f"run_spmd {tuned['selection']['dp2']['ms']:.1f} ms vs "
          f"{tuned['selection']['dp2']['untuned_ms']:.1f} ms untuned; SPMD "
          f"TP=2 decode {tuned['serve']['tok_s']:.1f} tokens/s tuned vs "
          f"{tuned['serve']['untuned_tok_s']:.1f} untuned")
    print(f"  elastic: drain consensus {item6['drain']['consensus_ms']:.1f}"
          f" ms, drain {item6['drain']['drain_ms']:.1f} ms; spare "
          f"death-to-resume {item6['spare']['resume_ms']:.1f} ms; serving "
          f"drain + readmit {item6['serve']['drain_ms']:.1f} + "
          f"{item6['serve']['readmit_ms']:.1f} ms, re-prefill "
          f"{item6['serve']['reprefill_ms']:.1f} ms; closed loop "
          f"{item6['ctl']['episode_s']:.1f} s")
    print(f"  multi-process: DP=2 step across two processes "
          f"{max(dist['step_ms']):.1f} ms vs {dist['one_process_ms']:.1f} ms "
          f"in one process; {dist['wire']['sent_bytes'] / 1e9:.3f} GB sent "
          f"and {dist['wire']['received_bytes'] / 1e9:.3f} GB received a "
          f"step by worker 0; its device idle {dist['idle_pct']:.1f}%")
    print(f"  verifier: the card sweep {verifier['sweep']['s']:.1f} s "
          f"({verifier['sweep']['cases']} cases) and the defect corpus "
          f"{verifier['sweep']['corpus_s']:.1f} s; lowering phase 51's "
          f"DP=2 step {verifier['dp2']['lower_s']:.2f} s against its "
          f"{verifier['dp2']['step_ms']:.1f} ms step; peak_live_bytes "
          f"{verifier['dp2']['peak_live_bytes'] / 2**30:.3f} GiB beside "
          f"max_memory_allocated "
          f"{verifier['dp2']['max_memory_allocated'] / 2**30:.3f} GiB; "
          f"decode exposure overlap {verifier['serve']['overlap']} vs "
          f"blocking {verifier['serve']['blocking']}")
    print(f"  runtime census: the traced exact DP=2 step "
          f"{reconciled['exact']['step_ms']:.1f} ms, reconciled in "
          f"{reconciled['exact']['reconcile_s']:.2f} s; the fused q8 "
          f"step {reconciled['fused_q8']['step_ms']:.1f} ms, reconciled "
          f"in {reconciled['fused_q8']['reconcile_s']:.2f} s with "
          f"{reconciled['fused_q8']['equivalent']['lowerings']} "
          f"equivalent recordings; TP=2 decode leg "
          f"{reconciled['serve']['s']:.1f} s; CLIs "
          + ", ".join(f"{k} {v:.1f} s"
                      for k, v in reconciled["cli_s"].items()))
    phase(68)
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(sys.argv[2:]))
    sys.exit(main())
