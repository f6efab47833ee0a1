#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mpi4torch_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 (sm_90a)
and the CUDA toolkit.  It exits non-zero, printing no result, when CUDA is
unavailable, when the package cannot be imported, or when any phase's
check fails.  Phases, in order:

1. device: the card's name and power limit;
2. build: ``nvcc`` compiles the port's kernels from ``ops/csrc``;
3. the block-attention kernel (``flash_fwd``) against its plain PyTorch
   version on the card, on the cases listed in ``KERNEL_CASES``, each
   within the stated tolerance;
4. serving at the full width of the flagship transformer (vocab 32768,
   d_model 2048, 16 heads, 8 layers, d_ff 8192, max_seq 2048; bf16,
   random weights from a seed) on a tensor-parallel world of one: eight
   greedy requests through ``serve.Engine`` with four slots, checked
   against the port's own ``generate()``, with the kernel's launch count
   proving that every prefill ran through it;
5. the same model on a two-rank world (``run_ranks``, both rank threads on
   the one card): four requests, both ranks bitwise identical, the
   first prefill's logits within tolerance of the one-rank logits;
6. numbers: the kernel's time at the flagship prefill shape beside its
   bound, its plain version and ``scaled_dot_product_attention`` (timed
   only; the port never calls it), then prefill, TTFT, decode rate and
   peak memory;
7. one JSON line describing each ported kernel.

The last line is ``{"ok": true, "device": {"platform": "gpu", ...}}``.
TF32 is switched off for matmuls and cuDNN here, so float32 work on the
card stays float32-exact like the JAX reference.
"""

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
# accumulate in f32 and round once at the end, so bf16 outputs differ by
# about one bf16 ulp (2^-8 relative); lse is f32 on both sides.
TOL = {torch.bfloat16: {"out": 1e-2, "lse": 1e-4},
       torch.float32: {"out": 1e-5, "lse": 1e-5}}

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
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def kernel_phase(flash):
    results = {}
    for i, (name, dt, b, sq, sk, h, h_kv, d, q_off, kv_off, window,
            causal) in enumerate(KERNEL_CASES):
        q, k, v = attention_inputs(dt, b, sq, sk, h, h_kv, d, seed=i)
        kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off,
                  window=window)
        o, l = flash.flash_block_attention(q, k, v, impl="cuda", **kw)
        po, pl = flash.flash_block_attention(q, k, v, impl="torch", **kw)
        torch.cuda.synchronize()
        err_o = (o.float() - po.float()).abs().max().item()
        err_l = (l - pl.float()).abs().max().item()
        tol = TOL[dt]
        ok = (err_o <= tol["out"] and err_l <= tol["lse"]
              and bool(torch.isfinite(o).all()))
        if name == "fully_masked_rows":
            n_masked = kv_off - q_off
            ok = ok and bool((o[:, :n_masked] == 0).all()) and bool(
                (l[:, :n_masked] == flash.NEG_BIG).all())
        print(f"  {name:24s} {str(dt):15s} out err {err_o:.3e} "
              f"(tol {tol['out']:g})  lse err {err_l:.3e} "
              f"(tol {tol['lse']:g})  {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"kernel case {name} disagrees with the plain version")
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
    launches = kernels.launch_counts["flash_fwd"]
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


def serve_tp2(P, T, serve, kv, kernels, cfg, params, prompts):
    def rank_body():
        with torch.inference_mode():
            shards = kv.shard_params_tp(cfg, params, P.COMM_WORLD)
            cache = kv.init_kv_cache_tp(cfg, 1, P.COMM_WORLD.size,
                                        params["embed"].dtype, "cuda")
            p0 = torch.as_tensor(prompts[0], device="cuda")[None]
            logits, _ = kv.prefill_tp(cfg, shards, cache, p0, P.COMM_WORLD)
            eng = serve.Engine(cfg, params,
                               serve.ServeConfig(slots=SLOTS,
                                                 max_new=TP2_MAX_NEW),
                               device="cuda")
            for p in prompts[:TP2_REQUESTS]:
                eng.submit(p)
            res = eng.run()
            return logits[0].float().cpu(), \
                [res[i].tolist() for i in range(TP2_REQUESTS)]

    kernels.reset_launch_counts()
    ms, out = sync_ms(lambda: P.run_ranks(rank_body, 2, device="cuda"))
    return out, kernels.launch_counts["flash_fwd"], ms


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
    from mpi4torch_tpu_torch.serve import kv

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
    for line in log["flash_fwd"]["output"].splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    phase(3, "kernel vs plain version on the card")
    errs = kernel_phase(flash)

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
              f"{launches} (expected n_layers x prefills = {want})")
        check(launches == want, f"flash_fwd launched {launches} times, "
              f"expected {want}: prefill did not run on the kernel")
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
    (r0, r1), launches2, tp2_ms = serve_tp2(P, T, serve, kv, kernels, cfg,
                                            params, prompts)
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
          f"flash_fwd launches {launches2} (expected {want2})")
    check(tp_diff <= TP_LOGIT_TOL, "TP=2 prefill logits too far from TP=1")
    check(launches2 == want2, "TP=2 prefill did not run on the kernel")

    phase(6, "numbers")
    dt = torch.bfloat16
    _, _, b, sq, sk, h, h_kv, d, q_off, kv_off, window, causal = \
        KERNEL_CASES[0]
    q, k, v = attention_inputs(dt, b, sq, sk, h, h_kv, d, seed=0)
    kw = dict(causal=True, q_offset=q_off, kv_offset=kv_off, window=window)
    plain_ms = event_ms(lambda: flash.flash_block_attention(
        q, k, v, impl="torch", **kw))
    kernel_ms = event_ms(lambda: flash.flash_block_attention(
        q, k, v, impl="cuda", **kw))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = event_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
    pairs = live_pairs(sq, sk, q_off, kv_off, window, causal)
    flops = 4.0 * b * h * d * pairs
    nbytes = (2 * b * sq * h * d + 2 * b * sk * h_kv * d) * 2 \
        + b * sq * h * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dt] * 1e3, nbytes / PEAK_BYTES_S * 1e3
    bound_ms, bound_by = max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")
    print(f"  flash_fwd at (1, 1024, 16, 128) bf16 causal: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB)")
    ttft = snap.get("ttft_s", {})
    print(f"  prefill per request {np.mean(prefill_ms):.2f} ms mean "
          f"(prompts {min(map(len, prompts))}-{max(map(len, prompts))} "
          f"tokens); TTFT p50 {ttft.get('p50', float('nan')) * 1e3:.1f} ms "
          f"(all {N_REQUESTS} submitted at once, {SLOTS} slots); decode "
          f"{decode_tok / (decode_ms / 1e3):.1f} tokens/s over "
          f"decode-only steps; peak memory {peak_gb:.2f} GiB")

    phase(7, "kernels")
    line = {"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "mpi4torch_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "mpi4torch_tpu/ops/flash.py:243",
        "launches": launches, "max_abs_err": errs["flagship_prefill"],
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}]}
    print(json.dumps(line))
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
