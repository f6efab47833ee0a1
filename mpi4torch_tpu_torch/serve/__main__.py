"""``python -m mpi4torch_tpu_torch.serve --smoke [--device cpu]`` — the
serve-smoke lane.

Port of ``mpi4torch_tpu/serve/__main__.py``: the serving subsystem end
to end on a TP world of :data:`NRANKS` rank threads:

1. **engine-vs-oracle bitwise**: the continuous-batching engine's tokens
   against per-request ``generate()``, with admission/eviction churn (4
   requests through 2 slots), under EVERY registered scheduling policy,
   on ``run_spmd`` and on the rank threads; the registry-sync guard
   fails a policy added to ``serve.POLICIES`` without appearing in
   :data:`PARITY_POLICIES`;
2. **scheduled-exposure census**: the recorded Mode A decode step
   (``Engine.lower_step``) with the overlap schedule censuses strictly
   below 1.0 exposed decode collectives (the blocking baseline 1.0);
3. **latency-tier selection**: with a latency crossover in place,
   ``serve.latency_report`` picks a latency-tier algorithm for the real
   decode chunk sizes AND the recorded decode step carries the resolved
   ``Allreduce_start.<algo>`` span with no bandwidth-tier schedule;
4. **fault composition**: a ``rank_death`` injected mid-decode on the
   rank threads raises an attributed ``RankFailedError``;
5. **paged bitwise under block churn**: the paged engine with a pool
   smaller than the dense equivalent, bitwise the oracle under every
   policy (and the paged registry guard, :data:`PAGED_PARITY_POLICIES`,
   :data:`MIRRORED_SERVE_COUNTERS`);
6. **prefix sharing prefills the shared prefix exactly once**, and the
   sharers' table rows hold the same page ids for it;
7. **counter mirror**: every ``ServeStats`` counter appears in
   ``obs.prometheus_text()`` as an ``mpi4torch_serve_*`` metric;
8. **no-retrace census**: the paged decode step records the SAME
   program across two block-table states (the table is data, not
   structure): equal op kinds and span paths, equal collectives (kinds,
   operand and result types, groups), and a stable block-gather count
   (the JAX package compares the lowered text).  The port picks a step's
   write cells on the host, so the two states each hold a live writer
   whose page is mapped (a step at a page boundary maps its page at the
   next ``step()``; recorded before that, it writes nothing).

Exits non-zero on any divergence.  The device is CUDA unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import sys

# The parity-covered policies: must equal serve.POLICIES, so a
# scheduling policy can never ship without oracle-parity coverage.
PARITY_POLICIES = ("fcfs", "shortest_first")

# The policies the PAGED engine-vs-oracle matrix covers (lane 5):
# must equal serve.POLICIES (analyze.registry.serve_paging_problems).
PAGED_PARITY_POLICIES = ("fcfs", "shortest_first")

# Every ServeStats counter mirrored into the obs metrics as
# mpi4torch_serve_<name> (lane 7 asserts the exposition literally).
# Must equal utils.profiling.ServeStats._COUNTERS.
MIRRORED_SERVE_COUNTERS = (
    "steps", "admitted", "evicted", "finished", "rejected",
    "decode_tokens", "occupancy_ticks", "slot_ticks",
    "deadline_expired", "shed",
    "prefix_hits", "prefix_misses", "prefill_tokens", "cow_copies",
    "preempted", "blocks_in_use", "blocks_free", "blocks_cached",
)

#: TP world of the lane (the JAX CLI's 4 of 8 host devices).
NRANKS = 4


def _program_key(program):
    """What lane 8 holds equal across block-table states: each op's kind,
    kernel and span path, and each collective's kind, operand and result
    types, groups, pairs and span.  (An op's result size may differ: the
    host-side pick of the live write cells sizes by their count.)"""
    ops = [(e.kind, e.target, e.scope) for e in program.events]
    colls = [(c.kind, c.operand_types, c.result_types, c.replica_groups,
              c.source_target_pairs, c.scope)
             for c in program.collectives]
    return ops, colls


def _block_gathers(program, nbytes: int) -> int:
    """The block gathers of a recorded paged decode step: its ``index``
    ops whose result is a whole gathered K or V extent of ``nbytes``
    (``ops.ragged.block_gather``)."""
    return sum(1 for e in program.events
               if e.kind == "index" and e.results
               and e.results[0][1] == nbytes)


def smoke(device=None) -> int:
    import numpy as np
    import torch

    from .. import RankFailedError, config, obs, run_ranks, serve
    from .. import resilience as rz
    from ..analyze import parse_program
    from ..analyze.registry import (serve_paging_problems,
                                    serve_policy_problems)
    from ..models import transformer as T
    from ..overlap import scheduled_exposure
    from ..runtime import resolve_device

    dev = resolve_device(device)
    size = NRANKS
    print(f"serve-smoke: device {dev}, TP world ({size},)")

    cfg = T.TransformerConfig(vocab=61, d_model=32, n_heads=4,
                              n_layers=2, d_ff=64, max_seq=32)
    params = T.init_transformer(0, cfg,
                                dtype=torch.float32, device=dev)
    prompts = [np.array([1, 2, 3]), np.array([4, 5, 6, 7, 8]),
               np.array([9, 10]), np.array([11, 12, 13, 14])]
    budgets = [6, 4, 5, 3]

    def oracle(p, n):
        return T.generate(cfg, params, torch.as_tensor(
            p, dtype=torch.int64, device=dev)[None, :], n,
            dtype=torch.float32)[0].cpu().numpy()

    want = [oracle(p, n) for p, n in zip(prompts, budgets)]

    def check(results, label) -> bool:
        for i, w in enumerate(want):
            if not np.array_equal(np.asarray(results[i]), w):
                print(f"FAIL: {label}: request {i} tokens diverge from "
                      f"per-request generate()")
                return False
        return True

    def engine(serve_cfg, spmd=True):
        if spmd:
            return serve.Engine(cfg, params, serve_cfg, spmd=True,
                                nranks=size, device=dev)
        return serve.Engine(cfg, params, serve_cfg, device=dev)

    # 1. Registry-sync guard + the engine-vs-oracle parity matrix.
    sync = serve_policy_problems(PARITY_POLICIES)
    if sync:
        for p in sync:
            print(f"FAIL: {p}")
        return 1
    for policy in sorted(serve.POLICIES):
        eng = engine(serve.ServeConfig(slots=2, policy=policy,
                                       overlap=True))
        for p, n in zip(prompts, budgets):
            eng.submit(p, max_new=n)
        if not check(eng.run(), f"Mode A ({size},) policy={policy}"):
            return 1
    print(f"engine: bitwise == per-request generate() on ({size},), "
          f"both policies, across slot churn "
          f"({len(prompts)} requests / 2 slots)")

    def fn(rank):
        e = engine(serve.ServeConfig(slots=2, overlap=True), spmd=False)
        for p, n in zip(prompts, budgets):
            e.submit(p, max_new=n)
        return e.run()

    outs = run_ranks(fn, size, timeout=300.0, device=dev)
    if not check(outs[0], f"Mode B ({size},)"):
        return 1
    print(f"engine: Mode B ({size},) rank threads bitwise == oracle")

    # 2. Scheduled-exposure census of the recorded decode step.
    census = {}
    for name, ov in (("overlap", True), ("blocking", False)):
        eng = engine(serve.ServeConfig(slots=2, overlap=ov))
        eng.submit(prompts[0], max_new=3)
        eng.step()
        census[name] = scheduled_exposure(eng.lower_step())
    co, cb = census["overlap"], census["blocking"]
    print(f"scheduled exposure: overlap {co['exposed_fraction']} "
          f"({co['n_buckets']} buckets), blocking "
          f"{cb['exposed_fraction']} ({cb['n_buckets']} buckets)")
    if not (co["n_buckets"] and co["exposed_fraction"] < 1.0):
        print("FAIL: overlap decode schedule does not census < 1.0 "
              "exposed")
        return 1
    if cb["exposed_fraction"] != 1.0:
        print("FAIL: blocking decode baseline should census 1.0")
        return 1

    # 3. Latency-tier selection on the real decode message sizes.
    prev = config.latency_crossover_bytes()
    config.set_latency_crossover_bytes(1 << 14)
    try:
        rep = serve.latency_report(cfg, serve.ServeConfig(slots=2), size,
                                   torch.float32)
        print(f"latency tier: {rep['chunk_bytes']} B decode chunks "
              f"(cache bucket {rep['cache_bucket_bytes']}) -> "
              f"{rep['algorithm']}")
        if not rep["latency_tier"]:
            print(f"FAIL: decode selection {rep} did not land in the "
                  "latency tier under the measured crossover")
            return 1
        eng = engine(serve.ServeConfig(slots=2, overlap=True))
        eng.submit(prompts[0], max_new=3)
        eng.step()
        scopes = "\n".join(parse_program(eng.lower_step()).scopes())
        if f"Allreduce_start.{rep['algorithm']}" not in scopes:
            print("FAIL: recorded decode step does not carry the "
                  f"resolved Allreduce_start.{rep['algorithm']} span")
            return 1
        if ".bidir" in scopes or ".torus" in scopes:
            print("FAIL: a bandwidth-tier schedule leaked into the "
                  "decode step")
            return 1
        print(f"latency tier: recorded decode step carries "
              f"Allreduce_start.{rep['algorithm']} spans, no "
              "bandwidth-tier schedule")
        res = eng.run()
        if not np.array_equal(np.asarray(res[0]), oracle(prompts[0], 3)):
            print("FAIL: latency-tier engine diverges from the oracle")
            return 1
    finally:
        config.set_latency_crossover_bytes(prev)

    # 4. Fault composition: rank death mid-decode, attributed.
    def dying(rank):
        e = engine(serve.ServeConfig(slots=2), spmd=False)
        e.submit(prompts[0], max_new=4)
        return e.run()

    try:
        with rz.fault_scope([rz.FaultSpec(
                "rank_death", rank=1, op="Allreduce",
                index=2 * cfg.n_layers)]):
            run_ranks(dying, 2, timeout=20.0, device=dev)
        print("FAIL: rank_death mid-decode did not raise")
        return 1
    except RankFailedError as e:
        if e.ranks != frozenset({1}):
            print(f"FAIL: RankFailedError misattributed: {e.ranks}")
            return 1
    print("faults: rank_death mid-decode -> RankFailedError(ranks="
          "{1}) on every survivor")

    # 5. Paged engine bitwise under BLOCK CHURN: a pool smaller than the
    # dense equivalent, so pages churn (and cached pages evict) while 4
    # requests run through 2 slots; plus the paged registry guard.
    sync = serve_paging_problems(PAGED_PARITY_POLICIES,
                                 MIRRORED_SERVE_COUNTERS)
    if sync:
        for p in sync:
            print(f"FAIL: {p}")
        return 1
    for policy in sorted(serve.POLICIES):
        serve.reset_stats()
        eng = engine(serve.ServeConfig(slots=2, policy=policy,
                                       overlap=True, block_size=4,
                                       num_blocks=6))
        for p, n in zip(prompts, budgets):
            eng.submit(p, max_new=n)
        if not check(eng.run(), f"paged Mode A ({size},) "
                                f"policy={policy}"):
            return 1
    print(f"paged engine: bitwise == per-request generate() on "
          f"({size},), both policies, 6-page pool churn")

    # 6. Prefix sharing: the shared prefix prefills EXACTLY ONCE.
    serve.reset_stats()
    eng = engine(serve.ServeConfig(slots=2, block_size=4))
    sys_prompt = np.arange(1, 9)                 # 8 tokens = 2 pages
    pa = np.concatenate([sys_prompt, [20, 21]])
    pb = np.concatenate([sys_prompt, [22]])
    ra = eng.submit(pa, max_new=4)
    rb = eng.submit(pb, max_new=4)
    eng.step()                     # both admitted: tables are live NOW
    sa = [s for r, s in eng.slot_log if r == ra][0]
    sb = [s for r, s in eng.slot_log if r == rb][0]
    shared_pages = [int(b) for b in eng._table[sb][:2]]
    if [int(b) for b in eng._table[sa][:2]] != shared_pages \
            or min(shared_pages) < 0:
        print(f"FAIL: sharers do not reference the SAME prefix pages "
              f"({list(eng._table[sa][:2])} vs {shared_pages})")
        return 1
    res = eng.run()
    for rid, p in ((ra, pa), (rb, pb)):
        if not np.array_equal(np.asarray(res[rid]), oracle(p, 4)):
            print("FAIL: prefix-sharing engine diverges from oracle")
            return 1
    snap = eng.stats.snapshot()
    want_prefill = len(pa) + (len(pb) - len(sys_prompt))
    if snap["prefill_tokens"] != want_prefill:
        print(f"FAIL: shared prefix not prefilled exactly once: "
              f"{snap['prefill_tokens']} prefill tokens, expected "
              f"{want_prefill} (= {len(pa)} + {len(pb)} - "
              f"{len(sys_prompt)} shared)")
        return 1
    if snap["prefix_hits"] != 1:
        print(f"FAIL: expected exactly one prefix hit, got "
              f"{snap['prefix_hits']}")
        return 1
    print(f"prefix sharing: {len(sys_prompt)}-token system prompt "
          f"prefilled once ({snap['prefill_tokens']} prefill tokens "
          f"for 2 requests), pages {shared_pages} shared by both slots")

    # 7. Counter mirror.
    txt = obs.prometheus_text()
    missing = [c for c in MIRRORED_SERVE_COUNTERS
               if f"mpi4torch_serve_{c} " not in txt]
    if missing:
        print(f"FAIL: counters missing from prometheus_text(): "
              f"{missing}")
        return 1
    print(f"obs mirror: all {len(MIRRORED_SERVE_COUNTERS)} serve "
          "counters exposed as mpi4torch_serve_*")

    # 8. No-retrace census: the paged decode step records the same
    # program across two block-table states.
    eng = engine(serve.ServeConfig(slots=2, block_size=4, overlap=True))
    eng.submit(prompts[0], max_new=6)
    eng.step()
    eng.step()                          # slot 0 writes inside page 1
    p1 = eng.lower_step()
    eng.submit(prompts[1], max_new=4)   # second slot maps fresh pages
    eng.step()
    p2 = eng.lower_step()
    if _program_key(p1) != _program_key(p2):
        print("FAIL: paged decode step records another program across "
              "table states")
        return 1
    kv_heads = (cfg.n_kv_heads or cfg.n_heads) // size
    extent = 2 * cfg.max_seq * kv_heads * (cfg.d_model // cfg.n_heads) * 4
    n_gather = _block_gathers(p1, extent)
    if n_gather != _block_gathers(p2, extent) \
            or n_gather < 2 * cfg.n_layers:
        print(f"FAIL: paged decode step censuses {n_gather} and "
              f"{_block_gathers(p2, extent)} block gathers; expected "
              f"the same >= {2 * cfg.n_layers} (one per K and V per "
              "layer)")
        return 1
    res = eng.run()
    if not (np.array_equal(np.asarray(res[0]), oracle(prompts[0], 6))
            and np.array_equal(np.asarray(res[1]),
                               oracle(prompts[1], 4))):
        print("FAIL: no-retrace engine diverges from oracle")
        return 1
    print(f"no-retrace: paged decode step recorded identical across "
          f"table states ({len(p1.events)} ops, {n_gather} gather ops "
          "censused)")

    print("serve-smoke: OK")
    return 0


def main(argv) -> int:
    if "--smoke" in argv or not argv:
        device = argv[argv.index("--device") + 1] \
            if "--device" in argv else None
        return smoke(device)
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
