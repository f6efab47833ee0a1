"""``python -m mpi4torch_tpu_torch.obs --smoke [--device cpu]`` — the
obs-smoke lane.

Port of ``mpi4torch_tpu/obs/__main__.py``.  Four verdict families, each
exit-coded (a claim reproduces exactly or the lane fails):

1. **Static-vs-runtime reconciliation**: four representative schedules
   run traced under the Mode B runtime and are joined against the
   ``analyze`` predictions of their recorded Mode A programs, all EXACT
   (wire bytes AND per-kind collective counts): a plain ring Allreduce,
   a fused q8 bucket pair, the (8,) -> (2, 4) reshard migration (the
   pinned 98304-byte plan), and an overlap serve decode step (split-phase
   RS + AG pairs, scheduled exposure 0.0).
2. **Flight recorder**: an injected ``FaultSpec("rank_death")``
   mid-collective must give a postmortem NAMING the dead rank, with every
   survivor's event tail ending on the same torn collective, and the
   JSON + human-table dump and the Chrome trace written.
3. **Off-path census**: a lowering serves no step, so no tracer sees it.
   With no tracer, a Mode B-only tracer or a ``mode_a`` tracer installed,
   the recorded program is the same and the tracer gains no event (the
   JAX package compares StableHLO text here); a ``mode_a`` tracer prices
   exactly one step event per collective entry of a run.
4. **Metrics surfaces**: retry events and integrity violations land in
   the unified registry beside their historical access paths, the serve
   collector aggregates, and the Prometheus exposition renders.

The worlds are rank threads on one device: CUDA unless ``--device cpu``
is given.
"""

from __future__ import annotations

import sys

#: World size of the reconcile and off-path families (the JAX CLI's 8
#: host devices).
NRANKS = 8


def _fail(failures: list, msg: str) -> None:
    failures.append(msg)
    print(f"FAIL: {msg}")


def _ok(msg: str) -> None:
    print(f"ok  : {msg}")


def _reconcile_case(failures, name, mode_b_body, nranks, lowered, dev):
    from .. import run_ranks
    from . import reconcile, trace

    with trace() as t:
        run_ranks(mode_b_body, nranks, device=dev)
    rep = reconcile(t.events, lowered, dropped=t.dropped, device=dev)
    m, p = rep["measured"], rep["predicted"]
    detail = (f"measured {m['wire_bytes']} B {m['counts']} == "
              f"predicted {p['wire_bytes']} B {p['counts']}")
    if rep["ok"]:
        _ok(f"reconcile[{name}]: {detail}")
    else:
        _fail(failures, f"reconcile[{name}]: {detail} "
                        f"(matches={rep['matches']}, consistent="
                        f"{m['per_rank_consistent']}, dropped="
                        f"{rep['dropped_events']})")
    return rep


def serve_decode_reconcile(cfg, params, prompts, nranks, dev,
                           max_new=3):
    """Reconcile one traced Mode B overlap decode step (every rank's
    events after a barrier sentinel that follows the admission step)
    against ``Engine(spmd=True, overlap=True).lower_step()``; returns
    the report."""
    from .. import run_ranks, serve
    from ..runtime import current_rank_context
    from . import reconcile, trace

    with trace() as t:
        def body(rank):
            ctx = current_rank_context()
            eng = serve.Engine(cfg, params,
                               serve.ServeConfig(slots=len(prompts),
                                                 overlap=True),
                               device=dev)
            for p in prompts:
                eng.submit(p, max_new=max_new)
            eng.step()                     # admission + prefill + decode
            ctx.world.barrier(ctx.rank)    # sentinel: next step isolated
            eng.step()
            return True
        run_ranks(body, nranks, device=dev)

    decode = []
    for r in range(nranks):
        er = t.events_for(rank=r)
        cut = max(i for i, e in enumerate(er) if e.op == "Barrier")
        decode.extend(er[cut + 1:])

    eng_a = serve.Engine(cfg, params,
                         serve.ServeConfig(slots=len(prompts),
                                           overlap=True),
                         spmd=True, nranks=nranks, device=dev)
    eng_a.submit(prompts[0], max_new=max_new)
    eng_a.step()
    return reconcile(decode, eng_a.lower_step(), dropped=t.dropped,
                     device=dev)


def _smoke_reconcile(failures, dev) -> None:
    import numpy as np
    import torch

    from .. import COMM_WORLD as comm
    from .. import MPI_SUM, serve
    from .. import reshard as rs
    from ..analyze.sweep import _flat_lowerer
    from ..models import transformer as T

    n = NRANKS
    lower, _ = _flat_lowerer(n, dev)

    # 1a. plain ring Allreduce.
    x8 = torch.arange(1024, dtype=torch.float32, device=dev)
    _reconcile_case(
        failures, "ring-allreduce",
        lambda rank: comm.Allreduce(x8 * (rank + 1), MPI_SUM,
                                    algorithm="ring"), n,
        lower(lambda c, a: c.Allreduce(a, MPI_SUM, algorithm="ring"), x8),
        dev)

    # 1b. fused q8 buckets (two buckets; the in-schedule int8 + scale
    # pipeline priced through the equivalent recording).
    def tree_of(rank):
        return {"a": torch.linspace(-1, 1, 768, device=dev) * (rank + 1),
                "b": torch.linspace(-2, 2, 512, device=dev) * (rank + 1)}

    bb = 2048
    _reconcile_case(
        failures, "fused-q8-buckets",
        lambda rank: comm.Allreduce_tree(tree_of(rank), MPI_SUM,
                                         compression="q8",
                                         bucket_bytes=bb), n,
        lower(lambda c, tr: c.Allreduce_tree(
            tr, MPI_SUM, compression="q8", bucket_bytes=bb), tree_of(0)),
        dev)

    # 1c. the (8,) -> (2, 4) checkpoint-migration reshard (planned wire
    # 98304 B against the 917504 B gather).
    fl = rs.layout((8,), 0, None)
    tl = rs.layout((2, 4), 0, 1)
    shard = fl.shard_shape((1024, 256))

    def migrate(rank):
        x = torch.arange(int(np.prod(shard)), dtype=torch.float32,
                         device=dev).reshape(shard) * (rank + 1)
        return comm.Reshard(x, fl, tl)

    rep = _reconcile_case(
        failures, "reshard-(8,)->(2,4)", migrate, n,
        lower(lambda c, a: c.Reshard(a, fl, tl),
              torch.zeros(shard, dtype=torch.float32, device=dev)), dev)
    if rep["predicted"]["wire_bytes"] != 98304:
        _fail(failures,
              f"reshard predicted wire {rep['predicted']['wire_bytes']}"
              " != the pinned 98304 B plan")

    # 1d. overlap serve decode step.
    cfg = T.TransformerConfig(vocab=61, d_model=32, n_heads=4,
                              n_layers=2, d_ff=64, max_seq=32)
    params = T.init_transformer(0, cfg,
                                dtype=torch.float32, device=dev)
    prompts = [np.array([1, 2, 3]), np.array([4, 5, 6, 7, 8])]
    rep = serve_decode_reconcile(cfg, params, prompts, 4, dev)
    m, p = rep["measured"], rep["predicted"]
    detail = (f"measured {m['wire_bytes']} B {m['counts']} == "
              f"predicted {p['wire_bytes']} B {p['counts']}, "
              f"exposure {p['scheduled_exposure']}")
    if rep["ok"] and p["scheduled_exposure"] == 0.0:
        _ok(f"reconcile[serve-decode-step]: {detail}")
    else:
        _fail(failures, f"reconcile[serve-decode-step]: {detail} "
                        f"(matches={rep['matches']})")
    serve.reset_stats()


def _smoke_flight(failures, workdir, dev) -> None:
    import json
    import os

    import torch

    from .. import COMM_WORLD as comm
    from .. import MPI_SUM, FaultSpec, RankFailedError, fault_scope
    from .. import run_ranks
    from . import (dump_postmortem, format_postmortem, trace,
                   write_chrome_trace)
    from .flight import last_event_signature

    nranks, dead = 4, 1
    spec = FaultSpec("rank_death", rank=dead, op="Allreduce", index=2)
    err = None
    with trace(ring=16) as t:
        with fault_scope([spec]):
            def body(rank):
                x = torch.arange(64, dtype=torch.float32,
                                 device=dev) * (rank + 1)
                for _ in range(4):
                    x = comm.Allreduce(x, MPI_SUM)
                return x
            try:
                run_ranks(body, nranks, timeout=2.0, device=dev)
            except RankFailedError as e:
                err = e
    if err is None:
        return _fail(failures, "flight: injected rank_death was not "
                               "raised as RankFailedError")
    pm = t.last_postmortem()
    if pm is None:
        return _fail(failures, "flight: no postmortem captured")
    if pm["failed_ranks"] != [dead]:
        return _fail(failures, f"flight: postmortem names "
                               f"{pm['failed_ranks']}, not [{dead}]")
    dead_sig = last_event_signature(pm, dead)
    bad = [r for r in range(nranks)
           if last_event_signature(pm, r) != dead_sig]
    if dead_sig is None or bad:
        return _fail(failures,
                     f"flight: survivor tails inconsistent with the "
                     f"dead rank's last event (ranks {bad})")
    paths = dump_postmortem(pm, workdir)
    if f"rank(s): [{dead}]" not in format_postmortem(pm):
        return _fail(failures, "flight: human table does not name the "
                               "dead rank")
    _ok(f"flight: rank_death postmortem names rank {dead}; all "
        f"{nranks} tails end on the torn collective "
        f"{dead_sig}; dumped {paths['json']}")
    tpath = write_chrome_trace(os.path.join(workdir, "modeb_trace.json"),
                               t.events)
    with open(tpath, encoding="utf-8") as f:
        n = len(json.load(f)["traceEvents"])
    _ok(f"export: chrome/Perfetto trace with {n} events at {tpath}")


def _smoke_offpath(failures, dev) -> None:
    import torch

    from .. import COMM_WORLD as comm
    from .. import MPI_SUM, run_spmd
    from ..analyze.sweep import _flat_lowerer
    from . import trace

    n = NRANKS
    lower, _ = _flat_lowerer(n, dev)
    x = torch.ones((1 << 12,), dtype=torch.float32, device=dev)

    def lowered(compression=False):
        return lower(lambda c, a: c.Allreduce(a, MPI_SUM,
                                              compression=compression), x)

    base = (lowered(), lowered("q8"))
    unseen = True
    for label, kw in (("Mode B-only", {}), ("mode_a", {"mode_a": True})):
        with trace(**kw) as t:
            same = (lowered(), lowered("q8")) == base
        if not same:
            _fail(failures, f"off-path: a {label} tracer moved the "
                            "recorded Mode A program")
        if t.events:
            unseen = False
            _fail(failures, f"off-path: a lowering fed the {label} "
                            f"tracer {len(t.events)} event(s)")
    if unseen:
        _ok("off-path: the recorded program (plain + q8) is the same "
            "under no, a Mode B-only and a mode_a tracer, and no "
            "lowering feeds a tracer")

    with trace(mode_a=True) as t:
        run_spmd(lambda a: comm.Allreduce(a, MPI_SUM), nranks=n,
                 device=dev)(x)
    got = len(t.events_for(channel="spmd"))
    if got != n:
        _fail(failures, f"off-path: mode_a tracer priced {got} step "
                        f"events for one collective entry on {n} ranks, "
                        f"expected {n}")
    else:
        _ok("off-path: mode_a tracer prices exactly 1 step event per "
            "collective entry and rank")


def _smoke_metrics(failures, dev) -> None:
    import warnings

    import torch

    from .. import COMM_WORLD as comm
    from .. import MPI_SUM, FaultSpec, config, fault_scope, run_ranks
    from ..resilience import guards
    from ..runtime import current_rank_context
    from . import prometheus_text, reset_metrics, snapshot, trace

    reset_metrics()
    # Retry surfacing: a dropped p2p message recovered by retries lands
    # in BOTH World.retry_events and the unified counter.
    spec = FaultSpec("drop_p2p", rank=0, op="p2p", index=0)
    retry_events = []
    config.set_comm_retries(4)
    config.set_comm_backoff(0.05)
    try:
        with trace():
            def body(rank):
                ctx = current_rank_context()
                if rank == 0:
                    ctx.world.p2p_send(0, 1, 7, torch.ones(4, device=dev))
                if rank == 1:
                    got = ctx.world.p2p_recv(0, 1, 7)
                    retry_events.append(ctx.world.retry_events)
                    return got
                return None
            with fault_scope([spec]):
                run_ranks(body, 2, timeout=0.3, device=dev)
    finally:
        config.set_comm_retries(0)
        config.set_comm_backoff(0.05)
    counters = snapshot()["counters"]
    if not retry_events or retry_events[0] < 1:
        _fail(failures, "metrics: dropped p2p was not recovered via "
                        "retries (World.retry_events stayed 0)")
    elif counters.get("comm_retry_events_total", 0) < 1:
        _fail(failures, "metrics: comm_retry_events_total missing from "
                        f"the registry (counters={counters})")
    else:
        _ok(f"metrics: retry_events={retry_events[0]} mirrored as "
            f"comm_retry_events_total="
            f"{counters['comm_retry_events_total']}")

    # Integrity-violation surfacing beside the historical ledger.
    guards.clear_violations()
    config.set_comm_finite_guard("warn")
    try:
        def nan_body(rank):
            x = torch.full((4,), float("nan") if rank == 1 else 1.0,
                           device=dev)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                return comm.Allreduce(x, MPI_SUM)
        run_ranks(nan_body, 2, device=dev)
    finally:
        config.set_comm_finite_guard("off")
    viol = guards.last_violation()
    counters = snapshot()["counters"]
    if viol is None or counters.get("integrity_violations_total", 0) < 1:
        _fail(failures, "metrics: finite-guard violation not mirrored "
                        f"(ledger={viol}, counters={counters})")
    else:
        _ok("metrics: integrity violation in ledger AND "
            "integrity_violations_total="
            f"{counters['integrity_violations_total']}")
        guards.clear_violations()

    text = prometheus_text()
    if "mpi4torch_comm_retry_events_total" not in text \
            or "mpi4torch_serve_" not in text:
        _fail(failures, "metrics: prometheus exposition missing "
                        "namespaced families")
    else:
        _ok("metrics: prometheus exposition carries the mpi4torch_* "
            "namespace (comm + serve families)")


def smoke(device=None) -> int:
    import tempfile

    from ..runtime import resolve_device

    dev = resolve_device(device)
    print(f"obs-smoke: {NRANKS} rank threads, device {dev}")
    failures: list = []
    _smoke_reconcile(failures, dev)
    with tempfile.TemporaryDirectory() as d:
        _smoke_flight(failures, d, dev)
    _smoke_offpath(failures, dev)
    _smoke_metrics(failures, dev)
    verdict = (f"FAIL — {len(failures)} problem(s)" if failures
               else "all verdicts exact")
    print(f"obs-smoke: {verdict}")
    return 1 if failures else 0


def main(argv) -> int:
    if "--smoke" in argv:
        device = argv[argv.index("--device") + 1] \
            if "--device" in argv else None
        return smoke(device)
    print(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
