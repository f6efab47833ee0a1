"""Closed-loop expert-parallel training on rank threads of one card.

As :mod:`.dp_train` (its set-up, checked steps, window and profiled
stretch), with each rank holding the whole of every replicated leaf and
its ``E / ranks`` slice of every expert leaf (the family's
``is_expert``).  The readings the reference checks are assembled into
the reference's leaf order: a replicated leaf's norms are each rank's
own; an expert leaf's norm is the root of the sum of the ranks' squared
shard norms, and its changed share the mean of the shards'.
``ranks_differ`` compares the replicated leaves alone.  :func:`reference`
takes ``reference.common.train``'s steps leaf by leaf, keeping one
float32 copy of the parameters, so that the reference of a model of two
billion parameters fits on the card.  A traced run
also keeps ``alltoall_s`` (rank 0's seconds in the ``Alltoall``
exchanges: the port's eager ``Alltoall`` is a ``Gather`` to rank 0 and a
``Scatter`` from it, waits included) and ``moe_assignments`` (the
``moe_assignments_total`` counters over the profiled steps, every rank's
and layer's).
"""

from __future__ import annotations

import contextlib
import math
import threading
import time

from . import dp_train as D

CHECKED_STEPS = D.CHECKED_STEPS
ALLTOALL_OPS = ("Gather", "Scatter")


def _moe_assignments():
    from mpi4torch_tpu_torch import obs

    return sum(v for k, v in obs.snapshot()["counters"].items()
               if k.startswith("moe_assignments_total"))


def shard_leaves(fam, specs, leaves, rank, ranks):
    """One rank's leaves: the replicated ones whole, the expert ones cut
    to the rank's slice of axis 0 (views)."""
    out = []
    for (path, *_), t in zip(specs, leaves):
        if fam.is_expert(path):
            n = t.shape[0] // ranks
            t = t[rank * n:(rank + 1) * n]
        out.append(t)
    return out


def assemble(fam, specs, per_rank, combine):
    """Each rank's readings in the reference's leaf order: an expert
    leaf's reading ``combine``-d over the ranks' shards, the same on
    every rank."""
    out = [list(r) for r in per_rank]
    for i, (path, *_) in enumerate(specs):
        if fam.is_expert(path):
            whole = combine([r[i] for r in per_rank])
            for r in out:
                r[i] = whole
    return out


def _root_sum_squares(xs):
    return math.sqrt(sum(x * x for x in xs))


def _mean(xs):
    return sum(xs) / len(xs)


def run(fam, conf, traffic, seed, seconds, trace, device, step_fn=None,
        t_start=None):
    """One run; returns the record :mod:`.dp_train`'s ``run`` returns."""
    import torch
    import mpi4torch_tpu_torch as P

    cuda = torch.device(device).type == "cuda"
    t_start = time.perf_counter() if t_start is None else t_start
    dtype = getattr(torch, conf["torch_dtype"])
    cfg = fam.port_config(conf)
    if cuda:
        # Built (or loaded) before the ranks start: no rank waits on nvcc
        # inside a rendezvous.
        from mpi4torch_tpu_torch.ops import _kernels

        head_dim = fam.attention_calls(conf, traffic)[0]["d"]
        tc = _kernels.fwd_variant(dtype, head_dim) == "tc"
        for stem in ("flash_fwd", "flash_bwd"):
            _kernels.load(f"{stem}_tc" if tc else stem)
    specs, p0, inputs, n_pool = D.draw(fam, conf, traffic, seed, device,
                                       dtype)
    ranks, lr = traffic["ranks"], traffic["lr"]
    mine = [shard_leaves(fam, specs, p0, r, ranks) for r in range(ranks)]
    n_check = CHECKED_STEPS
    step_fn = step_fn or fam.train_step
    replicated = [i for i, s in enumerate(specs) if not fam.is_expert(s[0])]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    shared = {"stop": False, "t0": None, "t1": None}

    def decide():
        now = time.perf_counter()
        if shared["t0"] is None:
            shared["t0"] = now
        elif now - shared["t0"] >= seconds:
            shared["stop"], shared["t1"] = True, now

    step_bar = threading.Barrier(ranks, action=decide, timeout=D.BARRIER_S)
    bar = threading.Barrier(ranks, timeout=D.BARRIER_S)
    out = {"losses": [[None] * n_check for _ in range(ranks)],
           "grad1": [None] * ranks, "change": [None] * ranks,
           "moved": [None] * ranks, "final": [None] * ranks, "step_s": [],
           "trace": None}

    def timed_step(comm, params, j, rank):
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.step"):
            _, params = step_fn(comm, cfg, params,
                                fam.batch(inputs, j % n_pool, rank), lr)
        with torch.profiler.record_function("bench.sync"):
            sync()
        return params, time.perf_counter() - t0

    def body(rank):
        comm = P.COMM_WORLD
        start = mine[rank]
        params = D.tree_from_leaves(specs, start)
        for k in range(n_check):
            loss, params = step_fn(comm, cfg, params,
                                   fam.batch(inputs, k, rank), lr)
            out["losses"][rank][k] = float(loss)
            if k == 0:
                out["grad1"][rank] = D._norms(start, D._leaves(params, specs),
                                              1.0 / lr)
        final = D._leaves(params, specs)
        out["change"][rank] = D._norms(final, start)
        out["moved"][rank] = D._moved(final, start)
        out["final"][rank] = [final[i] for i in replicated]
        sync()
        bar.wait()
        if rank == 0:
            out["ranks_differ"] = sum(
                1 for r in range(1, ranks)
                for a, b in zip(out["final"][0], out["final"][r])
                if not torch.equal(a, b))
            out["final"] = None
            for key, combine in (("grad1", _root_sum_squares),
                                 ("change", _root_sum_squares),
                                 ("moved", _mean)):
                out[key] = assemble(fam, specs, out[key], combine)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
        bar.wait()
        j = n_check
        while True:
            step_bar.wait()
            if shared["stop"]:
                break
            params, dt = timed_step(comm, params, j, rank)
            if rank == 0:
                out["step_s"].append(dt)
            j += 1
        if trace:
            _traced(comm, params, j, rank)
        return None

    def _traced(comm, params, j, rank):
        """The profiled stretch: one warm step, then ``trace_steps``."""
        from mpi4torch_tpu_torch import obs
        from .. import trace_reduce

        with contextlib.ExitStack() as stack:
            if rank == 0:
                tracer = stack.enter_context(obs.trace())
                acts = [torch.profiler.ProfilerActivity.CPU]
                if cuda:
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = stack.enter_context(
                    torch.profiler.profile(activities=acts))
            for i in range(traffic["trace_steps"] + 1):
                bar.wait()
                if rank == 0 and i == 1:
                    tracer.clear()    # the profiler's warm step is left out
                    counted = _moe_assignments()
                bar.wait()
                params, _ = timed_step(comm, params, j + i, rank)
            bar.wait()
            if rank == 0:
                evs = tracer.events_for(rank=0)
                counted = _moe_assignments() - counted
        if rank == 0:
            red = trace_reduce.reduce(prof, "bench.step", skip=1)
            red["comm_s"] = sum(e.duration_s for e in evs)
            red["comm_events"] = len(evs)
            red["alltoall_s"] = sum(e.duration_s for e in evs
                                    if e.op in ALLTOALL_OPS)
            red["moe_assignments"] = counted
            red["expert_shapes"] = {
                "d": conf["hidden_size"], "f": conf["moe_intermediate_size"],
                "experts": conf["num_experts"], "ranks": ranks,
                "layers": conf["num_hidden_layers"]}
            out["trace"] = red

    P.run_ranks(body, ranks, device=device)
    del mine, p0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    return {"setup_s": shared["t0"] - t_start,
            "window": {"steps": len(out["step_s"]),
                       "seconds": (shared["t1"] - shared["t0"]
                                   if out["step_s"] else 0.0),
                       "step_s": out["step_s"]},
            "attempted": len(out["step_s"]) + (
                traffic["trace_steps"] + 1 if trace else 0),
            "memory_peak_bytes": peak,
            "checked": {"losses": out["losses"], "grad1": out["grad1"],
                        "change": out["change"], "moved": out["moved"],
                        "ranks_differ": out["ranks_differ"]},
            "trace": out["trace"]}


def reference(fam, conf, traffic, seed, device, precision="f32"):
    """The reference's readings for the same seed, as
    :func:`.dp_train.reference` gives them: the weights and inputs drawn
    again (in the model's dtype, as the program got them) and
    ``reference.common.train``'s SGD steps on the mean loss of every
    rank's rows, in float32 (``precision`` "fp8": the weight products in
    float8) with the parameters stored in the model's dtype between
    steps.  Each leaf's norms are taken as its update is made, so that
    no second float32 copy of the parameters is held."""
    import torch
    from ..reference import common

    common.no_tf32()
    dtype = getattr(torch, conf["torch_dtype"])
    specs, leaves, inputs, _ = D.draw(fam, conf, traffic, seed, device,
                                      dtype)
    ref, mm, lr = common.family(conf["family"]), \
        common.PRECISIONS[precision], traffic["lr"]
    paths = [s[0] for s in specs]
    cur = [t.float() for t in leaves]
    losses, grad1, gradient = [], [], []
    for k in range(CHECKED_STEPS):
        P = {p: t.requires_grad_(True) for p, t in zip(paths, cur)}
        ranks = [fam.batch(inputs, k, r) for r in range(traffic["ranks"])]
        denom = sum(ref.n_rows(b) for b in ranks) * \
            ref.positions_per_row(ranks[0])
        total = 0.0
        for b in ranks:
            for lo in range(0, ref.n_rows(b), ref.ROWS_PER_CALL):
                s = ref.loss_sum(conf, P, ref.take_rows(
                    b, lo, lo + ref.ROWS_PER_CALL), mm)
                (s / denom).backward()
                total += float(s.detach())
        losses.append(total / denom)
        with torch.no_grad():
            for i, t in enumerate(cur):
                g = t.grad if t.grad is not None else torch.zeros_like(t)
                new = (t.detach() - lr * g).to(dtype).float()
                if k == 0:
                    gradient.append(float(g.norm()))
                    grad1.append(float(((leaves[i].float() - new) / lr)
                                       .norm()))
                t.grad = None
                cur[i] = new
        del P
    with torch.no_grad():
        deltas = [(c - p.float()) for c, p in zip(cur, leaves)]
        return {"losses": losses, "grad1": grad1, "gradient": gradient,
                "change": [float(d.norm()) for d in deltas],
                "moved": [float((d != 0).float().mean()) for d in deltas]}
