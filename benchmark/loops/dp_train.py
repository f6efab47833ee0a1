"""Closed-loop data-parallel training on rank threads of one card.

``run_ranks(body, ranks, device=...)`` runs one body a rank.  Each body
takes the seeded weights through the :data:`CHECKED_STEPS` first steps,
whose losses, gradient and change the reference checks afterwards, and then,
with the same state, runs steps back to back until ``seconds`` have
passed: each step starts when the previous one has synchronised with the
device, as a loop that reads its loss every step does.  With ``trace`` a
stretch of ``trace_steps`` more steps (after one that warms the profiler)
runs under ``torch.profiler`` on rank 0's thread and the program's
``obs.trace()``.
"""

from __future__ import annotations

import contextlib
import threading
import time

BARRIER_S = 300.0
# The steps that the reference follows.  The limits under ``limits/`` were
# set from readings after this many steps, and hold only at it.
CHECKED_STEPS = 3


def _leaves(tree, specs):
    out = []
    for path, *_ in specs:
        t = tree
        for k in path:
            t = t[k]
        out.append(t)
    return out


def tree_from_leaves(specs, leaves):
    """The nested dict/list tree of ``leaves`` at their spec paths."""
    root = {}
    for (path, *_), leaf in zip(specs, leaves):
        node = root
        for k, nxt in zip(path[:-1], path[1:]):
            if isinstance(node, list):
                while len(node) <= k:
                    node.append({} if not isinstance(nxt, int) else [])
                node = node[k]
            else:
                node = node.setdefault(k, [] if isinstance(nxt, int) else {})
        if isinstance(node, list):
            while len(node) <= path[-1]:
                node.append(None)
            node[path[-1]] = leaf
        else:
            node[path[-1]] = leaf
    return root


def init_leaves(specs, generator, device, dtype):
    """Every leaf of ``specs`` on ``device`` in ``dtype``: the normal ones
    from one draw of ``generator`` (then scaled, leaf by leaf, in place),
    the rest ones or zeros."""
    import torch

    sizes = [int(torch.Size(shape).numel()) for _, shape, kind, _ in specs
             if kind == "normal"]
    flat = torch.randn(sum(sizes), generator=generator, device=device,
                       dtype=dtype)
    out, off = [], 0
    for _, shape, kind, scale in specs:
        if kind == "normal":
            n = int(torch.Size(shape).numel())
            out.append(flat[off:off + n].view(shape).mul_(scale))
            off += n
        elif kind == "ones":
            out.append(torch.ones(shape, device=device, dtype=dtype))
        else:
            out.append(torch.zeros(shape, device=device, dtype=dtype))
    return out


def draw(fam, conf, traffic, seed, device, dtype):
    """The run's weights and inputs, drawn from ``seed`` on ``device``:
    the same seed gives the same of both."""
    import torch

    gen = torch.Generator(device=device).manual_seed(int(seed))
    specs = fam.param_specs(conf)
    leaves = init_leaves(specs, gen, device, dtype)
    n_pool = max(traffic["pool_steps"], CHECKED_STEPS)
    inputs = fam.make_inputs(conf, traffic, gen, device, n_pool)
    return specs, leaves, inputs, n_pool


def _norms(a, b, scale=1.0):
    return [float((x.float() - y.float()).norm()) * scale
            for x, y in zip(a, b)]


def _moved(a, b):
    """Each leaf's share of elements that differ between ``a`` and
    ``b``."""
    return [float((x != y).float().mean()) for x, y in zip(a, b)]


def run(fam, conf, traffic, seed, seconds, trace, device, step_fn=None,
        t_start=None):
    """One run; returns the record the harness reduces: ``setup_s``, the
    window (``steps``, ``seconds``, ``step_s``), ``memory_peak_bytes``,
    ``checked`` (what the reference is held against) and, traced,
    ``trace``."""
    import torch
    import mpi4torch_tpu_torch as P

    cuda = torch.device(device).type == "cuda"
    t_start = time.perf_counter() if t_start is None else t_start
    dtype = getattr(torch, conf["torch_dtype"])
    cfg = fam.port_config(conf)
    if cuda:
        # The attention libraries that the model's shapes launch, built (or
        # loaded from the checkout's build directory) before the ranks
        # start, so that no rank waits on nvcc inside a rendezvous.
        from mpi4torch_tpu_torch.ops import _kernels

        head_dim = fam.attention_calls(conf, traffic)[0]["d"]
        tc = _kernels.fwd_variant(dtype, head_dim) == "tc"
        for stem in ("flash_fwd", "flash_bwd"):
            _kernels.load(f"{stem}_tc" if tc else stem)
    specs, p0, inputs, n_pool = draw(fam, conf, traffic, seed, device, dtype)
    params0 = tree_from_leaves(specs, p0)
    ranks, lr = traffic["ranks"], traffic["lr"]
    n_check = CHECKED_STEPS
    step_fn = step_fn or fam.train_step

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

    step_bar = threading.Barrier(ranks, action=decide, timeout=BARRIER_S)
    bar = threading.Barrier(ranks, timeout=BARRIER_S)
    out = {"losses": [[None] * n_check for _ in range(ranks)],
           "grad1": [None] * ranks, "change": [None] * ranks,
           "moved": [None] * ranks, "final": [None] * ranks, "step_s": [], "trace": None}

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
        params = params0
        for k in range(n_check):
            loss, params = step_fn(comm, cfg, params,
                                   fam.batch(inputs, k, rank), lr)
            out["losses"][rank][k] = float(loss)
            if k == 0:
                out["grad1"][rank] = _norms(p0, _leaves(params, specs),
                                            1.0 / lr)
        out["change"][rank] = _norms(_leaves(params, specs), p0)
        out["moved"][rank] = _moved(_leaves(params, specs), p0)
        out["final"][rank] = _leaves(params, specs)
        sync()
        bar.wait()
        if rank == 0:
            out["ranks_differ"] = sum(
                1 for r in range(1, ranks)
                for a, b in zip(out["final"][0], out["final"][r])
                if not torch.equal(a, b))
            out["final"] = None
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
                bar.wait()
                params, _ = timed_step(comm, params, j + i, rank)
            bar.wait()
            if rank == 0:
                evs = tracer.events_for(rank=0)
        if rank == 0:
            red = trace_reduce.reduce(prof, "bench.step", skip=1)
            red["comm_s"] = sum(e.duration_s for e in evs)
            red["comm_events"] = len(evs)
            out["trace"] = red

    P.run_ranks(body, ranks, device=device)
    del params0, p0
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
    """The reference's readings for the same seed: the weights and inputs
    drawn again (in the model's dtype, as the program got them), widened
    to float32, and the checked steps computed by ``reference.common``."""
    import torch
    from ..reference import common

    common.no_tf32()
    dtype = getattr(torch, conf["torch_dtype"])
    specs, leaves, inputs, _ = draw(fam, conf, traffic, seed, device, dtype)
    params = {s[0]: t.float() for s, t in zip(specs, leaves)}
    del leaves
    batches = [[fam.batch(inputs, k, r) for r in range(traffic["ranks"])]
               for k in range(CHECKED_STEPS)]
    res = common.train(conf, batches, params, traffic["lr"], CHECKED_STEPS,
                       precision=precision)
    return {"losses": res["losses"],
            "grad1": [float(res["grad1"][s[0]].norm()) for s in specs],
            "gradient": [float(res["gradient"][s[0]].norm()) for s in specs],
            "change": [float(res["delta"][s[0]].norm()) for s in specs],
            "moved": [float((res["delta"][s[0]] != 0).float().mean())
                      for s in specs]}
