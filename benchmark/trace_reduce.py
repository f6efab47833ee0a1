"""Reducing a ``torch.profiler`` trace of a stretch of steps to what the
per-layer metrics and the breakdown read: the device's kernel intervals,
their union, the idle gaps and what the host was doing in them."""

from __future__ import annotations

import bisect
from collections import defaultdict

SHORT_GAP_US = 20.0


def _cuda(e):
    import torch

    return e.device_type == torch.autograd.DeviceType.CUDA


def reduce(prof, step_span: str, skip: int = 1) -> dict:
    """The stretch runs from the start of the ``skip``-th ``step_span``
    (0-based) to the end of the last span the profiling thread recorded;
    device operations (kernels, copies, sets; no annotations) are clipped
    to it.  Times in the result are seconds."""
    evs = prof.events()
    cpu = sorted((e for e in evs if not _cuda(e)),
                 key=lambda e: e.time_range.start)
    steps = [e for e in cpu if e.name == step_span]
    if len(steps) <= skip:
        raise RuntimeError(f"the trace holds {len(steps)} {step_span!r} "
                           f"spans; {skip + 1} or more are needed")
    lo = steps[skip].time_range.start
    hi = max(e.time_range.end for e in cpu if e.name.startswith("bench."))
    ops = []
    for e in evs:
        if _cuda(e) and not e.is_user_annotation:
            a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
            if b > a:
                ops.append((a, b, e.name))
    ops.sort()
    busy, gaps, cur_a, cur_b = 0.0, [], None, None
    edge = lo
    for a, b, _ in ops:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            if a > edge:
                gaps.append((edge, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
        edge = cur_b
    if cur_b is not None:
        busy += cur_b - cur_a
    if hi > edge:
        gaps.append((edge, hi))
    by_name = defaultdict(float)
    for a, b, name in ops:
        by_name[name] += b - a
    starts = [e.time_range.start for e in cpu]
    idle = defaultdict(float)
    for a, b in gaps:
        idle[_host_label(cpu, starts, a, b) if b - a >= SHORT_GAP_US
             else f"gaps under {SHORT_GAP_US:g} us"] += b - a
    n_steps = len(steps) - skip
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
            "steps": n_steps,
            "ops": [(a / 1e6, b / 1e6, n) for a, b, n in ops],
            "device_ops": sorted(((n, t / 1e6) for n, t in by_name.items()),
                                 key=lambda x: -x[1]),
            "idle_gaps": sorted(((n, t / 1e6) for n, t in idle.items()),
                                key=lambda x: -x[1])}


def _host_label(cpu, starts, a, b) -> str:
    """What the profiling thread was in at the middle of a gap: the
    harness span and the innermost operation or span around it."""
    t = (a + b) / 2
    i = bisect.bisect_right(starts, t)
    inner = outer = None
    for e in reversed(cpu[:i]):
        if e.time_range.end >= t:
            if inner is None:
                inner = e.name
            if e.name.startswith("bench."):
                outer = e.name
                break
    if inner is None:
        return "host outside any span"
    return inner if inner == outer else f"{outer or '-'} > {inner}"
