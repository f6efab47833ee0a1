"""The tracer's host spans on a ``torch.profiler`` trace's clock.

The tracer times its records with ``time.perf_counter``, a monotonic
clock with an arbitrary origin; a profiler trace times its events in
microseconds from the profile's start (``prof.events()``' time ranges,
which ``prof.events().export_chrome_trace(path)`` writes).  The profiler
records the ranges (``record_function``'s) of the thread that opened it
alone, so it holds that rank thread's step-phase spans
(``mpi4torch.step.*``), and the tracer holds every rank's.
:func:`clock_offset` pairs the profiling rank's spans of both records
and returns the offset between the two clocks; :func:`on_profiler_clock`
moves every rank's phase spans, barrier waits and events onto the
profiler's timeline with it, and ``chrome_trace(..., offset=...)``
writes them on that clock::

    got = {}

    def body(rank):
        with torch.profiler.profile() if rank == 0 \\
                else contextlib.nullcontext() as prof:
            step(rank)
        if rank == 0:
            got["prof"] = prof

    with mpi.obs.trace() as t:
        mpi.run_ranks(body, 2)
    offset, spread = mpi.obs.clock_offset(t, got["prof"], rank=0)
    mpi.obs.write_chrome_trace("host.json", t.events, offset=offset,
                               spans=t.spans_for())
    got["prof"].events().export_chrome_trace("device.json")
"""

from __future__ import annotations

import statistics
from typing import List, Tuple

import torch

__all__ = ["clock_offset", "on_profiler_clock"]

PREFIX = "mpi4torch.step."


def _pairs(mine: List, theirs: List[Tuple[float, str]], k: int):
    """``(profiler start, tracer span)`` of the alignment that pairs
    ``mine[i]`` with ``theirs[i + k]``, or None where a name differs."""
    out = []
    for i in range(max(0, -k), min(len(mine), len(theirs) - k)):
        t, name = theirs[i + k]
        if name != PREFIX + mine[i].phase:
            return None
        out.append((t, mine[i]))
    return out


def _spread(diffs: List[float]) -> float:
    """The distance between the first and third quartiles."""
    if len(diffs) < 2:
        return 0.0
    q1, _, q3 = statistics.quantiles(diffs, n=4, method="inclusive")
    return q3 - q1


def clock_offset(tracer, prof, rank: int = 0) -> Tuple[float, float]:
    """``(offset, spread)`` in seconds: a tracer time plus ``offset`` is
    the same instant on ``prof``'s clock, in seconds.

    ``prof`` is a finished ``torch.profiler.profile`` opened on
    ``rank``'s thread.  Its ``mpi4torch.step.*`` spans and the tracer's
    spans of ``rank`` are aligned in order (either record may hold steps
    the other lacks: the alignment of the least spread among those that
    pair at least half as many spans as the best does), and the offset
    is the median of the paired starts' differences; ``spread``, the
    distance between their quartiles, is its error.  Raises
    ``ValueError`` when no span pairs."""
    mine = sorted(tracer.spans_for(rank), key=lambda s: s.t_start)
    # The host's ranges alone: on the card the profiler also keeps each
    # range's device-side annotation under the same name.
    cpu = torch.autograd.DeviceType.CPU
    theirs = sorted((e.time_range.start * 1e-6, e.name)
                    for e in prof.events()
                    if e.name.startswith(PREFIX) and e.device_type == cpu)
    found = [p for p in (_pairs(mine, theirs, k)
                         for k in range(1 - len(mine), len(theirs))) if p]
    if not found:
        raise ValueError(f"no step-phase span of rank {rank} is in both "
                         "the tracer and the profile")
    most = max(len(p) for p in found)
    least = max(2, (most + 1) // 2) if most > 1 else 1
    best = None
    for pairs in found:
        if len(pairs) < least:
            continue
        diffs = [t - s.t_start for t, s in pairs]
        key = (_spread(diffs), -len(diffs))
        if best is None or key < best[0]:
            best = (key, diffs)
    (spread, _), diffs = best
    return statistics.median(diffs), spread


def on_profiler_clock(tracer, offset: float) -> dict:
    """Every rank's host records on the profiler's clock, in seconds:
    ``phases`` ``(world, rank, step, phase, start, end)`` of the step
    spans, ``waits`` ``(world, rank, start, end)`` of the rendezvous
    barriers, ``events`` ``(world, rank, op, start, end)`` of the
    chokepoint events; each list in order of its start."""
    evs = tracer.events_for()
    return {
        "phases": sorted(((s.world, s.rank, s.step, s.phase,
                           s.t_start + offset, s.t_end + offset)
                          for s in tracer.spans_for()),
                         key=lambda x: x[4]),
        "waits": sorted(((e.world, e.rank, a + offset, b + offset)
                         for e in evs for a, b in e.extra.get("waits", ())),
                        key=lambda x: x[2]),
        "events": sorted(((e.world, e.rank, e.op, e.t_start + offset,
                           e.t_start + e.duration_s + offset)
                          for e in evs), key=lambda x: x[3]),
    }
