"""Chrome-trace / Perfetto JSON export of the rank-thread event timeline.

Port of ``mpi4torch_tpu/obs/export.py``.  :func:`chrome_trace` renders a
:class:`~.events.CommEvent` list in the Chrome Trace Event Format (the
``traceEvents`` JSON that Perfetto and ``chrome://tracing`` load): one
row per (world, rank), complete ("X") events with the op, bytes,
retries and status in ``args``, so a hung collective shows as the row
where every rank's lane goes quiet but the one that never arrived.  The
times are host times (see ``events``); a ``torch.profiler`` trace holds
the device's side, and with ``clock.clock_offset``'s offset the two
share a clock.
"""

from __future__ import annotations

import json
from typing import Iterable, Optional

__all__ = ["chrome_trace", "write_chrome_trace"]


def chrome_trace(events: Iterable, label: str = "mpi4torch_tpu_torch",
                 offset: Optional[float] = None,
                 spans: Optional[Iterable] = None) -> dict:
    """Chrome Trace Event Format dict of an event list.

    Timestamps are microseconds relative to the earliest record (the
    absolute ``perf_counter`` epoch means nothing to a viewer); ``pid``
    is the world ordinal and ``tid`` the rank, so Perfetto renders one
    lane per rank with the collective spans aligned.

    ``offset`` (``clock.clock_offset``'s) puts the timestamps on a
    profiler trace's clock instead, the clock of ``prof.events()`` that
    ``prof.events().export_chrome_trace`` writes, so the two files'
    ``traceEvents`` lay over each other.  ``spans`` (a tracer's
    ``spans_for()``) adds every rank's step phases to its lane, and
    with them each event's rendezvous barrier waits."""
    evs = sorted(events, key=lambda e: (e.t_start, e.seq))
    spans = sorted(spans, key=lambda s: s.t_start) if spans is not None \
        else None
    if offset is not None:
        t0 = -offset
    else:
        t0 = min((x[0].t_start for x in (evs, spans or ()) if x),
                 default=0.0)
    out = {"displayTimeUnit": "ms", "traceEvents": [],
           "otherData": {"source": label}}
    named = set()

    def lane(world, rank):
        pid = world if world >= 0 else 9999
        tid = rank if rank >= 0 else 0
        if (pid, tid) not in named:
            named.add((pid, tid))
            out["traceEvents"].append({
                "ph": "M", "pid": pid, "tid": tid,
                "name": "thread_name",
                "args": {"name": f"rank{rank}"}})
        return pid, tid

    for e in evs:
        pid, tid = lane(e.world, e.rank)
        name = e.op
        if e.codec:
            name += f".{e.codec}"
        if e.algorithm and e.algorithm != "ring":
            name += f".{e.algorithm}"
        out["traceEvents"].append({
            "ph": "X", "pid": pid, "tid": tid, "name": name,
            "cat": e.channel,
            "ts": (e.t_start - t0) * 1e6,
            "dur": max(e.duration_s, 0.0) * 1e6,
            "args": {
                "seq": e.seq,
                "payload_bytes": e.payload_bytes,
                "retries": e.retries,
                "status": e.status,
                "bucket": e.bucket,
                "signature": repr(e.signature),
            }})
        if spans is not None:
            for a, b in e.extra.get("waits", ()):
                out["traceEvents"].append({
                    "ph": "X", "pid": pid, "tid": tid,
                    "name": "mpi4torch.exchange.wait", "cat": "wait",
                    "ts": (a - t0) * 1e6, "dur": (b - a) * 1e6,
                    "args": {"seq": e.seq}})
    for s in spans or ():
        pid, tid = lane(s.world, s.rank)
        out["traceEvents"].append({
            "ph": "X", "pid": pid, "tid": tid,
            "name": f"mpi4torch.step.{s.phase}", "cat": "step",
            "ts": (s.t_start - t0) * 1e6,
            "dur": (s.t_end - s.t_start) * 1e6,
            "args": {"step": s.step}})
    return out


def write_chrome_trace(path: str, events: Iterable,
                       label: str = "mpi4torch_tpu_torch",
                       offset: Optional[float] = None,
                       spans: Optional[Iterable] = None) -> str:
    """Write :func:`chrome_trace` JSON to ``path`` (load it in Perfetto
    via "Open trace file", or ``chrome://tracing``).  Returns the
    path."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(chrome_trace(events, label=label, offset=offset,
                               spans=spans), f)
    return path
