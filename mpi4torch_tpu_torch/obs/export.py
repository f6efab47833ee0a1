"""Chrome-trace / Perfetto JSON export of the rank-thread event timeline.

Port of ``mpi4torch_tpu/obs/export.py``.  :func:`chrome_trace` renders a
:class:`~.events.CommEvent` list in the Chrome Trace Event Format (the
``traceEvents`` JSON that Perfetto and ``chrome://tracing`` load): one
row per (world, rank), complete ("X") events with the op, bytes,
retries and status in ``args``, so a hung collective shows as the row
where every rank's lane goes quiet but the one that never arrived.  The
times are host times (see ``events``); a ``torch.profiler`` trace holds
the device's side.
"""

from __future__ import annotations

import json
from typing import Iterable

__all__ = ["chrome_trace", "write_chrome_trace"]


def chrome_trace(events: Iterable, label: str = "mpi4torch_tpu_torch") -> dict:
    """Chrome Trace Event Format dict of an event list.

    Timestamps are microseconds relative to the earliest event (the
    absolute ``perf_counter`` epoch means nothing to a viewer); ``pid``
    is the world ordinal and ``tid`` the rank, so Perfetto renders one
    lane per rank with the collective spans aligned."""
    evs = sorted(events, key=lambda e: (e.t_start, e.seq))
    t0 = evs[0].t_start if evs else 0.0
    out = {"displayTimeUnit": "ms", "traceEvents": [],
           "otherData": {"source": label}}
    named = set()
    for e in evs:
        pid = e.world if e.world >= 0 else 9999
        tid = e.rank if e.rank >= 0 else 0
        if (pid, tid) not in named:
            named.add((pid, tid))
            out["traceEvents"].append({
                "ph": "M", "pid": pid, "tid": tid,
                "name": "thread_name",
                "args": {"name": f"rank{e.rank}"}})
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
    return out


def write_chrome_trace(path: str, events: Iterable,
                       label: str = "mpi4torch_tpu_torch") -> str:
    """Write :func:`chrome_trace` JSON to ``path`` (load it in Perfetto
    via "Open trace file", or ``chrome://tracing``).  Returns the
    path."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(chrome_trace(events, label=label), f)
    return path
