"""The failure flight recorder: what were the last N wire operations on
each rank when it died?

Port of ``mpi4torch_tpu/obs/flight.py``.  The tracer keeps a bounded
ring of recent :class:`~.events.CommEvent` records per (world, rank).
When a chokepoint raises one of the attributed failures
(``RankFailedError``, ``DeadlockError``, ``IntegrityError``,
``SlowRankError``), the first raising rank snapshots every rank's ring
into a postmortem: the error's type and message, the rank attribution
the error carries, and each rank's event tail, newest last, so the last
row of a rank's table is the operation it died in (or the last one it
completed before a peer tore the world down).

Two renderings: :func:`build_postmortem` (the dict the tracer stores,
written by :func:`dump_postmortem`) and :func:`format_postmortem` (the
table).  The times in a tail are host times (see ``events``).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

__all__ = [
    "build_postmortem",
    "format_postmortem",
    "dump_postmortem",
]


def _error_ranks(error) -> List[int]:
    ranks = getattr(error, "ranks", None)
    if ranks:
        return sorted(ranks)
    missing = getattr(error, "missing", None)
    return sorted(missing) if missing else []


def build_postmortem(tracer, ev, error) -> dict:
    """Snapshot the tracer's ring state for ``ev.world`` into a
    postmortem dict (caller holds the tracer lock — first failing
    commit wins; see ``CommTracer._note_failure``)."""
    tails = {}
    for (world, rank), ring in tracer._rings.items():
        if world == ev.world:
            tails[rank] = [e.to_dict() for e in ring]
    return {
        "error": type(error).__name__,
        "message": str(error),
        "failed_ranks": _error_ranks(error),
        "first_observer_rank": ev.rank,
        "observers": 1,
        "observer_ranks": [ev.rank],
        "world": ev.world,
        "world_size": ev.world_size,
        "ring": tracer.ring,
        "tails": tails,
    }


def format_postmortem(pm: dict, width: int = 78) -> str:
    """Human table of a postmortem: header (error, attribution), then
    one section per rank with its event tail, newest last."""
    lines = [
        "=" * width,
        f"FLIGHT RECORDER POSTMORTEM — {pm['error']}",
        f"  failed/missing rank(s): {pm['failed_ranks'] or 'unattributed'}"
        f"   (first observed on rank {pm['first_observer_rank']}, "
        f"{pm['observers']} observer(s))",
        f"  world size {pm['world_size']}, last {pm['ring']} events/rank",
        f"  {pm['message'][:2 * width]}",
        "=" * width,
    ]
    header = (f"  {'seq':>6} {'channel':<9} {'op':<22} {'bytes':>10} "
              f"{'ms':>8} {'retries':>7} status")
    for rank in sorted(pm["tails"]):
        dead = rank in pm["failed_ranks"]
        lines.append(f"rank {rank}"
                     + ("   ** FAILED/MISSING **" if dead else ""))
        lines.append(header)
        for e in pm["tails"][rank]:
            lines.append(
                f"  {e['seq']:>6} {e['channel']:<9} {e['op']:<22} "
                f"{e['payload_bytes']:>10} "
                f"{e['duration_s'] * 1e3:>8.2f} {e['retries']:>7} "
                f"{e['status']}")
        if not pm["tails"][rank]:
            lines.append("  (no events recorded)")
    lines.append("=" * width)
    return "\n".join(lines)


def dump_postmortem(pm: dict, directory: str,
                    stem: str = "postmortem") -> dict:
    """Write a postmortem as ``<stem>.json`` + the human ``<stem>.txt``
    table under ``directory`` (created if needed); returns the two
    paths."""
    os.makedirs(directory, exist_ok=True)
    jpath = os.path.join(directory, f"{stem}.json")
    tpath = os.path.join(directory, f"{stem}.txt")
    with open(jpath, "w", encoding="utf-8") as f:
        json.dump(pm, f, indent=1, sort_keys=True)
    with open(tpath, "w", encoding="utf-8") as f:
        f.write(format_postmortem(pm) + "\n")
    return {"json": jpath, "table": tpath}


def last_event_signature(pm: dict, rank: int) -> Optional[str]:
    """The signature repr of ``rank``'s newest tail event (or None) —
    what the tail-consistency check compares across survivors."""
    tail = pm["tails"].get(rank) or []
    return tail[-1]["signature"] if tail else None
