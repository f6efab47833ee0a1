"""Gray-failure detection: who is slow, and how do we know?

Port of ``mpi4torch_tpu/resilience/health.py``.  A dead rank raises a
typed, attributed error; a chronically slow rank completes every
collective, just late.  This module turns the comm tracer's events into
a detector:

* The signal.  Every chokepoint event (:class:`~mpi4torch_tpu_torch.obs.
  CommEvent`) carries ``wait_s``, the time the rank spent blocked on
  peers at the rendezvous barriers, beside its ``duration_s``.  The
  difference is the rank's own local latency.  At a rendezvous everyone
  leaves together, so durations alone are symmetric; the split is not:
  the slow rank shows a high local time and a near-zero wait, every
  peer the inverse.
* The verdict.  :func:`detect_slow_ranks` folds a window of events into
  per-rank :class:`RankCommStats` and flags the ranks whose mean local
  latency exceeds ``threshold`` times the other ranks' median (and an
  absolute ``floor_s``), as a typed :class:`SlowRankReport`.
* The escalation.  :meth:`GrayFailureDetector.check` counts detections
  in the metrics registry (``mpi4torch_gray_failures_total``) and, with
  ``escalate=True``, raises :class:`SlowRankError`, which snapshots a
  flight-recorder postmortem like any attributed failure.

The events' times are host times, as in the JAX package: on the card a
rendezvous returns before the device has run the work, so the detector
sees the host's pacing of each rank, which is where a slow rank shows.
"""

from __future__ import annotations

from dataclasses import dataclass
from statistics import median as _median
from typing import Dict, FrozenSet, Optional, Tuple

from ..runtime import CommError

__all__ = [
    "RankCommStats",
    "SlowRankReport",
    "SlowRankError",
    "detect_slow_ranks",
    "GrayFailureDetector",
]

# Detection defaults: a rank must be this many times slower than the
# world's median local latency (and above the absolute floor) to be
# flagged.  Conservative on purpose: the detector must not flap on
# scheduler noise.
DEFAULT_THRESHOLD = 4.0
DEFAULT_FLOOR_S = 0.01
DEFAULT_MIN_EVENTS = 2
DEFAULT_WINDOW = 256

# Channels whose duration-wait split attributes the OWNING rank's local
# latency.  p2p_recv is excluded: a receive's duration measures the
# SENDER's lateness (attributed via `peer`, not via the receiving
# rank's stats).
_LOCAL_CHANNELS = ("exchange", "p2p_send")


@dataclass(frozen=True)
class RankCommStats:
    """Rolling per-rank communication statistics over the detection
    window: mean pre-barrier local latency (the gray signal), mean
    barrier wait (the inverse signal), and total retry extensions."""
    rank: int
    events: int
    local_s: float
    wait_s: float
    retries: int


@dataclass(frozen=True)
class SlowRankReport:
    """The detector's typed verdict: per-rank stats, the flagged
    ``slow`` set, and the decision parameters that produced it.
    ``baseline_s`` is the world's median per-rank local latency."""
    world: int
    world_size: int
    stats: Tuple[RankCommStats, ...]
    slow: FrozenSet[int]
    baseline_s: float
    threshold: float
    floor_s: float

    def stat(self, rank: int) -> Optional[RankCommStats]:
        for s in self.stats:
            if s.rank == rank:
                return s
        return None

    def summary(self) -> str:
        rows = ", ".join(
            f"rank {s.rank}: local {s.local_s * 1e3:.1f}ms / wait "
            f"{s.wait_s * 1e3:.1f}ms ({s.events} ev, {s.retries} retries)"
            for s in self.stats)
        return (f"slow={sorted(self.slow)} (baseline "
                f"{self.baseline_s * 1e3:.1f}ms x {self.threshold}, "
                f"floor {self.floor_s * 1e3:.0f}ms) [{rows}]")


class SlowRankError(CommError):
    """An escalated gray failure: ``ranks`` names the slow rank(s),
    ``report`` carries the evidence, and the flight recorder snapshots a
    postmortem on it as it does for a crash."""

    def __init__(self, message: str, ranks=(),
                 report: Optional[SlowRankReport] = None):
        super().__init__(message)
        self.ranks: FrozenSet[int] = frozenset(ranks)
        self.report = report


def detect_slow_ranks(events, *, world: Optional[int] = None,
                      threshold: float = DEFAULT_THRESHOLD,
                      floor_s: float = DEFAULT_FLOOR_S,
                      min_events: int = DEFAULT_MIN_EVENTS,
                      window: int = DEFAULT_WINDOW
                      ) -> Optional[SlowRankReport]:
    """Fold CommEvents into a :class:`SlowRankReport`.

    ``events`` is any iterable of :class:`~mpi4torch_tpu_torch.obs.
    CommEvent`
    (typically ``tracer.events_for()``); ``world`` selects one traced
    world ordinal (default: the one with the most usable events — a
    detector must not average two different jobs together).  Returns
    None when no world has a judgeable rank (fewer than ``min_events``
    completed chokepoint events everywhere)."""
    per_rank: Dict[Tuple[int, int], list] = {}
    for ev in events:
        if ev.channel not in _LOCAL_CHANNELS or ev.status != "ok":
            continue
        if world is not None and ev.world != world:
            continue
        per_rank.setdefault((ev.world, ev.rank), []).append(ev)
    if not per_rank:
        return None
    if world is None:
        counts: Dict[int, int] = {}
        for (w, _r), evs in per_rank.items():
            counts[w] = counts.get(w, 0) + len(evs)
        world = max(counts, key=lambda w: (counts[w], w))
        per_rank = {k: v for k, v in per_rank.items() if k[0] == world}

    stats = []
    world_size = 0
    for (_w, rank), evs in sorted(per_rank.items()):
        evs = evs[-window:]
        world_size = max(world_size, evs[-1].world_size)
        if len(evs) < min_events:
            continue
        local = [max(0.0, e.duration_s - e.wait_s) for e in evs]
        wait = [e.wait_s for e in evs]
        stats.append(RankCommStats(
            rank=rank, events=len(evs),
            local_s=sum(local) / len(local),
            wait_s=sum(wait) / len(wait),
            retries=sum(e.retries for e in evs)))
    if not stats:
        return None
    baseline = _median([s.local_s for s in stats])
    # Leave-one-out decision: each rank is judged against the median of
    # the OTHER ranks' local latency — on a small world the global
    # median is contaminated by the outlier itself (a 2-rank world's
    # median is half the slow rank's own tax, and nothing would ever
    # exceed threshold x that).
    slow = set()
    for s in stats:
        others = [o.local_s for o in stats if o.rank != s.rank]
        base = _median(others) if others else baseline
        if s.local_s > max(threshold * base, floor_s):
            slow.add(s.rank)
    slow = frozenset(slow)
    return SlowRankReport(world=world, world_size=world_size,
                          stats=tuple(stats), slow=slow,
                          baseline_s=baseline, threshold=threshold,
                          floor_s=floor_s)


class GrayFailureDetector:
    """The detector riding a :class:`~mpi4torch_tpu_torch.obs.
    CommTracer`:
    :meth:`report` folds the tracer's current event stream,
    :meth:`check` additionally counts detections
    (``mpi4torch_gray_failures_total``) and — with ``escalate=True`` —
    raises the typed :class:`SlowRankError` after snapshotting a
    flight-recorder postmortem for the traced world.

    It only reads events a tracer already recorded: with no tracer
    installed there is nothing to read and nothing on the comm path."""

    def __init__(self, tracer=None, *,
                 threshold: float = DEFAULT_THRESHOLD,
                 floor_s: float = DEFAULT_FLOOR_S,
                 min_events: int = DEFAULT_MIN_EVENTS,
                 window: int = DEFAULT_WINDOW):
        self._tracer = tracer
        self.threshold = float(threshold)
        self.floor_s = float(floor_s)
        self.min_events = int(min_events)
        self.window = int(window)

    def _resolve_tracer(self):
        if self._tracer is not None:
            return self._tracer
        from .. import config as _cfg

        return _cfg.comm_tracer()

    def report(self, world: Optional[int] = None
               ) -> Optional[SlowRankReport]:
        tracer = self._resolve_tracer()
        if tracer is None:
            return None
        return detect_slow_ranks(
            tracer.events_for(), world=world, threshold=self.threshold,
            floor_s=self.floor_s, min_events=self.min_events,
            window=self.window)

    def check(self, world: Optional[int] = None, *,
              escalate: bool = False) -> Optional[SlowRankReport]:
        """One detection round.  Flagged ranks are counted in the obs
        metrics registry; with ``escalate=True`` a non-empty ``slow``
        set raises :class:`SlowRankError` (the postmortem snapshotted
        first)."""
        report = self.report(world)
        if report is None or not report.slow:
            return report
        from ..obs import metrics as _metrics

        _metrics.inc("gray_failures_total", len(report.slow),
                     help="slow ranks flagged by the gray-failure "
                          "detector (resilience.health)")
        if escalate:
            err = SlowRankError(
                f"gray failure escalated: rank(s) "
                f"{sorted(report.slow)} are chronically slow — "
                + report.summary(), ranks=report.slow, report=report)
            tracer = self._resolve_tracer()
            if tracer is not None:
                tracer.note_gray_failure(
                    report.world, report.world_size,
                    min(report.slow), err)
            raise err
        return report
