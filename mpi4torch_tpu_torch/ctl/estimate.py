"""Live bandwidth estimation from the CommEvent stream.

Port of ``mpi4torch_tpu/ctl/estimate.py``.

The estimator is the controller's *measurement leg*: it folds the
censused Mode B events the obs tracer already collects (payload bytes /
wall duration at the two chokepoints — zero new hooks) into exponentially-weighted per-link and per-tier bandwidth
estimates.

* **per-link** — one EWMA per rank: every exchange event a rank
  commits updates that rank's link estimate.  The measured quantity is
  GOODPUT — *logical* bytes per second: an event on a compressed wire
  censuses its encoded bytes (the same bytes the brownout throttle
  reads), which :func:`goodput_bytes` scales back up by the codec's
  wire ratio (``compress.get_codec(...).wire_bytes``).  Goodput is codec-INVARIANT, which the control loop
  needs on both sides: a healthy link reads the same estimate whether
  the wire is exact or q8 (so an escalated episode can *recover* —
  the ratio climbs back above the high watermark once the fault
  clears), while a browned link stays sagged under q8 (duration is
  dominated by the per-encoded-byte throttle) — so the escalation
  never flaps back while the fault holds.
* **per-tier** — the event's traffic is attributed to a tier of the
  resolved stack with :func:`mpi4torch_tpu_torch.csched.tier_of_group` — THE
  shared attribution rule of the program census, the StableHLO census
  and the obs reconciliation, so prediction and live measurement can
  only disagree about *traffic*, never about *pricing*.  Whole-world
  events (the flat allreduce rendezvous) cross the slowest link and
  charge the top tier (``tier_of_groups(None, tiers)``); grouped
  events (reshard/grouped steps carrying ``group_size``) charge the
  tier of the contiguous innermost-first group of that size.

Estimates export as ``mpi4torch_ctl_*`` gauges
(:func:`BandwidthEstimator.export_gauges`) and feed the drift monitor
(:mod:`.drift`) and the controller's live re-synthesis
(:mod:`.controller`).  Ingestion is cursor-based on the tracer's
global monotone ``seq`` (process-backend worker events are re-sequenced
by ``CommTracer.absorb`` before we ever see them), so repeated
``observe()`` calls over one tracer never double-count an event.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch

__all__ = [
    "Ewma",
    "event_tier",
    "goodput_bytes",
    "BandwidthEstimator",
]


class Ewma:
    """Exponentially-weighted moving average with a half-life in
    SAMPLES: after ``halflife`` updates, the old value's weight is
    1/2.  ``alpha = 1 - 0.5**(1/halflife)``."""

    __slots__ = ("alpha", "value", "count")

    def __init__(self, halflife: float):
        halflife = float(halflife)
        if halflife <= 0:
            raise ValueError(f"halflife must be > 0, got {halflife}")
        self.alpha = 1.0 - 0.5 ** (1.0 / halflife)
        self.value: Optional[float] = None
        self.count = 0

    def update(self, x: float) -> float:
        x = float(x)
        if self.value is None:
            self.value = x
        else:
            self.value += self.alpha * (x - self.value)
        self.count += 1
        return self.value


def event_tier(ev, tiers: Tuple[int, ...]) -> int:
    """Tier of the resolved stack (innermost first) an event's traffic
    crosses — the census attribution rule applied to a *measured*
    event.  ``group_size`` None/world-sized traffic spans every tier
    and is charged to the slowest link it crosses (the top tier,
    exactly ``csched.tier_of_groups(None, tiers)``); a grouped event of
    size ``g`` charges the tier of the contiguous innermost-first
    ``g``-group (the highest mixed-radix digit that differs inside
    it)."""
    from ..csched import tier_of_group, tier_of_groups

    world = 1
    for t in tiers:
        world *= int(t)
    g = ev.group_size
    if g is None or g <= 1 or g >= world:
        return tier_of_groups(None, tiers)
    return tier_of_group(tuple(range(int(g))), tiers)


def _measurable(ev) -> bool:
    """Which events carry a (bytes, duration) bandwidth sample:
    successful exchange-channel wire events with a real payload.
    Unlike the reconciler's byte-accounting filter, ``unmodeled`` heads
    COUNT here — a head the static census does not price (e.g. the
    compressed ``.c`` eager forms) still moved real bytes over a real
    wall interval, and the escalated phase of an episode runs exactly
    such heads, so excluding them would blind the monitor to its own
    recovery.  Bookkeeping rounds (rendezvous control traffic) and
    failed ops price nothing."""
    return (ev.channel == "exchange" and ev.status == "ok"
            and not ev.bookkeeping and ev.payload_bytes > 0
            and ev.duration_s > 0)


_CODEC_FACTORS: Dict[str, float] = {}

# Canonical probe for the codec expansion factor: large enough that
# per-block metadata is amortized the way real payloads amortize it.
_PROBE_ELEMS = 4096


def goodput_bytes(ev) -> float:
    """The event's LOGICAL payload bytes: encoded wire bytes scaled by
    the codec's expansion factor (logical/wire, measured once per codec
    from ``Codec.wire_bytes`` on a canonical float32 probe — real
    encoded buffers, so the factor cannot drift from the codec
    implementation).  Exact-wire events pass through unchanged; an
    unregistered/ad-hoc codec name degrades to factor 1.0 (encoded
    bytes), never an error."""
    name = getattr(ev.codec, "name", ev.codec)
    if name is None:
        return float(ev.payload_bytes)
    factor = _CODEC_FACTORS.get(name)
    if factor is None:
        factor = 1.0
        try:
            from ..compress import get_codec

            wire = get_codec(name).wire_bytes((_PROBE_ELEMS,),
                                              torch.float32)
            if wire > 0:
                factor = (_PROBE_ELEMS * 4) / wire
        except Exception:
            pass
        _CODEC_FACTORS[name] = factor
    return float(ev.payload_bytes) * factor


class BandwidthEstimator:
    """EWMA per-link and per-tier GOODPUT estimates (logical bytes/s,
    codec-invariant — see :func:`goodput_bytes`) over a CommEvent
    stream.

    ::

        est = BandwidthEstimator(tiers=(2, 2, 2))
        est.observe()                  # ingest the installed tracer
        est.tier_estimates()           # (None-able) bytes/s per tier
        est.link_estimates()           # {rank: bytes/s}

    ``halflife`` defaults to :func:`mpi4torch_tpu_torch.config.ctl_halflife`
    (samples, not seconds: a deterministic unit — the smoke/test cells
    drive the estimator with known event counts, never wall-clock)."""

    def __init__(self, tiers, *, halflife: Optional[float] = None):
        self.tiers: Tuple[int, ...] = tuple(int(t) for t in tiers)
        if not self.tiers or any(t < 1 for t in self.tiers):
            raise ValueError(
                f"estimator needs a tier stack of factors >= 1, got "
                f"{tiers!r}")
        if halflife is None:
            from .. import config as _cfg

            halflife = _cfg.ctl_halflife()
        self.halflife = float(halflife)
        self._tier: List[Ewma] = [Ewma(self.halflife)
                                  for _ in self.tiers]
        self._link: Dict[int, Ewma] = {}
        self._last_seq = -1

    # ------------------------------------------------------------ ingest

    def ingest(self, events: Iterable) -> int:
        """Fold events with ``seq`` beyond the cursor into the
        estimates; returns how many carried a measurable sample."""
        n = 0
        cursor = self._last_seq
        for ev in events:
            if ev.seq <= self._last_seq:
                continue
            cursor = max(cursor, ev.seq)
            if not _measurable(ev):
                continue
            bw = goodput_bytes(ev) / ev.duration_s
            link = self._link.get(ev.rank)
            if link is None:
                link = self._link[ev.rank] = Ewma(self.halflife)
            link.update(bw)
            self._tier[event_tier(ev, self.tiers)].update(bw)
            n += 1
        self._last_seq = cursor
        return n

    def observe(self, tracer=None) -> int:
        """Ingest from ``tracer`` (default: the installed
        ``config.comm_tracer()``); no tracer means no new samples —
        never an error, the controller must stay inert on an
        unobserved program."""
        if tracer is None:
            from .. import config as _cfg

            tracer = _cfg.comm_tracer()
        if tracer is None:
            return 0
        return self.ingest(list(tracer.events))

    # ----------------------------------------------------------- queries

    def tier_estimates(self) -> Tuple[Optional[float], ...]:
        """Per-tier bytes/s (innermost first); None for an unsampled
        tier."""
        return tuple(e.value for e in self._tier)

    def tier_samples(self) -> Tuple[int, ...]:
        return tuple(e.count for e in self._tier)

    def link_estimates(self) -> Dict[int, float]:
        """Per-rank link bytes/s (only sampled ranks appear)."""
        return {r: e.value for r, e in sorted(self._link.items())
                if e.value is not None}

    def export_gauges(self) -> None:
        """Publish the live estimates as ``mpi4torch_ctl_*`` gauges
        (the exposition layer adds the ``mpi4torch_`` prefix)."""
        from ..obs import metrics as _metrics

        for tier, val in enumerate(self.tier_estimates()):
            if val is not None:
                _metrics.set_gauge(
                    f'ctl_tier_bandwidth_bytes_per_s{{tier="{tier}"}}',
                    val, help="EWMA per-tier live bandwidth estimate "
                              "(ctl.estimate)")
        for rank, val in self.link_estimates().items():
            _metrics.set_gauge(
                f'ctl_link_bandwidth_bytes_per_s{{rank="{rank}"}}',
                val, help="EWMA per-rank link bandwidth estimate "
                          "(ctl.estimate)")

    def __repr__(self) -> str:
        est = ["-" if v is None else f"{v:.3g}"
               for v in self.tier_estimates()]
        return (f"BandwidthEstimator(tiers={self.tiers}, "
                f"halflife={self.halflife:g}, est=[{', '.join(est)}])")
