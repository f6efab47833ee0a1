"""The process-wide metrics registry: counters, gauges, histograms.

Port of ``mpi4torch_tpu/obs/metrics.py``.  One namespace for the
runtime counters (``World.retry_events`` mirrored as
``comm_retry_events_total``, the guards' violations, health probes, the
comm tracer's events and postmortems, the gray-failure detector's
flags, the serving engines' ``ServeStats``) with two exports: a JSON
:func:`snapshot` and Prometheus text (:func:`prometheus_text`, names
prefixed ``mpi4torch_``).  Thread-safe under one lock.

* The registry (:class:`MetricsRegistry`, the process default
  :func:`registry`): ``inc`` / ``set_gauge`` / ``observe``.  The comm
  fast path never writes here; only exceptional events (a retry that
  rescued a wait, a guard violation, a health probe) do.
* Collectors: callables polled at snapshot time, for subsystems that
  keep their own live state (the serving engines register one that
  aggregates every live ``ServeStats``).
* :class:`StatsSourceRegistry`: the weak-reference registry of live
  stats objects, so a discarded engine leaves the aggregate and memory.

:func:`percentile` is the one percentile rule ``ServeStats.snapshot``
uses (nearest-rank floor: element ``min(int(q * n), n - 1)`` of the
sorted sample).
"""

from __future__ import annotations

import json
import threading
import weakref
from typing import Callable, Dict, List, Optional, Sequence

__all__ = [
    "MetricsRegistry",
    "StatsSourceRegistry",
    "registry",
    "sources",
    "inc",
    "set_gauge",
    "observe",
    "register_collector",
    "snapshot",
    "metrics_json",
    "prometheus_text",
    "reset_metrics",
    "percentile",
    "record_moe",
]

PROM_PREFIX = "mpi4torch_"

# Default histogram bucket bounds (seconds: comm durations).
DEFAULT_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank-floor percentile of ``values`` (sorted internally):
    element ``min(int(q * n), n - 1)``.  Returns None on an empty
    sample.  The one rule of the package: ``ServeStats.snapshot``'s p50
    and p99 call it."""
    vals = sorted(values)
    if not vals:
        return None
    return vals[min(int(q * len(vals)), len(vals) - 1)]


class _Histogram:
    __slots__ = ("bounds", "counts", "total", "count")

    def __init__(self, bounds):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        i = 0
        for i, b in enumerate(self.bounds):
            if v <= b:
                break
        else:
            i = len(self.bounds)
        self.counts[i] += 1
        self.total += v
        self.count += 1

    def to_dict(self) -> dict:
        return {"buckets": {("%g" % b): c
                            for b, c in zip(self.bounds, self.counts)},
                "inf": self.counts[-1],
                "sum": self.total, "count": self.count}


class MetricsRegistry:
    """Counters / gauges / histograms under one lock, plus snapshot-time
    collectors.  Names are bare (``comm_retry_events_total``); the
    Prometheus exposition adds the ``mpi4torch_`` prefix."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Histogram] = {}
        self._collectors: Dict[str, Callable[[], dict]] = {}
        self._help: Dict[str, str] = {}

    # ------------------------------------------------------------ writes

    def inc(self, name: str, n: float = 1, help: str = "") -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n
            if help:
                self._help.setdefault(name, help)

    def set_gauge(self, name: str, value: float, help: str = "") -> None:
        with self._lock:
            self._gauges[name] = value
            if help:
                self._help.setdefault(name, help)

    def observe(self, name: str, value: float,
                buckets=DEFAULT_BUCKETS, help: str = "") -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Histogram(buckets)
            h.observe(value)
            if help:
                self._help.setdefault(name, help)

    def register_collector(self, name: str,
                           fn: Callable[[], dict]) -> None:
        """Register a snapshot-time collector: ``fn()`` returns a flat
        ``{metric_name: number}`` dict merged into the snapshot's
        ``collected`` section (and exported as Prometheus gauges).
        Re-registering a name replaces the collector (idempotent module
        reload)."""
        with self._lock:
            self._collectors[name] = fn

    # ------------------------------------------------------------- reads

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.to_dict()
                               for k, h in self._hists.items()},
            }
            collectors = list(self._collectors.items())
        collected: Dict[str, dict] = {}
        for name, fn in collectors:
            try:
                collected[name] = fn()
            except Exception as e:  # noqa: BLE001 — a broken collector
                # must not take the snapshot down with it.
                collected[name] = {"error": f"{type(e).__name__}: {e}"}
        out["collected"] = collected
        return out

    def json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, default=str)

    def prometheus_text(self) -> str:
        """Prometheus text exposition (format 0.0.4): counters as
        ``counter``, gauges and collector outputs as ``gauge``,
        histograms as the standard ``_bucket``/``_sum``/``_count``
        triple with cumulative ``le`` buckets."""
        snap = self.snapshot()
        lines: List[str] = []

        seen_headers = set()

        def emit(name, kind, value):
            # A name may carry a Prometheus label set (`..._total{result=
            # "ok"}` — the health-probe counters): the sample line keeps
            # it, the HELP/TYPE headers use the bare metric name (and are
            # emitted once per family, not once per label value).
            full = PROM_PREFIX + name
            bare = full.split("{", 1)[0]
            if bare not in seen_headers:
                seen_headers.add(bare)
                doc = self._help.get(name)
                if doc:
                    lines.append(f"# HELP {bare} {doc}")
                lines.append(f"# TYPE {bare} {kind}")
            lines.append(f"{full} {value:g}")

        for name in sorted(snap["counters"]):
            emit(name, "counter", snap["counters"][name])
        for name in sorted(snap["gauges"]):
            emit(name, "gauge", snap["gauges"][name])
        for group in sorted(snap["collected"]):
            for name, v in sorted(snap["collected"][group].items()):
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    full = f"{PROM_PREFIX}{group}_{name}"
                    lines.append(f"# TYPE {full} gauge")
                    lines.append(f"{full} {v:g}")
        with self._lock:
            hists = {k: h for k, h in self._hists.items()}
        for name in sorted(hists):
            h = hists[name]
            full = PROM_PREFIX + name
            lines.append(f"# TYPE {full} histogram")
            cum = 0
            for b, c in zip(h.bounds, h.counts):
                cum += c
                lines.append(f'{full}_bucket{{le="{b:g}"}} {cum}')
            cum += h.counts[-1]
            lines.append(f'{full}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{full}_sum {h.total:g}")
            lines.append(f"{full}_count {h.count}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero counters/gauges/histograms (collectors stay registered —
        they are live views, their owners reset themselves)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


class StatsSourceRegistry:
    """Weak-reference registry of live per-object stats sources, grouped
    by subsystem name: an object registers at construction, aggregation
    reads the live set, and a garbage-collected owner drops out of the
    set (and out of memory) instead of being summed forever."""

    def __init__(self):
        self._lock = threading.Lock()
        self._groups: Dict[str, List[weakref.ref]] = {}

    def register(self, group: str, obj):
        with self._lock:
            self._groups.setdefault(group, []).append(weakref.ref(obj))
        return obj

    def live(self, group: str) -> list:
        with self._lock:
            refs = self._groups.get(group, [])
            live, keep = [], []
            for ref in refs:
                obj = ref()
                if obj is not None:
                    live.append(obj)
                    keep.append(ref)
            refs[:] = keep   # prune dead owners' slots
        return live

    def clear(self, group: str) -> list:
        """Empty the group, returning the objects that were live — the
        ``reset_serve_stats`` semantics: callers reset the returned
        objects in place; owners constructed before the clear keep
        counting on their own objects but leave the aggregate."""
        live = self.live(group)
        with self._lock:
            self._groups.pop(group, None)
        return live


# ----------------------------------------------------------- process-wide

_registry = MetricsRegistry()
_sources = StatsSourceRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry every subsystem reports to."""
    return _registry


def sources() -> StatsSourceRegistry:
    """The process-wide weak-reference stats-source registry (where
    ``ServeStats`` objects register; see utils/profiling.py)."""
    return _sources


def inc(name: str, n: float = 1, help: str = "") -> None:
    _registry.inc(name, n, help=help)


def set_gauge(name: str, value: float, help: str = "") -> None:
    _registry.set_gauge(name, value, help=help)


def observe(name: str, value: float, buckets=DEFAULT_BUCKETS,
            help: str = "") -> None:
    _registry.observe(name, value, buckets=buckets, help=help)


def register_collector(name: str, fn: Callable[[], dict]) -> None:
    _registry.register_collector(name, fn)


def snapshot() -> dict:
    return _registry.snapshot()


def metrics_json() -> str:
    return _registry.json()


def prometheus_text() -> str:
    return _registry.prometheus_text()


def record_moe(layer: int, computed: int, sent: int,
               load_max_over_mean: float) -> None:
    """One rank's counts of one forward of a dropless MoE layer
    (``parallel/moe.py``, while a tracer is installed), labelled by
    layer: ``moe_assignments_total`` (token-expert assignments this
    rank's experts computed), ``moe_assignments_sent_total`` (rows this
    rank sent to the other ranks' experts) and the gauge
    ``moe_expert_load_max_over_mean`` (the busiest expert's assignments
    over the mean expert's, over every rank's tokens)."""
    lab = f'{{layer="{int(layer)}"}}'
    reg = registry()
    reg.inc("moe_assignments_total" + lab, computed,
            help="token-expert assignments computed by this process's "
                 "experts")
    reg.inc("moe_assignments_sent_total" + lab, sent,
            help="assignment rows sent to another rank's experts")
    reg.set_gauge("moe_expert_load_max_over_mean" + lab,
                  load_max_over_mean,
                  help="the busiest expert's assignments over the mean "
                       "expert's, last forward")


def reset_metrics() -> None:
    """Zero the default registry (isolation between runs; collectors and
    stats sources are untouched — their owners reset themselves, e.g.
    :func:`mpi4torch_tpu_torch.serve.reset_stats`)."""
    _registry.reset()
