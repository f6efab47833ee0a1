"""Observability: profiler spans, engine counters and trace capture.

Port of ``mpi4torch_tpu/utils/profiling.py``.  The spans are
``torch.profiler.record_function`` ranges (the counterpart of the JAX
package's ``jax.named_scope``), so a ``torch.profiler`` trace separates
prefill from decode and names every decode collective site and every
bucket of a fused collective; with a comm tracer installed
(``mpi4torch_tpu_torch.obs``) each span's name is also pushed as the
label of the chokepoint events inside it.  :class:`ServeStats` keeps an
engine's counters and per-request timestamps; :meth:`ServeStats.snapshot`
derives occupancy and TTFT / end-to-end latency p50 and p99.  Engines
register their stats with the obs source registry, so
:func:`serve_stats` aggregates every live engine and the metrics
registry exports them as ``mpi4torch_serve_*``.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from ..obs.metrics import percentile, register_collector, sources
from ..obs.trace import push_label

__all__ = ["profiler_trace", "bucket_scope", "serve_step_scope",
           "ServeStats", "serve_stats", "reset_serve_stats", "percentile"]


def bucket_scope(op: str, index: int, total: int, codec=None, phase=None):
    """Span ``mpi4torch.<op>.bucket<i>of<n>[.<codec>][.<phase>]`` around
    one collective site: one bucket of a fused tree collective (a
    compressed bucket carries its codec's name), one chunk of a decode
    collective, or one half (``start``/``wait``) of a split-phase
    bucket."""
    name = f"mpi4torch.{op}.bucket{index}of{total}"
    if codec is not None:
        name += f".{codec.name}"
    if phase is not None:
        name += f".{phase}"
    return _labeled_scope(name)


def serve_step_scope(what: str = "decode_step"):
    """Span ``mpi4torch.serve.<what>`` around one serving-engine phase."""
    return _labeled_scope(f"mpi4torch.serve.{what}")


@contextlib.contextmanager
def _labeled_scope(name: str):
    """``record_function(name)`` plus the obs label push (which does
    nothing while no comm tracer is installed)."""
    with push_label(name), torch.profiler.record_function(name):
        yield


class ServeStats:
    """Engine counters plus per-request lifecycle timestamps.

    Counters: ``steps`` (decode steps run), ``admitted`` / ``evicted`` /
    ``finished`` / ``rejected`` (request lifecycle), ``deadline_expired``
    and ``shed`` (typed non-ok completions), ``decode_tokens`` (tokens
    emitted by decode steps; a prefill's first token counts under
    ``admitted``), ``occupancy_ticks`` (active slots summed over steps)
    and ``slot_ticks`` (slots x steps) — their ratio is the mean slot
    occupancy.  The paged engine adds ``prefix_hits`` / ``prefix_misses``
    (admissions that did / did not reuse indexed prefix pages),
    ``prefill_tokens`` (tokens actually run through prefill: reused
    prefix tokens never are), ``cow_copies`` (copy-on-write page copies)
    and ``preempted`` (slots preempted under pool pressure), and the
    levels ``blocks_in_use`` / ``blocks_free`` / ``blocks_cached``
    (absolute pool populations, re-set every step by :meth:`level`).
    Spans per request id: ``submitted`` → ``admitted`` →
    ``first_token`` → ``finished`` host timestamps, capped at the most
    recent :data:`SPAN_CAP` requests.  Thread-safe."""

    _COUNTERS = ("steps", "admitted", "evicted", "finished", "rejected",
                 "decode_tokens", "occupancy_ticks", "slot_ticks",
                 "deadline_expired", "shed",
                 "prefix_hits", "prefix_misses", "prefill_tokens",
                 "cow_copies", "preempted",
                 "blocks_in_use", "blocks_free", "blocks_cached")
    SPAN_CAP = 1024

    def __init__(self):
        self._lock = threading.Lock()
        self.counters = {k: 0 for k in self._COUNTERS}
        self.spans = {}

    def reset(self) -> None:
        """Zero the counters and drop the spans, in place (an engine
        holding this object goes on counting from zero)."""
        with self._lock:
            for k in list(self.counters):
                self.counters[k] = 0
            self.spans.clear()

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def level(self, name: str, value) -> None:
        """Set a gauge counter to an absolute value (the paged engine's
        pool populations, re-set every step)."""
        with self._lock:
            self.counters[name] = int(value)

    def tick(self, active: int, slots: int) -> None:
        """One decode step over a ``slots``-slot table with ``active``
        live slots."""
        with self._lock:
            self.counters["steps"] += 1
            self.counters["occupancy_ticks"] += int(active)
            self.counters["slot_ticks"] += int(slots)

    def mark(self, rid, event: str) -> None:
        """Record a lifecycle timestamp; the first occurrence wins."""
        with self._lock:
            self.spans.setdefault(rid, {}).setdefault(event,
                                                      time.perf_counter())
            while len(self.spans) > self.SPAN_CAP:
                self.spans.pop(next(iter(self.spans)))

    def snapshot(self) -> dict:
        """Counters plus occupancy and TTFT / end-to-end latency
        aggregates (seconds: mean, max, p50, p99)."""
        with self._lock:
            counters = dict(self.counters)
            spans = {rid: dict(s) for rid, s in self.spans.items()}
        out = dict(counters)
        out["occupancy"] = (
            round(counters["occupancy_ticks"] / counters["slot_ticks"], 4)
            if counters["slot_ticks"] else None)
        out["n_requests_tracked"] = len(spans)
        for key, end in (("ttft_s", "first_token"), ("e2e_s", "finished")):
            lat = [s[end] - s["submitted"] for s in spans.values()
                   if end in s and "submitted" in s]
            if lat:
                out[key] = {"mean": sum(lat) / len(lat), "max": max(lat),
                            "p50": percentile(lat, 0.50),
                            "p99": percentile(lat, 0.99)}
        return out


# Engines register their ServeStats weakly in the obs source registry,
# so a discarded engine leaves the aggregate (and memory).
_SERVE_GROUP = "serve"


def _register_serve_stats(stats: ServeStats) -> ServeStats:
    return sources().register(_SERVE_GROUP, stats)


def serve_stats() -> dict:
    """Process-wide aggregate of every live engine's :class:`ServeStats`
    (``serve.stats()``).  Counters sum across engines: on rank threads
    each rank runs its own engine, so counts there are ``nranks`` times
    the logical traffic."""
    engines = sources().live(_SERVE_GROUP)
    agg = {k: 0 for k in ServeStats._COUNTERS}
    for e in engines:
        snap = e.snapshot()
        for k in agg:
            agg[k] += snap.get(k, 0)
    agg["n_engines"] = len(engines)
    agg["occupancy"] = (round(agg["occupancy_ticks"] / agg["slot_ticks"], 4)
                        if agg["slot_ticks"] else None)
    return agg


def reset_serve_stats() -> None:
    """Zero every live engine's counters and spans in place and empty the
    registry (``serve.reset_stats()``).  Engines made before the reset
    keep counting on their own stats but leave the aggregate."""
    for e in sources().clear(_SERVE_GROUP):
        e.reset()


# The serving counters in the metrics namespace (mpi4torch_serve_*),
# polled at snapshot time from the engines' own live state.
register_collector("serve", serve_stats)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block (host and,
    with CUDA available, device activity) into ``logdir``, in the
    TensorBoard / Perfetto format; the spans above name the collective
    sites in it.  The counterpart of the JAX package's
    ``profiler_trace``, which captures a JAX profiler trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)):
        yield
