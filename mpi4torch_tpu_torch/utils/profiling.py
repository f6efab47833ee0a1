"""Observability: profiler spans and engine counters.

Port of the serving and bucket parts of
``mpi4torch_tpu/utils/profiling.py``.  The spans are
``torch.profiler.record_function`` ranges (the counterpart of the JAX
package's ``jax.named_scope``), so a ``torch.profiler`` trace separates
prefill from decode and names every decode collective site and every
bucket of a fused collective.  :class:`ServeStats` keeps the engine's
counters and per-request timestamps; :meth:`ServeStats.snapshot`
derives occupancy and TTFT / end-to-end latency p50 and p99.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import torch

__all__ = ["bucket_scope", "serve_step_scope", "ServeStats", "percentile"]


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
    return torch.profiler.record_function(name)


def serve_step_scope(what: str = "decode_step"):
    """Span ``mpi4torch.serve.<what>`` around one serving-engine phase."""
    return torch.profiler.record_function(f"mpi4torch.serve.{what}")


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank-floor percentile: element ``min(int(q * n), n - 1)``
    of the sorted sample (the JAX package's rule), or None when empty."""
    vals = sorted(values)
    if not vals:
        return None
    return vals[min(int(q * len(vals)), len(vals) - 1)]


class ServeStats:
    """Engine counters plus per-request lifecycle timestamps.

    Counters: ``steps`` (decode steps run), ``admitted`` / ``evicted`` /
    ``finished`` / ``rejected`` (request lifecycle), ``deadline_expired``
    and ``shed`` (typed non-ok completions), ``decode_tokens`` (tokens
    emitted by decode steps; a prefill's first token counts under
    ``admitted``), ``occupancy_ticks`` (active slots summed over steps)
    and ``slot_ticks`` (slots x steps) — their ratio is the mean slot
    occupancy.  Spans per request id: ``submitted`` → ``admitted`` →
    ``first_token`` → ``finished`` host timestamps, capped at the most
    recent :data:`SPAN_CAP` requests.  Thread-safe."""

    _COUNTERS = ("steps", "admitted", "evicted", "finished", "rejected",
                 "decode_tokens", "occupancy_ticks", "slot_ticks",
                 "deadline_expired", "shed")
    SPAN_CAP = 1024

    def __init__(self):
        self._lock = threading.Lock()
        self.counters = {k: 0 for k in self._COUNTERS}
        self.spans = {}

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

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
