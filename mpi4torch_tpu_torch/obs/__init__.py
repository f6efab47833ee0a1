"""Runtime observability of the rank-thread runtime.

Port of ``mpi4torch_tpu.obs``:

* chokepoint comm tracing (:mod:`.trace`, :mod:`.events`): typed
  :class:`CommEvent` records from ``World.exchange`` and the p2p
  mailboxes, which every subsystem's traffic goes through.  Off, a
  chokepoint pays one attribute read; on, the tracer reads no device
  value, so it adds no device sync;
* a metrics registry (:mod:`.metrics`): counters, gauges and histograms
  with a JSON snapshot and Prometheus text, the serving engines'
  counters as a collector, the shared :func:`percentile` rule;
* a flight recorder (:mod:`.flight`): per-rank rings of recent events,
  written as a rank-attributed postmortem when a rank dies, a rendezvous
  times out or an integrity guard fires;
* a Chrome-trace / Perfetto export (:mod:`.export`) of the timeline;
* static-vs-runtime reconciliation (:mod:`.reconcile`):
  :func:`reconcile` holds a traced run's wire bytes and collective
  counts, exactly, against the recorded Mode A program
  (``analyze.lower``, ``Engine.lower_step``).

Event times are host times.  ``python -m mpi4torch_tpu_torch.obs
--smoke`` runs the four verdict families.
"""

# The module alias comes first: the `trace` attribute below is the
# context manager, which shadows the submodule on the package.
from . import trace as tracing  # noqa: F401  (module alias)
from .events import CommEvent, annotate_signature, payload_nbytes
from .export import chrome_trace, write_chrome_trace
from .flight import dump_postmortem, format_postmortem
from .reconcile import (equivalent_tier_wire, equivalent_wire,
                        measured_wire_table, reconcile)
from .metrics import (MetricsRegistry, StatsSourceRegistry, metrics_json,
                      percentile, prometheus_text, register_collector,
                      registry, reset_metrics, snapshot)
from .trace import (CommTracer, current_tracer, push_label,
                    spmd_collective_event, trace)

__all__ = [
    "tracing",
    "CommEvent",
    "CommTracer",
    "annotate_signature",
    "payload_nbytes",
    "trace",
    "current_tracer",
    "push_label",
    "spmd_collective_event",
    "MetricsRegistry",
    "StatsSourceRegistry",
    "registry",
    "snapshot",
    "metrics_json",
    "prometheus_text",
    "register_collector",
    "reset_metrics",
    "percentile",
    "format_postmortem",
    "dump_postmortem",
    "chrome_trace",
    "write_chrome_trace",
    "measured_wire_table",
    "reconcile",
    "equivalent_wire",
    "equivalent_tier_wire",
]
