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
* step phases and rendezvous waits (:mod:`.trace`): with a tracer
  installed, every rank thread's ``mpi4torch.step.forward`` /
  ``backward`` / ``exchange`` / ``update`` phases are
  profiler ranges and :class:`StepSpan` records, and each
  barrier wait on a peer a ``mpi4torch.exchange.wait`` span and an
  interval in its event's ``extra["waits"]``;
* one clock (:mod:`.clock`): :func:`clock_offset` pairs the profiling
  rank's phase spans with a ``torch.profiler`` trace's and gives the
  offset between ``perf_counter`` and the profiler's clock, with its
  spread; :func:`on_profiler_clock` puts every rank's phases, waits
  and events on that clock;
* a Chrome-trace / Perfetto export (:mod:`.export`) of the timeline:
  ``chrome_trace(t.events, offset=offset, spans=t.spans_for())`` draws
  every rank's events, phases and waits on the profiler's clock, to lay
  over ``prof.events().export_chrome_trace(...)`` of the same run;
* static-vs-runtime reconciliation (:mod:`.reconcile`):
  :func:`reconcile` holds a traced run's wire bytes and collective
  counts, exactly, against the recorded Mode A program
  (``analyze.lower``, ``Engine.lower_step``).

Event times are host times.  To get the phase and wait lanes of every
rank on a profiler trace's clock: run the ranks under ``obs.trace()``
with ``torch.profiler.profile`` opened on rank 0's thread (the profiler
records that thread's spans alone), then ``offset, spread =
obs.clock_offset(t, prof)`` and ``obs.write_chrome_trace(path,
t.events, offset=offset, spans=t.spans_for())``.  ``python -m mpi4torch_tpu_torch.obs
--smoke`` runs the four verdict families.
"""

# The module alias comes first: the `trace` attribute below is the
# context manager, which shadows the submodule on the package.
from . import trace as tracing  # noqa: F401  (module alias)
from .clock import clock_offset, on_profiler_clock
from .events import CommEvent, StepSpan, annotate_signature, payload_nbytes
from .export import chrome_trace, write_chrome_trace
from .flight import dump_postmortem, format_postmortem
from .reconcile import (equivalent_tier_wire, equivalent_wire,
                        measured_wire_table, reconcile)
from .metrics import (MetricsRegistry, StatsSourceRegistry, metrics_json,
                      percentile, prometheus_text, record_moe,
                      register_collector, registry, reset_metrics, snapshot)
from .trace import (CommTracer, current_tracer, moe_range, push_label,
                    spmd_collective_event, step_phase, trace)

__all__ = [
    "tracing",
    "CommEvent",
    "CommTracer",
    "StepSpan",
    "annotate_signature",
    "payload_nbytes",
    "trace",
    "current_tracer",
    "push_label",
    "step_phase",
    "moe_range",
    "record_moe",
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
    "clock_offset",
    "on_profiler_clock",
    "measured_wire_table",
    "reconcile",
    "equivalent_wire",
    "equivalent_tier_wire",
]
