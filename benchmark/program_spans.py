"""The program's step-phase and rendezvous-wait spans over a profiled
stretch: what ``exchange_wait_ms.*`` and ``idle_in_wait_pct.*`` read.

:func:`read` takes the stretch's tracer (``obs.trace()``, cleared after
the profiler's warm step), its profile and
:func:`benchmark.trace_reduce.reduce`'s result, puts every rank thread's
phase spans (``mpi4torch.step.*``) and barrier waits on the profile's
clock (``obs.clock_offset`` on the profiling rank's spans) and returns

* ``wait_s``: each rank's seconds blocked at rendezvous barriers over
  the profiled steps, and ``exchange_wait_s``, their rank mean;
* ``idle_in_wait_s``: the device's idle seconds, in the stretch and gaps
  that ``device_idle_pct`` reads, during which at least one rank thread
  was inside a wait;
* ``idle_by_phase``: the idle seconds by what each rank thread was in,
  rank 0 first: a phase, ``<phase>.wait`` inside a wait, ``-`` in none;
* ``clock_offset_s`` and ``clock_spread_s``, the offset's error.

A program without the spans gives ``{}``.

    python3 benchmark/program_spans.py --workload <cell> --seed <n> \\
        --seconds <s>

runs the cell as ``run.py --trace 1`` does and prints, as its last line,
one JSON object: the run's result, these readings, the two metrics they
give, and the median step of the window and of the profiled stretch
(the tracing's cost).
"""

from __future__ import annotations

import bisect
import contextlib
import os
import statistics
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stretch(prof, step_span: str, skip: int):
    """``(lo, hi)`` in seconds on the profile's clock: the stretch that
    ``trace_reduce.reduce`` clips the device operations to."""
    from .trace_reduce import _cuda

    cpu = [e for e in prof.events() if not _cuda(e)]
    steps = sorted(e.time_range.start for e in cpu if e.name == step_span)
    hi = max(e.time_range.end for e in cpu if e.name.startswith("bench."))
    return steps[skip] / 1e6, hi / 1e6


def gaps(ops, lo: float, hi: float):
    """The idle intervals of ``[lo, hi]`` between the union of ``ops``
    (``(start, end, name)``, sorted)."""
    out, edge = [], lo
    for a, b, _ in ops:
        if a > edge:
            out.append((edge, a))
        edge = max(edge, b)
    if hi > edge:
        out.append((edge, hi))
    return out


class _Lane:
    """One rank thread's phases and waits, for lookups by instant."""

    def __init__(self, phases, waits):
        self.phases = sorted(phases)                 # (start, end, phase)
        self.pstarts = [p[0] for p in self.phases]
        self.reach, far = [], float("-inf")
        for p in self.phases:
            far = max(far, p[1])
            self.reach.append(far)
        self.waits = sorted(waits)                   # (start, end)
        self.wstarts = [w[0] for w in self.waits]

    def state(self, t: float) -> str:
        phase = "-"
        j = bisect.bisect_right(self.pstarts, t) - 1
        while j >= 0 and self.reach[j] > t:
            if self.phases[j][1] > t:
                phase = self.phases[j][2]
                break
            j -= 1
        i = bisect.bisect_right(self.wstarts, t) - 1
        if i >= 0 and self.waits[i][1] > t:
            return f"{phase}.wait"
        return phase


def split(idle, phases, waits):
    """``(idle_in_wait_s, {label: seconds})`` of the ``idle`` intervals,
    cut wherever a rank's phase or wait starts or ends.  ``phases``:
    ``(rank, start, end, phase)``; ``waits``: ``(rank, start, end)``."""
    ranks = sorted({p[0] for p in phases} | {w[0] for w in waits})
    lanes = [_Lane([p[1:] for p in phases if p[0] == r],
                   [w[1:] for w in waits if w[0] == r]) for r in ranks]
    cuts = sorted({t for p in phases for t in p[1:3]}
                  | {t for w in waits for t in w[1:3]})
    by_label, in_wait = defaultdict(float), 0.0
    for a, b in idle:
        inner = cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)]
        for x, y in zip([a] + inner, inner + [b]):
            states = [lane.state((x + y) / 2) for lane in lanes]
            by_label[" | ".join(f"r{r} {s}" for r, s in zip(ranks, states))
                     ] += y - x
            if any(s.endswith(".wait") for s in states):
                in_wait += y - x
    return in_wait, dict(by_label)


def read(tracer, prof, red, step_span: str = "bench.step",
         skip: int = 1) -> dict:
    """The readings of the module's docstring, or ``{}`` where the
    program records no step-phase span."""
    from mpi4torch_tpu_torch import obs

    if not hasattr(obs, "clock_offset"):
        return {}
    try:
        offset, spread = obs.clock_offset(tracer, prof, rank=0)
    except ValueError:
        return {}
    on = obs.on_profiler_clock(tracer, offset)
    ranks = sorted({p[1] for p in on["phases"]})
    wait_s = [sum(b - a for _, r, a, b in on["waits"] if r == rank)
              for rank in ranks]
    lo, hi = stretch(prof, step_span, skip)
    in_wait, by_label = split(
        gaps(red["ops"], lo, hi),
        [(r, a, b, phase) for _, r, _, phase, a, b in on["phases"]],
        [(r, a, b) for _, r, a, b in on["waits"]])
    return {"wait_s": wait_s,
            "exchange_wait_s": sum(wait_s) / len(wait_s),
            "idle_in_wait_s": in_wait,
            "idle_by_phase": sorted(by_label.items(), key=lambda x: -x[1]),
            "clock_offset_s": offset, "clock_spread_s": spread}


def step_times(prof, step_span: str = "bench.step", skip: int = 1):
    """Seconds from each ``step_span`` of the profiling thread to the end
    of the ``bench.sync`` after it, the first ``skip`` left out."""
    cpu = sorted((e for e in prof.events()
                  if e.name in (step_span, "bench.sync")),
                 key=lambda e: e.time_range.start)
    out, start = [], None
    for e in cpu:
        if e.name == step_span:
            start = e.time_range.start
        elif start is not None:
            out.append((e.time_range.end - start) / 1e6)
            start = None
    return out[skip:]


def capture(workload, seed, seconds, device="cuda", cell=None):
    """``harness.run_cell`` traced, with the tracer and the profile of its
    stretch read by :func:`read` and :func:`step_times` as the loop
    hands the profile to ``trace_reduce.reduce``.  Returns ``(result,
    window, trace)``: ``trace`` is the reduced stretch with the
    readings, rank 0's summed event and wait seconds (``rank0_comm_s``,
    ``rank0_wait_s``) and the stretch's step times (``step_s``)."""
    from mpi4torch_tpu_torch import obs

    from . import harness, trace_reduce

    got = {}
    real_trace, real_reduce = obs.trace, trace_reduce.reduce

    @contextlib.contextmanager
    def trace(*args, **kwargs):
        with real_trace(*args, **kwargs) as t:
            got["tracer"] = t
            yield t

    def reduce(prof, step_span, skip=1):
        red = real_reduce(prof, step_span, skip)
        evs = got["tracer"].events_for(rank=0)
        got["trace"] = dict(
            red, **read(got["tracer"], prof, red, step_span, skip),
            step_s=step_times(prof, step_span, skip),
            rank0_comm_s=sum(e.duration_s for e in evs),
            rank0_wait_s=sum(e.wait_s for e in evs))
        return red

    obs.trace, trace_reduce.reduce = trace, reduce
    try:
        result, _, window = harness.run_cell(workload, seed, seconds, True,
                                             device=device, cell=cell)
    finally:
        obs.trace, trace_reduce.reduce = real_trace, real_reduce
    return result, window, got["trace"]


def main(argv=None) -> int:
    import argparse
    import json
    from types import SimpleNamespace

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    # Not the script's own directory: its module names would shadow the
    # standard library's.
    sys.path[0] = ROOT
    from benchmark import harness, program_spans

    harness.pin_caches()
    import torch

    if not torch.cuda.is_available():
        print("program_spans.py: no CUDA device", file=sys.stderr)
        return 2
    result, window, t = program_spans.capture(args.workload, args.seed,
                                              args.seconds)
    out = {k: t[k] for k in ("wait_s", "exchange_wait_s", "idle_in_wait_s",
                             "clock_offset_s", "clock_spread_s",
                             "rank0_comm_s", "rank0_wait_s", "steps",
                             "window_s", "busy_s") if k in t}
    out["idle_by_phase"] = t.get("idle_by_phase", [])[:12]
    for name in ("exchange_wait_ms", "idle_in_wait_pct"):
        value = harness.reader(name).read(SimpleNamespace(trace=t))
        if value is not None:
            out[name] = value
    out["window_step_ms_median"] = 1e3 * statistics.median(window["step_s"])
    out["traced_step_ms_median"] = 1e3 * statistics.median(t["step_s"])
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "result": result, "program_spans": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
