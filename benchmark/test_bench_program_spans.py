"""``program_spans``: the idle split and the wait means on a synthetic
trace, and the whole capture on a tiny traced cell on the CPU."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, program_spans
from benchmark.conftest import tiny_cell
from mpi4torch_tpu_torch import obs

CPU = torch.autograd.DeviceType.CPU


def _ev(name, a, b):
    return SimpleNamespace(name=name, device_type=CPU,
                           time_range=SimpleNamespace(start=a * 1e6,
                                                      end=b * 1e6))


def _synthetic():
    """Two steps of two ranks; the profile's clock is the tracer's plus
    100 s.  Rank 0 runs forward [0, 4), backward [4, 8) and exchange
    [8, 10) a step of 10 s; rank 1 lags 1 s, so rank 0 waits at each
    step's exchange from 8 to 9 and rank 1 does not wait."""
    tracer = obs.CommTracer()
    prof = []
    lanes = {0: (("forward", 0, 4), ("backward", 4, 8), ("exchange", 8, 10)),
             1: (("forward", 1, 5), ("backward", 5, 9), ("exchange", 9, 10))}
    for k in range(2):
        t0 = 10.0 * k
        for rank, phases in lanes.items():
            for phase, a, b in phases:
                tracer._add_span(obs.StepSpan(0, rank, k, phase,
                                              t0 + a, t0 + b))
        waits = {0: ((t0 + 8, t0 + 9),), 1: ()}
        for rank in (0, 1):
            tracer._append(obs.CommEvent(
                seq=0, rank=rank, world=0, world_size=2,
                channel="exchange", op="Allreduce", t_start=t0 + 8,
                duration_s=2.0, wait_s=sum(b - a for a, b in waits[rank]),
                extra={"waits": waits[rank]}))
        prof += [_ev("bench.step", 100 + t0, 100 + t0 + 10)]
        prof += [_ev("mpi4torch.step." + p, 100 + t0 + a, 100 + t0 + b)
                 for p, a, b in (("forward", 0, 4), ("backward", 4, 8),
                                 ("exchange", 8, 10))]
    return tracer, SimpleNamespace(events=lambda: prof)


def test_idle_split_counts_a_wait_gap_and_not_a_working_gap():
    tracer, prof = _synthetic()
    # Device idle in [102, 103) (both ranks in the forward) and
    # [108.5, 109) (rank 0 waiting, rank 1 in its backward) of step 0,
    # and [118, 120) of step 1 (rank 0 waiting to 119).
    ops = [(100.0, 102.0, "k"), (103.0, 108.5, "k"), (109.0, 118.0, "k")]
    red = {"ops": ops, "window_s": 20.0, "busy_s": 16.5, "steps": 2}
    got = program_spans.read(tracer, prof, red, skip=0)
    assert got["clock_offset_s"] == pytest.approx(100.0)
    assert got["clock_spread_s"] == pytest.approx(0.0, abs=1e-9)
    # Waits: [108.5, 109) of step 0 and [118, 119) of step 1.
    assert got["idle_in_wait_s"] == pytest.approx(1.5)
    split = dict(got["idle_by_phase"])
    assert split["r0 forward | r1 forward"] == pytest.approx(1.0)
    assert split["r0 exchange.wait | r1 backward"] == pytest.approx(1.5)
    assert split["r0 exchange | r1 exchange"] == pytest.approx(1.0)
    assert sum(split.values()) == pytest.approx(20.0 - 16.5)
    run = SimpleNamespace(trace=dict(red, **got))
    assert harness.reader("idle_in_wait_pct.vit").read(run) == \
        pytest.approx(100 * 1.5 / 3.5)


def test_exchange_wait_ms_is_the_rank_mean():
    tracer, prof = _synthetic()
    red = {"ops": [(100.0, 120.0, "k")], "window_s": 20.0,
           "busy_s": 20.0, "steps": 2}
    got = program_spans.read(tracer, prof, red, skip=0)
    assert got["wait_s"] == pytest.approx([2.0, 0.0])
    assert got["exchange_wait_s"] == pytest.approx(1.0)
    assert got["idle_in_wait_s"] == 0.0
    run = SimpleNamespace(trace=dict(red, **got))
    assert harness.reader("exchange_wait_ms.lm").read(run) == \
        pytest.approx(500.0)
    assert harness.reader("idle_in_wait_pct.lm").read(run) is None


def test_a_program_without_spans_reads_nothing():
    _, prof = _synthetic()
    red = {"ops": [], "window_s": 1.0, "busy_s": 0.0, "steps": 1}
    assert program_spans.read(obs.CommTracer(), prof, red) == {}
    run = SimpleNamespace(trace=red)
    for name in ("exchange_wait_ms.vit", "idle_in_wait_pct.vit"):
        assert harness.reader(name).read(run) is None


def test_capture_reads_a_tiny_traced_cell(workload):
    cell = tiny_cell(workload)
    result, window, t = program_spans.capture(workload, 7, 0.2,
                                              device="cpu", cell=cell)
    assert result["correct"]
    assert len(t["wait_s"]) == cell["traffic"]["ranks"]
    assert t["exchange_wait_s"] >= 0 and t["rank0_wait_s"] <= \
        t["rank0_comm_s"]
    assert 0 <= t["idle_in_wait_s"] <= t["window_s"] - t["busy_s"] + 1e-9
    assert len(t["step_s"]) == cell["traffic"]["trace_steps"]
    assert window["steps"] >= 1
