"""Step-phase and rendezvous-wait spans of the port's obs layer.

Under ``obs.trace()`` every rank thread of a data-parallel step records
its ``forward`` / ``backward`` (``utils.tree.value_and_grad``),
``exchange`` and ``update`` phases with one step ordinal on every rank;
its chokepoint events carry the phase in ``extra`` and the JAX
package's bucket labels; each rendezvous barrier's wait interval lies
inside its event and the intervals sum to ``wait_s``.  ``clock_offset``
puts the tracer's spans on a CPU profiler trace's clock within 100 us.
With no tracer the program opens none of the new spans, and a lowering
records the span paths it recorded without them.
"""

import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as jmpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu.models import transformer as JT
from mpi4torch_tpu_torch import analyze, config, obs
from mpi4torch_tpu_torch.models import transformer as T
from mpi4torch_tpu_torch.models import vit as V

# The event fields that tests/test_torch_obs.py holds equal to JAX's.
FIELDS = ("channel", "op", "payload_bytes", "family", "algorithm", "codec",
          "bucket", "shape", "dtype", "peer", "tag", "status", "retries")
KW = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=16)
VIT = V.ViTConfig(image_hw=8, patch=4, d_model=16, n_heads=2, n_layers=1,
                  d_ff=32, num_classes=5)
NEW_SPANS = ("mpi4torch.step.", "mpi4torch.exchange.wait")
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


@pytest.fixture(autouse=True)
def _no_tracer_after():
    yield
    config.set_comm_tracer(None)


def _lm():
    jcfg, cfg = JT.TransformerConfig(**KW), T.TransformerConfig(**KW)
    jparams = JT.init_transformer(jax.random.PRNGKey(0), jcfg,
                                  dtype=jnp.float64)
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(1).integers(0, KW["vocab"], (4, 16))
    return jcfg, jparams, cfg, params, toks


def _lm_body(cfg, params, toks, steps=1, profile=None):
    def body(rank):
        p = params
        with profile() if profile and rank == 0 \
                else contextlib.nullcontext() as prof:
            for _ in range(steps):
                _, p = T.train_step(
                    cfg, p, torch.from_numpy(toks[2 * rank:2 * rank + 2]),
                    comm_dp=P.COMM_WORLD, lr=0.1)
        return prof
    return body


def _vit_body(steps=1):
    params = V.init_vit(0, VIT, torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(2)
    images = torch.randn(4, 8, 8, 3, generator=gen, dtype=torch.float64)
    labels = torch.randint(0, 5, (4,), generator=gen)

    def body(rank):
        p = params
        for _ in range(steps):
            _, p = V.dp_grad_train_step(
                P.COMM_WORLD, VIT, p,
                (images[2 * rank:2 * rank + 2], labels[2 * rank:2 * rank + 2]))
    return body


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("model,phases", [
    ("lm", ["forward", "backward", "update"]),
    ("vit", ["forward", "backward", "exchange", "update"])])
def test_dp_step_records_every_phase_on_both_ranks(model, phases):
    if model == "lm":
        _, _, cfg, params, toks = _lm()
        body = _lm_body(cfg, params, toks, steps=2)
    else:
        body = _vit_body(steps=2)
    with obs.trace() as t:
        P.run_ranks(body, 2, device="cpu")
    for rank in (0, 1):
        spans = sorted(t.spans_for(rank), key=lambda s: s.t_start)
        assert [(s.step, s.phase) for s in spans] == \
            [(k, p) for k in (0, 1) for p in phases]
        assert all(s.t_start <= s.t_end for s in spans)
        assert all(a.t_end <= b.t_start for a, b in zip(spans, spans[1:]))
        assert {(s.world, s.rank) for s in spans} == {(0, rank)}
    t.clear()
    assert t.spans_for() == [] and t._steps == {}


def test_worker_processes_ship_their_phase_spans():
    with obs.trace() as t:
        P.run_ranks(_vit_body(), 2, backend="process", device="cpu")
    for rank in (0, 1):
        assert [(s.world, s.step, s.phase) for s in sorted(
            t.spans_for(rank), key=lambda s: s.t_start)] == \
            [(t.events_for(rank=rank)[0].world, 0, p)
             for p in ("forward", "backward", "exchange", "update")]
    assert all(e.extra["phase"] == "exchange" for e in t.events_for())


def test_events_carry_phase_and_the_jax_bucket_labels():
    jcfg, jparams, cfg, params, toks = _lm()

    def jbody(rank):
        JT.train_step(jcfg, jparams,
                      jnp.asarray(toks[2 * rank:2 * rank + 2]),
                      comm_dp=jmpi.COMM_WORLD, lr=0.1)

    with obs.trace() as t:
        P.run_ranks(_lm_body(cfg, params, toks), 2, device="cpu")
    with jmpi.obs.trace() as jt:
        jmpi.run_ranks(jbody, 2)
    for rank in (0, 1):
        evs = t.events_for(rank=rank)
        assert [tuple(getattr(e, f) for f in FIELDS) for e in evs] == \
            [tuple(getattr(e, f) for f in FIELDS)
             for e in jt.events_for(rank=rank)]
        assert {e.extra["step"] for e in evs} == {0}
        phases = [e.extra["phase"] for e in evs]
        # The parameter average runs in the forward, its adjoint in the
        # backward.
        assert set(phases) == {"forward", "backward"}
        assert all(e.bucket is None for e in evs
                   if e.extra["phase"] == "backward")
        assert any(e.bucket for e in evs if e.extra["phase"] == "forward")


def test_vit_exchange_events_run_in_the_exchange_phase():
    with obs.trace() as t:
        P.run_ranks(_vit_body(), 2, device="cpu")
    evs = t.events_for(rank=0)
    n_leaves = len(P.utils.tree.tree_leaves(
        V.init_vit(0, VIT, torch.float64, device="cpu")))
    assert len(evs) == n_leaves + 1
    assert {(e.extra["phase"], e.extra["step"]) for e in evs} == \
        {("exchange", 0)}


def test_wait_intervals_lie_inside_their_event_and_sum_to_wait_s():
    with obs.trace() as t:
        P.run_ranks(_vit_body(), 2, device="cpu")
    evs = t.events_for(channel="exchange")
    assert evs
    for e in evs:
        waits = e.extra["waits"]
        assert len(waits) == 2        # the deposit and the read barriers
        for a, b in waits:
            assert e.t_start <= a <= b <= e.t_start + e.duration_s
        assert sum(b - a for a, b in waits) == e.wait_s
    assert sum(e.wait_s for e in evs if e.rank == 0) \
        <= sum(e.duration_s for e in evs if e.rank == 0)


def test_clock_offset_maps_rank0_spans_onto_the_profile():
    _, _, cfg, params, toks = _lm()
    with obs.trace() as t:
        prof = P.run_ranks(_lm_body(cfg, params, toks, steps=3,
                                    profile=_profiler), 2, device="cpu")[0]
    offset, spread = obs.clock_offset(t, prof, rank=0)
    assert 0 <= spread < 100e-6
    theirs = sorted((e.time_range.start * 1e-6, e.name)
                    for e in prof.events()
                    if e.name.startswith("mpi4torch.step."))
    mine = sorted(t.spans_for(0), key=lambda s: s.t_start)
    assert [n for _, n in theirs] == \
        ["mpi4torch.step." + s.phase for s in mine]
    for (start, _), s in zip(theirs, mine):
        assert abs(s.t_start + offset - start) < 100e-6
    on = obs.on_profiler_clock(t, offset)
    assert {p[1] for p in on["phases"]} == {0, 1}
    assert len(on["phases"]) == len(t.spans_for())
    assert len(on["waits"]) == sum(len(e.extra.get("waits", ()))
                                   for e in t.events_for())
    assert len(on["events"]) == len(t.events_for())
    first = min(t.spans_for(0), key=lambda s: s.t_start)
    assert [p[4] for p in on["phases"] if p[1] == 0][0] == \
        first.t_start + offset


def _fake(spans, theirs):
    tracer = SimpleNamespace(spans_for=lambda rank: spans)
    # Each range twice, as the profiler keeps them on the card: the
    # host's and a device-side annotation that starts later.
    events = [SimpleNamespace(name="mpi4torch.step." + p, device_type=kind,
                              time_range=SimpleNamespace(start=t * 1e6 + lag))
              for t, p in theirs for kind, lag in ((CPU, 0.0), (CUDA, 7.0))]
    return tracer, SimpleNamespace(events=lambda: events)


def test_clock_offset_aligns_past_a_step_only_the_profile_holds():
    # The profile holds a warm step before the tracer was cleared; step
    # times differ by a millisecond, the clocks by 5 s and a few us.
    phases = ["forward", "backward", "update"]
    starts, t = [], 0.0
    for k in range(4):
        for p in phases:
            starts.append((t, p))
            t += 0.010 + 0.001 * k
    jitter = [0.0, 2e-6, -1e-6, 1e-6, 0.0, -2e-6, 1e-6, 3e-6, 0.0]
    spans = [obs.StepSpan(0, 0, i // 3, p, s, s + 0.005)
             for i, ((s, p), j) in enumerate(zip(starts[3:], jitter))]
    theirs = [(s + 5.0 + (jitter[i - 3] if i >= 3 else 0.0), p)
              for i, (s, p) in enumerate(starts)]
    offset, spread = obs.clock_offset(*_fake(spans, theirs))
    assert abs(offset - 5.0) < 3e-6 and spread < 3e-6
    with pytest.raises(ValueError, match="no step-phase span"):
        obs.clock_offset(*_fake(spans, []))


def test_no_new_span_without_a_tracer():
    _, _, cfg, params, toks = _lm()
    names = lambda prof: {e.name for e in prof.events()  # noqa: E731
                          if e.name.startswith(NEW_SPANS)}
    prof = P.run_ranks(_lm_body(cfg, params, toks, profile=_profiler), 2,
                       device="cpu")[0]
    assert names(prof) == set()
    with obs.trace():
        prof = P.run_ranks(_lm_body(cfg, params, toks, profile=_profiler),
                           2, device="cpu")[0]
    assert names(prof) == {"mpi4torch.step.forward",
                           "mpi4torch.step.backward",
                           "mpi4torch.step.update",
                           "mpi4torch.exchange.wait"}


def test_chrome_trace_draws_phases_and_waits_on_the_profile_clock():
    with obs.trace() as t:
        P.run_ranks(_vit_body(), 2, device="cpu")
    evs, spans = t.events_for(), t.spans_for()
    doc = obs.chrome_trace(evs, offset=3.0, spans=spans)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    by_cat = {}
    for e in xs:
        by_cat.setdefault(e["cat"], []).append(e)
    assert len(by_cat["step"]) == len(spans) == 8
    assert len(by_cat["wait"]) == sum(len(e.extra["waits"]) for e in evs)
    assert len(by_cat["exchange"]) == len(evs)
    first = min(evs, key=lambda e: e.t_start)
    assert min(e["ts"] for e in by_cat["exchange"]) == \
        (first.t_start + 3.0) * 1e6
    assert {(e["pid"], e["tid"]) for e in by_cat["step"]} == {(0, 0), (0, 1)}
    # Without spans or an offset the trace is the one the JAX package
    # draws: events alone, from the earliest.
    plain = obs.chrome_trace(evs)
    assert {e["cat"] for e in plain["traceEvents"] if e["ph"] == "X"} == \
        {"exchange"}
    assert min(e["ts"] for e in plain["traceEvents"] if e["ph"] == "X") \
        == 0.0


def test_lowering_records_the_same_span_paths_under_a_tracer():
    cfg = T.TransformerConfig(**KW)
    params = T.init_transformer(0, cfg, torch.float32, device="cpu")
    toks = torch.randint(0, KW["vocab"], (4, 16),
                         generator=torch.Generator().manual_seed(0))
    comm = P.COMM_WORLD

    def body(p, x):
        idx = comm.rank * 2 + torch.arange(2)
        return T.train_step(cfg, p, x.index_select(0, idx), comm_dp=comm,
                            lr=0.1)[0]

    def scopes():
        return analyze.parse_program(analyze.lower(
            P.run_spmd(body, nranks=2, device="cpu"), params, toks)).scopes()

    plain = scopes()
    with obs.trace() as t:
        traced = scopes()
    assert traced == plain
    assert not [s for s in plain if "mpi4torch.step" in s
                or "exchange.wait" in s]
    assert any("mpi4torch.Allreduce_tree" in s for s in plain)
    assert t.spans_for() == [] and t.events_for() == []


def test_the_tracer_counts_no_registry_metric_per_event():
    obs.reset_metrics()
    with obs.trace() as t:
        P.run_ranks(_vit_body(), 2, device="cpu")
    assert t.events_for()
    assert "obs_events_total" not in obs.snapshot()["counters"]
