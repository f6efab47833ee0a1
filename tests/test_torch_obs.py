"""The port's runtime observability (``mpi4torch_tpu_torch.obs``) against
the JAX package's (``mpi4torch_tpu.obs``) on the CPU.

The same programs, traced under both packages on rank threads (the JAX
side in Mode B, ``run_ranks``), give the same per-rank event streams:
channel, op, censused bytes, wire family, algorithm, codec, bucket
label, shape, dtype, peer, tag, status and retries, event for event.
The metrics registry gives the same snapshot and byte-equal Prometheus
text for the same writes; ``percentile``, the postmortem table and the
Chrome-trace structure are equal for equal inputs.  The rest holds the
port's own contracts: tracing off by default and bitwise inert, bounded
rings, the flight recorder on a rank death and on a guard's raise, the
serving counters in the registry."""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as jmpi
import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu_torch import config, obs
from mpi4torch_tpu_torch.constants import divide
from mpi4torch_tpu_torch.utils.tree import value_and_grad

comm = mpi.COMM_WORLD
jcomm = jmpi.COMM_WORLD

FIELDS = ("channel", "op", "payload_bytes", "family", "algorithm", "codec",
          "bucket", "shape", "dtype", "peer", "tag", "status", "retries")


@pytest.fixture(autouse=True)
def _restore_config():
    yield
    config.set_comm_tracer(None)
    config.set_fault_plan(None)
    config.set_comm_finite_guard("off")
    config.set_comm_retries(0)
    config.set_comm_backoff(0.05)


def _streams(tracer, n):
    return [[tuple(getattr(e, f) for f in FIELDS)
             for e in tracer.events_for(rank=r)] for r in range(n)]


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# ---------------------------------------------------------------- programs
# Each program is a (JAX body, port body) pair over the same numpy
# inputs; both differentiate, so forward and backward traffic is traced.

def _linreg():
    # The DP regression of examples/simple_linear_regression.py.
    def xs(rank):
        return np.linspace(0.0, 1.0, 5) + rank

    p0 = np.array([0.5, -0.2, 0.1])

    def jbody(rank):
        x = jnp.asarray(xs(rank))

        def loss(p):
            p = jcomm.Allreduce(p, jmpi.MPI_SUM) / jcomm.size
            return jcomm.Allreduce(
                jnp.sum((x * p[0] + p[1] - 1.0) ** 2), jmpi.MPI_SUM)
        return jax.value_and_grad(loss)(jnp.asarray(p0))

    def pbody(rank):
        x = _t(xs(rank))

        def loss(p):
            p = divide(comm.Allreduce(p, mpi.MPI_SUM), comm.size)
            return comm.Allreduce(
                torch.sum((x * p[0] + p[1] - 1.0) ** 2), mpi.MPI_SUM)
        return value_and_grad(loss, _t(p0))
    return jbody, pbody


def _ring():
    # The Isend/Irecv/Wait ring of examples/isend-recv-wait.py.
    def jbody(rank):
        n = jcomm.size

        def f(a):
            h = jcomm.Isend(a, (rank + 1) % n, 3)
            buf = jmpi.JoinDummies(jnp.zeros(8), [h.dummy])
            y = jcomm.Recv(buf, (rank - 1) % n, 3)
            ret = jcomm.Wait(jmpi.JoinDummiesHandle(h, [y]))
            return jnp.sum(jmpi.JoinDummies(y, [ret]) * a)
        return jax.grad(f)(jnp.arange(8.0) + rank)

    def pbody(rank):
        n = comm.size

        def f(a):
            h = comm.Isend(a, (rank + 1) % n, 3)
            buf = mpi.JoinDummies(torch.zeros(8, dtype=torch.float64),
                                  [h.dummy])
            y = comm.Recv(buf, (rank - 1) % n, 3)
            ret = comm.Wait(mpi.JoinDummiesHandle(h, [y]))
            return torch.sum(mpi.JoinDummies(y, [ret]) * a)
        return value_and_grad(f, torch.arange(8.0, dtype=torch.float64)
                              + rank)
    return jbody, pbody


def _fused():
    # A fused Allreduce_tree over two 512-byte buckets, with labels.
    def tree(rank):
        return {"a": np.arange(96.0) * (rank + 1),
                "b": np.arange(40.0) + rank, "c": np.ones(5)}

    def jbody(rank):
        t = {k: jnp.asarray(v) for k, v in tree(rank).items()}
        return jax.grad(lambda t: sum(
            jnp.sum(v * v) for v in jcomm.Allreduce_tree(
                t, jmpi.MPI_SUM, bucket_bytes=512, mean=True).values()))(t)

    def pbody(rank):
        t = {k: _t(v) for k, v in tree(rank).items()}
        return value_and_grad(lambda t: sum(
            torch.sum(v * v) for v in comm.Allreduce_tree(
                t, mpi.MPI_SUM, bucket_bytes=512, mean=True).values()), t)
    return jbody, pbody


def _allgather(codec):
    # A compressed Allgather with uneven shards and a rank-specific
    # cotangent.
    def x(rank):
        return (np.linspace(-2.0, 2.0, 48 + rank) * (rank + 1)) \
            .astype(np.float32)

    def w(rank, n):
        return np.random.default_rng(rank).standard_normal(
            48 * n + n * (n - 1) // 2).astype(np.float32)

    def jbody(rank):
        wr = jnp.asarray(w(rank, jcomm.size))
        return jax.grad(lambda v: jnp.vdot(
            jcomm.Allgather(v, 0, compression=codec), wr))(
                jnp.asarray(x(rank)))

    def pbody(rank):
        wr = torch.from_numpy(w(rank, comm.size))
        return value_and_grad(lambda v: torch.dot(
            comm.Allgather(v, 0, compression=codec), wr),
            torch.from_numpy(x(rank)))
    return jbody, pbody


PROGRAMS = {"linreg": _linreg, "ring": _ring, "fused": _fused,
            "allgather_q8": lambda: _allgather("q8"),
            "allgather_bf16": lambda: _allgather("bf16")}


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_event_streams_equal_jax(program, n):
    jbody, pbody = PROGRAMS[program]()
    with jmpi.obs.trace() as jt:
        jmpi.run_ranks(jbody, n)
    with obs.trace() as pt:
        mpi.run_ranks(pbody, n, device="cpu")
    want, got = _streams(jt, n), _streams(pt, n)
    assert all(got), "a rank recorded no event"
    assert got == want
    if program == "fused":
        # The forward's buckets carry their labels; the backward runs
        # outside the scopes, in both packages.
        labels = {e.bucket for e in pt.events_for()}
        assert labels == {"mpi4torch.Allreduce_tree.bucket0of2",
                          "mpi4torch.Allreduce_tree.bucket1of2", None}


def test_off_by_default_and_bitwise_inert():
    assert config.comm_tracer() is None
    _, pbody = _linreg()
    plain = mpi.run_ranks(pbody, 3, device="cpu")
    with obs.trace() as t:
        traced = mpi.run_ranks(pbody, 3, device="cpu")
    assert config.comm_tracer() is None     # restored on exit
    assert len(t.events) == 12
    for (l0, g0), (l1, g1) in zip(plain, traced):
        assert torch.equal(l0, l1) and torch.equal(g0, g1)


def test_ring_buffer_bounds_and_event_cap():
    def body():
        x = torch.ones(2)
        for _ in range(9):
            x = comm.Allreduce(x, mpi.MPI_SUM)
        return x

    with obs.trace(ring=4, max_events=10) as t:
        mpi.run_ranks(body, 2, device="cpu")
    tails = t.tails()
    assert sorted(r for _, r in tails) == [0, 1]
    assert all(len(v) == 4 for v in tails.values())
    for tail in tails.values():
        assert [e.seq for e in tail] == sorted(e.seq for e in tail)
    assert len(t.events) == 10 and t.dropped == 8


def test_payload_nbytes_reads_shapes_only():
    assert obs.payload_nbytes(torch.ones(3, 5, dtype=torch.bfloat16)) == 30
    meta = ("q8", (10,), torch.float32)
    wire = {"q": torch.zeros(1, 256, dtype=torch.int8),
            "scale": torch.zeros(1)}
    assert obs.payload_nbytes((meta, wire, 12345)) == 260
    assert obs.payload_nbytes((3, None, "x")) == 0
    # A meta tensor has no data at all: the count needs none.
    assert obs.payload_nbytes(torch.empty(7, 9, device="meta")) == 252


def test_annotate_signature_normalizes_torch_dtypes():
    sig = ("Allreduce", 3, "ring", ((4, 2), "torch.float32"))
    got = obs.annotate_signature(sig)
    want = jmpi.obs.annotate_signature(
        ("Allreduce", 3, "ring", ((4, 2), "float32")))
    assert got == want
    assert obs.annotate_signature(("Allreduce.q8hop", "q8", "bidir", False,
                                   ((9,), "torch.float32"), "fold")) \
        == jmpi.obs.annotate_signature(("Allreduce.q8hop", "q8", "bidir",
                                        False, ((9,), "float32"), "fold"))


# ------------------------------------------------------------------ metrics

def _metric_writes(m):
    m.inc("comm_retry_events_total", 3, help="retries")
    m.inc('comm_health_probes_total{result="ok"}', help="probes")
    m.inc('comm_health_probes_total{result="failed"}', 2)
    m.set_gauge("obs_dropped", 0.25, help="a gauge")
    for v in (2e-6, 3e-4, 0.5, 7.0, 100.0):
        m.observe("comm_seconds", v, help="durations")
    m.observe("custom", 0.3, buckets=(0.1, 1.0))
    m.register_collector("serve", lambda: {"steps": 4, "occupancy": 0.5,
                                           "label": "x", "flag": True})
    m.register_collector("broken", lambda: 1 / 0)


def test_metrics_snapshot_and_prometheus_equal_jax():
    mine, ref = obs.MetricsRegistry(), jmpi.obs.MetricsRegistry()
    _metric_writes(mine)
    _metric_writes(ref)
    assert mine.snapshot() == ref.snapshot()
    assert mine.prometheus_text() == ref.prometheus_text()
    assert mine.json() == ref.json()
    mine.reset()
    ref.reset()
    assert mine.prometheus_text() == ref.prometheus_text()


def test_percentile_bitwise_jax():
    rng = np.random.default_rng(5)
    for n in (0, 1, 2, 7, 100):
        vals = list(rng.standard_normal(n))
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert obs.percentile(vals, q) == jmpi.obs.percentile(vals, q)
    from mpi4torch_tpu_torch.utils import profiling
    assert profiling.percentile is obs.percentile


def test_stats_source_registry_drops_dead_owners():
    reg = obs.StatsSourceRegistry()

    class Owner:
        pass

    a, b = Owner(), Owner()
    reg.register("g", a)
    reg.register("g", b)
    del b
    assert reg.live("g") == [a]
    assert reg.clear("g") == [a] and reg.live("g") == []


def test_retry_events_mirrored():
    obs.reset_metrics()
    seen = {}

    def body(rank):
        world = mpi.runtime.current_rank_context().world
        if rank == 0:
            world.p2p_send(0, 1, 9, torch.ones(4))
            return None
        got = world.p2p_recv(0, 1, 9)
        seen["retry_events"] = world.retry_events
        return got

    config.set_comm_retries(4)
    with obs.trace() as t, mpi.fault_scope(
            [mpi.FaultSpec("drop_p2p", rank=0, op="p2p")]):
        out = mpi.run_ranks(body, 2, timeout=0.3, device="cpu")
    assert torch.equal(out[1], torch.ones(4))
    assert seen["retry_events"] >= 1
    assert obs.snapshot()["counters"]["comm_retry_events_total"] \
        == seen["retry_events"]
    assert any(e.retries >= 1 for e in t.events_for(channel="p2p_recv"))


def test_violations_and_health_probes_counted():
    from mpi4torch_tpu_torch.resilience import guards

    obs.reset_metrics()
    guards.clear_violations()
    config.set_comm_finite_guard("warn")

    def body(rank):
        x = torch.full((4,), float("nan") if rank == 1 else 1.0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            comm.Allreduce(x, mpi.MPI_SUM)
        return comm.check_health(timeout=2.0).ok

    assert mpi.run_ranks(body, 2, device="cpu") == [True, True]
    assert guards.last_violation()["ranks"] == [1]
    counters = obs.snapshot()["counters"]
    assert counters["integrity_violations_total"] == 2   # one per rank
    assert counters['comm_health_probes_total{result="ok"}'] == 2
    guards.clear_violations()


# ----------------------------------------------------------- serving stats

def test_serve_stats_registry_and_prometheus():
    from mpi4torch_tpu_torch import serve
    from mpi4torch_tpu_torch.obs.metrics import sources
    from mpi4torch_tpu_torch.utils.profiling import (ServeStats,
                                                     _register_serve_stats)

    serve.reset_stats()
    s = _register_serve_stats(ServeStats())
    assert s in sources().live("serve")
    s.count("steps", 3)
    s.tick(2, 4)
    agg = serve.stats()
    assert agg["steps"] == 4 and agg["n_engines"] == 1
    assert agg["occupancy"] == s.snapshot()["occupancy"] == 0.5
    text = obs.prometheus_text()
    for k, v in agg.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            assert f"mpi4torch_serve_{k} {v:g}" in text
    serve.reset_stats()
    assert sources().live("serve") == [] and serve.stats()["steps"] == 0
    assert s.counters["steps"] == 0          # reset in place


def test_engine_registers_its_stats():
    from mpi4torch_tpu_torch import serve
    from mpi4torch_tpu_torch.models import transformer as T

    serve.reset_stats()
    cfg = T.TransformerConfig(vocab=31, d_model=16, n_heads=2, n_layers=1,
                              d_ff=32, max_seq=16)
    params = T.init_transformer(0, cfg, torch.float32, device="cpu")
    eng = serve.Engine(cfg, params, serve.ServeConfig(slots=2, max_new=3),
                       device="cpu")
    eng.submit([1, 2, 3])
    eng.run()
    agg = serve.stats()
    snap = eng.stats.snapshot()
    assert agg["n_engines"] == 1
    assert all(agg[k] == snap[k] for k in ("steps", "admitted", "finished",
                                           "decode_tokens"))
    assert f"mpi4torch_serve_finished {snap['finished']:g}" \
        in obs.prometheus_text()
    serve.reset_stats()


def test_serve_stats_snapshot_percentiles():
    from mpi4torch_tpu_torch.utils.profiling import ServeStats

    s = ServeStats()
    for i, rid in enumerate(("a", "b", "c")):
        s.mark(rid, "submitted")
        s.spans[rid]["first_token"] = s.spans[rid]["submitted"] \
            + 0.1 * (i + 1)
    snap = s.snapshot()
    ttft = [s.spans[r]["first_token"] - s.spans[r]["submitted"]
            for r in "abc"]
    assert snap["ttft_s"]["p50"] == obs.percentile(ttft, 0.5)
    assert snap["ttft_s"]["p99"] == obs.percentile(ttft, 0.99)


# --------------------------------------------------------- flight recorder

def _allreduce_loop(rank):
    x = torch.ones(8)
    for _ in range(3):
        x = comm.Allreduce(x, mpi.MPI_SUM)
    return x


def test_rank_death_postmortem(tmp_path):
    with obs.trace(ring=8) as t, mpi.fault_scope(
            [mpi.FaultSpec("rank_death", rank=1, op="Allreduce", index=1)]):
        with pytest.raises(mpi.RankFailedError) as ei:
            mpi.run_ranks(_allreduce_loop, 3, timeout=2.0, device="cpu")
    assert ei.value.ranks == frozenset({1})
    pm = t.last_postmortem()
    assert pm["error"] == "RankFailedError" and pm["failed_ranks"] == [1]
    from mpi4torch_tpu_torch.obs.flight import last_event_signature
    dead = last_event_signature(pm, 1)
    assert dead is not None
    assert all(last_event_signature(pm, r) == dead for r in range(3))
    text = obs.format_postmortem(pm)
    assert "FLIGHT RECORDER POSTMORTEM" in text
    assert "rank(s): [1]" in text and "** FAILED/MISSING **" in text
    paths = obs.dump_postmortem(pm, str(tmp_path))
    with open(paths["json"], encoding="utf-8") as f:
        assert json.load(f)["failed_ranks"] == [1]


def test_integrity_error_postmortem():
    config.set_comm_finite_guard("raise")
    with obs.trace() as t, mpi.fault_scope(
            [mpi.FaultSpec("corrupt_nan", rank=1, op="Allreduce")]):
        with pytest.raises(mpi.IntegrityError):
            mpi.run_ranks(lambda: comm.Allreduce(torch.ones(8),
                                                 mpi.MPI_SUM),
                          2, timeout=2.0, device="cpu")
    pm = t.last_postmortem()
    assert pm["error"] == "IntegrityError" and pm["failed_ranks"] == [1]
    assert pm["observer_ranks"] == [0, 1]


def _jax_event(e):
    from mpi4torch_tpu.obs.events import CommEvent as JEvent
    return JEvent(**{k: getattr(e, k) for k in (
        "seq", "rank", "world", "world_size", "channel", "op", "signature",
        "payload_bytes", "duration_s", "wait_s", "t_start", "retries",
        "status", "family", "bookkeeping", "unmodeled", "algorithm",
        "codec", "bucket", "group_size", "shape", "dtype", "peer", "tag")})


def test_postmortem_text_and_chrome_trace_equal_jax():
    from mpi4torch_tpu.obs import flight as jflight
    from mpi4torch_tpu_torch.obs import flight

    with obs.trace(ring=4) as t, mpi.fault_scope(
            [mpi.FaultSpec("rank_death", rank=2, op="Allreduce", index=2)]):
        with pytest.raises(mpi.RankFailedError):
            mpi.run_ranks(_allreduce_loop, 3, timeout=2.0, device="cpu")
    pm = t.last_postmortem()
    assert obs.format_postmortem(pm) == jmpi.obs.format_postmortem(pm)
    assert obs.format_postmortem(pm, width=60) \
        == jmpi.obs.format_postmortem(pm, width=60)
    for r in range(3):
        assert flight.last_event_signature(pm, r) \
            == jflight.last_event_signature(pm, r)
    evs = t.events_for()
    jevs = [_jax_event(e) for e in evs]
    assert [e.to_dict() for e in evs] == [e.to_dict() for e in jevs]
    assert obs.chrome_trace(evs, label="x") \
        == jmpi.obs.chrome_trace(jevs, label="x")


def test_chrome_trace_export(tmp_path):
    with obs.trace() as t:
        mpi.run_ranks(lambda: comm.Allreduce(torch.ones(16), mpi.MPI_SUM),
                      2, device="cpu")
    doc = obs.chrome_trace(t.events)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == 2 and {e["tid"] for e in xs} == {0, 1}
    assert all(e["args"]["payload_bytes"] == 64 for e in xs)
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in xs)
    names = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert sorted(e["args"]["name"] for e in names) == ["rank0", "rank1"]
    path = obs.write_chrome_trace(str(tmp_path / "t.json"), t.events)
    with open(path, encoding="utf-8") as f:
        assert json.load(f)["traceEvents"]


def test_labels_pushed_only_under_a_tracer():
    from mpi4torch_tpu_torch.obs.trace import current_label
    from mpi4torch_tpu_torch.utils.profiling import bucket_scope

    with bucket_scope("Allreduce_tree", 0, 2):
        assert current_label() is None
    with obs.trace():
        with bucket_scope("Allreduce_tree", 1, 2, phase="start"):
            assert current_label() == \
                "mpi4torch.Allreduce_tree.bucket1of2.start"
        assert current_label() is None


def test_world_ordinals_do_not_alias():
    # A world collected before the next one is made may leave its id to
    # it; each world keeps an ordinal of its own all the same.  (The JAX
    # tracer keys ordinals by id alone and gives all six the same one.)
    tracer = obs.CommTracer()
    ords = []
    for _ in range(6):
        w = mpi.runtime.World(2)
        ords.append(tracer._world_ord(w))
        del w
    assert ords == list(range(6))
    with obs.trace() as t:
        for _ in range(3):
            mpi.run_ranks(lambda: comm.Allreduce(torch.ones(2),
                                                 mpi.MPI_SUM),
                          2, device="cpu")
    assert sorted({e.world for e in t.events}) == [0, 1, 2]


def test_mode_a_hook_raises():
    # The Mode A hook is ported: it returns its input untouched unless a
    # mode_a tracer is installed, and then records one step event a
    # rank's collective entry (tests/test_torch_spmd.py holds it against
    # the JAX package's events).
    x = torch.ones(3)
    assert obs.spmd_collective_event(x, "Allreduce") is x
    with obs.trace() as t:
        assert obs.spmd_collective_event(x, "Allreduce") is x
    assert not t.events
    with obs.trace(mode_a=True) as t:
        assert obs.spmd_collective_event(x, "Allreduce") is x
    assert [(e.channel, e.op, e.payload_bytes) for e in t.events] == \
        [("spmd", "Allreduce", 12)]


def test_profiler_trace_writes_a_trace(tmp_path):
    from mpi4torch_tpu_torch.utils import bucket_scope, profiler_trace

    with profiler_trace(str(tmp_path)):
        with bucket_scope("Allreduce_tree", 0, 1):
            mpi.run_ranks(lambda: comm.Allreduce(torch.ones(4),
                                                 mpi.MPI_SUM),
                          2, device="cpu")
    traces = list(tmp_path.glob("*.json"))
    assert traces and "mpi4torch.Allreduce_tree.bucket0of1" \
        in traces[0].read_text()
