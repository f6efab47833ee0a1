"""The port's fault tolerance (``mpi4torch_tpu_torch.resilience``)
against the JAX package's (``mpi4torch_tpu.resilience``) on the CPU.

The fault kinds, the plan grammar and the seeded draws are equal; the
same plan on the same program fires the same faults and raises the same
error type naming the same ranks, in both packages (the JAX side in Mode
B, ``run_ranks``), for every kind with an exchange or p2p site.  The
guards hold the JAX package's cases, and the wire checksum of an encoded
wire equals the JAX package's.  The gray-failure detector gives equal
reports on equal event lists.  Every world here that waits out a
timeout has one of at most 2 s."""

import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as jmpi
import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu import resilience as jrz
from mpi4torch_tpu.resilience import faults as jfaults
from mpi4torch_tpu.resilience import guards as jguards
from mpi4torch_tpu_torch import config, obs
from mpi4torch_tpu_torch import resilience as rz
from mpi4torch_tpu_torch.resilience import faults
from mpi4torch_tpu_torch.resilience import guards

comm = mpi.COMM_WORLD
jcomm = jmpi.COMM_WORLD


def _reset_both():
    for cfg in (config, jmpi.config):
        cfg.set_comm_retries(0)
        cfg.set_comm_backoff(0.05)
        cfg.set_comm_finite_guard("off")
        cfg.set_comm_wire_checksum(False)
        cfg.set_fault_plan(None)
    guards.clear_violations()
    jguards.clear_violations()


@pytest.fixture(autouse=True)
def _restore_config():
    yield
    _reset_both()
    config.set_comm_tracer(None)


# ------------------------------------------------------------ registry

def test_fault_kinds_equal_jax():
    assert sorted(faults.FAULT_KINDS) == sorted(jfaults.FAULT_KINDS)
    for name, kind in faults.FAULT_KINDS.items():
        ref = jfaults.FAULT_KINDS[name]
        assert (kind.sites, kind.transient) == (ref.sites, ref.transient)
    assert "runs after every save of utils.checkpoint" in \
        faults.FAULT_KINDS["truncate_save"].doc


@pytest.mark.parametrize("kw", [dict(kind="nosuch"), dict(index=-1),
                                dict(count=0), dict(p=1.5),
                                dict(per_byte_s=-1.0)])
def test_spec_validation_equal_jax(kw):
    kw = {"kind": "delay", **kw}
    with pytest.raises(ValueError):
        jrz.FaultSpec(**kw)
    with pytest.raises(ValueError):
        rz.FaultSpec(**kw)


def test_plan_windows_and_filters_equal_jax():
    specs = [dict(kind="delay", rank=1, op="Allreduce", index=1, count=2),
             dict(kind="corrupt_nan", op="Allgather"),
             dict(kind="drop_p2p", rank=0, op="p2p", index=2),
             dict(kind="jitter", index=0, count=3, seed=4),
             dict(kind="truncate_save", rank=0)]
    calls = [("exchange", 1, "Allreduce"), ("exchange", 1, "Allreduce.fold"),
             ("exchange", 0, "Allreduce"), ("exchange", 1, "Allreduce"),
             ("exchange", 2, "Allgather.c"), ("p2p", 0, "p2p"),
             ("p2p", 0, "p2p"), ("p2p", 0, "p2p"), ("p2p", 1, "p2p"),
             ("exchange", 1, "Allreduce"), ("checkpoint", 0, "ckpt_save"),
             ("exchange", 2, "Allgather")]
    mine = rz.FaultPlan([rz.FaultSpec(**s) for s in specs])
    ref = jrz.FaultPlan([jrz.FaultSpec(**s) for s in specs])
    for call in calls:
        assert [(i, s.kind) for i, s in mine._matching(*call)] \
            == [(i, s.kind) for i, s in ref._matching(*call)]
    assert mine._counts == ref._counts
    assert mine.wants_checkpoint() and ref.wants_checkpoint()


def test_hash01_bitwise_jax():
    for seed in (0, 1, 7, 12345):
        for rank in range(5):
            for idx in range(40):
                assert faults._hash01(seed, rank, idx) \
                    == jfaults._hash01(seed, rank, idx)


def test_fault_scope_restores_previous_plan():
    outer = rz.FaultPlan([rz.FaultSpec("delay", seconds=0.0)])
    with rz.fault_scope(outer) as got:
        assert got is outer and config.fault_plan() is outer
        with rz.fault_scope(rz.FaultSpec("delay")) as inner:
            assert config.fault_plan() is inner
        assert config.fault_plan() is outer
    assert config.fault_plan() is None
    assert rz.as_plan([rz.FaultSpec("delay")]).specs[0].kind == "delay"


# ------------------------------------------------------ the fault matrix
# Programs in both packages: three Allreduces (the exchange site), a
# Send/Recv ring (the p2p site), a q8 compressed Allgather (an encoded
# int8 wire).

def _jax_program(name):
    def allreduce(rank):
        x = jnp.arange(16.0) * (rank + 1)
        for _ in range(3):
            x = jcomm.Allreduce(x, jmpi.MPI_SUM)
        return np.asarray(x)

    def p2p(rank):
        n = jcomm.size
        h = jcomm.Isend(jnp.arange(8.0) + rank, (rank + 1) % n, 5)
        y = jcomm.Recv(jnp.zeros(8), (rank - 1) % n, 5)
        jcomm.Wait(h)
        return np.asarray(y)

    def allgather_q8(rank):
        x = jnp.linspace(-2.0, 2.0, 48, dtype=jnp.float32) * (rank + 1)
        return np.asarray(jcomm.Allgather(x, 0, compression="q8"))

    return locals()[name]


def _port_program(name):
    def allreduce(rank):
        x = torch.arange(16.0, dtype=torch.float64) * (rank + 1)
        for _ in range(3):
            x = comm.Allreduce(x, mpi.MPI_SUM)
        return x.numpy()

    def p2p(rank):
        n = comm.size
        h = comm.Isend(torch.arange(8.0, dtype=torch.float64) + rank,
                       (rank + 1) % n, 5)
        y = comm.Recv(torch.zeros(8, dtype=torch.float64), (rank - 1) % n,
                      5)
        comm.Wait(h)
        return y.numpy()

    def allgather_q8(rank):
        x = torch.linspace(-2.0, 2.0, 48, dtype=torch.float32) * (rank + 1)
        return comm.Allgather(x, 0, compression="q8").numpy()

    return locals()[name]


# (cell id, program, spec, settings, nranks, world timeout)
CELLS = [
    ("rank_death-exchange", "allreduce",
     dict(kind="rank_death", rank=1, op="Allreduce", index=1), {}, 3, 2.0),
    ("rank_death-p2p", "p2p", dict(kind="rank_death", rank=1, op="p2p"),
     {}, 3, 2.0),
    ("delay-exchange", "allreduce",
     dict(kind="delay", rank=1, op="Allreduce", seconds=0.1), {}, 3, 2.0),
    ("delay-p2p", "p2p", dict(kind="delay", rank=1, op="p2p", seconds=0.1),
     {}, 2, 2.0),
    ("delay-past-timeout", "allreduce",
     dict(kind="delay", rank=1, op="Allreduce", seconds=0.5), {}, 3, 0.2),
    ("drop_p2p-retried", "p2p", dict(kind="drop_p2p", rank=0, op="p2p"),
     dict(retries=2), 2, 0.3),
    ("drop_p2p-no-retries", "p2p", dict(kind="drop_p2p", rank=0, op="p2p"),
     {}, 2, 0.3),
    ("corrupt_nan-guarded", "allreduce",
     dict(kind="corrupt_nan", rank=1, op="Allreduce"),
     dict(guard="raise"), 3, 2.0),
    ("corrupt_inf-guarded", "allreduce",
     dict(kind="corrupt_inf", rank=2, op="Allreduce"),
     dict(guard="raise"), 3, 2.0),
    ("corrupt_nan-p2p", "p2p", dict(kind="corrupt_nan", rank=1, op="p2p"),
     {}, 2, 2.0),
    ("bitflip-checksummed", "allgather_q8",
     dict(kind="bitflip", rank=1, op="Allgather.c"),
     dict(checksum=True), 3, 2.0),
    ("bitflip-float-inert", "allreduce",
     dict(kind="bitflip", rank=1, op="Allreduce"), {}, 2, 2.0),
    ("preempt", "allreduce",
     dict(kind="preempt", rank=1, op="Allreduce", index=0, count=2), {}, 3,
     2.0),
    ("slow_rank", "allreduce",
     dict(kind="slow_rank", rank=1, op="Allreduce", seconds=0.02, count=3),
     {}, 2, 2.0),
    ("jitter", "allreduce",
     dict(kind="jitter", rank=0, seconds=0.02, count=3, seed=7), {}, 2, 2.0),
    ("flaky_link", "p2p",
     dict(kind="flaky_link", rank=0, op="p2p", p=1.0, count=5),
     dict(retries=2), 2, 0.3),
    ("brownout", "allreduce",
     dict(kind="brownout", rank=1, op="Allreduce", per_byte_s=1e-5), {}, 2,
     2.0),
]


def _apply(cfg, settings):
    cfg.set_comm_retries(settings.get("retries", 0))
    cfg.set_comm_finite_guard(settings.get("guard", "off"))
    cfg.set_comm_wire_checksum(settings.get("checksum", False))


def _outcome(run):
    try:
        outs = run()
    except Exception as e:  # noqa: BLE001 — the outcome under test
        return type(e).__name__, getattr(e, "ranks", None), None
    return "ok", None, outs


def _fired(plan):
    return sorted((f.kind, f.rank, f.op, f.site, repr(f.info))
                  for f in plan.fired)


@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_fault_outcome_equal_jax(cell):
    _, program, spec, settings, n, timeout = cell
    _apply(jmpi.config, settings)
    with jrz.fault_scope([jrz.FaultSpec(**spec)]) as jplan:
        want = _outcome(lambda: jmpi.run_ranks(_jax_program(program), n,
                                               timeout=timeout))
    _reset_both()
    _apply(config, settings)
    with rz.fault_scope([rz.FaultSpec(**spec)]) as plan:
        got = _outcome(lambda: mpi.run_ranks(_port_program(program), n,
                                             timeout=timeout, device="cpu"))
    assert got[:2] == want[:2]
    assert plan.fired_kinds() == jplan.fired_kinds()
    assert _fired(plan) == _fired(jplan)
    if got[0] == "ok":
        for a, b in zip(got[2], want[2]):
            np.testing.assert_array_equal(a, b)


def test_preemption_notice_board_equal_jax():
    spec = dict(kind="preempt", rank=1, op="Allreduce", index=0, count=5)
    with jrz.fault_scope([jrz.FaultSpec(**spec)]):
        jmpi.run_ranks(_jax_program("allreduce"), 2)
        want = jrz.pending_preemptions()
    with rz.fault_scope([rz.FaultSpec(**spec)]) as plan:
        mpi.run_ranks(_port_program("allreduce"), 2, device="cpu")
        assert rz.pending_preemptions() == want == {1: 2}
        plan.clear_preemption(1)
        assert rz.pending_preemptions() == {}
    assert rz.pending_preemptions() == {}


def test_delay_past_timeout_recovers_under_retries():
    obs.reset_metrics()
    config.set_comm_retries(2)
    config.set_comm_backoff(0.25)
    worlds = []

    def body(rank):
        worlds.append(mpi.runtime.current_rank_context().world)
        return _port_program("allreduce")(rank)

    with obs.trace() as t, rz.fault_scope(
            [rz.FaultSpec("delay", rank=1, op="Allreduce", seconds=0.4)]):
        outs = mpi.run_ranks(body, 3, timeout=0.2, device="cpu")
    assert all(np.array_equal(o, outs[0]) for o in outs)
    used = worlds[0].retry_events
    assert used > 0
    assert obs.snapshot()["counters"]["comm_retry_events_total"] == used
    assert sum(e.retries for e in t.events) == used


def test_deadlock_names_the_late_rank():
    with rz.fault_scope([rz.FaultSpec("delay", rank=2, op="Allreduce",
                                      seconds=0.5)]):
        with pytest.raises(mpi.DeadlockError) as ei:
            mpi.run_ranks(_port_program("allreduce"), 3, timeout=0.2,
                          device="cpu")
    assert ei.value.missing == frozenset({2})
    assert ei.value.arrived == frozenset({0, 1})


def test_corruption_never_writes_the_callers_tensor():
    x = torch.arange(6.0)
    poisoned = faults._poison(x, float("nan"))
    assert torch.isnan(poisoned[0]) and torch.equal(x, torch.arange(6.0))
    q = torch.arange(4, dtype=torch.int8)
    flipped = faults._flip_bits(q, 5)
    assert torch.equal(q, torch.arange(4, dtype=torch.int8))
    want = jfaults._flip_bits(jnp.arange(4, dtype=jnp.int8), 5)
    np.testing.assert_array_equal(flipped.numpy(), np.asarray(want))

    seen = []

    def body():
        y = comm.Allreduce(x, mpi.MPI_SUM)
        seen.append(torch.equal(x, torch.arange(6.0)))
        return y

    with rz.fault_scope([rz.FaultSpec("corrupt_nan", op="Allreduce")]):
        y = mpi.run_ranks(body, 1, device="cpu")[0]
    assert seen == [True] and torch.isnan(y[0])


# ---------------------------------------------------------------- guards

def _allreduce_nan_on(bad_rank):
    def body(rank):
        x = torch.arange(16.0) * (rank + 1)
        if rank == bad_rank:
            x[3] = float("nan")
        return comm.Allreduce(x, mpi.MPI_SUM)
    return body


def test_finite_guard_raise_names_offending_rank_on_every_rank():
    config.set_comm_finite_guard("raise")

    def body(rank):
        try:
            _allreduce_nan_on(2)(rank)
        except mpi.IntegrityError as e:
            return type(e).__name__, e.ranks
        return "ok", None

    outs = mpi.run_ranks(body, 3, timeout=2.0, device="cpu")
    assert outs == [("IntegrityError", frozenset({2}))] * 3
    with rz.fault_scope([rz.FaultSpec("corrupt_nan", rank=2,
                                      op="Allreduce")]):
        with pytest.raises(mpi.IntegrityError) as ei:
            mpi.run_ranks(_port_program("allreduce"), 3, timeout=2.0,
                          device="cpu")
    assert ei.value.ranks == frozenset({2})


def test_finite_guard_warn_completes():
    config.set_comm_finite_guard("warn")
    with pytest.warns(rz.IntegrityWarning):
        out = comm.Allreduce(torch.tensor([float("nan"), 1.0]),
                             mpi.MPI_SUM)
    assert torch.isnan(out[0])
    assert rz.last_violation() == {"where": "Allreduce", "mode": "warn",
                                   "ranks": [0]}


def test_finite_guard_off_is_silent():
    # A violation another test left behind is not this test's.
    guards.clear_violations()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = comm.Allreduce(torch.tensor([float("nan"), 1.0]), mpi.MPI_SUM)
    assert torch.isnan(out[0]) and rz.last_violation() is None


def test_huge_finite_float64_is_not_a_false_positive():
    assert guards._finite_flags([{"x": np.asarray([1e300, -1e300])},
                                 torch.tensor([1e300, -1e300],
                                              dtype=torch.float64)]) \
        == [True, True]
    assert guards._finite_flags([np.asarray([1e300, np.inf]),
                                 torch.tensor([np.nan])]) == [False, False]
    assert jguards._all_finite({"x": np.asarray([1e300, -1e300])})


def test_bf16_payload_checked():
    config.set_comm_finite_guard("raise")
    with pytest.raises(mpi.IntegrityError):
        comm.Allreduce(torch.tensor([float("nan")], dtype=torch.bfloat16),
                       mpi.MPI_SUM)


@pytest.mark.parametrize("op", ["Reduce_scatter", "Reduce_", "Allgather",
                                "Allreduce_tree", "fused_pipeline",
                                "Allreduce_q8"])
def test_finite_guard_on_every_guarded_collective(op):
    config.set_comm_finite_guard("raise")

    def body(rank):
        x = torch.arange(12.0) + rank
        if rank == 1:
            x[5] = float("inf")
        if op == "Reduce_scatter":
            return comm.Reduce_scatter(x, mpi.MPI_SUM, 0)
        if op == "Reduce_":
            return comm.Reduce_(x, mpi.MPI_SUM, 0)
        if op == "Allgather":
            return comm.Allgather(x, 0)
        if op == "Allreduce_q8":
            return comm.Allreduce(x, mpi.MPI_SUM, compression="q8")
        kw = dict(overlap=True) if op == "fused_pipeline" else {}
        return comm.Allreduce_tree({"x": x}, mpi.MPI_SUM, bucket_bytes=64,
                                   **kw)

    with pytest.raises(mpi.IntegrityError) as ei:
        mpi.run_ranks(body, 2, timeout=2.0, device="cpu")
    assert ei.value.ranks == frozenset({1})


def _ag_q8(rank):
    return _port_program("allgather_q8")(rank)


def test_bitflip_on_q8_wire_detected_and_attributed():
    config.set_comm_wire_checksum(True)
    with rz.fault_scope([rz.FaultSpec("bitflip", rank=1,
                                      op="Allgather.c")]):
        with pytest.raises(mpi.IntegrityError) as ei:
            mpi.run_ranks(_ag_q8, 3, timeout=2.0, device="cpu")
    assert ei.value.ranks == frozenset({1})


def test_checksum_off_bitflip_is_silent_corruption():
    baseline = mpi.run_ranks(_ag_q8, 2, device="cpu")
    with rz.fault_scope([rz.FaultSpec("bitflip", rank=1,
                                      op="Allgather.c")]) as plan:
        got = mpi.run_ranks(_ag_q8, 2, timeout=2.0, device="cpu")
    assert plan.fired_kinds() == frozenset({"bitflip"})
    assert not np.array_equal(got[0], baseline[0])


@pytest.mark.parametrize("codec", ["q8", "q8_ef", "bf16", "bf16r"])
def test_checksum_on_clean_wire_is_bitwise_inert(codec):
    def body(rank):
        x = torch.linspace(-2.0, 2.0, 300, dtype=torch.float32) * (rank + 1)
        x.requires_grad_()
        y = comm.Allgather(x, 0, compression=codec)
        s = comm.Allreduce(x, mpi.MPI_SUM, compression=codec)
        g, = torch.autograd.grad((y * y).sum() + (s * s).sum(), [x])
        return y.detach(), s.detach(), g

    baseline = mpi.run_ranks(body, 3, device="cpu")
    config.set_comm_wire_checksum(True)
    config.set_comm_finite_guard("raise")
    with obs.trace() as t:
        got = mpi.run_ranks(body, 3, device="cpu")
    for b, g in zip(baseline, got):
        assert all(torch.equal(u, v) for u, v in zip(b, g))
    ops = {e.signature[-1] for e in t.events if e.op.startswith(
        "Allgather.c")}
    assert ops == {"crc"}


def test_verify_wire_covers_meta_too():
    payload = {"q": torch.zeros(4, dtype=torch.int8)}
    meta = ("q8", (4,), torch.float32)
    crc = rz.wire_checksum((meta, payload))
    assert rz.verify_wire([(meta, payload, crc)], "op") == [(meta, payload)]
    with pytest.raises(mpi.IntegrityError) as ei:
        rz.verify_wire([(meta, payload, crc),
                        (("q8", (8,), torch.float32), payload, crc)], "op")
    assert ei.value.ranks == frozenset({1})


def test_wire_checksum_roundtrip():
    payload = {"q": torch.tensor([[1, -3], [7, 9]], dtype=torch.int8),
               "scale": torch.tensor([0.5, 2.0])}
    c = rz.wire_checksum(payload)
    assert c == rz.wire_checksum(payload)
    flipped = dict(payload, q=payload["q"].clone())
    flipped["q"][0, 0] = 2
    assert c != rz.wire_checksum(flipped)


@pytest.mark.parametrize("codec", ["q8", "q8_ef_hop", "bf16", "bf16r"])
@pytest.mark.parametrize("shape", [(48,), (3, 100)])
def test_wire_checksum_equals_jax_on_the_same_wire(codec, shape):
    from mpi4torch_tpu.compress import get_codec as jget
    from mpi4torch_tpu_torch.compress import get_codec
    from mpi4torch_tpu_torch.utils import threefry

    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    mine, ref = get_codec(codec), jget(codec)
    key, jkey = threefry.PRNGKey(11), jax.random.PRNGKey(11)
    payload, meta = mine.encode(torch.from_numpy(x),
                                key if mine.stochastic else None)
    jpayload, jmeta = ref.encode(jnp.asarray(x),
                                 jkey if ref.stochastic else None)
    for k in payload:
        np.testing.assert_array_equal(
            payload[k].view(torch.int16).numpy()
            if payload[k].dtype == torch.bfloat16 else payload[k].numpy(),
            np.asarray(jpayload[k]).view(np.int16)
            if jpayload[k].dtype == jnp.bfloat16 else np.asarray(jpayload[k]))
    assert rz.wire_checksum((meta, payload)) \
        == jguards.wire_checksum((jmeta, jpayload))


def test_mode_a_guard_raises():
    # The Mode A guard is ported: off, it returns its input untouched;
    # "raise" under run_spmd raises the same IntegrityError on every rank,
    # naming the corrupt one.
    x = torch.ones(1)
    assert rz.spmd_finite_value(x, "Allreduce") is x
    comm = mpi.COMM_WORLD

    def body(v):
        bad = torch.where(comm.rank == 0, torch.tensor(float("inf")),
                          torch.tensor(1.0))
        return comm.Allreduce(v * bad, mpi.MPI_SUM)

    config.set_comm_finite_guard("raise")
    with pytest.raises(mpi.IntegrityError, match="entering Allreduce") as ei:
        mpi.run_spmd(body, nranks=2, device="cpu")(x)
    assert ei.value.ranks == frozenset({0})


def test_knob_validation():
    for bad in (lambda: config.set_comm_retries(-1),
                lambda: config.set_comm_retries("x"),
                lambda: config.set_comm_backoff(-0.5),
                lambda: config.set_comm_finite_guard("loud")):
        with pytest.raises(ValueError):
            bad()


# ---------------------------------------------------------------- health

def _events(pkg, rows):
    if pkg == "jax":
        from mpi4torch_tpu.obs.events import CommEvent
    else:
        from mpi4torch_tpu_torch.obs.events import CommEvent
    return [CommEvent(seq=i, rank=r, world=w, world_size=size,
                      channel=ch, op="Allreduce", duration_s=d, wait_s=wt,
                      status=st, retries=rt)
            for i, (r, d, wt, w, size, st, ch, rt) in enumerate(rows)]


def _report_tuple(rep):
    if rep is None:
        return None
    return (rep.world, rep.world_size,
            tuple((s.rank, s.events, s.local_s, s.wait_s, s.retries)
                  for s in rep.stats),
            rep.slow, rep.baseline_s, rep.threshold, rep.floor_s,
            rep.summary())


def _synthetic(seed):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(12):
        for r in range(4):
            slow = r == seed % 4
            d = float(rng.uniform(0.05, 0.15))
            local = float(rng.uniform(0.03, 0.09)) if slow \
                else float(rng.uniform(0.0, 0.004))
            rows.append((r, d, max(d - local, 0.0), seed % 2, 4, "ok",
                         "exchange", int(rng.integers(0, 2))))
    rows.append((0, 9.0, 0.0, 0, 4, "DeadlockError", "exchange", 0))
    rows.append((1, 9.0, 0.0, 0, 4, "ok", "p2p_recv", 0))
    return rows


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kw", [dict(), dict(floor_s=0.02),
                                dict(threshold=2.0, window=5),
                                dict(min_events=50), dict(world=1)])
def test_detect_slow_ranks_equal_jax(seed, kw):
    rows = _synthetic(seed)
    got = rz.detect_slow_ranks(_events("port", rows), **kw)
    want = jrz.detect_slow_ranks(_events("jax", rows), **kw)
    assert _report_tuple(got) == _report_tuple(want)


def test_gray_failure_detected_and_escalated():
    obs.reset_metrics()
    spec = rz.FaultSpec("slow_rank", rank=1, op="Allreduce", seconds=0.08,
                        count=10)
    with obs.trace() as t, rz.fault_scope([spec]) as plan:
        mpi.run_ranks(_port_program("allreduce"), 4, device="cpu")
    assert "slow_rank" in plan.fired_kinds()
    det = rz.GrayFailureDetector(t, floor_s=0.02)
    rep = det.check()
    assert rep.slow == frozenset({1})
    assert obs.snapshot()["counters"]["gray_failures_total"] == 1
    with pytest.raises(rz.SlowRankError) as ei:
        det.check(escalate=True)
    assert ei.value.ranks == frozenset({1})
    pm = t.last_postmortem()
    assert pm["error"] == "SlowRankError" and pm["failed_ranks"] == [1]
    assert rz.GrayFailureDetector().report() is None   # no tracer


def test_health_probe_reports_slow_and_dead():
    def body(rank):
        if rank == 2:
            time.sleep(0.1)
        return comm.check_health(timeout=2.0)

    reps = mpi.run_ranks(body, 3, device="cpu")
    assert all(r.ok for r in reps)
    assert reps[0].arrival_s[2] >= 0.05
