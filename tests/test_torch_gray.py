"""The port's degraded mode and chaos matrix
(``mpi4torch_tpu_torch.resilience.degrade`` and ``.chaos``) against the
JAX package's on the CPU.

* ``HealthReport.slow_ranks``: a late rank is slow but alive, a dead one
  missing and never slow, as in JAX;
* the per-rank wire census: ``rank_wire_bytes`` and
  ``failover_schedule`` equal JAX's integers for every algorithm,
  nranks 2-8 and every slow rank (and root), the refusals too;
* the controller: each policy's transition (epoch, policy, action, slow)
  equals JAX's; ``reset`` restores every knob a policy touched; the
  typed refusals name JAX's fallbacks;
* the registry guard (``degrade_problems``) equals JAX's, clean and
  drifted;
* the chaos matrix: the coverage literals and constants are JAX's, the
  storm plans equal JAX's spec for spec, and the fast cells' records
  (status, fired kinds, epoch, algorithm, slots) equal JAX's.  The full
  sweep and the storms are ``slow``, as in JAX.
"""

import time

import numpy as np
import pytest
import torch

import mpi4torch_tpu as jmpi
import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu.resilience import chaos as jchaos
from mpi4torch_tpu.resilience import degrade as jdegrade
from mpi4torch_tpu_torch import config
from mpi4torch_tpu_torch.resilience import chaos, degrade
from mpi4torch_tpu_torch.resilience.__main__ import degrade_problems
from mpi4torch_tpu_torch.resilience.health import SlowRankReport

CPU = "cpu"


@pytest.fixture(autouse=True)
def _reset():
    yield
    for cfg in (config, jmpi.config):
        cfg.set_fault_plan(None)
        cfg.set_comm_tracer(None)
        cfg.set_default_compression(None)
        cfg.set_default_algorithm(None)


# --------------------------------------------------------------- health


def test_health_report_slow_ranks():
    def probe(rank):
        if rank == 2:
            time.sleep(0.2)
        return mpi.COMM_WORLD.check_health(timeout=5.0)

    for rep in mpi.run_ranks(probe, 3, timeout=10.0, device=CPU):
        assert rep.ok and not rep.missing
        assert set(rep.arrival_s) == {0, 1, 2}
        assert rep.arrival_s[2] >= 0.15
        assert rep.slow_ranks(0.1) == frozenset({2})
        assert rep.slow_ranks(10.0) == frozenset()

    def dead(rank):
        if rank == 1:
            return None
        return mpi.COMM_WORLD.check_health(timeout=0.3)

    reps = mpi.run_ranks(dead, 3, timeout=5.0, device=CPU)
    for rank, rep in enumerate(reps):
        if rank == 1:
            continue
        assert rep.missing == frozenset({1}) and 1 not in rep.arrival_s
        assert rep.slow_ranks(0.0) == rep.arrived
        assert rep.slow_ranks(10.0) == frozenset()
    empty = mpi.HealthReport(True, 1, frozenset({0}), frozenset())
    assert empty.slow_ranks(0.0) == frozenset()


# ----------------------------------------------------------- wire census


ALGOS = ("ring", "bidir", "rhd", "tree", "hier", "torus")


def _outcome(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("n", range(1, 9))
def test_rank_wire_bytes_equal_jax(n):
    for algo in ALGOS + ("warp",):
        for nbytes in (128, 1000, 1 << 20):
            for root in range(n):
                assert _outcome(degrade.rank_wire_bytes, algo, n, nbytes,
                                root=root) == \
                    _outcome(jdegrade.rank_wire_bytes, algo, n, nbytes,
                             root=root), (algo, n, nbytes, root)


@pytest.mark.parametrize("n", range(2, 9))
def test_failover_schedule_equal_jax(n):
    for slow in range(n):
        for nbytes in (128, 4 << 20):
            assert _outcome(degrade.failover_schedule, slow, n, nbytes) \
                == _outcome(jdegrade.failover_schedule, slow, n, nbytes)
            cands = ("ring", "tree")
            assert degrade.failover_schedule(
                slow, n, nbytes, candidates=cands) == \
                jdegrade.failover_schedule(slow, n, nbytes,
                                           candidates=cands)
    assert _outcome(degrade.failover_schedule, 0, n, 8, candidates=()) \
        == _outcome(jdegrade.failover_schedule, 0, n, 8, candidates=())


# ------------------------------------------------------------ controller


def _report(pkg_report, slow, size):
    return pkg_report(world=0, world_size=size, stats=(),
                      slow=frozenset(slow), baseline_s=0.0, threshold=4.0,
                      floor_s=0.01)


def _transition(tr):
    return (tr.epoch, tr.policy, tr.action, tr.slow)


def test_policy_transitions_equal_jax_and_reset_restores():
    from mpi4torch_tpu.resilience.health import SlowRankReport as JReport

    cases = [("codec_escalate", {1}, 4, {}),
             ("schedule_failover", {2}, 4, dict(nbytes=128)),
             ("schedule_failover", {0}, 6, {}),
             ("spare_demote", {1}, 4, dict(n_data=3)),
             ("spare_demote", {0}, 5, dict(n_data=3,
                                           slots=(1, 0, None, 2, None)))]
    ctl = degrade.DegradeController(n_ranks=4, device=CPU)
    jctl = jdegrade.DegradeController(n_ranks=4)
    for policy, slow, size, kw in cases:
        if size != ctl.runtime.view.size:
            ctl = degrade.DegradeController(n_ranks=size, device=CPU)
            jctl = jdegrade.DegradeController(n_ranks=size)
        tr = ctl.apply(policy, _report(SlowRankReport, slow, size), **kw)
        jtr = jctl.apply(policy, _report(JReport, slow, size), **kw)
        assert _transition(tr) == _transition(jtr), policy
        assert (config.default_algorithm(),
                getattr(config.default_compression(), "name", None)) == \
            (jmpi.config.default_algorithm(),
             getattr(jmpi.config.default_compression(), "name", None))
        assert ctl.runtime.epoch == jctl.runtime.epoch == tr.epoch
    # Three transitions touching two knobs: first-write-wins snapshots,
    # so reset restores the pre-episode values.
    config.set_default_compression(None)
    config.set_default_algorithm("tree")
    ctl = degrade.DegradeController(n_ranks=4, device=CPU)
    ctl.apply("schedule_failover", _report(SlowRankReport, {1}, 4))
    ctl.apply("codec_escalate", None)
    ctl.apply("schedule_failover", _report(SlowRankReport, {3}, 4))
    assert [t.epoch for t in ctl.transitions] == [1, 2, 3]
    ctl.reset()
    assert config.default_algorithm() == "tree"
    assert config.default_compression() is None
    assert ctl._saved == {}


def test_typed_refusals_equal_jax():
    from mpi4torch_tpu.resilience.health import SlowRankReport as JReport

    ctl = degrade.DegradeController(n_ranks=2, device=CPU)
    jctl = jdegrade.DegradeController(n_ranks=2)
    for policy, rep, jrep, kw in [
            ("warp_drive", None, None, {}),
            ("schedule_failover", None, None, {}),
            ("spare_demote", _report(SlowRankReport, {1}, 2),
             _report(JReport, {1}, 2), dict(n_data=2)),
            ("spare_demote", _report(SlowRankReport, {1}, 2),
             _report(JReport, {1}, 2), dict(n_data=1, slots=(0,)))]:
        with pytest.raises(degrade.DegradeError) as pe:
            ctl.apply(policy, rep, consensus=False, **kw)
        with pytest.raises(jdegrade.DegradeError) as je:
            jctl.apply(policy, jrep, consensus=False, **kw)
        assert str(pe.value) == str(je.value)
    with pytest.raises(degrade.DegradeError, match="runtime= or n_ranks="):
        degrade.DegradeController()
    assert ctl.runtime.epoch == 0


def test_register_policy_and_transition_metric():
    from mpi4torch_tpu_torch.obs import metrics as om

    om.reset_metrics()
    degrade.register_degrade_policy(
        "noop_policy", lambda host, report, **kw: {"noop": True})
    try:
        ctl = degrade.DegradeController(n_ranks=2, device=CPU)
        tr = ctl.apply("noop_policy", consensus=False)
        assert (tr.epoch, tr.action) == (0, {"noop": True})
        assert any("noop_policy" in p for p in degrade_problems())
    finally:
        del degrade.DEGRADE_POLICIES["noop_policy"]
    assert om.snapshot()["counters"][
        'degrade_transitions_total{policy="noop_policy"}'] == 1
    assert sorted(degrade.DEGRADE_POLICIES) == \
        sorted(jdegrade.DEGRADE_POLICIES)


# -------------------------------------------------------------- registry


def test_degrade_guard_equals_jax(monkeypatch):
    from mpi4torch_tpu.analyze.registry import degrade_problems as jprob

    assert degrade_problems() == [] == jprob()
    for mod in (chaos, jchaos):
        cov = {k: dict(v) for k, v in mod.CHAOS_COVERAGE.items()}
        cov.pop("jitter")
        cov["brownout"]["compressed"] = "recover"
        monkeypatch.setattr(mod, "CHAOS_COVERAGE", cov)
    assert degrade_problems() == jprob()
    assert len(degrade_problems()) == 3


# ----------------------------------------------------------------- chaos


def test_chaos_literals_equal_jax():
    assert chaos.GRAY_KINDS == jchaos.GRAY_KINDS
    assert chaos.CHAOS_SUBSYSTEMS == jchaos.CHAOS_SUBSYSTEMS
    assert chaos.CHAOS_COVERAGE == jchaos.CHAOS_COVERAGE
    assert chaos.DEGRADE_COVERED == jchaos.DEGRADE_COVERED
    assert list(chaos.coverage_cells()) == list(jchaos.coverage_cells())
    for name in ("CELL_TIMEOUT_S", "RETRIES", "BACKOFF_S", "SLOW_S",
                 "JITTER_S", "CO_JITTER_S", "PER_BYTE_S", "FLAKY_P",
                 "DETECT_FLOOR_S"):
        assert getattr(chaos, name) == getattr(jchaos, name), name


@pytest.mark.parametrize("seed", [1, 2, 3, 17])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_storm_plans_equal_jax(seed, n):
    def spec(s):
        return (s.kind, s.rank, s.op, s.index, s.count, s.seconds,
                s.per_byte_s, s.p, s.seed)

    assert [spec(s) for s in chaos.storm_plan(seed, n)] == \
        [spec(s) for s in jchaos.storm_plan(seed, n)]


_FAST_CHAOS = [
    ("slow_rank", "plain"),      # degrade: schedule failover, lock-step
    ("jitter", "plain"),         # recover under the storm
    ("flaky_link", "overlap"),   # recover via redelivery
    ("flaky_link", "plain"),     # provably inert
]

_CHAOS_KEYS = ("kind", "subsystem", "expected", "status", "fired",
               "epoch", "algorithm", "slots", "nranks")


def _chaos_record(rec):
    return {k: rec.get(k) for k in _CHAOS_KEYS}


@pytest.mark.parametrize("kind,subsystem", _FAST_CHAOS)
def test_chaos_fast_cell_equals_jax(kind, subsystem):
    rec = chaos.run_chaos_cell(kind, subsystem, device=CPU)
    assert rec["status"] == "ok", rec
    assert _chaos_record(rec) == _chaos_record(
        jchaos.run_chaos_cell(kind, subsystem))


def test_storm_never_hangs():
    rec = chaos.run_storm(1, device=CPU)
    assert rec["status"] == "ok", rec
    assert set(rec["fired"]) == set(chaos.GRAY_KINDS)


@pytest.mark.slow
@pytest.mark.parametrize("kind,subsystem", list(chaos.coverage_cells()))
def test_chaos_every_cell_equals_jax(kind, subsystem):
    rec = chaos.run_chaos_cell(kind, subsystem, device=CPU)
    assert rec["status"] == "ok", rec
    assert _chaos_record(rec) == _chaos_record(
        jchaos.run_chaos_cell(kind, subsystem))


@pytest.mark.slow
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_storm(seed):
    rec = chaos.run_storm(seed, device=CPU)
    assert rec["status"] == "ok", rec


def test_unknown_chaos_cell_fails_typed():
    rec = chaos.run_chaos_cell("slow_rank", "nosuch", device=CPU)
    assert rec["status"] == "fail" and "CHAOS_COVERAGE" in rec["detail"]
    assert rec == jchaos.run_chaos_cell("slow_rank", "nosuch")


def test_codec_escalate_lockstep_q8_bitwise_and_fenced():
    """The fault fast path on a fused DP-style step: after
    ``codec_escalate`` every rank runs the q8 wire at the ratified
    epoch, bitwise an explicit-q8 run; a phase prepared at the old epoch
    is fenced; ``reset`` restores the exact wire bitwise."""
    from mpi4torch_tpu_torch.elastic import StaleEpochError

    rng = np.random.default_rng(3)
    tree = [{"a": rng.standard_normal(700).astype(np.float32),
             "b": rng.standard_normal(90).astype(np.float32)}
            for _ in range(2)]

    def step(pos, rid=None, compression=None):
        t = {k: torch.from_numpy(v) for k, v in tree[pos].items()}
        out = mpi.COMM_WORLD.Allreduce_tree(
            t, mpi.MPI_SUM, mean=True, bucket_bytes=1024,
            compression=compression)
        codec = config.default_compression()
        return (getattr(codec, "name", codec),
                {k: v.numpy() for k, v in out.items()})

    exact = mpi.run_ranks(step, 2, timeout=10.0, device=CPU)
    q8 = mpi.run_ranks(lambda p: step(p, compression="q8"), 2,
                       timeout=10.0, device=CPU)
    ctl = degrade.DegradeController(n_ranks=2, device=CPU)
    stale = ctl.runtime.view
    try:
        tr = ctl.apply("codec_escalate", None)
        outs = ctl.runtime.run_phase(step, view=ctl.runtime.view)
        with pytest.raises(StaleEpochError):
            ctl.runtime.run_phase(step, view=stale)
    finally:
        ctl.reset()
    assert {(o[0], tr.epoch) for o in outs} == {("q8", 1)}
    for (_c, got), (_q, want) in zip(outs, q8):
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    after = mpi.run_ranks(step, 2, timeout=10.0, device=CPU)
    for (c, got), (_e, want) in zip(after, exact):
        assert c is None
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
