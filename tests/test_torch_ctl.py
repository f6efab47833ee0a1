"""The port's online controller (``mpi4torch_tpu_torch.ctl``) against the
JAX package's (``mpi4torch_tpu.ctl``) on the CPU.

* over the same synthetic ``CommEvent`` streams (the JAX smoke lane's
  ``synthetic_round``), the EWMA, the per-tier and per-link estimates,
  the goodput factors, the drift states and ratios, and
  ``live_bandwidths`` equal JAX's;
* the six ``ctl_*`` knobs: defaults, validation (the same errors and
  messages) and their trip through ``snapshot_process_state``;
* the ledger's JSON and table equal JAX's; the registry guard equals
  JAX's, clean and drifted;
* the controller's decisions on synthetic streams (drift re-rank, codec
  crossover, recovery, the min-epochs hysteresis, the fault fast path)
  equal JAX's field for field: trigger, epoch, tier, ratio, winner names
  and digests, weighted costs, tier wire;
* ``closed_loop_episode`` with real traffic and a real brownout on the
  rank threads ((2, 2, 2) and (8,)) and on worker processes ((2, 2, 2);
  (8,) is ``slow``, as in JAX): the trigger sequence and epochs,
  bitwise oracles, the stale fence, and the escalation's winners, costs
  and tier wire equal JAX's synthesis under the same live bandwidths; the
  watermarks JAX's rule on this wire's measured healthy ratio, and the
  installed winner, run in the escalated configuration, bitwise the
  port's and JAX's interpreters of its program;
* off path: a constructed but disabled controller leaves a Mode A
  Allreduce's programs, exchanges and values, an eager Allreduce's values
  and an engine's tokens unchanged; the engine consults an attached
  controller once a step.
"""

import json

import numpy as np
import pytest
import torch

import mpi4torch_tpu as jmpi
import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu import csched as jcsched
from mpi4torch_tpu import ctl as jctl
from mpi4torch_tpu.ctl import __main__ as jmain
from mpi4torch_tpu_torch import config, ctl, tune
from mpi4torch_tpu_torch.ctl import __main__ as cmain
from mpi4torch_tpu_torch.ctl.controller import SelfTuningController
from mpi4torch_tpu_torch.elastic import StaleEpochError

CPU = "cpu"
NR = 8
TIERS = (2, 2, 2)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("MPI4TORCH_TPU_TORCH_TUNE_CACHE",
                       str(tmp_path / "port_tune.json"))
    monkeypatch.setenv("MPI4TORCH_TPU_TUNE_CACHE",
                       str(tmp_path / "jax_tune.json"))
    snaps = (config.snapshot_process_state(),
             jmpi.config.snapshot_process_state())
    yield
    config.apply_process_state(snaps[0])
    jmpi.config.apply_process_state(snaps[1])
    for cfg in (config, jmpi.config):
        cfg.set_fault_plan(None)
        cfg.set_comm_tracer(None)
    tune.clear()
    jmpi.tune.clear()


def _both(fn):
    """``fn(pkg_main, pkg_ctl, pkg_config)`` on the port and on JAX."""
    return (fn(cmain, ctl, config), fn(jmain, jctl, jmpi.config))


# ------------------------------------------------------------- estimator


def _stream(main):
    ev = []
    ev += main.synthetic_round(0, 1e6)
    ev += [main.synthetic_event(8, 0, 2e6, group_size=2),
           main.synthetic_event(9, 3, 4e6, group_size=4),
           main.synthetic_event(10, 5, 9e9, bookkeeping=True, family=None),
           main.synthetic_event(11, 6, 9e9, status="Timeout"),
           main.synthetic_event(12, 1, 5e5, codec="q8"),
           main.synthetic_event(13, 2, 7e5, codec="bf16"),
           main.synthetic_event(14, 2, 7e5, codec="nosuch")]
    ev += main.synthetic_round(15, 3e5, group_size=8)
    return ev


def test_estimator_equals_jax():
    def run(main, pkg, cfg):
        est = pkg.BandwidthEstimator(TIERS, halflife=1.5)
        evs = _stream(main)
        n = est.ingest(evs)
        again = est.ingest(evs)
        return (n, again, est.tier_estimates(), est.tier_samples(),
                est.link_estimates(), repr(est),
                [pkg.event_tier(e, TIERS) for e in evs],
                [pkg.goodput_bytes(e) for e in evs])

    ours, theirs = _both(run)
    assert ours == theirs
    assert ours[0] == 21 and ours[1] == 0


def test_ewma_and_default_halflife_equal_jax():
    for h in (0.5, 1.0, 4.0, 7.3):
        a, b = ctl.Ewma(h), jctl.Ewma(h)
        for x in (3.0, 1.0, 8.0, 2.5):
            assert a.update(x) == b.update(x)
        assert (a.alpha, a.count) == (b.alpha, b.count)
    for pkg in (ctl, jctl):
        with pytest.raises(ValueError):
            pkg.Ewma(0)
        with pytest.raises(ValueError):
            pkg.BandwidthEstimator(())
    config.set_ctl_halflife(2.0)
    assert ctl.BandwidthEstimator(TIERS).halflife == 2.0
    assert ctl.BandwidthEstimator(TIERS).observe() == 0   # no tracer


def test_drift_monitor_equals_jax():
    def run(main, pkg, cfg):
        est = pkg.BandwidthEstimator(TIERS, halflife=1.0)
        mon = pkg.DriftMonitor(3, low=0.5, high=0.8, patience=2)
        est.ingest(main.synthetic_round(0, 1e6))
        mon.calibrate(est)
        out, seq = [], 8
        for bw in (0.55e6, 0.75e6, 0.2e6, 0.3e6, 0.1e6, 0.9e6, 1e6, 1e6,
                   0.6e6, 1.2e6):
            est.ingest(main.synthetic_round(seq, bw))
            seq += 8
            rep = mon.check(est)
            out.append((rep.ratios, rep.states, rep.changed, rep.ok,
                        rep.degraded, rep.as_reconcile(),
                        pkg.live_bandwidths(rep, (1.0, 2.0, 4.0)),
                        pkg.live_bandwidths(rep)))
        late = pkg.DriftMonitor(3, low=0.5, high=0.8, patience=1)
        fresh = pkg.BandwidthEstimator(TIERS, halflife=1.0)
        late.calibrate(fresh)
        fresh.ingest(main.synthetic_round(0, 5.0))
        out.append(late.check(fresh).ratios)
        fresh.ingest(main.synthetic_round(8, 1.0))
        out.append(late.check(fresh).states)
        return out

    ours, theirs = _both(run)
    assert ours == theirs


def test_thresholds_validate_like_jax():
    for kw in (dict(low=0.8, high=0.5), dict(low=0.0, high=0.5),
               dict(patience=0)):
        with pytest.raises(ValueError) as pe:
            ctl.DriftMonitor(3, **kw)
        with pytest.raises(ValueError) as je:
            jctl.DriftMonitor(3, **kw)
        assert str(pe.value) == str(je.value)
    with pytest.raises(ValueError):
        ctl.DriftMonitor(0)
    with pytest.raises(ValueError):
        ctl.live_bandwidths(ctl.DriftMonitor(2).check(
            ctl.BandwidthEstimator((2, 2))), (1.0,))


# ----------------------------------------------------------------- knobs


def test_knob_defaults_equal_jax():
    for name in ("ctl_enabled", "ctl_halflife", "ctl_drift_thresholds",
                 "ctl_drift_patience", "ctl_min_switch_epochs",
                 "ctl_codec_crossover"):
        assert getattr(config, name)() == getattr(jmpi.config, name)()
    assert config.ctl_enabled() is False


@pytest.mark.parametrize("setter,args", [
    ("set_ctl_halflife", (0.0,)), ("set_ctl_halflife", ("x",)),
    ("set_ctl_drift_thresholds", (0.8, 0.5)),
    ("set_ctl_drift_thresholds", (0.0, 0.5)),
    ("set_ctl_drift_thresholds", ("a", 0.5)),
    ("set_ctl_drift_patience", (0,)), ("set_ctl_drift_patience", ("p",)),
    ("set_ctl_min_switch_epochs", (-1,)),
    ("set_ctl_codec_crossover", (0.0,)),
    ("set_ctl_codec_crossover", (1.5,)),
    ("set_ctl_codec_crossover", (None,))])
def test_knobs_validate_like_jax(setter, args):
    with pytest.raises(ValueError) as pe:
        getattr(config, setter)(*args)
    with pytest.raises(ValueError) as je:
        getattr(jmpi.config, setter)(*args)
    assert str(pe.value) == str(je.value)


def test_snapshot_round_trips_ctl_knobs():
    config.set_ctl_enabled(True)
    config.set_ctl_halflife(2.5)
    config.set_ctl_drift_thresholds(0.2, 0.6)
    config.set_ctl_drift_patience(3)
    config.set_ctl_min_switch_epochs(4)
    config.set_ctl_codec_crossover(0.1)
    snap = config.snapshot_process_state()
    jsnap_keys = set(jmpi.config.snapshot_process_state())
    ctl_keys = {k for k in jsnap_keys if k.startswith("ctl_")}
    assert ctl_keys and ctl_keys <= set(snap)
    config.set_ctl_enabled(False)
    config.set_ctl_halflife(4.0)
    config.set_ctl_drift_thresholds(0.5, 0.8)
    config.apply_process_state(snap)
    assert config.ctl_enabled() is True
    assert config.ctl_halflife() == 2.5
    assert config.ctl_drift_thresholds() == (0.2, 0.6)
    assert config.ctl_drift_patience() == 3
    assert config.ctl_min_switch_epochs() == 4
    assert config.ctl_codec_crossover() == 0.1


def test_ctl_knobs_reach_worker_processes():
    config.set_ctl_enabled(True)
    config.set_ctl_drift_thresholds(0.25, 0.75)
    config.set_default_compression("q8")

    def body(rank):
        from mpi4torch_tpu_torch import config as c

        codec = c.default_compression()
        return (c.ctl_enabled(), c.ctl_drift_thresholds(),
                getattr(codec, "name", codec))

    outs = mpi.run_ranks(body, 2, backend="process", device=CPU,
                         timeout=60.0)
    assert outs == [(True, (0.25, 0.75), "q8")] * 2


# ---------------------------------------------------------------- ledger


def _ledger(pkg):
    led = pkg.DecisionLedger()
    led.record(3, "crossover", tier=2, ratio=0.01,
               estimates=(None, 2e6, 1e3),
               old={"winner": "synth:aa", "codec": "synth",
                    "weighted_cost": 9.0, "tier_wire": (0, 0, 4096)},
               new={"winner": "synth:bb", "codec": "synth_q8",
                    "weighted_cost": 2.5, "tier_wire": (0, 0, 1024)})
    led.record(4, "recovery", ratio=0.9, new={"restored": ["compression"]})
    led.record(5, "fault", policy="codec_escalate",
               new={"codec": "q8"}, note="policy=codec_escalate slow=(1,)")
    led.record(6, "drift", tier=0, ratio=0.456789,
               old={"algorithm": "ring"}, new={"winner": "synth:cc"})
    return led


def test_ledger_json_and_table_equal_jax(tmp_path):
    led, jled = _ledger(ctl), _ledger(jctl)
    assert led.to_json() == jled.to_json()
    assert led.format_table() == jled.format_table()
    assert led.triggers() == jled.triggers() and len(led) == 4
    path = led.dump(str(tmp_path / "ledger.json"))
    assert json.load(open(path)) == json.loads(jled.to_json())
    assert ctl.DecisionLedger().format_table() == \
        jctl.DecisionLedger().format_table()
    for pkg in (ctl, jctl):
        with pytest.raises(ValueError):
            pkg.DecisionLedger().record(5, "vibes")
    assert ctl.TRIGGER_KINDS == jctl.TRIGGER_KINDS
    assert ctl.POLICY_TRIGGER == jctl.POLICY_TRIGGER
    assert cmain.LEDGER_COVERED == jmain.LEDGER_COVERED


def test_registry_guard_equals_jax(monkeypatch):
    from mpi4torch_tpu.analyze.registry import ctl_problems as jprob

    assert cmain.ctl_problems() == [] == jprob()
    for main, pkg in ((cmain, ctl), (jmain, jctl)):
        monkeypatch.setattr(main, "LEDGER_COVERED", ("drift", "fault"))
        monkeypatch.setitem(pkg.controller.POLICY_TRIGGER, "ghost",
                            "vibes")
    assert cmain.ctl_problems() == jprob()
    assert len(cmain.ctl_problems()) == 3


# ------------------------------------------------------------ controller


def _controller(pkg, cfg, **kw):
    cfg.set_ctl_enabled(True)
    cfg.set_ctl_halflife(1.0)
    cfg.set_ctl_drift_patience(2)
    if pkg is ctl:
        kw["device"] = CPU
    return pkg.SelfTuningController(n_ranks=NR, tiers=TIERS,
                                    nbytes=1 << 14, persist=False, **kw)


def _decision(d):
    return None if d is None else d.to_dict()


@pytest.mark.parametrize("script", ["drift", "crossover", "hysteresis"])
def test_controller_decisions_equal_jax(script):
    def run(main, pkg, cfg):
        c = _controller(pkg, cfg)
        out = []
        try:
            c.observe(main.synthetic_round(0, 1e6))
            out.append(c.calibrate())
            sag = 0.4e6 if script == "drift" else 1e3
            if script == "hysteresis":
                cfg.set_ctl_min_switch_epochs(5)
            for i, bw in enumerate((sag, sag, 1e6, 1e6, 1e6, 1e6)):
                if script == "hysteresis" and i == 4:
                    cfg.set_ctl_min_switch_epochs(1)
                out.append(_decision(c.poll(
                    main.synthetic_round(NR * (i + 1), bw))))
                codec = cfg.default_compression()
                out.append((getattr(codec, "name", codec),
                            cfg.tier_bandwidths(), c.runtime.epoch,
                            c._escalated))
            out.append(c.ledger.to_json())
            out.append(c.check().states)
        finally:
            c.reset()
        return out

    ours, theirs = _both(run)
    assert ours == theirs
    triggers = [d["trigger"] for d in ours if isinstance(d, dict)]
    want = {"drift": ["drift", "recovery"],
            "crossover": ["crossover", "recovery"],
            "hysteresis": ["crossover", "recovery"]}[script]
    assert triggers == want


def test_drift_rerank_installs_with_online_provenance():
    d1, d2, ent = cmain.drift_rerank(CPU)
    assert d1 is None and d2.trigger == "drift"
    assert ent == d2.new["installed"]
    full = tune.lookup("allreduce", "float32", 1 << 14, NR,
                       platform="cpu", codec="synth", tiers=TIERS)
    assert full["ctl"] == {"provenance": "online-switched",
                           "epoch": d2.epoch, "trigger": "drift"}


def test_fault_fast_path_shares_ledger_and_epoch():
    def run(main, pkg, cfg):
        c = _controller(pkg, cfg)
        try:
            tr = c.apply("codec_escalate")
            out = (c.ledger.triggers(), _decision(list(c.ledger)[-1]),
                   tr.epoch, c.runtime.epoch)
        finally:
            c.reset()
        return out, cfg.default_compression()

    ours, theirs = _both(run)
    assert ours == theirs
    assert ours[0][0] == ["fault"] and ours[1] is None


def test_controller_refusals_and_inert_when_disabled():
    with pytest.raises(ctl.CtlError) as pe:
        SelfTuningController(n_ranks=NR, tiers=(2, 2), device=CPU)
    with pytest.raises(jctl.CtlError) as je:
        jctl.SelfTuningController(n_ranks=NR, tiers=(2, 2))
    assert str(pe.value) == str(je.value)
    c = SelfTuningController(n_ranks=NR, tiers=TIERS, device=CPU)
    before = config.snapshot_process_state()
    assert c.poll() is None
    assert c.poll(cmain.synthetic_round(0, 1.0)) is None
    assert config.snapshot_process_state() == before
    assert len(c.ledger) == 0
    assert c.estimator.tier_samples() == (0, 0, 0)
    config.set_tier_stack((4, 2))
    assert SelfTuningController(n_ranks=NR, device=CPU).tiers == (4, 2)


# ----------------------------------------------------------- closed loop


def _jax_synthesis(dec, declared=(1.0, 1.0, 1.0)):
    """JAX's tier synthesis under the live vector the escalation ratified
    (the sagged tier's declared weight times its ratio)."""
    live = tuple(b * (max(dec.ratio, 1e-6) if t == dec.tier else 1.0)
                 for t, b in enumerate(declared))
    return jcsched.synthesize_tiers(NR, 4096, 4, tiers=TIERS,
                                    tier_bandwidths=live, codec="q8")


@pytest.mark.parametrize("tiers,backend", [
    ((2, 2, 2), "thread"),
    ((8,), "thread"),
    ((2, 2, 2), "process"),
    pytest.param((8,), "process", marks=pytest.mark.slow),
])
def test_brownout_escalate_recover_round_trip(tiers, backend):
    ev = cmain.closed_loop_episode(n=NR, tiers=tiers, backend=backend,
                                   device=CPU)
    assert cmain.closed_loop_problems(ev) == []
    esc, rec = ev["escalation"], ev["recovery"]
    assert ev["ledger"].triggers() == ["crossover", "recovery"]
    assert (esc.epoch, rec.epoch) == (1, 2)
    assert ev["bandwidths_during"] is not None
    if len(tiers) > 1:
        res = _jax_synthesis(esc)
        assert esc.old == {"winner": res["exact_winner"], "codec": "synth",
                           "tier_wire": tuple(res["exact_tier_wire"]),
                           "weighted_cost": res["exact_weighted_cost"]}
        assert {k: v for k, v in esc.new.items() if k != "installed"} == {
            "winner": res["winner"], "codec": "synth_q8",
            "compression": "q8", "tier_wire": tuple(res["tier_wire"]),
            "weighted_cost": res["weighted_cost"]}
        assert esc.new["installed"] == res["winner"]
        assert res["program"].digest() == \
            esc.new["installed"].split(":", 1)[1]
        assert ev["tune_entry"]["ctl"]["trigger"] == "crossover"


def test_escalated_winner_runs_bitwise_its_interpreter():
    """In the escalated configuration the installed q8-slow winner, named
    at its bucket, is bitwise the port's and JAX's interpreters of the
    installed program on the same rows; the watermarks are the
    :data:`WATERMARKS` of the measured ratio (JAX's fixed (0.15, 0.3) at
    the half of exact that JAX's wire reads), and the knobs come back."""
    import jax.numpy as jnp

    assert tuple(f * 0.5 for f in cmain.WATERMARKS) == (0.15, 0.3)
    before = config.ctl_drift_thresholds()
    ev = cmain.closed_loop_episode(n=NR, tiers=TIERS, backend="thread",
                                   device=CPU,
                                   on_escalated=cmain.installed_allreduce)
    assert cmain.closed_loop_problems(ev) == []
    run = ev["on_escalated"]
    assert run["name"] == ev["escalation"].new["installed"]
    assert run["slot"] == "synth_q8" and run["q8_steps"] >= 1
    oracle = cmain.installed_oracle(run)
    assert all(np.array_equal(r, oracle) for r in run["results"])
    jprog = jcsched.synthesize_tiers(
        NR, 4096, 4, tiers=TIERS,
        tier_bandwidths=(1.0, 1.0, max(ev["escalation"].ratio, 1e-6)),
        codec="q8")["program"]
    want = jcsched.interpret_allreduce(
        jprog, jmpi.MPI_SUM, [jnp.asarray(r) for r in run["rows"]])
    assert np.array_equal(oracle, np.asarray(want))
    h = ev["healthy"]
    assert 0 < h["ratio"] <= 1
    assert h["watermarks"] == tuple(f * h["ratio"] for f in cmain.WATERMARKS)
    assert h["exact"]["events"] == h["q8"]["events"] \
        == cmain.HEALTHY_PAIRS * NR
    assert len(h["pairs"]) == cmain.HEALTHY_PAIRS
    assert h["codec"]["encode_ms"] > 0 and h["codec"]["decode_ms"] > 0
    assert config.ctl_drift_thresholds() == before


def test_stale_fence_names_epochs():
    c = SelfTuningController(n_ranks=4, tiers=(4,), device=CPU)
    stale = c.runtime.view
    c.runtime.consensus()
    with pytest.raises(StaleEpochError) as ei:
        c.runtime.run_phase(lambda pos, rid: None, view=stale)
    assert (ei.value.have, ei.value.want) == (stale.epoch, c.runtime.epoch)


# -------------------------------------------------------------- off path


def test_disabled_controller_changes_nothing():
    from mpi4torch_tpu_torch.csched.synth import installed

    before = cmain.off_path_run(CPU)
    snap = config.snapshot_process_state()
    progs = sorted(installed())
    c = SelfTuningController(n_ranks=NR, tiers=TIERS, device=CPU)
    assert [c.poll(), c.poll(cmain.synthetic_round(0, 1.0))] == [None, None]
    after = cmain.off_path_run(CPU)
    assert before[1] and before[1] == after[1]
    assert before[2] and before[2] == after[2]
    assert torch.equal(before[0], after[0])
    assert all(torch.equal(a, b) for a, b in zip(before[3], after[3]))
    assert config.snapshot_process_state() == snap
    assert sorted(installed()) == progs


def _tiny_engine():
    from mpi4torch_tpu_torch.models import transformer as T
    from mpi4torch_tpu_torch.serve import Engine, ServeConfig

    cfg = T.TransformerConfig(vocab=37, d_model=16, n_heads=4,
                              n_layers=2, d_ff=32, max_seq=24)
    params = T.init_transformer(0, cfg, dtype=torch.float64, device=CPU)
    return Engine(cfg, params, ServeConfig(slots=2), device=CPU)


def test_engine_consults_controller_between_steps():
    class _Probe:
        polls = 0

        def poll(self):
            _Probe.polls += 1

    eng = _tiny_engine()
    eng.attach_controller(_Probe())
    eng.submit(np.array([1, 2, 3]), max_new=2)
    eng.step()
    eng.step()
    assert _Probe.polls == 2
    eng.attach_controller(None)
    eng.step()
    assert _Probe.polls == 2


def test_engine_tokens_unchanged_by_disabled_controller():
    def serve(attach):
        eng = _tiny_engine()
        if attach:
            eng.attach_controller(SelfTuningController(
                n_ranks=1, tiers=(1,), device=CPU))
        for p in ([1, 2, 3], [4, 5], [6, 7, 8, 9]):
            eng.submit(np.array(p), max_new=4)
        return {k: v.tolist() for k, v in eng.run().items()}

    assert serve(True) == serve(False)


def test_tune_rows_render_online_switched():
    from mpi4torch_tpu.tune.__main__ import _rows as jrows
    from mpi4torch_tpu_torch.tune.__main__ import _rows

    data = {"entries": {
        "allreduce|float32|16384|8|cpu|codec=synth_q8|tiers=2x2x2":
            {"algorithm": "synth:abcdef",
             "program": {"phases": [{"steps": [{}, {}]}]},
             "ctl": {"provenance": "online-switched", "epoch": 3,
                     "trigger": "crossover"}},
        "allreduce|float32|16384|8|cpu":
            {"algorithm": "ring", "measurements": {"ring": 1.0}},
    }}
    assert _rows(data) == jrows(data)
    sources = {r[6]: r[7] for r in _rows(data)}
    assert sources["synth:abcdef"] == \
        "online-switched(crossover@epoch 3, 2 steps)"
