"""``python -m mpi4torch_tpu_torch.ctl --smoke [--device cpu]`` — the
controller's smoke lane.

Port of ``mpi4torch_tpu/ctl/__main__.py``.  What it proves, exiting
non-zero on ANY divergence:

* **registry sync** — the ledger's trigger vocabulary, this lane's
  coverage literal (:data:`LEDGER_COVERED`) and the degrade-policy
  delegation map move together (:func:`ctl_problems`);
* **estimator units** — per-tier attribution of a synthetic CommEvent
  stream matches the census rule (``csched.tier_of_group``) and the
  EWMA math is exact;
* **no-flap hysteresis** — ratios oscillating inside the watermark
  band never flip a tier's drift state;
* **drift re-rank** — a mild sag re-ranks the exact winner under the
  live bandwidth vector and installs it in the tune cache;
* **closed loop** — an injected ``brownout`` on real traffic drives the
  controller through consensus to the q8/synth_q8 winner (bitwise vs
  the explicit-q8 oracle), a stale view is FENCED
  (``StaleEpochError``), the decision ledger names the trigger with the
  weighted-cost improvement pinned, and clearing the fault
  de-escalates back to the exact pre-episode configuration (bitwise vs
  the pre-episode result);
* **fault fast path** — ``apply("codec_escalate")`` runs through the
  same ratified switch and lands in the same ledger with trigger
  ``fault``;
* **off path** — with ``config.ctl_enabled()`` False (the default),
  ``poll`` returns None, the config snapshot is untouched, and a Mode A
  Allreduce runs the same programs and exchanges to the same values (the
  port's stand-in for JAX's bit-identical lowering text);
* **coverage** — the union of triggers the cells recorded equals
  :data:`LEDGER_COVERED` (no vacuous coverage literal).

``--device`` picks the device of the rank worlds (default: CUDA).
"""

from __future__ import annotations

import sys
from typing import List

# The guard's one home is the analyze registry (which reads
# LEDGER_COVERED below when it runs).
from ..analyze.registry import ctl_problems

#: The trigger kinds the cells below actually drive through the ledger;
#: :func:`ctl_problems` compares this against ``ledger.TRIGGER_KINDS``
#: — add a trigger, add a cell.
LEDGER_COVERED = ("drift", "crossover", "recovery", "fault")


def _fail(failures: list, msg: str) -> None:
    failures.append(msg)
    print(f"FAIL: {msg}")


def _ok(msg: str) -> None:
    print(f"ok  : {msg}")


# ---------------------------------------------------------------------------
# Synthetic event stream helpers
# ---------------------------------------------------------------------------

def synthetic_event(seq: int, rank: int, bw: float, *,
                    nbytes: int = 4096, group_size=None,
                    world_size: int = 8, **kw):
    """A measurable exchange CommEvent whose (bytes, duration) encode
    the given bandwidth exactly — the estimator unit-test currency."""
    from ..obs.events import CommEvent

    fields = dict(seq=seq, rank=rank, world=0, world_size=world_size,
                  channel="exchange", op="Allreduce",
                  payload_bytes=nbytes, duration_s=nbytes / bw,
                  family="all_reduce", group_size=group_size)
    fields.update(kw)
    return CommEvent(**fields)


def synthetic_round(seq0: int, bw: float, *, nranks: int = 8,
                    nbytes: int = 4096, group_size=None):
    """One whole-world round: ``nranks`` events at bandwidth ``bw``."""
    return [synthetic_event(seq0 + r, r, bw, nbytes=nbytes,
                            group_size=group_size,
                            world_size=nranks)
            for r in range(nranks)]


# ---------------------------------------------------------------------------
# The closed-loop brownout episode
# ---------------------------------------------------------------------------

#: The seconds the episode's brownout adds to one exact run of its
#: payload (``per_byte_s`` = this over the payload's bytes): far above a
#: healthy run's barrier waits (milliseconds on rank threads, tens of
#: milliseconds on a loaded host), so the browned goodput sits far below
#: the low watermark.  The JAX package's 5e-5 s/B on 4 KiB is 0.2 s.
BROWNOUT_S = 1.0

#: The healthy rounds the episode runs at most before the recovery must
#: have ratified.
RECOVERY_ROUNDS = 32

#: The back-to-back exact and q8 runs whose median goodput ratio sets
#: the watermarks.
HEALTHY_PAIRS = 3

#: The drift watermarks as fractions of the healthy q8/exact goodput
#: ratio the episode measures.  The JAX package fixes (0.15, 0.3) for a
#: wire whose healthy q8 reads about half of exact: these fractions of
#: 0.5.  Recovery must trip on "well above the sag", not "back at the
#: exact baseline".
WATERMARKS = (0.3, 0.6)


def wire_split(events) -> dict:
    """The healthy wire's goodput (logical bytes over the exchange
    events' wall time) and the mean event split into barrier wait and
    the rest (the read and decode after the rendezvous), over a traced
    run's measurable events."""
    from .controller import CtlError
    from .estimate import _measurable, goodput_bytes

    evs = [e for e in events if _measurable(e)]
    if not evs:
        raise CtlError("no measurable exchange event in a healthy run")
    dur = sum(e.duration_s for e in evs)
    wait = sum(e.wait_s for e in evs)
    return {"events": len(evs),
            "goodput": sum(goodput_bytes(e) for e in evs) / dur,
            "duration_ms": dur / len(evs) * 1e3,
            "wait_ms": wait / len(evs) * 1e3}


def codec_split(payload: int, device, reps: int = 20) -> dict:
    """One rank's host time (ms, the mean of ``reps`` calls after a warm
    one, the device synchronised) for the q8 codec on the episode's
    payload: one encode, and one decode (a rank's read decodes one for
    every rank).
    Every rank of a q8 Allgather encodes before its rendezvous, so the
    ranks' encodes show up in each other's barrier waits."""
    import time

    import torch

    from ..compress import get_codec
    from ..runtime import resolve_device

    dev = resolve_device(device)
    base = get_codec("q8").base()
    x = torch.linspace(-2.0, 2.0, payload, dtype=torch.float32, device=dev)

    def timed(fn):
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) / reps * 1e3

    payload_, meta = base.encode(x)
    return {"encode_ms": timed(lambda: base.encode(x)),
            "decode_ms": timed(lambda: base.decode(payload_, meta))}


def closed_loop_episode(*, n: int = 8, tiers=(2, 2, 2),
                        backend: str = "thread",
                        payload: int = 1024,
                        per_byte_s=None,
                        timeout: float = 60.0, device=None,
                        on_escalated=None) -> dict:
    """Run the full measure→escalate→recover episode with REAL
    rank-world traffic and a REAL brownout fault, and return the
    evidence: ``exact_before`` / ``escalated`` / ``recovered`` per-rank
    results (numpy), ``oracle_q8`` (the explicit ``compression="q8"``
    run the escalated phase must match bitwise), the escalation and
    recovery :class:`~.ledger.Decision` records, the fired brownout
    evidence split by phase, the stale-fence outcome, and the final
    config deltas.  The caller asserts; this function only collects.

    ``device`` is the rank worlds' (CUDA unless ``"cpu"``);
    ``per_byte_s`` the brownout's throttle (default :data:`BROWNOUT_S`
    over the payload's bytes).  The watermarks are :data:`WATERMARKS` of
    the healthy q8/exact goodput ratio of this wire: the median over
    :data:`HEALTHY_PAIRS` back-to-back exact and q8 runs, so that a swing
    of the host's load between the two wires' runs does not set them
    (``ev["healthy"]``: each pair's ratio, :func:`wire_split` of each
    wire's runs, and :func:`codec_split`, one rank's encode and decode of
    the payload).
    ``on_escalated(ctl)``, when given, runs once in the escalated
    configuration after the escalated run, under a tracer of its own (the
    controller never sees its traffic); its result is
    ``ev["on_escalated"]``."""
    import torch

    import mpi4torch_tpu_torch as mpi
    from .. import config as _cfg, obs
    from ..elastic.membership import StaleEpochError
    from ..resilience.faults import FaultSpec, fault_scope
    from .controller import SelfTuningController

    comm = mpi.COMM_WORLD
    nbytes = payload * 4
    if per_byte_s is None:
        per_byte_s = BROWNOUT_S / nbytes
    ev: dict = {"backend": backend, "tiers": tuple(tiers), "n": n,
                "per_byte_s": per_byte_s}

    def body(rank, compression=None):
        # ONE call site for every phase: compression=None reads the
        # PROCESS-wide default the controller's escalation flips, so
        # the exact and escalated phases run the same code.  Allgather:
        # its q8 wire carries ENCODED payloads, so the codec flip
        # shrinks the bytes the brownout throttles.
        x = torch.linspace(-2.0, 2.0, payload, dtype=torch.float32,
                           device=comm.device) * (rank + 1)
        return comm.Allgather(x, 0, compression=compression)

    def run(compression=None):
        outs = mpi.run_ranks(
            lambda r: body(r, compression=compression), n,
            backend=backend, timeout=timeout, device=device)
        return [o.detach().cpu().numpy() for o in outs]

    snap = _cfg.snapshot_process_state()
    ctl = None
    _cfg.set_ctl_enabled(True)
    _cfg.set_ctl_halflife(1.0)
    _cfg.set_ctl_drift_patience(2)
    _cfg.set_ctl_min_switch_epochs(1)
    try:
        # The healthy wires, each run under a tracer of its own (none is
        # the controller's sample), after untraced first calls: a first
        # call's one-time costs would read as a slow wire.
        run()
        run(compression="q8")
        pairs, traced = [], {"exact": [], "q8": []}
        for _ in range(HEALTHY_PAIRS):
            split = {}
            for wire, comp in (("exact", None), ("q8", "q8")):
                with obs.trace() as t:
                    run(compression=comp)
                traced[wire] += t.events
                split[wire] = wire_split(t.events)
            pairs.append(split["q8"]["goodput"] / split["exact"]["goodput"])
        ratio = min(sorted(pairs)[len(pairs) // 2], 1.0)
        low, high = (f * ratio for f in WATERMARKS)
        ev["healthy"] = {"exact": wire_split(traced["exact"]),
                         "q8": wire_split(traced["q8"]), "pairs": pairs,
                         "ratio": ratio, "watermarks": (low, high),
                         "codec": codec_split(payload, device)}
        # Knobs FIRST: the controller's estimator/monitor adopt the
        # halflife, patience and watermarks at construction.
        _cfg.set_ctl_drift_thresholds(low, high)
        ctl = SelfTuningController(n_ranks=n, tiers=tiers, nbytes=nbytes,
                                   persist=False, device=device)
        # The oracle is pinned BEFORE the episode: the escalated phase
        # must equal an explicitly-q8 run bitwise.
        ev["oracle_q8"] = run(compression="q8")
        with obs.trace() as tracer:
            ev["exact_before"] = run()
            run()
            ctl.observe()
            ctl.calibrate()
            ev["healthy_poll"] = ctl.poll()     # must be None
            view_before = ctl.runtime.view
            spec = FaultSpec("brownout", op="Allgather",
                             per_byte_s=per_byte_s, count=10 ** 6)
            with fault_scope([spec]) as plan:
                run()
                ev["patience_poll"] = ctl.poll()  # 1st sag: patience
                run()
                ev["escalation"] = ctl.poll()     # 2nd sag: switch
                n_exact_fired = len(plan.fired)
                ev["escalated"] = run()           # rides the q8 wire
                ev["fired_exact"] = [f.info for f in
                                     plan.fired[:n_exact_fired]
                                     if f.info]
                ev["fired_q8"] = [f.info for f in
                                  plan.fired[n_exact_fired:]
                                  if f.info]
            if on_escalated is not None:
                with obs.trace():
                    ev["on_escalated"] = on_escalated(ctl)
            # A phase prepared against the pre-switch view is FENCED.
            try:
                ctl.runtime.run_phase(lambda pos, rid: None,
                                      view=view_before)
                ev["stale_fenced"] = False
            except StaleEpochError as e:
                ev["stale_fenced"] = (e.have == view_before.epoch
                                      and e.want == ctl.runtime.epoch)
            ev["compression_during"] = getattr(
                _cfg.default_compression(), "name",
                _cfg.default_compression())
            ev["bandwidths_during"] = _cfg.tier_bandwidths()
            # Fault cleared: healthy rounds walk the monitor back above
            # the high watermark; poll until the recovery ratifies
            # (bounded: on a loaded host a round's goodput swings several
            # fold and resets the patience counter, so the bound is
            # RECOVERY_ROUNDS, where the JAX package's is 8).
            ev["recovery"] = None
            for _ in range(RECOVERY_ROUNDS):
                run()
                d = ctl.poll()
                if d is not None:
                    ev["recovery"] = d
                    break
            ev["recovered"] = run()
        ev["compression_after"] = _cfg.default_compression()
        ev["bandwidths_after"] = _cfg.tier_bandwidths()
        ev["ledger"] = ctl.ledger
        ev["epochs"] = [d.epoch for d in ctl.ledger]
        ev["tune_entry"] = _installed_entry(ctl)
        ev["estimates"] = ctl.estimator.tier_estimates()
    finally:
        _cfg.apply_process_state(snap)
        if ctl is not None:
            ctl.reset()
    return ev


def installed_allreduce(ctl, seed: int = 0):
    """One Allreduce of the winner the controller's escalation installed,
    at the bucket it was installed for, on the controller's world, named
    explicitly (auto selection never reads the lossy ``synth_q8`` slot:
    compressed tier programs are opt-in, ``csched.synth``), over seeded
    rows.  None when no winner was installed; :func:`installed_oracle`
    interprets the installed program on the same rows."""
    import numpy as np
    import torch

    import mpi4torch_tpu_torch as mpi
    from .. import csched
    from ..runtime import resolve_device

    ent = _installed_entry(ctl)
    if ent is None:
        return None
    name, n = ent["algorithm"], ctl.runtime.view.size
    rows = np.random.default_rng(seed).standard_normal(
        (n, ctl.nbytes // ctl.itemsize)).astype(np.float32)
    dev = resolve_device(ctl.runtime.device)

    def body(r):
        x = torch.from_numpy(rows[r]).to(mpi.COMM_WORLD.device)
        # compression=False: the program carries its own codec steps.
        return mpi.COMM_WORLD.Allreduce(x, mpi.MPI_SUM, compression=False,
                                        algorithm=name)

    outs = mpi.run_ranks(body, n, device=dev)
    prog = csched.installed_program(name, n)
    return {"name": name, "slot": ent["slot"], "rows": rows, "device": dev,
            "q8_steps": sum(s.kind == "q8_level_fold" for ph in prog.phases
                            for s in ph.steps),
            "results": [o.detach().cpu().numpy() for o in outs]}


def installed_oracle(run):
    """The csched interpreter of ``run``'s installed program on its rows
    (numpy): what every rank of :func:`installed_allreduce` must hold."""
    import torch

    import mpi4torch_tpu_torch as mpi
    from .. import csched

    prog = csched.installed_program(run["name"], len(run["rows"]))
    out = csched.interpret_allreduce(
        prog, mpi.MPI_SUM,
        [torch.from_numpy(r).to(run["device"]) for r in run["rows"]])
    return out.detach().cpu().numpy()


def _installed_entry(ctl):
    """The tune-cache entry the escalation installed (None when the
    search found no distinct lossy winner — the flat-stack case)."""
    from ..tune.autotuner import lookup

    for slot in ("synth_q8", "synth"):
        ent = lookup("allreduce", ctl.dtype, ctl.nbytes,
                     ctl.runtime.view.size, platform=ctl.platform(),
                     codec=slot, tiers=ctl.tiers)
        if ent is not None and ent.get("ctl"):
            return dict(ent, slot=slot)
    return None


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def _cell_guard(failures) -> None:
    probs = ctl_problems()
    for p in probs:
        _fail(failures, f"[registry] {p}")
    if not probs:
        _ok("registry: trigger kinds == ledger coverage == "
            "degrade-policy delegation map")


def _cell_estimator(failures) -> None:
    from .estimate import BandwidthEstimator

    est = BandwidthEstimator((2, 2, 2), halflife=1.0)
    events = []
    # Whole-world traffic charges the top tier; group-of-2 the inner
    # tier; group-of-4 the middle — the census attribution rule.
    events += synthetic_round(0, 1e6)
    events += [synthetic_event(8, 0, 2e6, group_size=2),
               synthetic_event(9, 0, 4e6, group_size=4)]
    n = est.ingest(events)
    tiers = est.tier_estimates()
    okays = (n == 10
             and abs(tiers[2] - 1e6) < 1e-6
             and abs(tiers[0] - 2e6) < 1e-6
             and abs(tiers[1] - 4e6) < 1e-6)
    if not okays:
        _fail(failures, f"estimator attribution/EWMA off: ingested "
                        f"{n}, tiers={tiers}")
        return
    # Cursor: re-ingesting the same events adds nothing; bookkeeping
    # and failed events are never samples.
    n2 = est.ingest(events)
    n3 = est.ingest([synthetic_event(10, 0, 9e9, bookkeeping=True,
                                     family=None),
                     synthetic_event(11, 0, 9e9, status="Timeout")])
    if n2 or n3:
        _fail(failures, f"estimator counted stale/bookkeeping/failed "
                        f"events ({n2}, {n3})")
        return
    # EWMA halflife: one more top-tier sample at half the bandwidth
    # with halflife=1 (alpha=1/2) lands exactly between.
    est.ingest([synthetic_event(12, 0, 5e5)])
    if abs(est.tier_estimates()[2] - 7.5e5) > 1e-6:
        _fail(failures, f"EWMA halflife math off: "
                        f"{est.tier_estimates()[2]}")
        return
    _ok("estimator: census-rule tier attribution, cursor, filters and "
        "EWMA halflife exact on a synthetic stream")


def _cell_no_flap(failures) -> None:
    from .drift import DriftMonitor
    from .estimate import BandwidthEstimator

    est = BandwidthEstimator((2, 2, 2), halflife=1.0)
    mon = DriftMonitor(3, low=0.5, high=0.8, patience=2)
    est.ingest(synthetic_round(0, 1e6))
    mon.calibrate(est)
    seq = 8
    # Oscillate INSIDE the hysteresis band (0.5..0.8 of baseline) for
    # many checks: no state may ever change.
    flips = []
    for i in range(12):
        bw = 0.55e6 if i % 2 else 0.75e6
        est.ingest(synthetic_round(seq, bw))
        seq += 8
        rep = mon.check(est)
        flips += list(rep.changed.items())
    if flips or mon.states != ("ok", "ok", "ok"):
        _fail(failures, f"hysteresis flapped inside the band: "
                        f"{flips}, states={mon.states}")
        return
    # And a single sub-low excursion (patience 2) must not degrade.
    est.ingest(synthetic_round(seq, 0.2e6))
    rep = mon.check(est)
    est.ingest(synthetic_round(seq + 8, 1e6))
    est.ingest(synthetic_round(seq + 16, 1e6))
    rep2 = mon.check(est)
    if rep.changed or rep2.changed or not rep2.ok:
        _fail(failures, "a single sub-watermark excursion flipped the "
                        f"state ({rep.changed}, {rep2.changed})")
        return
    _ok("hysteresis: 12 in-band oscillations + a single excursion, "
        "zero state changes (the no-flap property)")


def drift_rerank(device=None):
    """Mild sag (below low, above the codec crossover) on a synthetic
    stream: returns the two polls' decisions and the tune-cache entry
    the second one installed."""
    from .. import config as _cfg, tune
    from .controller import SelfTuningController

    snap = _cfg.snapshot_process_state()
    _cfg.set_ctl_enabled(True)
    _cfg.set_ctl_halflife(1.0)
    _cfg.set_ctl_drift_patience(2)
    ctl = SelfTuningController(n_ranks=8, tiers=(2, 2, 2),
                               nbytes=1 << 14, persist=False,
                               device=device)
    try:
        ctl.observe(synthetic_round(0, 1e6))
        ctl.calibrate()
        d1 = ctl.poll(synthetic_round(8, 0.4e6))
        d2 = ctl.poll(synthetic_round(16, 0.4e6))
        ent = tune.lookup_algorithm("allreduce", "float32", 1 << 14, 8,
                                    platform=ctl.platform(),
                                    codec="synth", tiers=(2, 2, 2))
    finally:
        _cfg.apply_process_state(snap)
        ctl.reset()
    return d1, d2, ent


def _cell_drift_rerank(failures, device) -> None:
    """Mild sag re-ranks the EXACT winner under the live bandwidth
    vector — trigger ``drift``, no codec flip."""
    d1, d2, ent = drift_rerank(device)
    if d1 is not None:
        _fail(failures, "drift switch fired before patience ran out")
        return
    if d2 is None or d2.trigger != "drift":
        _fail(failures, f"expected a drift decision, got {d2!r}")
        return
    live = d2.new.get("weighted_cost")
    prior = d2.old.get("weighted_cost")
    if not (live is not None and prior is not None
            and live <= prior):
        _fail(failures, f"re-ranked winner does not improve the live "
                        f"weighted cost ({prior} -> {live})")
        return
    if d2.new.get("installed") is None or ent != d2.new["installed"]:
        _fail(failures, f"drift switch install not in the tune cache "
                        f"(decision {d2.new.get('installed')!r}, "
                        f"cache {ent!r})")
        return
    _ok(f"drift re-rank: tier {d2.tier} at {d2.ratio:.2f} -> exact "
        f"winner {d2.new['winner']} installed at epoch {d2.epoch}, "
        f"live cost {prior:.4g}->{live:.4g}, codec untouched")


def closed_loop_problems(ev) -> List[str]:
    """What a closed-loop episode's evidence (:func:`closed_loop_episode`)
    fails of the contract; empty when it holds."""
    import numpy as np

    esc, rec = ev["escalation"], ev["recovery"]
    if ev["healthy_poll"] is not None or ev["patience_poll"] is not None:
        return ["controller switched without drift evidence (healthy or "
                "within-patience poll acted)"]
    if esc is None or esc.trigger != "crossover":
        return [f"expected a crossover escalation, got {esc!r}"]
    if ev["compression_during"] != "q8":
        return ["escalation did not flip the process-wide codec (got "
                f"{ev['compression_during']!r})"]
    probs = []
    if any(not np.array_equal(got, want)
           for got, want in zip(ev["escalated"], ev["oracle_q8"])):
        probs.append("escalated phase diverges from the explicit-q8 "
                     "oracle (bitwise)")
    if not (ev["fired_exact"] and ev["fired_q8"]):
        probs.append("vacuous cell: brownout did not fire in both phases")
    elif not (max(f["bytes"] for f in ev["fired_q8"])
              < max(f["bytes"] for f in ev["fired_exact"])):
        probs.append("q8 wire did not shrink the throttled bytes")
    if ev["stale_fenced"] is not True:
        probs.append("stale pre-switch view was NOT fenced")
    if rec is None or rec.trigger != "recovery":
        probs.append(f"expected a recovery decision, got {rec!r}")
        return probs
    if ev["compression_after"] is not None \
            or ev["bandwidths_after"] is not None:
        probs.append("recovery did not restore the pre-episode knobs")
    if any(not np.array_equal(got, want)
           for got, want in zip(ev["recovered"], ev["exact_before"])):
        probs.append("recovered phase diverges from the pre-episode "
                     "exact result (bitwise)")
    if not rec.epoch > esc.epoch:
        probs.append(f"epochs not monotone: {ev['epochs']}")
    if len(ev["tiers"]) > 1:
        if not esc.new.get("weighted_cost") < esc.old.get("weighted_cost"):
            probs.append("weighted-cost improvement not pinned")
        wire_old = esc.old.get("tier_wire", ())
        wire_new = esc.new.get("tier_wire", ())
        if not (wire_old and wire_new and wire_new[-1] < wire_old[-1]):
            probs.append(f"outer-tier wire did not shrink: {wire_old} -> "
                         f"{wire_new}")
        ent = ev["tune_entry"]
        if ent is None or ent.get("ctl", {}).get("provenance") \
                != "online-switched" or ent["ctl"]["epoch"] != esc.epoch:
            probs.append("installed winner carries no online-switched "
                         "provenance at the escalation's epoch")
    return probs


def _cell_closed_loop(failures, device) -> None:
    import numpy as np

    ev = closed_loop_episode(n=8, tiers=(2, 2, 2), backend="thread",
                             device=device,
                             on_escalated=installed_allreduce)
    probs = closed_loop_problems(ev)
    run = ev.get("on_escalated")
    if run is None or run["name"] != ev["escalation"].new.get("installed"):
        probs.append("the escalation installed no winner to run")
    elif not all(np.array_equal(r, installed_oracle(run))
                 for r in run["results"]):
        probs.append(f"the installed {run['name']} diverges from the "
                     "interpreter of its program (bitwise)")
    for p in probs:
        _fail(failures, p)
    if probs:
        return
    esc, rec, h = ev["escalation"], ev["recovery"], ev["healthy"]
    b_exact = max(f["bytes"] for f in ev["fired_exact"])
    b_q8 = max(f["bytes"] for f in ev["fired_q8"])
    _ok(f"closed loop: healthy exact / q8 event "
        f"{h['exact']['duration_ms']:.3f} / {h['q8']['duration_ms']:.3f} ms "
        f"(barrier wait "
        f"{h['exact']['wait_ms']:.3f} / {h['q8']['wait_ms']:.3f} ms; q8 "
        f"encode {h['codec']['encode_ms']:.3f} ms, decode "
        f"{h['codec']['decode_ms']:.3f} ms a rank), q8/exact "
        f"goodput {h['ratio']:.3f} -> watermarks ({h['watermarks'][0]:.4f}, "
        f"{h['watermarks'][1]:.4f}); brownout -> crossover@epoch {esc.epoch} "
        f"(cost {esc.old['weighted_cost']:.4g}->"
        f"{esc.new['weighted_cost']:.4g}, outer wire "
        f"{esc.old['tier_wire'][-1]}->{esc.new['tier_wire'][-1]}, "
        f"throttled bytes {b_exact}->{b_q8}), bitwise vs q8 oracle, "
        f"{run['name']} bitwise its interpreter, stale view fenced, "
        f"recovery@epoch {rec.epoch} bitwise vs pre-episode")


def _cell_fault_fast_path(failures, device) -> None:
    from .. import config as _cfg
    from .controller import SelfTuningController

    snap = _cfg.snapshot_process_state()
    ctl = SelfTuningController(n_ranks=4, tiers=(4,), persist=False,
                               device=device)
    try:
        tr = ctl.apply("codec_escalate")
        codec = getattr(_cfg.default_compression(), "name",
                        _cfg.default_compression())
        decs = list(ctl.ledger)
    finally:
        ctl.reset()
        _cfg.apply_process_state(snap)
    if codec != "q8":
        _fail(failures, f"fault fast path did not escalate the codec "
                        f"(got {codec!r})")
        return
    if not (decs and decs[-1].trigger == "fault"
            and decs[-1].policy == "codec_escalate"
            and decs[-1].epoch == tr.epoch):
        _fail(failures, f"fault transition not ledgered: {decs!r}")
        return
    if _cfg.default_compression() is not None:
        _fail(failures, "reset() did not restore the codec")
        return
    _ok(f"fault fast path: apply('codec_escalate') ran the SAME "
        f"ratified switch (epoch {tr.epoch}) and ledgered trigger "
        "'fault'; reset restored")


class ProgramLog:
    """Digests of every csched program the Mode A lowering builds and
    rank 0's ``World.exchange`` signatures, while entered: the port's
    stand-in for a lowering's text."""

    def __enter__(self):
        from .. import runtime
        from ..csched import programs

        self.digests, self.exchanges = [], []
        self._cached, self._exchange = programs.cached, \
            runtime.World.exchange
        cached, exchange = self._cached, self._exchange

        def logged_cached(build, *a, **kw):
            prog = cached(build, *a, **kw)
            if hasattr(prog, "digest"):
                self.digests.append(prog.digest())
            return prog

        def logged_exchange(w, rank, signature, *a, **kw):
            if rank == 0:
                self.exchanges.append(signature)
            return exchange(w, rank, signature, *a, **kw)

        programs.cached = logged_cached
        runtime.World.exchange = logged_exchange
        return self

    def __exit__(self, *exc):
        from .. import runtime
        from ..csched import programs

        programs.cached = self._cached
        runtime.World.exchange = self._exchange
        return False


def off_path_run(device=None, n: int = 8):
    """One Mode A Allreduce on ``n`` ranks and one eager Allreduce on
    rank threads: ``(mode_a_values, digests, exchanges, eager_values)``."""
    import torch

    import mpi4torch_tpu_torch as mpi

    x = torch.arange(n * 256, dtype=torch.float32,
                     device=mpi.resolve_device(device)).reshape(n, 256)

    def body(rows):
        return mpi.COMM_WORLD.Allreduce(rows[mpi.COMM_WORLD.rank],
                                        mpi.MPI_SUM)

    with ProgramLog() as log:
        out = mpi.run_spmd(body, nranks=n, device=device)(x)
    eager = mpi.run_ranks(
        lambda r: mpi.COMM_WORLD.Allreduce(
            x[r].clone(), mpi.MPI_SUM), n, device=device)
    return (out.cpu(), log.digests, log.exchanges,
            [e.cpu() for e in eager])


def _cell_off_path(failures, device) -> None:
    import torch

    from .. import config as _cfg
    from ..csched.synth import installed
    from .controller import SelfTuningController

    before = off_path_run(device)
    before_snap = _cfg.snapshot_process_state()
    before_installed = sorted(installed())
    ctl = SelfTuningController(n_ranks=8, tiers=(2, 2, 2), device=device)
    polls = [ctl.poll(), ctl.poll(synthetic_round(0, 1.0))]
    after = off_path_run(device)
    if polls != [None, None]:
        _fail(failures, f"disabled controller acted: {polls}")
        return
    after_snap = _cfg.snapshot_process_state()
    if after_snap != before_snap:
        _fail(failures, "disabled controller mutated config: "
              f"{ {k: (before_snap[k], after_snap[k]) for k in before_snap if before_snap[k] != after_snap[k]} }")
        return
    if sorted(installed()) != before_installed:
        _fail(failures, "disabled controller installed a program")
        return
    if before[1] != after[1] or before[2] != after[2] or not before[1]:
        _fail(failures, "controller-off Mode A Allreduce built other "
                        "programs or exchanges")
        return
    if not torch.equal(before[0], after[0]) or any(
            not torch.equal(a, b) for a, b in zip(before[3], after[3])):
        _fail(failures, "controller-off values differ")
        return
    if len(ctl.ledger) != 0:
        _fail(failures, "disabled controller wrote ledger decisions")
        return
    _ok("off path: ctl_enabled=False -> poll is a no-op, config "
        "snapshot untouched, Mode A Allreduce's programs "
        f"({len(before[1])} digests) and {len(before[2])} exchanges "
        "identical, values bitwise")


def _cell_ledger(failures) -> None:
    import json
    import os
    import tempfile

    from .ledger import DecisionLedger

    led = DecisionLedger()
    led.record(3, "crossover", tier=2, ratio=0.01,
               estimates=(None, 2e6, 1e3),
               old={"winner": "synth:aa", "codec": "synth",
                    "weighted_cost": 9.0, "tier_wire": (0, 0, 4096)},
               new={"winner": "synth:bb", "codec": "synth_q8",
                    "weighted_cost": 2.5, "tier_wire": (0, 0, 1024)})
    led.record(4, "recovery", new={"restored": ["compression"]})
    doc = json.loads(led.to_json())
    table = led.format_table()
    with tempfile.TemporaryDirectory() as td:
        path = led.dump(os.path.join(td, "ledger.json"))
        with open(path, "r", encoding="utf-8") as f:
            dumped = json.load(f)
    okays = (len(doc["decisions"]) == 2
             and doc == dumped
             and doc["decisions"][0]["trigger"] == "crossover"
             and doc["decisions"][0]["epoch"] == 3
             and "crossover" in table and "recovery" in table
             and "9->2.5" in table
             and "synth:bb[synth_q8]" in table)
    if not okays:
        _fail(failures, f"ledger dump/table round-trip broke:\n{table}")
        return
    try:
        led.record(5, "vibes")
    except ValueError:
        _ok("ledger: JSON == dumped file == table rows; unknown "
            "trigger kinds refused")
    else:
        _fail(failures, "ledger accepted an unregistered trigger kind")


def _smoke(device) -> int:
    from ..obs import metrics as _metrics
    from ..runtime import resolve_device
    from .ledger import TRIGGER_KINDS

    dev = resolve_device(device)
    print(f"ctl-smoke: device {dev}")

    failures: list = []
    _cell_guard(failures)
    _cell_estimator(failures)
    _cell_no_flap(failures)
    _cell_drift_rerank(failures, dev)
    _cell_closed_loop(failures, dev)
    _cell_fault_fast_path(failures, dev)
    _cell_off_path(failures, dev)
    _cell_ledger(failures)

    # The coverage literal is not allowed to be vacuous: the cells
    # above must have recorded every registered trigger kind.
    snap = _metrics.snapshot()
    seen = {t for t in TRIGGER_KINDS
            if snap.get("counters", {}).get(
                f'ctl_switches_total{{trigger="{t}"}}', 0) > 0}
    if seen != set(LEDGER_COVERED):
        _fail(failures, f"trigger coverage is vacuous: cells recorded "
                        f"{sorted(seen)}, literal says "
                        f"{sorted(LEDGER_COVERED)}")
    else:
        _ok(f"coverage: every trigger kind fired a ledgered switch "
            f"{sorted(seen)}")

    if failures:
        print(f"\nctl-smoke: {len(failures)} failure(s)")
        return 1
    print("\nctl-smoke: all cells passed")
    return 0


def main(argv) -> int:
    if "--smoke" in argv:
        device = argv[argv.index("--device") + 1] \
            if "--device" in argv else None
        return _smoke(device)
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
