"""The online self-tuning controller: measure → detect → re-rank →
ratify.

Port of ``mpi4torch_tpu/ctl/controller.py``.

:class:`SelfTuningController` closes the loop the repo's optimization
layers left open: the obs tracer measures, the estimator
(:mod:`.estimate`) folds measurements into live per-tier bandwidths,
the drift monitor (:mod:`.drift`) turns them into sticky verdicts, and
the controller re-runs the tier-stack synthesis
(``csched.synthesize_tiers``) under the LIVE bandwidth vector —
escalating to the q8/synth_q8 winner when a tier's estimate crosses
the codec crossover (the EQuARX regime), de-escalating symmetrically
when the link recovers.

**One switching mechanism.**  Every transition — drift re-rank, codec
crossover, recovery, AND the gray-failure fast path — funnels
through :func:`ratified_switch`: one ``ElasticRuntime.consensus``
round (epoch += 1, every rank ratifies the same view; a stale phase
raises ``StaleEpochError`` instead of running a bifurcated schedule),
then the process-wide mutation, then the decision-ledger record.
``DegradeController.apply`` delegates here too (see
``resilience/degrade.py``), so the fault-triggered path and the
measurement-triggered path are the same code with different triggers —
the delegation map :data:`POLICY_TRIGGER` is registry-sync guarded
against ``DEGRADE_POLICIES`` and the ledger's trigger vocabulary
(``analyze.registry.ctl_problems``).

Off path: ``config.ctl_enabled()`` is False by default and ``poll``
is one knob read — a controller constructed but disabled changes
NOTHING (the same programs and exchanges, untouched config).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..runtime import CommError
from ..resilience.degrade import DEGRADE_POLICIES, DegradeController
from .drift import DriftMonitor, DriftReport, live_bandwidths
from .estimate import BandwidthEstimator
from .ledger import Decision, DecisionLedger

__all__ = [
    "CtlError",
    "POLICY_TRIGGER",
    "ratified_switch",
    "SelfTuningController",
]


class CtlError(CommError):
    """The controller could not act (mis-sized tier stack, unknown
    trigger) — typed, with the documented fix in the message."""


# Which ledger trigger kind each registered degrade policy delegates
# to — the "one switching mechanism" contract made structural: every
# DEGRADE_POLICIES entry must appear here, and every value must be a
# ledger TRIGGER_KIND (analyze.registry.ctl_problems guards both
# directions, so adding a policy without routing it through the
# controller's ledger fails the ctl smoke lane).
POLICY_TRIGGER: Dict[str, str] = {
    "codec_escalate": "fault",
    "schedule_failover": "fault",
    "spare_demote": "fault",
}


def ratified_switch(host, mutate, *, consensus: bool = True):
    """THE switching mechanism: one membership-consensus round over
    ``host.runtime`` (epoch += 1, every rank ratifies the same view —
    lock-step by construction, stale phases fenced with
    ``StaleEpochError``), then the process-wide mutation.  Returns
    ``(view, action)`` where ``action`` is ``mutate(host, view)``'s
    record.  ``consensus=False`` skips the round only on a
    single-process caller that owns every rank's configuration by
    construction (the DegradeController contract, unchanged)."""
    view = host.runtime.consensus() if consensus else host.runtime.view
    action = mutate(host, view)
    return view, action


class SelfTuningController(DegradeController):
    """Continuous controller over one elastic world.

    ::

        ctl = SelfTuningController(n_ranks=8, tiers=(2, 2, 2))
        config.set_ctl_enabled(True)
        with obs.trace():
            ...healthy traffic...
            ctl.observe(); ctl.calibrate()     # adopt the baseline
            while training:
                ...traffic...
                decision = ctl.poll()          # None, or a ratified
                                               # Decision (ledgered)

    Subclasses :class:`DegradeController`, so the fault fast
    path (``ctl.apply("codec_escalate", report)``) runs through the
    SAME ratified switch and records into the SAME ledger, and
    ``reset()`` / the recovery trigger restore every knob any switch
    touched (first-write-wins snapshots, one episode discipline).

    ``nbytes``/``dtype``/``itemsize`` describe the representative
    payload the online re-synthesis ranks winners for (the tune-cache
    bucket the installed winner lands in).  ``device`` is the device of
    the runtime built from ``n_ranks`` (CUDA unless the caller passes
    ``"cpu"``); the tune-cache entries a switch records are keyed on the
    runtime's platform."""

    def __init__(self, runtime=None, *, n_ranks: Optional[int] = None,
                 tiers=None, nbytes: int = 1 << 14,
                 dtype: str = "float32", itemsize: int = 4,
                 codec: str = "q8", tracer=None, persist: bool = False,
                 device=None):
        super().__init__(runtime, n_ranks=n_ranks, device=device)
        size = self.runtime.view.size
        if tiers is None:
            from .. import config as _cfg

            tiers = _cfg.tier_stack() or (size,)
        self.tiers: Tuple[int, ...] = tuple(int(t) for t in tiers)
        prod = 1
        for t in self.tiers:
            prod *= t
        if prod != size:
            raise CtlError(
                f"tier stack {self.tiers} factors a {prod}-rank world, "
                f"but the runtime's view has {size} ranks — pass the "
                "stack that factors the actual world")
        self.nbytes = int(nbytes)
        self.dtype = str(dtype)
        self.itemsize = int(itemsize)
        self.codec = str(codec)
        self.persist = bool(persist)
        self._tracer = tracer
        self.estimator = BandwidthEstimator(self.tiers)
        self.monitor = DriftMonitor(len(self.tiers))
        self.ledger = DecisionLedger()
        self._escalated = False
        self._last_switch_epoch: Optional[int] = None

    def platform(self) -> str:
        """The tune-cache platform of the runtime's device (``"gpu"``
        for CUDA, ``"cpu"`` otherwise)."""
        from ..runtime import resolve_device
        from ..tune.autotuner import platform_of

        return platform_of(resolve_device(self.runtime.device))

    # ---------------------------------------------------------- measure

    def observe(self, events=None) -> int:
        """Fold new CommEvents into the estimates: an explicit event
        list, else the constructor's tracer, else the installed
        ``config.comm_tracer()``.  Publishes the ``ctl_*`` gauges."""
        if events is not None:
            n = self.estimator.ingest(events)
        else:
            n = self.estimator.observe(self._tracer)
        self.estimator.export_gauges()
        return n

    def calibrate(self) -> Tuple[Optional[float], ...]:
        """Adopt the current estimates as the healthy baseline (call
        after a known-good warmup; tiers first sampled later
        self-calibrate on their first value)."""
        return self.monitor.calibrate(self.estimator)

    def check(self) -> DriftReport:
        """One monitor step WITHOUT acting (the report surface)."""
        return self.monitor.check(self.estimator)

    # -------------------------------------------------------------- act

    def poll(self, events=None, *, consensus: bool = True
             ) -> Optional[Decision]:
        """The between-steps consult: with the controller disabled
        (``config.ctl_enabled()`` False, the default) this is ONE knob
        read and None — the off-path discipline.  Enabled, it ingests
        new events, checks drift, and performs at most one ratified
        switch: escalate when a tier degrades, de-escalate when every
        degraded tier recovers."""
        from .. import config as _cfg

        if not _cfg.ctl_enabled():
            return None
        self.observe(events)
        report = self.monitor.check(self.estimator)
        if report.degraded and not self._escalated:
            return self._escalate(report, consensus=consensus)
        if self._escalated and report.ok:
            return self._deescalate(report, consensus=consensus)
        return None

    def _switch_allowed(self, *, consensus: bool) -> bool:
        """Min-epochs-between-switches hysteresis: the prospective
        epoch (the consensus round the switch would ratify) must be at
        least ``config.ctl_min_switch_epochs()`` beyond the last
        switch's."""
        if self._last_switch_epoch is None:
            return True
        from .. import config as _cfg

        prospective = self.runtime.epoch + (1 if consensus else 0)
        if prospective - self._last_switch_epoch \
                >= _cfg.ctl_min_switch_epochs():
            return True
        from ..obs import metrics as _metrics

        _metrics.inc("ctl_switches_suppressed_total",
                     help="switches suppressed by the min-epochs "
                          "hysteresis (ctl.controller)")
        return False

    def _synthesize(self, bandwidths):
        from .. import csched

        return csched.synthesize_tiers(
            self.runtime.view.size, self.nbytes, self.itemsize,
            tiers=self.tiers, tier_bandwidths=bandwidths,
            codec=self.codec)

    def _install(self, name: str, program, slot_codec: str,
                 epoch: int, trigger: str) -> None:
        """Install a synthesized winner and record it in the tune
        cache with its ONLINE provenance (rendered by ``tune --show``:
        online-switched vs offline-measured, and the installing
        epoch)."""
        from .. import csched, tune

        csched.install(program)
        tune.record("allreduce", self.dtype, self.nbytes,
                    self.runtime.view.size, name,
                    platform=self.platform(), codec=slot_codec,
                    tiers=self.tiers, program=program.to_json(),
                    persist=self.persist,
                    ctl={"provenance": "online-switched",
                         "epoch": int(epoch), "trigger": trigger})

    def _escalate(self, report: DriftReport, *,
                  consensus: bool) -> Optional[Decision]:
        if not self._switch_allowed(consensus=consensus):
            return None
        from .. import config as _cfg

        # Worst degraded tier (lowest live/baseline ratio) names the
        # trigger; crossing the codec crossover escalates the codec,
        # milder sag only re-ranks the exact winner.
        degraded = [t for t in report.degraded
                    if report.ratios[t] is not None]
        tier = min(degraded, key=lambda t: report.ratios[t]) \
            if degraded else report.degraded[0]
        ratio = report.ratios[tier]
        lossy = ratio is not None and ratio < _cfg.ctl_codec_crossover()
        trigger = "crossover" if lossy else "drift"
        declared = _cfg.tier_bandwidths() or (1.0,) * len(self.tiers)
        live = live_bandwidths(report, declared)
        res = self._synthesize(live)

        if lossy:
            old = {"winner": res["exact_winner"], "codec": "synth",
                   "tier_wire": tuple(res["exact_tier_wire"]),
                   "weighted_cost": res["exact_weighted_cost"]}
            new = {"winner": res["winner"], "codec": "synth_q8",
                   "compression": self.codec,
                   "tier_wire": tuple(res["tier_wire"]),
                   "weighted_cost": res["weighted_cost"]}
        else:
            # Pre-switch serving cost: the declared-bandwidth exact
            # winner, PRICED UNDER THE LIVE VECTOR — the apples-to-
            # apples comparison that justifies a re-rank.
            from ..csched import weighted_cost as _wcost

            prior = self._synthesize(declared)
            old = {"winner": prior["exact_winner"], "codec": "synth",
                   "tier_wire": tuple(prior["exact_tier_wire"]),
                   "weighted_cost": _wcost(prior["exact_tier_wire"],
                                           live)}
            new = {"winner": res["exact_winner"], "codec": "synth",
                   "tier_wire": tuple(res["exact_tier_wire"]),
                   "weighted_cost": res["exact_weighted_cost"]}

        def mutate(host, view):
            host._save_once("tier_bandwidths", _cfg.tier_bandwidths(),
                            _cfg.set_tier_bandwidths)
            _cfg.set_tier_bandwidths(live)
            action = {"tier_bandwidths": live}
            if lossy:
                # The SAME registered policy the fault fast path runs —
                # codec escalation is one mechanism with two triggers.
                action.update(DEGRADE_POLICIES["codec_escalate"](
                    host, None, codec=self.codec))
                if res["winner"] != res["exact_winner"]:
                    self._install(res["winner"], res["program"],
                                  "synth_q8", view.epoch, trigger)
                    action["installed"] = res["winner"]
            else:
                self._install(res["exact_winner"],
                              res["exact_program"], "synth",
                              view.epoch, trigger)
                action["installed"] = res["exact_winner"]
            return action

        view, action = ratified_switch(self, mutate,
                                       consensus=consensus)
        self._escalated = True
        self._last_switch_epoch = view.epoch
        return self.ledger.record(
            view.epoch, trigger, tier=tier, ratio=ratio,
            estimates=report.estimates, old=old,
            new=dict(new, **{k: v for k, v in action.items()
                             if k == "installed"}),
            note=f"tier {tier} at {ratio:.3f} of baseline"
                 if ratio is not None else "")

    def _deescalate(self, report: DriftReport, *,
                    consensus: bool) -> Optional[Decision]:
        if not self._saved:
            self._escalated = False
            return None
        if not self._switch_allowed(consensus=consensus):
            return None

        def mutate(host, view):
            restored = sorted(host._saved)
            for value, setter in host._saved.values():
                setter(value)
            host._saved.clear()
            return {"restored": restored}

        view, action = ratified_switch(self, mutate,
                                       consensus=consensus)
        self._escalated = False
        self._last_switch_epoch = view.epoch
        worst = min((r for r in report.ratios if r is not None),
                    default=None)
        return self.ledger.record(
            view.epoch, "recovery", ratio=worst,
            estimates=report.estimates,
            new={"restored": action["restored"]},
            note="pre-episode configuration restored "
                 f"({', '.join(action['restored'])})")
