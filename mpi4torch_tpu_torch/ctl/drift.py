"""Timing-drift detection with hysteresis: a monitor over live
bandwidth.

Port of ``mpi4torch_tpu/ctl/drift.py``.

The JAX package's ``obs.reconcile`` is the *correctness* leg of the static-vs-runtime
join: measured wire bytes and collective counts must match the Mode A
census EXACTLY, every time.  Timing cannot be held to that standard —
wall durations carry scheduler noise — so this module inverts the
reconciler into a *monitor*: the same per-tier attribution, but the
measured quantity is the live bandwidth estimate
(:mod:`.estimate`) and the predicted quantity is a calibrated healthy
baseline.  The verdict is a RATIO per tier, and the state machine
around it is deliberately sticky:

* a tier degrades only after ``patience`` CONSECUTIVE checks below the
  ``low`` watermark;
* it recovers only after ``patience`` consecutive checks above the
  ``high`` watermark;
* anything between the watermarks (the hysteresis band) resets both
  counters — scheduler noise that oscillates inside the band can
  never flap a switch (the no-flap property).

The monitor never acts.  It reports (:class:`DriftReport`), the
controller decides (:mod:`.controller`), and every actual switch is
epoch-fenced through consensus.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = [
    "DriftReport",
    "DriftMonitor",
    "live_bandwidths",
]


@dataclass(frozen=True)
class DriftReport:
    """One monitor check: per-tier live/baseline ratios (None =
    unsampled/uncalibrated, neutral), the sticky per-tier states, the
    tiers whose state CHANGED on this check, and the thresholds that
    judged them."""

    ratios: Tuple[Optional[float], ...]
    estimates: Tuple[Optional[float], ...]
    baseline: Tuple[Optional[float], ...]
    states: Tuple[str, ...]              # "ok" | "degraded" per tier
    changed: Dict[int, str] = field(default_factory=dict)
    low: float = 0.0
    high: float = 0.0
    patience: int = 0

    @property
    def degraded(self) -> Tuple[int, ...]:
        return tuple(i for i, s in enumerate(self.states)
                     if s == "degraded")

    @property
    def ok(self) -> bool:
        return not self.degraded

    def as_reconcile(self) -> dict:
        """The obs.reconcile report shape, timing flavor: measured vs
        predicted per tier, a per-tier match table, one verdict."""
        return {
            "measured": list(self.estimates),
            "predicted": list(self.baseline),
            "matches": {f"tier{i}": s == "ok"
                        for i, s in enumerate(self.states)},
            "ok": self.ok,
        }


class DriftMonitor:
    """Sticky measured-vs-predicted bandwidth monitor over one tier
    stack.

    ``calibrate()`` snapshots the current (healthy) estimates as the
    predicted baseline; tiers first sampled later self-calibrate on
    their first measured value (``check`` adopts it), so an
    uncalibrated tier is neutral, never a false alarm.  Thresholds
    default to the config knobs
    (:func:`~mpi4torch_tpu_torch.config.ctl_drift_thresholds`,
    :func:`~mpi4torch_tpu_torch.config.ctl_drift_patience`)."""

    def __init__(self, ntiers: int, *, low: Optional[float] = None,
                 high: Optional[float] = None,
                 patience: Optional[int] = None):
        from .. import config as _cfg

        ntiers = int(ntiers)
        if ntiers < 1:
            raise ValueError(f"ntiers must be >= 1, got {ntiers}")
        cfg_low, cfg_high = _cfg.ctl_drift_thresholds()
        self.low = float(cfg_low if low is None else low)
        self.high = float(cfg_high if high is None else high)
        if not (0.0 < self.low < self.high):
            raise ValueError(
                f"drift thresholds need 0 < low < high, got "
                f"({self.low}, {self.high})")
        self.patience = int(_cfg.ctl_drift_patience()
                            if patience is None else patience)
        if self.patience < 1:
            raise ValueError(
                f"patience must be >= 1, got {self.patience}")
        self._baseline: List[Optional[float]] = [None] * ntiers
        self._states: List[str] = ["ok"] * ntiers
        self._below: List[int] = [0] * ntiers
        self._above: List[int] = [0] * ntiers

    @property
    def baseline(self) -> Tuple[Optional[float], ...]:
        return tuple(self._baseline)

    @property
    def states(self) -> Tuple[str, ...]:
        return tuple(self._states)

    def calibrate(self, estimator) -> Tuple[Optional[float], ...]:
        """Adopt the estimator's CURRENT per-tier estimates as the
        healthy baseline (call after a known-good warmup) and reset the
        state machine."""
        est = estimator.tier_estimates()
        if len(est) != len(self._baseline):
            raise ValueError(
                f"estimator has {len(est)} tiers, monitor has "
                f"{len(self._baseline)}")
        self._baseline = list(est)
        self._states = ["ok"] * len(self._baseline)
        self._below = [0] * len(self._baseline)
        self._above = [0] * len(self._baseline)
        return self.baseline

    def check(self, estimator) -> DriftReport:
        """One monitor step: ratio each tier's live estimate against
        its baseline, advance the hysteresis counters, report."""
        est = estimator.tier_estimates()
        if len(est) != len(self._baseline):
            raise ValueError(
                f"estimator has {len(est)} tiers, monitor has "
                f"{len(self._baseline)}")
        ratios: List[Optional[float]] = []
        changed: Dict[int, str] = {}
        for i, live in enumerate(est):
            base = self._baseline[i]
            if base is None and live is not None:
                # First sample of a previously unsampled tier: it IS
                # the baseline (self-calibration; neutral this check).
                self._baseline[i] = base = live
            if base is None or live is None or base <= 0:
                ratios.append(None)
                continue
            ratio = live / base
            ratios.append(ratio)
            if self._states[i] == "ok":
                self._above[i] = 0
                if ratio < self.low:
                    self._below[i] += 1
                    if self._below[i] >= self.patience:
                        self._states[i] = "degraded"
                        self._below[i] = 0
                        changed[i] = "degraded"
                else:
                    self._below[i] = 0
            else:
                self._below[i] = 0
                if ratio > self.high:
                    self._above[i] += 1
                    if self._above[i] >= self.patience:
                        self._states[i] = "ok"
                        self._above[i] = 0
                        changed[i] = "ok"
                else:
                    self._above[i] = 0
        report = DriftReport(
            ratios=tuple(ratios), estimates=tuple(est),
            baseline=self.baseline, states=self.states,
            changed=changed, low=self.low, high=self.high,
            patience=self.patience)
        self._export_gauges(report)
        return report

    @staticmethod
    def _export_gauges(report: DriftReport) -> None:
        from ..obs import metrics as _metrics

        for tier, ratio in enumerate(report.ratios):
            if ratio is not None:
                _metrics.set_gauge(
                    f'ctl_drift_ratio{{tier="{tier}"}}', ratio,
                    help="live/baseline per-tier bandwidth ratio "
                         "(ctl.drift; < low watermark degrades after "
                         "`patience` consecutive checks)")


def live_bandwidths(report: DriftReport,
                    declared=None) -> Tuple[float, ...]:
    """The live bandwidth vector the controller re-synthesizes under:
    the declared relative per-tier profile (``config.tier_bandwidths``
    when set, else uniform) scaled by each tier's measured drift ratio.
    Anchoring measurement onto the declared profile keeps the vector
    RELATIVE (the ``weighted_cost`` contract) while mixing measured
    sag into exactly the tiers that drifted; unsampled tiers keep
    their declared weight."""
    n = len(report.ratios)
    if declared is None:
        from .. import config as _cfg

        declared = _cfg.tier_bandwidths()
    if declared is None:
        declared = (1.0,) * n
    declared = tuple(float(b) for b in declared)
    if len(declared) != n:
        raise ValueError(
            f"declared profile has {len(declared)} tiers, report has "
            f"{n}")
    out = []
    for base, ratio in zip(declared, report.ratios):
        if ratio is None:
            out.append(base)
        else:
            # Clamp away from zero: a fully stalled link must still
            # yield a valid (positive) weighted-cost denominator.
            out.append(base * max(ratio, 1e-6))
    return tuple(out)
