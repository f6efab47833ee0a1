"""mpi4torch_tpu_torch.ctl — the online self-tuning controller.

Port of ``mpi4torch_tpu.ctl``.  Closes the measure→retune→switch loop
over the optimization layers the port already has:

* :mod:`.estimate` — EWMA per-link / per-tier bandwidth estimates over
  the live CommEvent stream (censused payload bytes / wall duration,
  attributed with ``csched.tier_of_group`` — the shared pricing rule),
  exported as ``mpi4torch_ctl_*`` gauges;
* :mod:`.drift` — live/baseline ratios with two-watermark hysteresis
  and patience counters, so scheduler noise never flaps a switch;
* :mod:`.controller` — :class:`SelfTuningController`: re-runs
  ``csched.synthesize_tiers`` under the LIVE bandwidth vector,
  escalates to the q8/synth_q8 winner past the codec crossover,
  de-escalates symmetrically, and ratifies EVERY switch through
  ``ElasticRuntime.consensus`` (epoch-fenced lock-step; the
  ``DEGRADE_POLICIES`` fast path delegates to the same
  :func:`ratified_switch` — one switching mechanism, two triggers);
* :mod:`.ledger` — the "why did we switch" decision ledger beside the
  flight recorder: triggering estimates, old/new winner censuses,
  consensus epoch; JSON + human table.

``python -m mpi4torch_tpu_torch.ctl --smoke`` runs the closed-loop
cells; ``config.ctl_enabled`` (default False) gates everything — a
constructed-but-disabled controller changes nothing.
"""

from .controller import (CtlError, POLICY_TRIGGER, SelfTuningController,
                         ratified_switch)
from .drift import DriftMonitor, DriftReport, live_bandwidths
from .estimate import (BandwidthEstimator, Ewma, event_tier,
                       goodput_bytes)
from .ledger import Decision, DecisionLedger, TRIGGER_KINDS

__all__ = [
    "BandwidthEstimator",
    "Ewma",
    "event_tier",
    "goodput_bytes",
    "DriftMonitor",
    "DriftReport",
    "live_bandwidths",
    "Decision",
    "DecisionLedger",
    "TRIGGER_KINDS",
    "CtlError",
    "POLICY_TRIGGER",
    "SelfTuningController",
    "ratified_switch",
]
