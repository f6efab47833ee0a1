"""The "why did we switch" decision ledger.

Port of ``mpi4torch_tpu/ctl/ledger.py``.

The flight recorder (obs.flight) answers "what was the wire doing when
it tore"; this ledger answers the self-tuning counterpart: WHY did the
controller change the running configuration, under WHICH evidence, at
WHICH consensus epoch.  One :class:`Decision` per ratified switch:

* ``trigger`` — one of :data:`TRIGGER_KINDS` (registry-sync guarded
  against the smoke lane's coverage literal and the degrade-policy
  delegation map by ``analyze.registry.ctl_problems``);
* ``epoch`` — the consensus epoch every rank ratified BEFORE the
  switch (the lock-step guarantee);
* ``tier`` / ``ratio`` / ``estimates`` — the triggering measurement
  (None/() for the fault fast path, which acts on a SlowRankReport
  instead);
* ``old`` / ``new`` — the winner censuses on both sides of the switch
  (algorithm/codec, per-tier wire, weighted cost — the deterministic
  evidence that the switch reduced the weighted cost, not a hope);
* ``policy`` — the delegated DEGRADE_POLICIES name when the fault
  fast path made the switch.

Dumpable as JSON (:meth:`DecisionLedger.to_json`, machine join with
the flight recorder) and as a human table
(:meth:`DecisionLedger.format_table`, the ops surface).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = [
    "TRIGGER_KINDS",
    "Decision",
    "DecisionLedger",
]

# The closed trigger vocabulary (the ledger owns it; the controller's
# delegation map and the smoke lane's coverage literal are guarded
# against it by analyze.registry.ctl_problems):
#   drift     — a tier's estimate sagged below the low watermark for
#               `patience` checks, winner re-ranked under the live
#               bandwidth vector (exact wire);
#   crossover — the sag crossed the codec crossover, escalated to the
#               q8 / synth_q8 winner (the EQuARX regime);
#   recovery  — every degraded tier held above the high watermark,
#               pre-episode configuration restored;
#   fault     — the DEGRADE_POLICIES fast path (a gray-failure
#               report), delegated through the same ratified switch.
TRIGGER_KINDS: Tuple[str, ...] = ("drift", "crossover", "recovery",
                                  "fault")


@dataclass(frozen=True)
class Decision:
    """One ratified controller transition (see module docstring)."""

    epoch: int
    trigger: str
    tier: Optional[int] = None
    ratio: Optional[float] = None
    policy: Optional[str] = None
    estimates: Tuple[Optional[float], ...] = ()
    old: Dict = field(default_factory=dict)
    new: Dict = field(default_factory=dict)
    note: str = ""

    def to_dict(self) -> dict:
        return asdict(self)


class DecisionLedger:
    """Append-only record of controller decisions, beside the flight
    recorder."""

    def __init__(self):
        self.decisions: List[Decision] = []

    def record(self, epoch: int, trigger: str, *,
               tier: Optional[int] = None,
               ratio: Optional[float] = None,
               policy: Optional[str] = None,
               estimates=(), old: Optional[dict] = None,
               new: Optional[dict] = None, note: str = "") -> Decision:
        if trigger not in TRIGGER_KINDS:
            raise ValueError(
                f"unknown trigger kind {trigger!r}; the ledger records "
                f"{TRIGGER_KINDS} (extend TRIGGER_KINDS AND the "
                "ctl-smoke coverage, or the registry-sync guard tells "
                "you)")
        d = Decision(
            epoch=int(epoch), trigger=trigger, tier=tier,
            ratio=None if ratio is None else float(ratio),
            policy=policy, estimates=tuple(estimates),
            old=dict(old or {}), new=dict(new or {}), note=note)
        self.decisions.append(d)
        from ..obs import metrics as _metrics

        _metrics.inc(f'ctl_switches_total{{trigger="{trigger}"}}',
                     help="ratified self-tuning switches by trigger "
                          "kind (ctl.ledger)")
        return d

    def __len__(self) -> int:
        return len(self.decisions)

    def __iter__(self):
        return iter(self.decisions)

    def triggers(self) -> List[str]:
        return [d.trigger for d in self.decisions]

    # ------------------------------------------------------------- dumps

    def to_json(self) -> str:
        return json.dumps({"decisions": [d.to_dict()
                                         for d in self.decisions]},
                          indent=1, sort_keys=True)

    def dump(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json())
        return path

    def format_table(self) -> str:
        """Human table: one row per decision — epoch, trigger, the
        triggering tier/ratio, old -> new winner, weighted costs."""
        cols = ("epoch", "trigger", "tier", "ratio", "old", "new",
                "cost old->new", "note")
        rows = []
        for d in self.decisions:
            rows.append((
                str(d.epoch), d.trigger,
                "-" if d.tier is None else str(d.tier),
                "-" if d.ratio is None else f"{d.ratio:.3f}",
                _winner(d.old), _winner(d.new),
                _costs(d.old, d.new),
                d.note or ("-" if d.policy is None
                           else f"policy={d.policy}")))
        widths = [max(len(str(c)) for c in col)
                  for col in zip(cols, *rows)] if rows else \
            [len(c) for c in cols]
        fmt = "  ".join(f"{{:<{w}}}" for w in widths)
        lines = [fmt.format(*cols),
                 fmt.format(*("-" * w for w in widths))]
        lines += [fmt.format(*r) for r in rows]
        return "\n".join(lines)


def _winner(side: dict) -> str:
    w = side.get("winner") or side.get("algorithm")
    if w is None and side.get("restored"):
        return "restored:" + ",".join(side["restored"])
    if w is None:
        return "-"
    codec = side.get("codec")
    return f"{w}[{codec}]" if codec else str(w)


def _costs(old: dict, new: dict) -> str:
    a, b = old.get("weighted_cost"), new.get("weighted_cost")
    if a is None and b is None:
        return "-"
    fa = "-" if a is None else f"{a:.4g}"
    fb = "-" if b is None else f"{b:.4g}"
    return f"{fa}->{fb}"
