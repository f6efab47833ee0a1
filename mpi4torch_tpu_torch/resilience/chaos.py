"""The censused chaos matrix: gray faults × every subsystem, seeded
multi-fault storms, typed outcomes — never a hang.

Port of ``mpi4torch_tpu/resilience/chaos.py``: the same cells, specs,
constants and verdict records, on the port's rank threads (or worker
processes under ``config.transport_scope("process")``) on the device
``run_chaos_cell`` is given (CUDA unless ``"cpu"`` is asked for).

The fault matrix (:mod:`.matrix`) pins what a gray fault does to one
collective; THIS matrix pins what the whole stack does about it:
detection (:mod:`.health`), epoch-fenced degrade transitions
(:mod:`.degrade`), serve deadlines/shedding and the elastic drain.
``python -m mpi4torch_tpu_torch.resilience --chaos`` runs every cell.

Cell outcomes (:data:`CHAOS_COVERAGE`):

* ``"recover"`` — the storm is absorbed by the existing machinery
  (retries/backoff, p2p redelivery): results BITWISE equal to the
  fault-free baseline and the fired ledger proves the fault acted.
* ``"degrade"`` — recovered AND adapted: the gray-failure detector
  attributes the slow rank, a registered degrade policy applies
  through an epoch-fenced consensus round, every rank reports the SAME
  (configuration, epoch) after the switch (lock-step; a stale-epoch
  phase raises ``StaleEpochError``), and the degraded-mode result is
  bitwise against ITS oracle.
* ``"escalate"`` — the typed raise: the detector escalates to
  :class:`~.health.SlowRankError` naming the slow rank, with a
  flight-recorder postmortem snapshotted.
* ``"inert"`` — the kind has no eligible wire in this subsystem
  (``flaky_link`` off the p2p mailboxes): provably unfired AND bitwise
  exact.

Every cell carries a multi-fault flavor where it can: the primary gray
spec rides next to a low-grade ``jitter`` co-fault on another rank
(inert cells stay single-spec — "nothing fired" must mean nothing).
:func:`storm_plan`/:func:`run_storm` go further: a seeded storm draws
ALL four gray kinds across random ranks and the run must still end
bitwise-or-typed, never hung.

The timing constants are JAX's, sized for these small payloads: a
brownout throttles ``PER_BYTE_S`` seconds a wire byte, so a caller
driving full-width tensors picks its own ``per_byte_s``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import matrix as rmatrix
from .degrade import DegradeController
from .faults import FaultSpec, fault_scope
from .health import GrayFailureDetector, SlowRankError

__all__ = [
    "GRAY_KINDS",
    "CHAOS_SUBSYSTEMS",
    "CHAOS_COVERAGE",
    "DEGRADE_COVERED",
    "coverage_cells",
    "run_chaos_cell",
    "storm_plan",
    "run_storm",
]

GRAY_KINDS = ("slow_rank", "jitter", "flaky_link", "brownout")

CHAOS_SUBSYSTEMS = ("plain", "fused", "compressed", "overlap", "serve",
                    "elastic")

# The literal coverage table (registry-sync guarded against GRAY_KINDS,
# CHAOS_SUBSYSTEMS and DEGRADE_POLICIES by analyze.registry.
# degrade_problems).
CHAOS_COVERAGE: Dict[str, Dict[str, str]] = {
    "slow_rank": {"plain": "degrade", "fused": "recover",
                  "compressed": "recover", "overlap": "recover",
                  "serve": "escalate", "elastic": "degrade"},
    "jitter": {"plain": "recover", "fused": "recover",
               "compressed": "recover", "overlap": "recover",
               "serve": "recover", "elastic": "recover"},
    "flaky_link": {"plain": "inert", "fused": "inert",
                   "compressed": "inert", "overlap": "recover",
                   "serve": "inert", "elastic": "recover"},
    "brownout": {"plain": "recover", "fused": "recover",
                 "compressed": "degrade", "overlap": "recover",
                 "serve": "degrade", "elastic": "recover"},
}

# Which registered degrade policy each "degrade" cell exercises — the
# registry-sync literal: every DEGRADE_POLICIES entry must appear here,
# and every entry must point at a cell the coverage table declares
# "degrade".  The (brownout x serve) degrade cell exercises the
# serve-side machinery (deadlines, shed policy, elastic drain) rather
# than a process-wide policy, so it carries no row here.
DEGRADE_COVERED: Dict[Tuple[str, str], str] = {
    ("slow_rank", "plain"): "schedule_failover",
    ("brownout", "compressed"): "codec_escalate",
    ("slow_rank", "elastic"): "spare_demote",
}

# Cell timing: small sleeps, bounded patience.  Comm cells run their
# worlds at CELL_TIMEOUT_S with the retry budget; serve/elastic cells
# size their own timeouts (documented per cell).
CELL_TIMEOUT_S = 0.4
RETRIES = 5
BACKOFF_S = 0.2
SLOW_S = 0.12          # slow_rank per-call tax in chaos cells
JITTER_S = 0.1         # jitter maximum
CO_JITTER_S = 0.04     # the storm co-fault's maximum
PER_BYTE_S = 8e-4      # brownout throttle (256 B payload -> ~0.2s)
FLAKY_P = 0.6          # flaky_link drop probability (seeded)
DETECT_FLOOR_S = 0.05  # detector floor: well below SLOW_S, well above
                       # scheduler noise on an idle CPU world


def _gray_spec(kind: str, rank: Optional[int], op: Optional[str],
               count: int = 6, seed: int = 0) -> FaultSpec:
    if kind == "slow_rank":
        return FaultSpec(kind, rank=rank, op=op, seconds=SLOW_S,
                         count=count)
    if kind == "jitter":
        return FaultSpec(kind, rank=rank, op=op, seconds=JITTER_S,
                         count=count, seed=seed)
    if kind == "brownout":
        return FaultSpec(kind, rank=rank, op=op,
                         per_byte_s=PER_BYTE_S, count=count)
    if kind == "flaky_link":
        return FaultSpec(kind, rank=rank, op=op, p=FLAKY_P,
                         count=count, seed=seed)
    raise ValueError(f"not a gray kind: {kind!r}")


def coverage_cells():
    for kind in GRAY_KINDS:
        for subsystem in CHAOS_SUBSYSTEMS:
            yield kind, subsystem


def _rec(kind, subsystem, expected, **kw):
    rec = {"kind": kind, "subsystem": subsystem, "expected": expected}
    rec.update(kw)
    return rec


def _ok(rec, detail):
    rec.update(status="ok", detail=detail)
    return rec


def _fail(rec, detail):
    rec.update(status="fail", detail=detail)
    return rec


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Comm cells (plain / fused / compressed / overlap): the matrix bodies,
# plus a jitter co-fault and a detection report.
# ---------------------------------------------------------------------------

def _comm_cell(kind: str, subsystem: str, expected: str, device,
               nranks: int = 4) -> dict:
    import mpi4torch_tpu_torch as mpi
    from .. import obs

    rec = _rec(kind, subsystem, expected, nranks=nranks)
    target = 1
    fn, op_prefix = rmatrix._cell_fn(subsystem, kind, None)
    baseline = rmatrix._baseline(subsystem, kind, nranks, None, device)

    specs = [_gray_spec(kind, target, op_prefix)]
    if expected != "inert":
        # The multi-fault storm flavor: a low-grade jitter co-fault on
        # another rank rides along; the cell must absorb BOTH.
        specs.append(FaultSpec("jitter", rank=(target + 2) % nranks,
                               op=op_prefix, seconds=CO_JITTER_S,
                               count=6, seed=11))

    err = None
    got = None
    with rmatrix._knob(comm_retries=RETRIES, comm_backoff=BACKOFF_S), \
            fault_scope(specs) as plan, obs.trace() as tracer:
        try:
            got = mpi.run_ranks(fn, nranks, timeout=CELL_TIMEOUT_S,
                                device=device)
        except Exception as e:  # noqa: BLE001 — classified below
            err = e
        report = GrayFailureDetector(
            tracer, floor_s=DETECT_FLOOR_S).check()

    fired = plan.fired_kinds()
    rec["fired"] = sorted(fired)
    rec["detected"] = sorted(report.slow) if report else []
    if err is not None:
        return _fail(rec, f"expected {expected}, got "
                          f"{type(err).__name__}: {err}")
    if not rmatrix._tree_equal(got, baseline):
        return _fail(rec, "result DIVERGES from the fault-free baseline")
    if expected == "inert":
        if kind in fired:
            return _fail(rec, "fault fired on a subsystem declared "
                              "inert for it")
        return _ok(rec, "inert (no eligible wire), result bitwise exact")
    if kind not in fired:
        return _fail(rec, f"vacuous pass: {kind} never fired "
                          f"(fired={sorted(fired)})")
    if kind == "slow_rank" and (report is None
                                or target not in report.slow):
        return _fail(rec, "slow rank went UNDETECTED: expected rank "
                          f"{target} in {rec['detected']}")
    detail = "recovered bitwise under the storm"
    if report is not None and report.slow:
        detail += f"; detector attributed rank(s) {sorted(report.slow)}"
    return _ok(rec, detail)


# ---------------------------------------------------------------------------
# Degrade cells
# ---------------------------------------------------------------------------

def _int_data(rank: int, device, n: int = 32):
    """Integer-valued float payloads: exact under ANY fold association,
    so the oracle (numpy sum) stays bitwise across schedule switches —
    the elastic-matrix discipline."""
    return torch.arange(n, dtype=torch.float32, device=device) * (rank + 1)


def _int_expect(n_ranks: int) -> np.ndarray:
    return np.sum([np.arange(32, dtype=np.float32) * (r + 1)
                   for r in range(n_ranks)], axis=0)


def _cell_slow_rank_plain(device) -> dict:
    """slow_rank × plain → schedule_failover: detect rank 1, ratify an
    epoch-fenced transition, re-rank schedules by per-rank wire census,
    finish bitwise on the failover schedule with every rank reporting
    the SAME (algorithm, epoch) — and a stale-epoch phase fenced."""
    import mpi4torch_tpu_torch as mpi
    from .. import obs
    from ..elastic.membership import StaleEpochError

    rec = _rec("slow_rank", "plain", "degrade", nranks=4)
    comm = mpi.COMM_WORLD
    n = 4
    expect = _int_expect(n)
    ctl = DegradeController(n_ranks=n, device=device)
    specs = [_gray_spec("slow_rank", 1, "Allreduce", count=60),
             FaultSpec("jitter", rank=3, op="Allreduce",
                       seconds=CO_JITTER_S, count=60, seed=7)]
    try:
        with rmatrix._knob(comm_retries=RETRIES, comm_backoff=BACKOFF_S), \
                fault_scope(specs) as plan, obs.trace() as tracer:
            stale_view = ctl.runtime.view

            def phase(pos, rid):
                out = None
                for _ in range(3):
                    out = comm.Allreduce(_int_data(pos, comm.device),
                                         mpi.MPI_SUM)
                return _host(out)

            outs = ctl.runtime.run_phase(phase, timeout=5.0)
            report = GrayFailureDetector(
                tracer, floor_s=DETECT_FLOOR_S).check()
            if report is None or 1 not in report.slow:
                return _fail(rec, "detector missed the slow rank: "
                             f"{report and sorted(report.slow)}")
            tr = ctl.apply("schedule_failover", report, nbytes=128)

            def phase2(pos, rid):
                out = comm.Allreduce(_int_data(pos, comm.device),
                                     mpi.MPI_SUM)
                return (mpi.config.default_algorithm(),
                        ctl.runtime.epoch, _host(out))

            outs2 = ctl.runtime.run_phase(phase2, view=ctl.runtime.view,
                                          timeout=5.0)
            try:
                ctl.runtime.run_phase(phase, view=stale_view)
                fenced = False
            except StaleEpochError:
                fenced = True
    finally:
        ctl.reset()

    rec["fired"] = sorted(plan.fired_kinds())
    rec["epoch"] = tr.epoch
    rec["algorithm"] = tr.action["algorithm"]
    if any(not np.array_equal(o, expect) for o in outs):
        return _fail(rec, "pre-transition results diverge")
    states = {(a, e) for a, e, _o in outs2}
    if states != {(tr.action["algorithm"], tr.epoch)}:
        return _fail(rec, f"LOCK-STEP violated: ranks report {states}, "
                     f"want {{({tr.action['algorithm']!r}, {tr.epoch})}}")
    if any(not np.array_equal(o, expect) for _a, _e, o in outs2):
        return _fail(rec, "post-failover results diverge from oracle")
    if not fenced:
        return _fail(rec, "stale-epoch phase was NOT fenced")
    sb = tr.action["slow_rank_bytes"]
    if sb[tr.action["algorithm"]] >= sb.get("ring", float("inf")):
        return _fail(rec, f"failover did not unload the slow rank: {sb}")
    if "slow_rank" not in plan.fired_kinds():
        return _fail(rec, "vacuous pass: slow_rank never fired")
    return _ok(rec, f"failover ring->{tr.action['algorithm']} at epoch "
               f"{tr.epoch}: slow-rank bytes {sb['ring']}->"
               f"{sb[tr.action['algorithm']]}, lock-step + fenced, "
               "bitwise")


def _cell_brownout_compressed(device) -> dict:
    """brownout × compressed → codec_escalate: the throttle is
    proportional to censused wire bytes, so escalating exact→q8
    provably shrinks the stall (the fired ledger records bytes and
    sleep per firing); the q8 phase is bitwise against the fault-free
    q8 baseline and every rank reports the same (codec, epoch)."""
    import mpi4torch_tpu_torch as mpi
    from .. import obs

    rec = _rec("brownout", "compressed", "degrade", nranks=4)
    comm = mpi.COMM_WORLD
    n = 4

    def fn(rank, compression=None):
        # ONE call site for every phase: with compression=None it reads
        # the PROCESS-wide compression default the policy flips, so
        # phase 1 (exact) and phase 2 (escalated q8) run the same code;
        # compression="q8" pins the fault-free q8 baseline.
        x = torch.linspace(-2.0, 2.0, 512, dtype=torch.float32,
                           device=comm.device) * (rank + 1)
        return comm.Allgather(x, 0, compression=compression)

    baseline_q8 = mpi.run_ranks(lambda r: fn(r, compression="q8"), n,
                                timeout=30.0, device=device)
    ctl = DegradeController(n_ranks=n, device=device)
    spec = _gray_spec("brownout", 2, "Allgather", count=60)
    try:
        with rmatrix._knob(comm_retries=RETRIES, comm_backoff=BACKOFF_S), \
                fault_scope([spec]) as plan, obs.trace() as tracer:
            def phase1(pos, rid):
                out = None
                for _ in range(2):   # >= detector min_events per rank
                    out = fn(pos)
                return _host(out)

            outs = ctl.runtime.run_phase(phase1, timeout=5.0)
            report = GrayFailureDetector(
                tracer, floor_s=DETECT_FLOOR_S).check()
            if report is None or 2 not in report.slow:
                return _fail(rec, "detector missed the browned-out "
                             f"rank: {report and sorted(report.slow)}")
            exact_fires = [f for f in plan.fired
                           if f.kind == "brownout"]
            tr = ctl.apply("codec_escalate", report)

            def phase2(pos, rid):
                out = fn(pos)
                codec = mpi.config.default_compression()
                name = getattr(codec, "name", codec)
                return (name, ctl.runtime.epoch, _host(out))

            outs2 = ctl.runtime.run_phase(phase2, view=ctl.runtime.view,
                                          timeout=5.0)
            q8_fires = [f for f in plan.fired
                        if f.kind == "brownout"][len(exact_fires):]
    finally:
        ctl.reset()

    rec["fired"] = sorted(plan.fired_kinds())
    rec["epoch"] = tr.epoch
    del outs  # phase-1 results: covered by the recover cells' baseline
    states = {(c, e) for c, e, _o in outs2}
    if states != {("q8", tr.epoch)}:
        return _fail(rec, f"LOCK-STEP violated: ranks report {states}")
    for o, b in zip([o for _c, _e, o in outs2], baseline_q8):
        if not np.array_equal(o, _host(b)):
            return _fail(rec, "q8 phase diverges from the fault-free "
                              "q8 baseline")
    if not exact_fires or not q8_fires:
        return _fail(rec, "vacuous pass: brownout did not fire in both "
                     f"phases (exact={len(exact_fires)}, "
                     f"q8={len(q8_fires)})")
    exact_b = max(f.info["bytes"] for f in exact_fires)
    q8_b = max(f.info["bytes"] for f in q8_fires)
    if not q8_b < exact_b:
        return _fail(rec, f"q8 wire did NOT shrink the throttled bytes "
                     f"({exact_b} -> {q8_b})")
    return _ok(rec, f"codec escalated exact->q8 at epoch {tr.epoch}: "
               f"throttled bytes {exact_b}->{q8_b} "
               f"({exact_b / max(q8_b, 1):.1f}x less brownout sleep), "
               "lock-step, bitwise vs the q8 baseline")


def _cell_slow_rank_elastic(device) -> dict:
    """slow_rank × elastic → spare_demote: a slow DATA rank is demoted
    to mirror duty and the hot spare takes its deal slot by a LOCAL
    slice (zero wire), through an epoch-fenced round; the final bank
    equals the never-failed oracle bitwise."""
    import mpi4torch_tpu_torch as mpi
    from .. import obs
    from ..elastic.spare import bank_spare_step, takeover_bank_slot

    rec = _rec("slow_rank", "elastic", "degrade", nranks=4)
    comm = mpi.COMM_WORLD
    n, n_data = 4, 3
    bank0 = np.arange(6 * 4, dtype=np.float32).reshape(6, 4)

    def delta_at(step, pos):
        # Data ranks contribute integer deltas, mirrors zeros.
        d = np.zeros_like(bank0)
        d += float(step + 1) * (pos + 1)
        return d

    # Never-failed oracle: the summed data-rank deltas, four steps.
    def oracle_slots(slots_seq):
        bank = bank0.copy()
        for step, slots in enumerate(slots_seq):
            total = np.zeros_like(bank0)
            for pos, slot in enumerate(slots):
                if slot is not None:
                    total += delta_at(step, pos)
            bank = bank + total
        return bank

    slots_a = (0, 1, 2, None)
    ctl = DegradeController(n_ranks=n, device=device)
    spec = _gray_spec("slow_rank", 1, "Allreduce", count=60)
    state = {}

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(comm.device)

    try:
        with rmatrix._knob(comm_retries=RETRIES, comm_backoff=BACKOFF_S), \
                fault_scope([spec]) as plan, obs.trace() as tracer:

            def phase_a(pos, rid):
                slot = slots_a[pos]
                per = bank0.shape[0] // n_data
                bank = dev(bank0 if slot is None
                           else bank0[slot * per:(slot + 1) * per])
                for step in range(2):
                    contrib = (delta_at(step, pos)
                               if slot is not None
                               else np.zeros_like(bank0))
                    bank = bank_spare_step(comm, bank, dev(contrib),
                                           n_data=n_data, slot=slot)
                return _host(bank)

            banks_a = ctl.runtime.run_phase(phase_a, timeout=5.0)
            report = GrayFailureDetector(
                tracer, floor_s=DETECT_FLOOR_S).check()
            if report is None or 1 not in report.slow:
                return _fail(rec, "detector missed the slow rank: "
                             f"{report and sorted(report.slow)}")
            tr = ctl.apply("spare_demote", report, n_data=n_data,
                           slots=slots_a)
            slots_b = tr.action["slots"]
            # Takeover: the promoted spare slices its mirror LOCALLY.
            state["takeover"] = _host(takeover_bank_slot(
                torch.from_numpy(banks_a[tr.action["promoted"]]),
                tr.action["slot"], n_data))

            def phase_b(pos, rid):
                slot = slots_b[pos]
                if pos == tr.action["promoted"]:
                    bank = state["takeover"]
                elif pos == tr.action["demoted"]:
                    # Demoted to mirror duty: a fresh zero mirror — its
                    # slow compute leaves the data critical path.
                    bank = np.zeros_like(bank0)
                else:
                    bank = banks_a[pos]
                bank = dev(bank)
                for step in range(2, 4):
                    contrib = (delta_at(step, pos)
                               if slot is not None
                               else np.zeros_like(bank0))
                    bank = bank_spare_step(comm, bank, dev(contrib),
                                           n_data=n_data, slot=slot)
                return (ctl.runtime.epoch, _host(bank))

            outs_b = ctl.runtime.run_phase(phase_b,
                                           view=ctl.runtime.view,
                                           timeout=5.0)
    finally:
        ctl.reset()

    rec["fired"] = sorted(plan.fired_kinds())
    rec["epoch"] = tr.epoch
    rec["slots"] = tr.action["slots"]
    epochs = {e for e, _b in outs_b}
    if epochs != {tr.epoch}:
        return _fail(rec, f"LOCK-STEP violated: epochs {epochs}")
    want = oracle_slots([slots_a, slots_a,
                         tr.action["slots"], tr.action["slots"]])
    per = bank0.shape[0] // n_data
    got = np.zeros_like(bank0)
    for pos, slot in enumerate(tr.action["slots"]):
        if slot is not None:
            got[slot * per:(slot + 1) * per] = outs_b[pos][1]
    if not np.array_equal(got, want):
        return _fail(rec, "post-takeover bank diverges from the "
                          "never-failed oracle")
    if "slow_rank" not in plan.fired_kinds():
        return _fail(rec, "vacuous pass: slow_rank never fired")
    return _ok(rec, f"slow data rank {tr.action['demoted']} demoted, "
               f"spare {tr.action['promoted']} took slot "
               f"{tr.action['slot']} by local slice at epoch "
               f"{tr.epoch}; bank bitwise vs the never-failed oracle")


# ---------------------------------------------------------------------------
# Serve cells
# ---------------------------------------------------------------------------

def _serve_fixture(device):
    from ..models import transformer as T
    from ..runtime import resolve_device

    cfg = T.TransformerConfig(vocab=31, d_model=16, n_heads=4,
                              n_layers=2, d_ff=32, max_seq=24)
    params = T.init_transformer(0, cfg, dtype=torch.float32,
                                device=resolve_device(device))
    prompts = [np.array([1, 2, 3]), np.array([4, 5, 6, 7]),
               np.array([9, 10])]
    budgets = [4, 3, 4]
    return cfg, params, prompts, budgets


def _serve_oracle(cfg, params, prompt, n_new):
    from ..models import transformer as T

    dev = params["embed"].device
    out = T.generate(cfg, params,
                     torch.tensor(np.asarray(prompt), dtype=torch.int32,
                                  device=dev)[None, :],
                     n_new, dtype=torch.float32)
    return _host(out[0])


def _serve_cell(kind: str, expected: str, device) -> dict:
    """The recover/inert/escalate serve cells: an engine per rank on a
    (2,) world under the gray fault; tokens must stay bitwise vs the
    per-request generate() oracle, and an ``escalate`` cell must end in
    a typed, attributed SlowRankError with a postmortem."""
    import mpi4torch_tpu_torch as mpi
    from .. import obs, serve

    rec = _rec(kind, "serve", expected, nranks=2)
    cfg, params, prompts, budgets = _serve_fixture(device)
    op = "p2p" if kind == "flaky_link" else None
    if kind == "slow_rank":
        # The escalate cell: a PERSISTENT tax on every chokepoint call
        # (smaller per-call so the cell stays fast), so the detector's
        # windowed mean cannot be diluted by post-window events.
        specs = [FaultSpec("slow_rank", rank=1, op=None, seconds=0.05,
                           count=10_000)]
    else:
        specs = [_gray_spec(kind, 1, op, count=12)]
    if expected != "inert":
        specs.append(FaultSpec("jitter", rank=0, op=None,
                               seconds=CO_JITTER_S, count=6, seed=13))

    def body(rank):
        eng = serve.Engine(cfg, params, serve.ServeConfig(slots=2),
                           device=mpi.COMM_WORLD.device)
        for p, b in zip(prompts, budgets):
            eng.submit(p, max_new=b)
        return eng.run()

    err = None
    outs = None
    with rmatrix._knob(comm_retries=RETRIES, comm_backoff=BACKOFF_S), \
            fault_scope(specs) as plan, obs.trace() as tracer:
        try:
            outs = mpi.run_ranks(body, 2, timeout=20.0, device=device)
        except Exception as e:  # noqa: BLE001 — classified below
            err = e
        detector = GrayFailureDetector(
            tracer, floor_s=0.02 if expected == "escalate"
            else DETECT_FLOOR_S)
        esc_err = None
        if err is None and expected == "escalate":
            try:
                detector.check(escalate=True)
            except SlowRankError as e:
                esc_err = e
        else:
            detector.check()
        pm = tracer.last_postmortem()

    fired = plan.fired_kinds()
    rec["fired"] = sorted(fired)
    if err is not None:
        return _fail(rec, f"engine run raised {type(err).__name__}: "
                          f"{err}")
    for res in outs:
        for i, (p, b) in enumerate(zip(prompts, budgets)):
            if not np.array_equal(np.asarray(res[i]),
                                  _serve_oracle(cfg, params, p, b)):
                return _fail(rec, f"rank tokens diverge from the "
                                  f"generate() oracle (rid {i})")
    if expected == "inert":
        if kind in fired:
            return _fail(rec, "fault fired on the serve rendezvous "
                              "wire it should have no target on")
        return _ok(rec, "inert (decode rides the rendezvous, no p2p "
                        "wire), tokens bitwise vs oracle")
    if kind not in fired:
        return _fail(rec, f"vacuous pass: {kind} never fired")
    if expected == "escalate":
        if esc_err is None:
            return _fail(rec, "detector did not escalate the slow rank")
        if 1 not in esc_err.ranks:
            return _fail(rec, f"SlowRankError is UNATTRIBUTED: "
                              f"{sorted(esc_err.ranks)}")
        if pm is None or pm["error"] != "SlowRankError":
            return _fail(rec, "no flight-recorder postmortem on the "
                              "escalated SlowRankError")
        return _ok(rec, "tokens bitwise, then typed SlowRankError "
                   f"naming rank {sorted(esc_err.ranks)} with a "
                   "flight-recorder postmortem")
    return _ok(rec, "engine tokens bitwise vs oracle under the storm")


def _cell_brownout_serve(device) -> dict:
    """brownout × serve → degrade: sustained brownout with deadlines
    and a shed policy — deadline evictions surface as the typed
    ``deadline_expired`` status (tokens an oracle PREFIX), overflow
    sheds typed ``shed``, and the remaining load drains through the
    elastic path (epoch-fenced shrink) and finishes bitwise on the
    new world."""
    import mpi4torch_tpu_torch as mpi
    from .. import obs, serve
    from ..elastic.replan import (ServeTicket, drain_tickets, readmit,
                                  stitched_results)
    from ..elastic.runtime import ElasticRuntime
    from ..runtime import resolve_device

    rec = _rec("brownout", "serve", "degrade", nranks=2)
    cfg, params, prompts, budgets = _serve_fixture(device)
    rt = ElasticRuntime(2, device=device)
    spec = _gray_spec("brownout", 1, None, count=40)

    with rmatrix._knob(comm_retries=RETRIES, comm_backoff=BACKOFF_S), \
            fault_scope([spec]) as plan, obs.trace() as tracer:

        def phase_a(pos, rid):
            t = [0.0]
            eng = serve.Engine(
                cfg, params,
                serve.ServeConfig(slots=1, queue_limit=1,
                                  shed_policy="drop_oldest"),
                clock=lambda: t[0], device=mpi.COMM_WORLD.device)
            eng.submit(prompts[0], max_new=budgets[0], deadline_s=2.0)
            eng.submit(prompts[1], max_new=budgets[1])
            eng.step()        # admits rid 0 into the slot; rid 1 queued
            # Overflow under sustained brownout: the shed policy evicts
            # the oldest QUEUED request (rid 1, typed status) instead
            # of rejecting the newcomer.
            eng.submit(prompts[2], max_new=budgets[2])
            t[0] = 3.0        # rid 0's deadline passes mid-flight
            eng.step()
            tickets, results = drain_tickets(eng)
            return {"tickets": [(tk.rid, tk.prompt, tuple(tk.emitted),
                                 tk.max_new) for tk in tickets],
                    "results": {k: np.asarray(v)
                                for k, v in results.items()},
                    "statuses": eng.statuses()}

        outs = rt.run_phase(phase_a, timeout=30.0)
        report = GrayFailureDetector(
            tracer, floor_s=DETECT_FLOOR_S).check()
        # Epoch-fenced shrink: the browned-out rank drains out.
        view = rt.consensus(leaving=[1])

    rec["fired"] = sorted(plan.fired_kinds())
    rec["epoch"] = view.epoch
    rec["detected"] = sorted(report.slow) if report else []
    if "brownout" not in plan.fired_kinds():
        return _fail(rec, "vacuous pass: brownout never fired")
    if view.alive != (0,) or view.epoch < 1:
        return _fail(rec, f"shrink not ratified: {view}")
    # Every rank held the identical host-side ledger.
    first = outs[0]
    for o in outs[1:]:
        if o["statuses"] != first["statuses"]:
            return _fail(rec, "per-rank statuses diverge")
    st = first["statuses"]
    if st.get(0) != serve.STATUS_EXPIRED:
        return _fail(rec, f"deadline eviction missing its typed status "
                          f"({st})")
    if serve.STATUS_SHED not in st.values():
        return _fail(rec, f"shed policy left no typed shed status ({st})")
    # The deadline-evicted request's tokens are an oracle prefix.
    want0 = _serve_oracle(cfg, params, prompts[0], budgets[0])
    got0 = first["results"][0]
    if not np.array_equal(got0, want0[:len(got0)]):
        return _fail(rec, "expired request's tokens are not an oracle "
                          "prefix")
    # Drain → re-admit on the post-shrink world's engine (fresh, no
    # fault: the browned-out rank left the membership) and finish.
    eng2 = serve.Engine(cfg, params, serve.ServeConfig(slots=2),
                        device=resolve_device(device))
    tickets = [ServeTicket(rid=rid, prompt=pr, emitted=list(em),
                           max_new=mn)
               for rid, pr, em, mn in first["tickets"]]
    readmit(eng2, tickets)
    res2 = stitched_results(eng2.run(), tickets)
    for rid, pr, _em, mn in first["tickets"]:
        want = _serve_oracle(cfg, params, pr, mn)
        if not np.array_equal(np.asarray(res2[rid]), want):
            return _fail(rec, f"post-drain continuation diverges "
                              f"(rid {rid})")
    return _ok(rec, f"deadline eviction + shed typed, drained through "
               f"the elastic shrink (epoch {view.epoch}), "
               "continuations bitwise vs oracle")


# ---------------------------------------------------------------------------
# Elastic cells (recover): consensus + a phase under the gray fault.
# ---------------------------------------------------------------------------

def _elastic_recover_cell(kind: str, device) -> dict:
    import mpi4torch_tpu_torch as mpi
    from .. import obs
    from ..elastic.runtime import ElasticRuntime

    rec = _rec(kind, "elastic", "recover", nranks=4)
    comm = mpi.COMM_WORLD
    n = 4
    expect = _int_expect(n)
    # Small world timeout: a flaky-dropped consensus proposal is only
    # redelivered when the receive's base patience expires — the retry
    # budget must cycle fast.
    rt = ElasticRuntime(n, world_timeout=0.4, device=device)
    spec = _gray_spec(kind, 1, None, count=30, seed=5)

    err = None
    with rmatrix._knob(comm_retries=RETRIES, comm_backoff=BACKOFF_S), \
            fault_scope([spec]) as plan, obs.trace():
        try:
            view = rt.consensus()
            outs = rt.run_phase(
                lambda pos, rid: _host(comm.Allreduce(
                    _int_data(pos, comm.device), mpi.MPI_SUM)),
                view=rt.view, timeout=5.0)
        except Exception as e:  # noqa: BLE001 — classified below
            err = e

    rec["fired"] = sorted(plan.fired_kinds())
    if err is not None:
        return _fail(rec, f"expected recover, got "
                          f"{type(err).__name__}: {err}")
    rec["epoch"] = view.epoch
    if view.epoch != 1 or view.alive != tuple(range(n)):
        return _fail(rec, f"consensus did not ratify the full world: "
                          f"{view}")
    if any(not np.array_equal(o, expect) for o in outs):
        return _fail(rec, "phase results diverge from oracle")
    if kind not in plan.fired_kinds():
        return _fail(rec, f"vacuous pass: {kind} never fired")
    return _ok(rec, f"consensus ratified (epoch {view.epoch}) and the "
               "phase recovered bitwise under the fault")


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

_SPECIAL_CELLS = {
    ("slow_rank", "plain"): _cell_slow_rank_plain,
    ("brownout", "compressed"): _cell_brownout_compressed,
    ("slow_rank", "elastic"): _cell_slow_rank_elastic,
    ("brownout", "serve"): _cell_brownout_serve,
}


def run_chaos_cell(kind: str, subsystem: str, device=None) -> dict:
    """Run one chaos cell on worlds of ``device`` (CUDA unless
    ``"cpu"``); returns a verdict record with ``status``
    ``"ok"``/``"fail"`` and a human ``detail``."""
    expected = CHAOS_COVERAGE.get(kind, {}).get(subsystem)
    if expected is None:
        return _fail(_rec(kind, subsystem, None),
                     "no CHAOS_COVERAGE row — the registry-sync guard "
                     "should have caught this")
    special = _SPECIAL_CELLS.get((kind, subsystem))
    if special is not None:
        return special(device)
    if subsystem == "serve":
        return _serve_cell(kind, expected, device)
    if subsystem == "elastic":
        return _elastic_recover_cell(kind, device)
    return _comm_cell(kind, subsystem, expected, device)


# ---------------------------------------------------------------------------
# Seeded storms
# ---------------------------------------------------------------------------

def storm_plan(seed: int, nranks: int) -> list:
    """A seeded multi-fault storm: every gray kind, ranks and windows
    drawn deterministically from ``seed`` (FNV, like the jitter/flaky
    draws themselves) — the same seed replays the same storm."""
    from .faults import _hash01

    def draw(i):
        return int(_hash01(seed, i, 0) * nranks) % nranks

    return [
        FaultSpec("slow_rank", rank=draw(0), op=None,
                  seconds=SLOW_S / 2, count=8),
        FaultSpec("jitter", rank=draw(1), op=None, seconds=JITTER_S,
                  count=12, seed=seed),
        FaultSpec("brownout", rank=draw(2), op=None,
                  per_byte_s=PER_BYTE_S / 2, count=8),
        FaultSpec("flaky_link", rank=None, op="p2p", p=FLAKY_P,
                  count=10, seed=seed + 1),
    ]


def run_storm(seed: int, nranks: int = 4, device=None) -> dict:
    """One seeded storm over the fused + overlap workload (rendezvous
    AND p2p wires): the run must end bitwise against the fault-free
    baseline or in a typed CommError — never a hang (the world timeout
    caps every wait).  Returns a verdict record."""
    import mpi4torch_tpu_torch as mpi
    from .. import obs

    rec = {"storm": seed, "nranks": nranks}
    fn, _op = rmatrix._cell_fn("overlap", "jitter", None)
    baseline = rmatrix._baseline("overlap", "jitter", nranks, None, device)

    t0 = time.monotonic()
    err = None
    got = None
    with rmatrix._knob(comm_retries=RETRIES, comm_backoff=BACKOFF_S), \
            fault_scope(storm_plan(seed, nranks)) as plan, obs.trace():
        try:
            got = mpi.run_ranks(fn, nranks, timeout=CELL_TIMEOUT_S,
                                device=device)
        except mpi.CommError as e:
            err = e
    rec["fired"] = sorted(plan.fired_kinds())
    rec["wall_s"] = time.monotonic() - t0
    if err is not None:
        rec.update(status="ok",
                   detail=f"typed {type(err).__name__} (attributed "
                          "storm loss), no hang")
        return rec
    if not rmatrix._tree_equal(got, baseline):
        rec.update(status="fail",
                   detail="storm result diverges silently")
        return rec
    rec.update(status="ok", detail="recovered bitwise under the "
               f"4-kind storm (fired={rec['fired']})")
    return rec
