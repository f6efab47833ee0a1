"""One home for the registry-sync guards, over the port's registries.

Port of ``mpi4torch_tpu/analyze/registry.py``.  Every subsystem that
keeps a registry keeps a guard asserting registry == coverage —
algorithms vs the census matrices, split-phase forms vs the facade's
``*_start`` methods, fault kinds vs the fault matrix, reshard step
kinds vs both executors and the sweep, serving policies vs the parity
matrix.  :func:`set_drift` is the shared core (compare two name sets,
return the caller's message on drift), and one ``*_problems`` function
per domain rebuilds each guard on it, with the JAX package's messages.
The subsystems' smoke lanes (``resilience``, ``elastic``, ``ctl``,
``transport``, ``reshard``) import their guards from here.
``python -m mpi4torch_tpu_torch.analyze --sweep`` runs every guard that
needs no caller literal (:func:`standing_problems`).

The coverage literals that pin what a *test matrix* covers stay with
that matrix: the callers pass them.  The port's serving and tier
literals live in its tests (it has no serve or csched smoke lane to
publish them), so :func:`serve_policy_problems`,
:func:`serve_paging_problems` and the coverage half of
:func:`tier_program_problems` take them as arguments and
:func:`standing_problems` runs the rest.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Set

__all__ = [
    "set_drift",
    "resilience_problems",
    "elastic_problems",
    "degrade_problems",
    "reshard_step_problems",
    "serve_policy_problems",
    "serve_paging_problems",
    "tune_problems",
    "overlap_split_phase_problems",
    "csched_problems",
    "tier_program_problems",
    "transport_problems",
    "ctl_problems",
    "standing_problems",
]


def set_drift(registered: Iterable, covered: Iterable,
              message: str) -> List[str]:
    """The shared core of every registry-sync guard: ``[message]`` when
    the two name sets differ, else ``[]``.  ``message`` may reference
    ``{registered}`` and ``{covered}`` (each formatted as the sorted
    list) so callers keep their historical failure texts."""
    r, c = set(registered), set(covered)
    if r == c:
        return []
    return [message.format(registered=sorted(r), covered=sorted(c))]


# ------------------------------------------------------------- resilience

def resilience_problems() -> List[str]:
    """Fault-kind registry vs the censused matrix coverage."""
    from ..resilience.faults import FAULT_KINDS
    from ..resilience.matrix import COMM_SUBSYSTEMS, COVERAGE

    problems = set_drift(
        FAULT_KINDS, COVERAGE,
        "registry/coverage drift: registered={registered} "
        "covered={covered} — every fault kind needs a "
        "matrix row and vice versa")
    for kind, rows in COVERAGE.items():
        if kind not in FAULT_KINDS:
            continue
        sites = FAULT_KINDS[kind].sites
        if "checkpoint" in sites:
            if "checkpoint" not in rows:
                problems.append(f"{kind}: checkpoint-site kind without a "
                                "checkpoint cell")
        else:
            missing = set(COMM_SUBSYSTEMS) - set(rows)
            if missing:
                problems.append(f"{kind}: no cell for subsystem(s) "
                                f"{sorted(missing)}")
        if rows and all(v == "inert" for v in rows.values()):
            problems.append(f"{kind}: inert in EVERY subsystem — the "
                            "kind is effectively untested")
    return problems


# ---------------------------------------------------------------- elastic

def elastic_problems() -> List[str]:
    """Elastic matrix coverage vs its declared dimensions, and the
    bridge into the resilience registry: every failure kind the elastic
    matrix composes must itself be a registered fault kind with a plain
    fault-matrix row (the preempt satellite's guard)."""
    from ..elastic.matrix import (ACTIONS, CONSENSUS_COVERAGE, COVERAGE,
                                  EXPECTED_CONSENSUS_ERROR, KINDS,
                                  SUBSYSTEMS)
    from ..resilience.faults import FAULT_KINDS
    from ..resilience.matrix import COVERAGE as FAULT_COVERAGE

    declared = {(k, s, a) for k in KINDS for s in SUBSYSTEMS
                for a in ACTIONS}
    problems = set_drift(
        declared, set(COVERAGE),
        "elastic coverage drift: declared cells {registered} vs "
        "COVERAGE table {covered} — every (kind x subsystem x action) "
        "needs a cell and vice versa")
    for kind in KINDS:
        if kind not in FAULT_KINDS:
            problems.append(
                f"elastic kind {kind!r} is not a registered fault kind "
                "— register it (resilience.faults) so the injection "
                "grammar covers it")
        elif kind not in FAULT_COVERAGE:
            problems.append(
                f"elastic kind {kind!r} has no plain fault-matrix row — "
                "the resilience matrix must pin its unhandled "
                "(raise) behavior before the elastic matrix composes "
                "its handled one")
    problems += set_drift(
        CONSENSUS_COVERAGE, {(k, "membership", "consensus")
                             for k in EXPECTED_CONSENSUS_ERROR},
        "consensus-cell drift: coverage {registered} vs expected-error "
        "table {covered}")
    bad = [v for v in list(COVERAGE.values())
           + list(CONSENSUS_COVERAGE.values())
           if v not in ("recover", "raise")]
    if bad:
        problems.append(f"unknown elastic cell outcomes {sorted(set(bad))}")
    return problems


# ---------------------------------------------------------------- degrade

def degrade_problems() -> List[str]:
    """Gray-failure registry sync: the chaos matrix's
    coverage table vs the gray fault kinds (each of which must also be
    a registered fault kind WITH a plain fault-matrix row — the
    resilience matrix pins the transient behavior before the chaos
    matrix composes detection/degrade on top), and the degrade-policy
    registry vs the chaos matrix's degrade cells — a policy without a
    cell, or a covered cell whose policy is unregistered, fails the
    analyze sweep."""
    from ..resilience.chaos import (CHAOS_COVERAGE, CHAOS_SUBSYSTEMS,
                                    DEGRADE_COVERED, GRAY_KINDS)
    from ..resilience.degrade import DEGRADE_POLICIES
    from ..resilience.faults import FAULT_KINDS
    from ..resilience.matrix import COVERAGE as FAULT_COVERAGE

    problems = set_drift(
        GRAY_KINDS, CHAOS_COVERAGE,
        "gray-kind/chaos-coverage drift: kinds={registered} "
        "covered={covered} — every gray kind needs a chaos row and "
        "vice versa")
    for kind in GRAY_KINDS:
        if kind not in FAULT_KINDS:
            problems.append(
                f"gray kind {kind!r} is not a registered fault kind — "
                "register it (resilience.faults) so the injection "
                "grammar covers it")
        elif kind not in FAULT_COVERAGE:
            problems.append(
                f"gray kind {kind!r} has no plain fault-matrix row — "
                "the resilience matrix must pin its transient behavior "
                "before the chaos matrix composes the gray one")
        missing = set(CHAOS_SUBSYSTEMS) - set(CHAOS_COVERAGE.get(kind,
                                                                 {}))
        if missing:
            problems.append(f"{kind}: no chaos cell for subsystem(s) "
                            f"{sorted(missing)}")
    problems += set_drift(
        DEGRADE_POLICIES, set(DEGRADE_COVERED.values()),
        "degrade-policy registry {registered} != chaos-covered "
        "policies {covered} — every registered policy needs a degrade "
        "cell exercising it (DEGRADE_COVERED) and vice versa")
    for (kind, subsystem), policy in DEGRADE_COVERED.items():
        if CHAOS_COVERAGE.get(kind, {}).get(subsystem) != "degrade":
            problems.append(
                f"DEGRADE_COVERED names ({kind} x {subsystem}) for "
                f"policy {policy!r}, but the chaos coverage table does "
                "not declare that cell 'degrade'")
    bad = sorted({v for rows in CHAOS_COVERAGE.values()
                  for v in rows.values()
                  if v not in ("recover", "degrade", "escalate",
                               "inert")})
    if bad:
        problems.append(f"unknown chaos cell outcomes {bad}")
    return problems


# ---------------------------------------------------------------- reshard

def reshard_step_problems(exercised: Optional[Set[str]] = None
                          ) -> List[str]:
    """Step-kind registry vs both executor dispatch tables, plus —
    when the sweep passes the step kinds its forward+adjoint plans
    actually exercised — sweep coverage."""
    from ..reshard import STEP_KINDS
    from ..reshard.executor import _EAGER_EXEC, _SPMD_EXEC

    kinds = set(STEP_KINDS)
    probs: List[str] = []
    if set(_SPMD_EXEC) != kinds:
        probs.append(f"SPMD executor serves {sorted(_SPMD_EXEC)}")
    if set(_EAGER_EXEC) != kinds:
        probs.append(f"eager executor serves {sorted(_EAGER_EXEC)}")
    if exercised is not None and set(exercised) != kinds:
        probs.append(
            f"sweep exercised {sorted(exercised)} of {sorted(kinds)}")
    return probs


# ------------------------------------------------------------------ serve

def serve_policy_problems(parity_policies: Iterable) -> List[str]:
    """Scheduling-policy registry vs the parity-covered set the
    engine-vs-oracle matrix enumerates."""
    from ..serve import POLICIES

    return set_drift(
        POLICIES, parity_policies,
        "policy registry {registered} != parity-covered set {covered} "
        "— every scheduling policy needs oracle-parity coverage")


def serve_paging_problems(paged_parity_policies: Iterable,
                          mirrored_counters: Iterable) -> List[str]:
    """Paged-serving registry-sync guards: every scheduling policy must
    also hold engine-vs-oracle parity under block churn
    (``paged_parity_policies``, the paged matrix's literal), and every
    ServeStats counter must be mirrored into the ``mpi4torch_serve_*``
    obs metrics (``mirrored_counters``) — a new counter cannot ship
    unmirrored, a new policy cannot ship without paged parity
    coverage."""
    from ..serve import POLICIES
    from ..utils.profiling import ServeStats

    problems = set_drift(
        POLICIES, paged_parity_policies,
        "policy registry {registered} != paged-parity covered set "
        "{covered} — every scheduling policy needs oracle-parity "
        "coverage under block churn too")
    problems += set_drift(
        ServeStats._COUNTERS, mirrored_counters,
        "ServeStats counters {registered} != obs-mirrored set "
        "{covered} — every serve counter must surface as an "
        "mpi4torch_serve_* metric")
    return problems


# ------------------------------------------------------------------- tune

def tune_problems(algos: Iterable, census_covered: Iterable,
                  codec_capable: Iterable) -> List[str]:
    """Algorithm registry vs the parity/census matrices and the
    codec-capability cross-declarations."""
    from .. import tune
    from ..compress import available_codecs, get_codec

    registered = set(tune.available_algorithms())
    problems = set_drift(
        registered, algos,
        "registered algorithms {registered} out of sync with "
        "the parity/grads test matrix {covered} — extend "
        "ALGOS (and the tests it parametrizes)")
    problems += set_drift(
        registered, census_covered,
        "registered algorithms {registered} out of sync with "
        "the HLO census matrix {covered} — add a "
        "forward+backward census test and list the name in "
        "CENSUS_COVERED")
    capable = {a for a in registered
               if tune.get_algorithm(a).codec_capable}
    problems += set_drift(
        capable, codec_capable,
        "codec-capable algorithms {registered} out of sync with "
        "CODEC_CAPABLE {covered} — extend the literal "
        "(and check TestCodecAlgorithmCensus covers the new schedule)")
    for name in available_codecs():
        declared = set(get_codec(name).algorithms)
        if not declared <= capable:
            problems.append(
                f"codec {name!r} declares algorithms {sorted(declared)} "
                "outside the registry's codec_capable set — either mark "
                "the algorithm codec_capable (and census the pair) or "
                "fix the codec's declaration")
        if not declared:
            problems.append(
                f"codec {name!r} declares no algorithms — "
                "even exact-wire fallbacks need 'ring'")
    return problems


# ---------------------------------------------------------------- overlap

def overlap_split_phase_problems(census_covered: Iterable) -> List[str]:
    """Split-phase form registry vs the facade's ``*_start`` surface
    and the census matrix."""
    from ..comm import MPI_Communicator
    from ..overlap import SPLIT_PHASE_FORMS

    registered = set(SPLIT_PHASE_FORMS)
    facade_starts = {m[:-len("_start")] for m in dir(MPI_Communicator)
                     if m.endswith("_start") and not m.startswith("_")}
    problems = set_drift(
        facade_starts, registered,
        "facade *_start methods {registered} out of sync "
        "with overlap.SPLIT_PHASE_FORMS {covered}")
    problems += set_drift(
        registered, census_covered,
        "registered split-phase forms {registered} out of sync "
        "with the census matrix {covered} — add a "
        "start-precedes-compute census test and list the form")
    return problems


# ----------------------------------------------------------------- csched

def csched_problems() -> List[str]:
    """Schedule-IR registry sync: every registered collective
    algorithm either declares an IR program (csched.PROGRAM_ALGORITHMS)
    or an explicit native exemption, and every IR step kind is covered
    by the lowering, interpreter, transposition AND census dispatch
    tables — so extending the grammar without extending a table, or
    registering an algorithm outside the IR, fails the analyze sweep
    structurally."""
    from .. import csched, tune

    problems: List[str] = []
    registered = set(tune.available_algorithms())
    declared = set(csched.PROGRAM_ALGORITHMS) | set(csched.NATIVE_EXEMPT)
    missing = sorted(registered - declared)
    if missing:
        problems.append(
            f"algorithm(s) {missing} registered without an IR program "
            "or a csched.NATIVE_EXEMPT entry — every schedule must "
            "re-express through the IR or be exempted explicitly")
    stale = sorted(declared - registered)
    if stale:
        problems.append(
            f"csched declares program(s)/exemption(s) {stale} for "
            "algorithms the tune registry no longer knows")
    kinds = set(csched.STEP_KINDS)
    for table, covered in (
            ("lowering", csched.lowering_covers()),
            ("interpreter", csched.interpreter_covers()),
            ("transposition", csched.transposition_covers()),
            ("census", csched.census_covers())):
        problems += set_drift(
            kinds, covered,
            "IR step-kind registry {registered} out of sync with the "
            + table + " dispatch table {covered} — every step kind "
            "needs " + table + " coverage")
    return problems


def tier_program_problems(parity_covered: Optional[Iterable] = None,
                          census_covered: Optional[Iterable] = None
                          ) -> List[str]:
    """Tier-composition registry sync: every per-tier (algorithm x
    codec) composition the tier synthesis searches
    (``csched.TIER_COMPOSITIONS``) must transpose to a program with the
    forward's per-tier census (the declared ``"self"`` VJP every
    allreduce schedule ships), and, when the callers' coverage literals
    are given, hold a parity cell and a per-tier census cell."""
    from .. import csched

    problems: List[str] = []
    if parity_covered is not None:
        problems += set_drift(
            csched.TIER_COMPOSITIONS, parity_covered,
            "tier compositions {registered} out of sync with the "
            "parity matrix {covered} — every searched composition "
            "needs a parity cell")
    if census_covered is not None:
        problems += set_drift(
            csched.TIER_COMPOSITIONS, census_covered,
            "tier compositions {registered} out of sync with the "
            "census matrix {covered} — every searched composition "
            "needs a per-tier census cell")
    tiers = (2, 2, 2)
    for comp in csched.TIER_COMPOSITIONS:
        prog = csched.fold_program(8, tiers, tiers)
        if comp == "q8-slow":
            prog = csched.rewrite_fold_codec(prog, (len(tiers) - 1,))
        fwd = csched.program_tier_census(prog, 1024, 4, tiers)
        bwd = csched.program_tier_census(csched.transpose(prog), 1024, 4,
                                         tiers)
        if fwd != bwd:
            problems.append(
                f"tier composition {comp!r} does not transpose to its "
                f"own per-tier census (fwd {fwd} vs bwd {bwd}) — the "
                "declared 'self' VJP no longer holds")
    return problems


# -------------------------------------------------------------- transport

def transport_problems() -> List[str]:
    """Transport registry sync: every backend registered in
    ``transport.TRANSPORTS`` must be in the transport smoke's parity
    matrix (``transport.__main__.TESTED_BACKENDS``)."""
    from ..transport import TRANSPORTS
    from ..transport.__main__ import TESTED_BACKENDS

    return set_drift(
        set(TRANSPORTS), set(TESTED_BACKENDS),
        "transport registry {registered} out of sync with the "
        "smoke-tested backend set {covered} — every registered "
        "backend must pass the bitwise parity matrix")


# -------------------------------------------------------------------- ctl

def ctl_problems() -> List[str]:
    """Self-tuning controller registry sync: the decision
    ledger's trigger vocabulary (``ctl.ledger.TRIGGER_KINDS``), the
    ctl-smoke lane's coverage literal (``ctl.__main__.LEDGER_COVERED``)
    and the degrade-policy delegation map
    (``ctl.controller.POLICY_TRIGGER``) must move together — a new
    trigger kind cannot ship without a smoke cell that records it, and
    a new degrade policy cannot ship outside the controller's ONE
    switching mechanism (every DEGRADE_POLICIES entry must delegate to
    a registered trigger)."""
    from ..ctl.__main__ import LEDGER_COVERED
    from ..ctl.controller import POLICY_TRIGGER
    from ..ctl.ledger import TRIGGER_KINDS
    from ..resilience.degrade import DEGRADE_POLICIES

    problems = set_drift(
        TRIGGER_KINDS, LEDGER_COVERED,
        "ledger trigger kinds {registered} out of sync with the "
        "ctl-smoke coverage literal {covered} — every trigger kind "
        "needs a smoke cell that records a ledgered switch")
    problems += set_drift(
        DEGRADE_POLICIES, POLICY_TRIGGER,
        "degrade-policy registry {registered} out of sync with the "
        "controller's delegation map {covered} — every policy must "
        "route through the controller's ratified switch "
        "(ctl.controller.POLICY_TRIGGER)")
    stray = sorted(set(POLICY_TRIGGER.values()) - set(TRIGGER_KINDS))
    if stray:
        problems.append(
            f"POLICY_TRIGGER delegates to unregistered trigger "
            f"kind(s) {stray} — the ledger would refuse the record")
    return problems


# ------------------------------------------------------------- everything

def standing_problems() -> List[str]:
    """Every registry-sync guard that needs no caller-side coverage
    literal: the resilience fault matrix, the elastic and chaos
    matrices, the reshard executor tables, the schedule IR's tables and
    tier transposition, the transport and controller registries.  The
    analyze sweep runs this, so a drift in any of them fails
    ``python -m mpi4torch_tpu_torch.analyze --sweep`` too."""
    problems = [f"resilience: {p}" for p in resilience_problems()]
    problems += [f"elastic: {p}" for p in elastic_problems()]
    problems += [f"degrade: {p}" for p in degrade_problems()]
    problems += [f"reshard: {p}" for p in reshard_step_problems()]
    problems += [f"csched: {p}" for p in csched_problems()]
    problems += [f"csched: {p}" for p in tier_program_problems()]
    problems += [f"transport: {p}" for p in transport_problems()]
    problems += [f"ctl: {p}" for p in ctl_problems()]
    return problems
