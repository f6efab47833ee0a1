"""Soundness lints over the shared parse of a recorded program.

Port of ``mpi4torch_tpu/analyze/lints.py``, with the same verdicts on
the same programs; a violation's ``line`` is the index of its event in
the recorded stream.  The runtime failure modes of the collective
machinery — a permute schedule that loses or duplicates a shard, a
grouped collective whose groups drop a rank, a split-phase handle that
deadlocks un-waited or double-completes, a backward pass that is not the
forward's transpose — exist as *runtime* errors (``DeadlockError``,
``BifurcationError``, ``IntegrityError``) that need the wire to run
before they surface.  Each lint here diagnoses the same class of
defect from the recorded program alone:

=========================  =============================================
lint name                  property checked
=========================  =============================================
``permute-pairs``          every ``collective_permute``'s
                           ``source_target_pairs`` form a valid partial
                           permutation: no duplicated source, no
                           duplicated target, endpoints inside the
                           participating axis — a duplicated target is
                           two ranks writing one buffer (the runtime
                           analogue: silently dropped contribution).
``replica-groups``         every grouped collective's
                           ``replica_groups`` exactly partition the
                           participating axis (``num_partitions``):
                           no rank in two groups, no rank in none — a
                           non-partitioning group is a rank whose
                           contribution never merges (the runtime
                           analogue: a hang or a wrong sum).
``split-phase``            split-phase bucket spans pair up: every
                           ``.start`` span has a ``.wait`` (a dangling
                           start is the recorded ``DeadlockError``),
                           every ``.wait`` has a ``.start``, and no
                           bucket's wait phase completes the same wire
                           collective twice (the recorded
                           ``BifurcationError``).
``vjp-symmetry``           a registered algorithm's backward census is
                           the declared transpose of its forward
                           (``AlgorithmSpec.vjp_census``) — the paper's
                           "backward of a collective is itself a
                           collective", checked structurally.
=========================  =============================================

:func:`run_lints` runs the single-program lints; the VJP lint compares
two lowerings (forward, forward+backward) via
:func:`check_vjp_symmetry`.  Every lint is proven live by the
seeded-defect corpus (:mod:`.defects`): a mutated schedule per lint
that must be caught *by name*.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

from .parse import COLLECTIVE_KINDS, ParsedProgram, parse_program

__all__ = [
    "LINT_NAMES",
    "LintViolation",
    "run_lints",
    "check_vjp_symmetry",
    "lint_permute_pairs",
    "lint_replica_groups",
    "lint_split_phase",
]

# The closed lint registry.  The defect-corpus ledger (defects.py)
# cross-checks it: every name here must be the named catcher of at
# least one seeded defect, so a lint cannot ship without proof that it
# fires.
LINT_NAMES = ("permute-pairs", "replica-groups", "split-phase",
              "vjp-symmetry")


@dataclass(frozen=True)
class LintViolation:
    """One soundness violation, attributed to a program site."""
    lint: str                  # LINT_NAMES entry
    detail: str                # human diagnosis
    line: Optional[int] = None         # event index in the recording
    scope: str = ""                    # span path, when known

    def __str__(self):
        at = f" @ event {self.line}" if self.line is not None else ""
        span = f" [{self.scope}]" if self.scope else ""
        return f"{self.lint}{at}{span}: {self.detail}"


def _dups(values) -> List:
    return sorted(v for v, c in Counter(values).items() if c > 1)


def lint_permute_pairs(parsed: ParsedProgram) -> List[LintViolation]:
    """``source_target_pairs`` must be a valid partial permutation."""
    out: List[LintViolation] = []
    n = parsed.num_partitions
    for op in parsed.collectives:
        if op.kind != "collective_permute" or not op.source_target_pairs:
            continue
        srcs = [s for s, _ in op.source_target_pairs]
        tgts = [t for _, t in op.source_target_pairs]
        for what, dups in (("source", _dups(srcs)), ("target",
                                                     _dups(tgts))):
            if dups:
                out.append(LintViolation(
                    "permute-pairs",
                    f"duplicated {what} rank(s) {dups} in "
                    f"source_target_pairs {list(op.source_target_pairs)}"
                    " — not a partial permutation",
                    line=op.line, scope=op.scope))
        if n is not None:
            bad = sorted({v for v in srcs + tgts
                          if not 0 <= v < n})
            if bad:
                out.append(LintViolation(
                    "permute-pairs",
                    f"rank(s) {bad} outside the {n}-partition axis in "
                    f"source_target_pairs {list(op.source_target_pairs)}",
                    line=op.line, scope=op.scope))
    return out


def lint_replica_groups(parsed: ParsedProgram) -> List[LintViolation]:
    """``replica_groups`` must exactly partition the participating
    axis."""
    out: List[LintViolation] = []
    n = parsed.num_partitions
    for op in parsed.collectives:
        if op.replica_groups is None:
            continue
        flat = [v for g in op.replica_groups for v in g if v >= 0]
        dups = _dups(flat)
        if dups:
            out.append(LintViolation(
                "replica-groups",
                f"rank(s) {dups} appear in more than one replica group "
                f"of {op.kind} {list(map(list, op.replica_groups))}",
                line=op.line, scope=op.scope))
        if n is not None:
            missing = sorted(set(range(n)) - set(flat))
            if missing:
                out.append(LintViolation(
                    "replica-groups",
                    f"replica groups "
                    f"{list(map(list, op.replica_groups))} of {op.kind} "
                    f"do not partition the {n}-partition axis — "
                    f"rank(s) {missing} are in no group",
                    line=op.line, scope=op.scope))
    return out


def lint_split_phase(parsed: ParsedProgram) -> List[LintViolation]:
    """Split-phase ``.start``/``.wait`` bucket spans must pair up, and
    no bucket may complete the same wire collective twice."""
    out: List[LintViolation] = []
    phases: Dict[tuple, Dict[str, List[int]]] = {}
    for ev in parsed.events:
        b = ev.bucket
        if b is None or b[3] is None:
            continue
        phases.setdefault(b[:3], {"start": [], "wait": []})[
            b[3]].append(ev.line)

    for key in sorted(phases):
        op, i, tot = key
        label = f"{op}.bucket{i}of{tot}"
        slot = phases[key]
        if slot["start"] and not slot["wait"]:
            out.append(LintViolation(
                "split-phase",
                f"{label}: started but never waited — an un-waited "
                "split-phase handle deadlocks its region "
                "(DeadlockError at run time)",
                line=min(slot["start"]), scope=label))
        if slot["wait"] and not slot["start"]:
            out.append(LintViolation(
                "split-phase",
                f"{label}: waited but never started — the handle this "
                "wait completes was issued nowhere in the program",
                line=min(slot["wait"]), scope=label))

    # Double completion: the same wire collective signature twice
    # inside one bucket's wait phase (a WaitHandle completes exactly
    # once — BifurcationError at run time).
    waits: Dict[tuple, Counter] = {}
    firsts: Dict[tuple, int] = {}
    for cop in parsed.collectives:
        b = cop.bucket
        if b is None or b[3] != "wait":
            continue
        sig = (cop.kind, cop.operand_types, cop.result_types,
               cop.replica_groups, cop.source_target_pairs)
        waits.setdefault(b[:3], Counter())[sig] += 1
        firsts.setdefault(b[:3] + (sig,), cop.line)
    for key, sigs in sorted(waits.items()):
        op, i, tot = key
        label = f"{op}.bucket{i}of{tot}"
        for sig, count in sigs.items():
            if count > 1:
                out.append(LintViolation(
                    "split-phase",
                    f"{label}: wait phase completes the same "
                    f"{sig[0]} {count}x — a split-phase handle "
                    "completes exactly once (BifurcationError at run "
                    "time)",
                    line=firsts[key + (sig,)], scope=label))
    return out


def run_lints(program) -> List[LintViolation]:
    """Run every single-program soundness lint over a recorded program
    (or its parse); returns the (possibly empty) violation list.  The
    VJP-symmetry lint needs a forward AND a forward+backward lowering —
    see :func:`check_vjp_symmetry`."""
    parsed = parse_program(program)
    out: List[LintViolation] = []
    out += lint_permute_pairs(parsed)
    out += lint_replica_groups(parsed)
    out += lint_split_phase(parsed)
    return out


def _transpose_census(census: Dict[str, int],
                      declaration: Union[str, Dict[str, str]]
                      ) -> Dict[str, int]:
    """The declared backward census of a forward census.  ``"self"``
    (the self-adjoint declaration every shipped allreduce schedule
    makes: psum's adjoint is psum, so the backward re-runs the same
    machinery) maps each kind to itself; a dict declaration maps op
    kinds to their transposed kinds (``{"all_gather":
    "reduce_scatter", ...}``)."""
    if declaration == "self":
        return dict(census)
    if isinstance(declaration, dict):
        out = {k: 0 for k in COLLECTIVE_KINDS}
        for kind, count in census.items():
            out[declaration.get(kind, kind)] += count
        return out
    raise ValueError(
        f"unknown vjp_census declaration {declaration!r}; declare "
        "'self' or a kind->kind transpose mapping")


def check_vjp_symmetry(fwd, fwdbwd,
                       declaration: Union[str, Dict[str, str]] = "self",
                       context: str = "") -> List[LintViolation]:
    """Check that the backward half of ``fwdbwd`` (the recording of the
    same program with its gradient taken from outside) adds exactly the
    declared transpose of the forward census — the paper's AD-transparency
    contract, structurally: the backward of a collective schedule is
    itself a collective schedule, with the declared op mix.

    ``declaration`` comes from the registered
    ``AlgorithmSpec.vjp_census`` (how a new algorithm declares its
    symmetry)."""
    fwd_p = parse_program(fwd)
    bwd_p = parse_program(fwdbwd)
    fc, bc = fwd_p.census(), bwd_p.census()
    added = {k: bc[k] - fc[k] for k in COLLECTIVE_KINDS}
    expected = _transpose_census(
        {k: v for k, v in fc.items() if v}, declaration)
    want = {k: expected.get(k, 0) for k in COLLECTIVE_KINDS}
    if added != want:
        tag = f"{context}: " if context else ""
        return [LintViolation(
            "vjp-symmetry",
            f"{tag}backward census is not the declared transpose of "
            f"the forward: forward {_short(fc)}, backward adds "
            f"{_short(added)}, declaration {declaration!r} expects "
            f"{_short(want)}")]
    return []


def _short(census: Dict[str, int]) -> Dict[str, int]:
    return {k: v for k, v in census.items() if v}
