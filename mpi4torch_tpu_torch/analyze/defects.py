"""Seeded-defect corpus: mutated schedules proving every lint fires.

Port of ``mpi4torch_tpu/analyze/defects.py``.  A lint that never fires
reads as coverage and checks nothing, so for every lint in
:data:`~mpi4torch_tpu_torch.analyze.LINT_NAMES` the corpus carries at
least one *mutated schedule* — a clean recorded program with a targeted
defect spliced into its records (the JAX package splices text; the port
rewrites the typed records) — and :func:`run_defect_corpus` verifies
that

1. the clean program lints clean,
2. the mutant is caught **by the named lint** (not incidentally by
   another), and
3. every registered lint catches at least one mutant (the ledger —
   :func:`defect_ledger_problems`).

The mutations are the static analogues of the runtime failure modes:

* ``dropped-wait`` — a bucket's ``.wait`` span vanishes (the un-waited
  handle that DeadlockError catches at run time);
* ``orphan-wait`` — a wait with no start (a completion for a handle
  nothing issued);
* ``double-wait`` — a bucket's completion collective duplicated (the
  BifurcationError double-Wait);
* ``duplicated-permute-target`` — two sources shipping into one target
  rank (a silently dropped shard);
* ``non-partitioning-group`` — a replica group that lists one rank
  twice and another not at all (a contribution that never merges);
* ``dropped-backward`` — a value-and-gradient recording that contains no
  backward collectives (AD transparency silently lost).

``python -m mpi4torch_tpu_torch.analyze --defects`` and the tests run
this one corpus.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from .lints import LINT_NAMES, check_vjp_symmetry, run_lints
from .parse import ParsedProgram, parse_program

__all__ = [
    "DEFECTS",
    "Defect",
    "DefectPrograms",
    "run_defect_corpus",
    "defect_ledger_problems",
]


@dataclass(frozen=True)
class DefectPrograms:
    """The clean recorded programs the corpus mutates: a windowed
    split-phase program (bucket ``.start``/``.wait`` spans), a
    permute-schedule program (``source_target_pairs`` tables), a
    grouped-collective program (``replica_groups``), and a forward /
    forward+backward recording of one registered algorithm."""
    split_phase: object    # bucket start/wait spans
    permute: object        # >= 1 collective_permute
    grouped: object        # >= 1 replica_groups op
    fwd: object            # forward recording of a registered algorithm
    fwdbwd: object         # the same program with its gradient


@dataclass(frozen=True)
class Defect:
    """One seeded defect: which clean program it mutates, the mutation,
    and the lint that must catch it by name."""
    name: str
    lint: str                                  # LINT_NAMES entry
    program: str                               # DefectPrograms field
    doc: str
    mutate: Callable[[ParsedProgram], ParsedProgram]


def _first_bucket(parsed: ParsedProgram, phase: str) -> Optional[str]:
    """The ``<Op>.bucket<i>of<n>`` label of the first bucket span with
    ``phase``, or None."""
    for ev in parsed.events:
        b = ev.bucket
        if b is not None and b[3] == phase:
            return f"{b[0]}.bucket{b[1]}of{b[2]}"
    return None


def _rescope(parsed: ParsedProgram, old: str, new: str) -> ParsedProgram:
    """Every event's and collective's span path with ``old`` renamed."""
    return dataclasses.replace(
        parsed,
        events=tuple(dataclasses.replace(ev, scope=ev.scope.replace(
            old, new)) for ev in parsed.events),
        collectives=tuple(dataclasses.replace(op, scope=op.scope.replace(
            old, new)) for op in parsed.collectives))


def _mutate_drop_wait(parsed: ParsedProgram) -> ParsedProgram:
    """Erase one bucket's ``.wait`` phase suffix — its start span now
    dangles with no completion anywhere in the program."""
    label = _first_bucket(parsed, "wait")
    if label is None:
        raise ValueError("no split-phase wait span to drop")
    return _rescope(parsed, f"mpi4torch.{label}.wait",
                    f"mpi4torch.{label}")


def _mutate_orphan_wait(parsed: ParsedProgram) -> ParsedProgram:
    """Erase one bucket's ``.start`` phase suffix — its wait span now
    completes a handle nothing issued."""
    label = _first_bucket(parsed, "start")
    if label is None:
        raise ValueError("no split-phase start span to orphan")
    return _rescope(parsed, f"mpi4torch.{label}.start",
                    f"mpi4torch.{label}")


def _mutate_double_wait(parsed: ParsedProgram) -> ParsedProgram:
    """Duplicate the wire collective of one bucket's wait phase — the
    completion runs twice."""
    for k, op in enumerate(parsed.collectives):
        b = op.bucket
        if b is None or b[3] != "wait":
            continue
        at = op.line

        def shift(rec):
            return rec if rec.line <= at else dataclasses.replace(
                rec, line=rec.line + 1)

        events = [shift(ev) for ev in parsed.events]
        events.insert(at + 1, dataclasses.replace(parsed.events[at],
                                                  line=at + 1))
        colls = [shift(c) for c in parsed.collectives]
        colls.insert(k + 1, dataclasses.replace(op, line=at + 1))
        return dataclasses.replace(parsed, events=tuple(events),
                                   collectives=tuple(colls))
    raise ValueError("no wait-phase wire collective to duplicate")


def _replace_first(parsed: ParsedProgram, pick, edit) -> ParsedProgram:
    for k, op in enumerate(parsed.collectives):
        if pick(op):
            colls = list(parsed.collectives)
            colls[k] = edit(op)
            return dataclasses.replace(parsed, collectives=tuple(colls))
    return None


def _mutate_duplicate_permute_target(parsed: ParsedProgram
                                     ) -> ParsedProgram:
    """Point two sources at one target rank in the first permute's
    ``source_target_pairs`` table."""
    def edit(op):
        p = list(op.source_target_pairs)
        p[1] = (p[1][0], p[0][1])
        return dataclasses.replace(op, source_target_pairs=tuple(p))

    got = _replace_first(
        parsed, lambda op: op.kind == "collective_permute"
        and len(op.source_target_pairs or ()) >= 2, edit)
    if got is None:
        raise ValueError("no >= 2-pair source_target_pairs to mutate")
    return got


def _mutate_non_partitioning_group(parsed: ParsedProgram
                                   ) -> ParsedProgram:
    """Make the first replica-group table list one rank twice and drop
    another: the duplicated rank reduces twice, the dropped rank's
    contribution never merges."""
    def edit(op):
        g0 = op.replica_groups[0]
        groups = ((g0[0], g0[0]) + tuple(g0[2:]),) + op.replica_groups[1:]
        return dataclasses.replace(op, replica_groups=groups)

    got = _replace_first(
        parsed, lambda op: op.replica_groups is not None
        and len(op.replica_groups[0]) >= 2, edit)
    if got is None:
        raise ValueError("no >= 2-wide replica_groups to mutate")
    return got


DEFECTS: Dict[str, Defect] = {}


def _register(defect: Defect) -> Defect:
    DEFECTS[defect.name] = defect
    return defect


_register(Defect(
    name="dropped-wait", lint="split-phase", program="split_phase",
    doc="a split-phase bucket's wait span erased (un-waited handle)",
    mutate=_mutate_drop_wait))
_register(Defect(
    name="orphan-wait", lint="split-phase", program="split_phase",
    doc="a split-phase bucket's start span erased (wait without start)",
    mutate=_mutate_orphan_wait))
_register(Defect(
    name="double-wait", lint="split-phase", program="split_phase",
    doc="a bucket's completion collective duplicated (double Wait)",
    mutate=_mutate_double_wait))
_register(Defect(
    name="duplicated-permute-target", lint="permute-pairs",
    program="permute",
    doc="two sources shipping into one target rank",
    mutate=_mutate_duplicate_permute_target))
_register(Defect(
    name="non-partitioning-group", lint="replica-groups",
    program="grouped",
    doc="a replica group listing one rank twice, another not at all",
    mutate=_mutate_non_partitioning_group))
_register(Defect(
    name="dropped-backward", lint="vjp-symmetry", program="fwdbwd",
    doc="a value-and-gradient recording with the backward collectives "
        "gone",
    mutate=lambda parsed: parsed))  # special-cased: fwd stands in


def run_defect_corpus(programs: DefectPrograms) -> List[dict]:
    """Apply every seeded defect and record whether its named lint
    fired.  Each record: ``{"defect", "lint", "doc", "clean_ok",
    "fired", "violations"}`` — a corpus cell passes only when the clean
    program lints clean AND the mutant is caught by the expected lint
    name."""
    records: List[dict] = []
    for name in sorted(DEFECTS):
        d = DEFECTS[name]
        clean = parse_program(getattr(programs, d.program))
        if d.lint == "vjp-symmetry":
            # The mutant pair: forward census present, backward absent —
            # the forward standing in for the value-and-gradient program.
            fwd = parse_program(programs.fwd)
            clean_v = check_vjp_symmetry(fwd, clean)
            viols = check_vjp_symmetry(fwd, d.mutate(fwd), context=name)
        else:
            clean_v = [v for v in run_lints(clean) if v.lint == d.lint]
            viols = run_lints(d.mutate(clean))
        fired = any(v.lint == d.lint for v in viols)
        records.append({
            "defect": name,
            "lint": d.lint,
            "doc": d.doc,
            "clean_ok": not clean_v,
            "fired": fired,
            "violations": [str(v) for v in viols],
        })
    return records


def defect_ledger_problems(records=None) -> List[str]:
    """The fired-defect ledger: every registered lint must be the named
    catcher of at least one corpus defect (a lint without a defect
    proving it fires is effectively untested), and — when ``records``
    from :func:`run_defect_corpus` are given — every defect must have
    fired on a clean baseline."""
    problems: List[str] = []
    covered = {d.lint for d in DEFECTS.values()}
    missing = sorted(set(LINT_NAMES) - covered)
    if missing:
        problems.append(
            f"lint(s) {missing} have no seeded defect in the corpus — "
            "a lint without a mutant proving it fires is effectively "
            "untested")
    unknown = sorted(covered - set(LINT_NAMES))
    if unknown:
        problems.append(
            f"defect(s) name unregistered lint(s) {unknown} — extend "
            "analyze.LINT_NAMES")
    for rec in records or []:
        if not rec["clean_ok"]:
            problems.append(
                f"{rec['defect']}: the CLEAN program already violates "
                f"{rec['lint']} — the corpus baseline is broken")
        if not rec["fired"]:
            problems.append(
                f"{rec['defect']}: lint {rec['lint']} did not fire on "
                "the mutated schedule")
    return problems
