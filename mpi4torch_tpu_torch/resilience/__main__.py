"""``python -m mpi4torch_tpu_torch.resilience --smoke|--chaos
[--device cpu]`` — the fault-matrix and chaos smoke lanes.

``--smoke`` runs the FULL fault matrix (:mod:`.matrix`): every
registered fault kind × one representative collective per subsystem
(plain / fused / compressed / overlap, plus the checkpoint cell), on
the ``(3,)``, ``(8,)`` and (2,4)-factorized torus worlds.  A cell passes
only when its fault is recovered (bitwise-exact under the configured
retries), detected (its typed, rank-attributed error), or provably
inert (no eligible target AND a bitwise-exact result); the lane exits
non-zero on any other outcome and when the fault-kind registry and the
coverage table have drifted apart (:func:`resilience_problems`).

``--chaos`` runs the GRAY-failure matrix (:mod:`.chaos`): every (gray
kind × {plain, fused, compressed, overlap, serve, elastic}) cell plus
seeded multi-fault storms — each cell must end recovered bitwise,
degraded with an attributed epoch-fenced transition, or in its typed
attributed raise; the fired-fault ledger must show every gray kind
acted somewhere, and the degrade-policy registry guard
(:func:`degrade_problems`) runs first.

``--device`` picks the rank worlds' device (default: CUDA).
"""

from __future__ import annotations

import sys
from typing import Iterable, List


def set_drift(registered: Iterable, covered: Iterable,
              message: str) -> List[str]:
    """The shared core of the registry-sync guards: ``[message]`` when
    the two name sets differ, else ``[]``.  ``message`` may reference
    ``{registered}`` and ``{covered}`` (each the sorted list)."""
    r, c = set(registered), set(covered)
    if r == c:
        return []
    return [message.format(registered=sorted(r), covered=sorted(c))]


def resilience_problems() -> List[str]:
    """Fault-kind registry vs the censused matrix coverage."""
    from .faults import FAULT_KINDS
    from .matrix import COMM_SUBSYSTEMS, COVERAGE

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


def degrade_problems() -> List[str]:
    """Gray-failure registry sync: the chaos matrix's coverage table vs
    the gray fault kinds (each of which must also be a registered fault
    kind WITH a plain fault-matrix row), and the degrade-policy registry
    vs the chaos matrix's degrade cells — a policy without a cell, or a
    covered cell whose policy is unregistered, fails the chaos lane."""
    from .chaos import (CHAOS_COVERAGE, CHAOS_SUBSYSTEMS, DEGRADE_COVERED,
                        GRAY_KINDS)
    from .degrade import DEGRADE_POLICIES
    from .faults import FAULT_KINDS
    from .matrix import COVERAGE as FAULT_COVERAGE

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


def _report(tag: str, rec: dict) -> int:
    if rec["status"] == "ok":
        print(f"ok  : {tag}: {rec['detail']}")
        return 0
    print(f"FAIL: {tag}: {rec['detail']}")
    return 1


def _smoke(device) -> int:
    import tempfile

    from ..runtime import resolve_device
    from .matrix import (COVERAGE, WORLDS, coverage_cells, run_cell,
                         run_checkpoint_cell)

    dev = resolve_device(device)
    print(f"faults-smoke: device {dev}, {len(COVERAGE)} fault kinds")
    problems = resilience_problems()
    for p in problems:
        print(f"FAIL[registry]: {p}")
    failures = len(problems)
    ran = 0
    for nranks, algorithm in WORLDS:
        world = f"({nranks},)" if algorithm is None \
            else f"({nranks} as 2-level torus)"
        for kind, subsystem in coverage_cells():
            if subsystem == "checkpoint":
                continue  # world-independent; run once below
            if algorithm is not None and subsystem not in (
                    "plain", "compressed"):
                # The torus leg exercises the 2-level schedule — only
                # the cells that take an algorithm argument ride it.
                continue
            rec = run_cell(kind, subsystem, nranks=nranks,
                           algorithm=algorithm, device=dev)
            ran += 1
            failures += _report(f"{kind} x {subsystem} @ {world}", rec)
    with tempfile.TemporaryDirectory() as d:
        rec = run_checkpoint_cell(d)
    ran += 1
    failures += _report("truncate_save x checkpoint", rec)

    print(f"faults-smoke: {ran} cells, {failures} failure(s)")
    if failures:
        return 1
    print("faults-smoke: OK — every fault recovered, typed+attributed, "
          "or provably inert; no silent corruption")
    return 0


def _chaos(device) -> int:
    from ..runtime import resolve_device
    from .chaos import GRAY_KINDS, coverage_cells, run_chaos_cell, \
        run_storm

    dev = resolve_device(device)
    print(f"chaos-smoke: device {dev}, gray kinds {GRAY_KINDS}")
    problems = degrade_problems()
    for p in problems:
        print(f"FAIL[registry]: {p}")
    failures = len(problems)

    ran = 0
    fired_kinds = set()
    for kind, subsystem in coverage_cells():
        rec = run_chaos_cell(kind, subsystem, device=dev)
        ran += 1
        fired_kinds.update(rec.get("fired", []))
        failures += _report(f"{kind} x {subsystem} [{rec['expected']}]",
                            rec)

    for seed in (1, 2):
        rec = run_storm(seed, device=dev)
        ran += 1
        fired_kinds.update(rec.get("fired", []))
        failures += _report(f"storm seed={seed}", rec)

    unacted = set(GRAY_KINDS) - fired_kinds
    if unacted:
        failures += 1
        print(f"FAIL[ledger]: gray kind(s) {sorted(unacted)} never "
              "fired anywhere — the matrix is vacuous for them")

    print(f"chaos-smoke: {ran} cells, {failures} failure(s)")
    if failures:
        return 1
    print("chaos-smoke: OK — every gray cell recovered bitwise, "
          "degraded with an attributed epoch-fenced transition, or "
          "raised typed+attributed; no hangs, every kind acted")
    return 0


def _device_arg(argv):
    if "--device" in argv:
        return argv[argv.index("--device") + 1]
    return None


def main(argv) -> int:
    if "--chaos" in argv:
        return _chaos(_device_arg(argv))
    if "--smoke" in argv:
        return _smoke(_device_arg(argv))
    print(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
