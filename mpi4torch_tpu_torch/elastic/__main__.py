"""``python -m mpi4torch_tpu_torch.elastic --smoke [--device cpu]`` — the
elastic smoke lane.

Runs the FULL elastic matrix (:mod:`.matrix`): every (failure kind ×
subsystem × action) cell — rank_death and preempt across the plain /
ZeRO / MoE / serve subsystems under shrink, grow-after-shrink and
hot-spare takeover — plus the two membership-failure cells (injected
proposal disagreement; a rank dying mid-consensus).  A cell passes only
when it ends recovered and bitwise against the fresh-start oracle on
the new world (the fired-fault ledger proving the fault acted) or in
its typed, rank-attributed raise.  Exits non-zero on any failed cell or
registry drift (:func:`elastic_problems`).  ``--device`` picks the rank
worlds' device (default: CUDA).
"""

from __future__ import annotations

import sys
from typing import List


def elastic_problems() -> List[str]:
    """Elastic matrix coverage vs its declared dimensions, and the
    bridge into the resilience registry: every failure kind the elastic
    matrix composes must itself be a registered fault kind with a plain
    fault-matrix row."""
    from ..resilience.__main__ import set_drift
    from ..resilience.faults import FAULT_KINDS
    from ..resilience.matrix import COVERAGE as FAULT_COVERAGE
    from .matrix import (ACTIONS, CONSENSUS_COVERAGE, COVERAGE,
                         EXPECTED_CONSENSUS_ERROR, KINDS, SUBSYSTEMS)

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


def _smoke(device) -> int:
    from ..runtime import resolve_device
    from .matrix import (CONSENSUS_COVERAGE, COVERAGE, run_cell,
                         run_consensus_cell)

    dev = resolve_device(device)
    print(f"elastic-smoke: device {dev}, "
          f"{len(COVERAGE) + len(CONSENSUS_COVERAGE)} cells")

    problems = elastic_problems()
    for p in problems:
        print(f"FAIL[registry]: {p}")

    failures = len(problems)
    ran = 0
    for kind, subsystem, action in sorted(COVERAGE):
        rec = run_cell(kind, subsystem, action, device=dev)
        ran += 1
        tag = f"{kind} x {subsystem} x {action}"
        if rec.get("fallback"):
            tag += " (fallback)"
        if rec["status"] == "ok":
            print(f"ok  : {tag}: {rec['detail']}")
        else:
            failures += 1
            print(f"FAIL: {tag}: {rec['detail']}")

    for kind, subsystem, action in sorted(CONSENSUS_COVERAGE):
        rec = run_consensus_cell(kind, device=dev)
        ran += 1
        tag = f"{kind} x {subsystem}"
        if rec["status"] == "ok":
            print(f"ok  : {tag}: {rec['detail']}")
        else:
            failures += 1
            print(f"FAIL: {tag}: {rec['detail']}")

    print(f"elastic-smoke: {ran} cells, {failures} failure(s)")
    if failures:
        return 1
    print("elastic-smoke: OK — every cell recovered bitwise on the new "
          "world or raised typed+attributed; no hangs, no unfired "
          "cells")
    return 0


def _device_arg(argv):
    if "--device" in argv:
        return argv[argv.index("--device") + 1]
    return None


def main(argv) -> int:
    if "--smoke" in argv:
        return _smoke(_device_arg(argv))
    print(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
