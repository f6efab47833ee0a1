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

# The guards' one home is the analyze registry; this lane and its tests
# read them from here.
from ..analyze.registry import degrade_problems, resilience_problems


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
