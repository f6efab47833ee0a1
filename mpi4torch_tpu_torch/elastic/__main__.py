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

# The guard's one home is the analyze registry.
from ..analyze.registry import elastic_problems


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
