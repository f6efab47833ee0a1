"""``python -m mpi4torch_tpu_torch.analyze`` — the analyzer's lane.

``--sweep``
    Registry-wide lint sweep (:mod:`.sweep`): every registered
    (algorithm x codec) Allreduce pair (forward and with its gradient,
    the VJP-symmetry declaration checked), the Bcast_/Reduce_ algorithm
    forms, every reshard strategy, the overlap schedules and the serve
    decode step, recorded on the rank threads and run through the full
    soundness lint set, plus the standing registry-sync guards, on the
    (8,), (3,), (1,) and (2, 4) worlds.  Exits non-zero on any lint
    violation or registry drift.

``--defects``
    Seeded-defect corpus (:mod:`.defects`): mutated schedules — dropped
    wait, orphan/double wait, duplicated permute target,
    non-partitioning replica group, dropped backward — each of which must
    be caught by its named lint, with the ledger check that every
    registered lint catches at least one mutant.  Exits non-zero when a
    lint fails to fire.

``--device cpu`` runs on the CPU; the default is the card.  The full
flat world has 8 rank threads (the JAX package's 8-device CPU mesh).
"""

from __future__ import annotations

import sys


def _corpus_programs(nranks: int = 8, device=None):
    """The clean programs the defect corpus mutates, recorded on an
    ``nranks`` world: a windowed split-phase program, a permute-schedule
    program (bidir's dual ring), a grouped program (a reduce-scatter),
    and a ring forward / forward-and-gradient pair."""
    import torch

    from ..constants import MPI_SUM
    from ..overlap import overlap_split_allreduce
    from ..runtime import resolve_device
    from .defects import DefectPrograms
    from .sweep import _flat_lowerer

    if nranks < 2:
        raise ValueError("the defect corpus mutates multi-rank schedules; "
                         f"got {nranks} rank(s)")
    lower, lower_grad = _flat_lowerer(nranks, device)
    x = torch.ones((512,), dtype=torch.float32,
                   device=resolve_device(device))

    def allreduce(c, v):
        return c.Allreduce(v, MPI_SUM)

    split = lower(lambda c, v: overlap_split_allreduce(
        c, v, MPI_SUM, nsplits=2), x)
    permute = lower(lambda c, v: c.Allreduce(v, MPI_SUM,
                                             algorithm="bidir"), x)
    grouped = lower(lambda c, v: c.Reduce_scatter(v, MPI_SUM, 0), x)
    fwdbwd = lower_grad(allreduce, x)
    return DefectPrograms(split_phase=split, permute=permute,
                          grouped=grouped, fwd=fwdbwd.region(0),
                          fwdbwd=fwdbwd)


def _defects(nranks: int, device) -> int:
    from .defects import defect_ledger_problems, run_defect_corpus

    records = run_defect_corpus(_corpus_programs(nranks, device))
    failures = 0
    for rec in records:
        ok = rec["clean_ok"] and rec["fired"]
        tag = f"{rec['defect']} -> {rec['lint']}"
        if ok:
            print(f"ok  : {tag}: fired ({rec['doc']})")
        else:
            failures += 1
            print(f"FAIL: {tag}: clean_ok={rec['clean_ok']} "
                  f"fired={rec['fired']}")
    for p in defect_ledger_problems(records):
        failures += 1
        print(f"FAIL[ledger]: {p}")
    print(f"defect corpus: {len(records)} mutants, "
          f"{failures} failure(s)")
    if failures:
        return 1
    print("defect corpus: OK — every lint fires on its mutant")
    return 0


def _sweep(nranks: int, device) -> int:
    from ..runtime import resolve_device
    from .sweep import run_sweep, sweep_worlds

    print(f"analyze-sweep: {nranks} rank(s) on "
          f"{resolve_device(device)}")
    failures = 0
    for world in sweep_worlds(nranks):
        # The serve decode leg runs real engine steps; once, on the
        # full world, is the meaningful cell.
        res = run_sweep(world, include_serve=(world == (nranks,)),
                        device=device)
        for rec in res["records"]:
            if rec["skipped"]:
                print(f"skip: {rec['case']}: {rec['skipped']}")
            elif rec["violations"]:
                failures += len(rec["violations"])
                for v in rec["violations"]:
                    print(f"FAIL: {rec['case']}: {v}")
            else:
                extra = ""
                if "scheduled_exposure" in rec:
                    extra = (" exposure="
                             f"{rec['scheduled_exposure']}")
                census = ",".join(f"{k}={v}"
                                  for k, v in rec["census"].items())
                print(f"ok  : {rec['case']}: "
                      f"[{census or 'no collectives'}]{extra}")
        for p in res["problems"]:
            failures += 1
            print(f"FAIL[registry]: {p}")
        print(f"world {world}: {res['n_cases']} cases linted, "
              f"{res['n_skipped']} skipped, "
              f"{len(res['violations'])} violation(s)")
    if failures:
        print(f"analyze-sweep: {failures} FAILURE(S)")
        return 1
    print("analyze-sweep: OK — every registered schedule lints clean")
    return 0


NRANKS = 8


def main(argv) -> int:
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("--device needs a value")
        device = argv[i + 1]
    nranks = NRANKS
    rc = 0
    ran = False
    if "--sweep" in argv:
        ran = True
        rc |= _sweep(nranks, device)
    if "--defects" in argv:
        ran = True
        rc |= _defects(nranks, device)
    if not ran:
        print(__doc__)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
