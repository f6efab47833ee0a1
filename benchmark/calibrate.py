"""Readings the limits of ``correct`` are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--leaves] [--out readings.jsonl]

For every seed of ``--seeds`` the program's first steps (and a window of a
second) against the float32 reference; for every seed of
``--control-seeds`` also the control (the reference in float8 put in the
program's place) and each planted fault of :mod:`benchmark.faults`.  One
JSON line a reading, and a summary of each number's largest program
reading and smallest control and fault readings.  ``--leaves`` adds each
leaf's norms.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    # The checkout's root, not benchmark/, whose module names would shadow
    # the standard library's.
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import checks, faults, harness, spec  # noqa: E402


def as_program(ref, ranks):
    """A reference's readings in the form of the program's."""
    return {"losses": [ref["losses"]] * ranks,
            "grad1": [ref["grad1"]] * ranks,
            "change": [ref["change"]] * ranks,
            "moved": [ref["moved"]] * ranks, "ranks_differ": 0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--leaves", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.pin_caches()
    calibrate(spec.cell(args.workload),
              [int(s) for s in args.seeds.split(",") if s],
              [int(s) for s in args.control_seeds.split(",") if s],
              leaves=args.leaves, out_path=args.out)
    return 0


def calibrate(cell, seeds, ctrl, seconds=1.0, device="cuda", leaves=False,
              out_path=None):
    """The readings of ``cell`` (as :func:`spec.cell` gives it) on
    ``seeds``, and of its control and faults on ``ctrl``; returns them as
    ``{kind: {number: [readings]}}``."""
    conf, traffic = cell["config"], cell["traffic"]
    workload = cell["workload"]["name"]
    fam = harness.module("models", conf["family"])
    drv = harness.module("loops", traffic["loop"])
    out = open(out_path, "a") if out_path else None
    worst = {}

    def emit(kind, seed, values, extra=None):
        line = {"workload": workload, "lr": traffic["lr"], "kind": kind,
                "seed": seed, **values, **(extra or {})}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        for k, v in values.items():
            if isinstance(v, (int, float)):
                worst.setdefault(kind, {}).setdefault(k, []).append(v)

    def program(seed, step_fn=None):
        import torch

        rec = drv.run(fam, conf, traffic, seed, seconds, False, device,
                      step_fn=step_fn)
        if device != "cpu":
            torch.cuda.empty_cache()
        return rec

    refs = {}
    for seed in dict.fromkeys(seeds + ctrl):
        t0 = time.perf_counter()
        rec = program(seed)
        t1 = time.perf_counter()
        refs[seed] = drv.reference(fam, conf, traffic, seed, device)
        t2 = time.perf_counter()
        extra = {"program_s": t1 - t0, "reference_s": t2 - t1,
                 "losses": rec["checked"]["losses"],
                 "ref_losses": refs[seed]["losses"],
                 "window_steps": rec["window"]["steps"]}
        if leaves:
            extra["leaves"] = {
                "paths": [str(s[0]) for s in fam.param_specs(conf)],
                "ref_grad1": refs[seed]["grad1"],
                "ref_gradient": refs[seed]["gradient"],
                "ref_change": refs[seed]["change"],
                "ref_moved": refs[seed]["moved"],
                "grad1": rec["checked"]["grad1"][0],
                "change": rec["checked"]["change"][0],
                "moved": rec["checked"]["moved"][0]}
        emit("program", seed, checks.readings(rec["checked"], refs[seed]),
             extra)
    for seed in ctrl:
        ref = refs[seed]
        fp8 = drv.reference(fam, conf, traffic, seed, device,
                            precision="fp8")
        emit("control_fp8", seed,
             checks.readings(as_program(fp8, traffic["ranks"]), ref),
             {"losses": fp8["losses"]})
        for name, plant in faults.FAULTS.items():
            rec = program(seed, plant(fam))
            emit(f"fault_{name}", seed, checks.readings(rec["checked"], ref))
    print("summary (program: largest; control and faults: smallest)")
    for kind, vals in worst.items():
        pick = max if kind == "program" else min
        print(kind, json.dumps({k: pick(v) for k, v in vals.items()}))
    if out:
        out.close()
    return worst


if __name__ == "__main__":
    sys.exit(main())
