"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number that decides ``correct``
with its limit); the last lines of standard error give the same numbers.
The run exits non-zero, and prints no result, without a CUDA device (or
with fewer than the cell asks for), without the port beside it, or when
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Not the script's own directory: its module names would shadow the
    # standard library's.
    sys.path[0] = ROOT
    from benchmark import harness, spec

    harness.pin_caches()
    cell = spec.cell(args.workload)
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import mpi4torch_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"run.py: the port mpi4torch_tpu_torch is not importable: {e}",
              file=sys.stderr)
        return 2
    result, rows, window = harness.run_cell(args.workload, args.seed, args.seconds,
                                    bool(args.trace), device="cuda",
                                    cell=cell, t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"run.py: modules that may not be loaded were loaded: {bad}",
              file=sys.stderr)
        return 3
    times = sorted(1e3 * t for t in window["step_s"])
    if times:
        print(f"window: {len(times)} steps in {window['seconds']:.3f} s; step"
              f" ms min {times[0]:.2f} median {times[len(times) // 2]:.2f} "
              f"max {times[-1]:.2f}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for name, value, limit, ok in rows:
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
