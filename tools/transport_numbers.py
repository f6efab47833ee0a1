#!/usr/bin/env python3
"""The process transport's numbers on one GPU, without the rest of the
smoke.

    python3 tools/transport_numbers.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  It builds the port's kernels and runs ``chip_smoke.py``'s
phase 46 (the flagship's DP=2 ``train_step`` at full width on two worker
processes and on two rank threads: step ms, the parent's wire bytes a
step, the busy time of a step profiled in worker 0, split into copies
and kernels) and phase 48 (an 8-byte Allreduce's latency on 2 and 4
ranks, the 4 x 2^24 f32 Allreduce through the parent, cold spawn, warm
lease and a worker's CUDA context), with the smoke's checks.  To compare
two trees of the transport, unpack both and run this script in each,
alternating (A B B A), in one session on the card.  The last line is one
JSON object of the readings; it exits non-zero without CUDA or when a
check fails.
"""

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402  (the smoke's phases and checks)


def main():
    if not torch.cuda.is_available():
        print("transport_numbers: CUDA is not available", file=sys.stderr)
        return 2
    import mpi4torch_tpu_torch as P
    from mpi4torch_tpu_torch import transport
    from mpi4torch_tpu_torch.models import transformer as T
    from mpi4torch_tpu_torch.ops import _kernels as kernels
    from mpi4torch_tpu_torch.utils import tree

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"{ROOT}: torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)
    kernels.build_all()
    try:
        S.phase(46, "the flagship's DP=2 training on two worker processes")
        train = S.process_flagship_phase(P, T, tree, kernels, transport,
                                         S.flagship_config(T), smi)
        S.phase(48, "process transport numbers")
        numbers = S.process_numbers_phase(P, transport, smi)
        S.phase(49)
    finally:
        transport.shutdown()
    print(f"  total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"flagship": train, "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
