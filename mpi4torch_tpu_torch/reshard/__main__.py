"""``python -m mpi4torch_tpu_torch.reshard --smoke [--device cpu]`` — the
reshard-smoke lanes.

Port of ``mpi4torch_tpu/reshard/__main__.py``: a sweep of representative
(mesh, spec) -> (mesh', spec') transitions on an 8-rank ``run_spmd``
world.  Every cell:

1. the Mode A result is compared BITWISE against two oracles, the numpy
   assemble-and-slice reference and the executed gather-then-slice
   strategy;
2. the peak live bytes of the planned program's recording
   (``reshard.peak_live_bytes`` of ``analyze.lower``) must sit strictly
   below the gather-then-slice program's, unless the plan is the gather;
3. one cell re-runs under ``deterministic_mode`` and one runs its VJP
   under Mode A (the cotangents must land as the reverse
   redistribution).

Plus the registry-sync guard: the step-kind registry, both executors'
dispatch tables, the adjoint closure and the kinds the sweep exercised
(forward and adjoint plans) must agree.  Exits non-zero on any
divergence.  The device is CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import sys

# The guard's one home is the analyze registry.
from ..analyze.registry import reshard_step_problems

#: World size of the sweep (the JAX CLI's 8 host devices).
NRANKS = 8


def _cases(n: int, factors):
    from . import layout

    cases = [
        ("axis-move", layout((n,), 0, None), layout((n,), None, 0), None),
        ("replicate", layout((n,), 0, None), layout((n,), None, None),
         None),
        ("slice", layout((n,), None, None), layout((n,), 0, None), None),
    ]
    if factors is not None:
        a, b = factors
        cases += [
            ("migrate", layout((n,), 0, None), layout((a, b), 0, 1),
             None),
            ("migrate-T", layout((n,), 0, None), layout((b, a), 0, 1),
             None),
            ("migrate-rounds", layout((n,), 0, None),
             layout((a, b), 0, 1), "rounds"),
            ("coarsen", layout((n,), 0, None), layout((a, b), (0,), None),
             None),
            ("refine", layout((a, b), (0,), None), layout((n,), 0, None),
             None),
            ("block-permute", layout((a, b), (0, 1), None),
             layout((a, b), (1, 0), None), None),
            ("zero-to-tp", layout((n,), 0, None),
             layout((a, b), None, 1), None),
        ]
    return cases


def smoke(device=None) -> int:
    import numpy as np
    import torch

    from .. import COMM_WORLD, analyze, config, run_spmd
    from ..runtime import resolve_device
    from . import peak_live_bytes, plan_reshard, slice_shard

    n = NRANKS
    dev = resolve_device(device)
    print(f"reshard-smoke: {n} rank threads, device {dev}")
    factors = None
    for a in range(2, n):
        if n % a == 0 and n // a > 1:
            factors = (a, n // a)
            break
    G = (2 * n * 2, n)                       # divisible by every factor
    rng = np.random.default_rng(0)
    full = torch.from_numpy(rng.standard_normal(G).astype(np.float32)) \
        .to(dev)

    def stacked(lay):
        return torch.stack([slice_shard(full, lay, r) for r in range(n)])

    def run_mode_a(fl, tl, strategy, det=False):
        def body(xs):
            with config.deterministic_mode(det):
                return COMM_WORLD.Reshard(xs[COMM_WORLD.rank], fl, tl,
                                          strategy=strategy)

        return run_spmd(body, nranks=n, device=dev)(stacked(fl))

    def peak(fl, tl, strategy):
        call = run_spmd(lambda x: COMM_WORLD.Reshard(x, fl, tl,
                                                     strategy=strategy),
                        nranks=n, device=dev)
        return peak_live_bytes(analyze.lower(
            call, torch.zeros(fl.shard_shape(G), dtype=torch.float32,
                              device=dev)))

    exercised = set()
    failures = 0
    for name, fl, tl, strategy in _cases(n, factors):
        for s in (strategy, "gather"):
            plan = plan_reshard(fl, tl, G, torch.float32, s)
            exercised |= {st.kind for st in plan.steps}
            exercised |= {st.kind for st in plan.adjoint().steps}
        plan = plan_reshard(fl, tl, G, torch.float32, strategy)
        got = run_mode_a(fl, tl, strategy)
        oracle = stacked(tl)
        gather = run_mode_a(fl, tl, "gather")
        ok = torch.equal(got, oracle) and torch.equal(gather, oracle)
        peak_p, peak_g = peak(fl, tl, strategy), peak(fl, tl, "gather")
        bounded = plan.strategy == "gather" or peak_p < peak_g
        if not ok or not bounded:
            failures += 1
            print(f"FAIL {name}: bitwise={ok} peak {peak_p} vs "
                  f"gather {peak_g} (strategy {plan.strategy})")
            continue
        print(f"cell {name:14s} strategy={plan.strategy:9s} "
              f"steps={[st.kind for st in plan.steps]} bitwise=ok "
              f"peak_live {peak_p} < gather {peak_g}")

    if factors is not None:
        fl = _cases(n, factors)[3][1]
        tl = _cases(n, factors)[3][2]
        if torch.equal(run_mode_a(fl, tl, None, det=True), stacked(tl)):
            print("cell migrate/deterministic_mode bitwise=ok")
        else:
            failures += 1
            print("FAIL: deterministic_mode migration diverges")

        # The VJP: cotangents redistribute spec' -> spec.
        w = torch.from_numpy(rng.standard_normal(G).astype(np.float32)) \
            .to(dev)
        xs = stacked(fl).requires_grad_()
        out = run_spmd(lambda v: COMM_WORLD.Reshard(v[COMM_WORLD.rank], fl,
                                                    tl),
                       nranks=n, device=dev)(xs)
        wt = torch.stack([slice_shard(w, tl, r) for r in range(n)])
        (g,) = torch.autograd.grad(out, xs, wt)
        want = torch.stack([slice_shard(w, fl, r) for r in range(n)])
        if torch.equal(g, want):
            print("cell migrate/vjp: cotangents redistribute spec'->spec "
                  "bitwise")
        else:
            failures += 1
            print("FAIL: VJP cotangents did not redistribute spec' -> spec")

    probs = reshard_step_problems(exercised)
    if probs:
        failures += 1
        print("FAIL registry-sync: " + "; ".join(probs))
    else:
        from . import STEP_KINDS
        print(f"registry-sync: {len(STEP_KINDS)} step kinds == both "
              "executors == sweep coverage (fwd+adjoint)")
    if failures:
        print(f"reshard-smoke: {failures} FAILURE(S)")
        return 1
    print("reshard-smoke: OK")
    return 0


def main(argv) -> int:
    if "--smoke" in argv:
        device = argv[argv.index("--device") + 1] \
            if "--device" in argv else None
        return smoke(device)
    print(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
