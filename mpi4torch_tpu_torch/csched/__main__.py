"""``python -m mpi4torch_tpu_torch.csched --smoke|--tiers [--device cpu]``
— the IR smoke lanes.

Port of ``mpi4torch_tpu/csched/__main__.py``.  Non-zero exit on ANY
divergence.  ``--smoke`` has three legs:

1. **Registry guard** (``analyze.registry.csched_problems``): every
   registered algorithm declares an IR program (or a native exemption),
   every step kind is covered by the lowering / interpreter /
   transposition / census dispatch tables.
2. **Re-expression matrix**: every registered Allreduce algorithm,
   forward AND transposition-derived backward, deterministic and not:
   the IR route's recorded program (``analyze.lower``) equals the
   hand-written form's, in its collective sequence (kinds, types,
   replica groups, permute tables, spans) and in the aten op sequence of
   the program's rank (the JAX package compares StableHLO text here);
   the interpreter equals the rendezvous fold bitwise; the q8 codec leg
   holds the per-step rewrite against the hand-composed fused pipeline
   the same way; the tree Bcast_/Reduce_ pair holds ``transpose(bcast)
   == reduce``.
3. **Synthesis verdict**: the census-ranked winner for the 8-rank world
   beats the deterministic ring on wire bytes, its predicted collective
   census equals ``parse_program(...).census()`` of its recorded program
   EXACTLY, and the search is deterministic.  The port's convention: a
   recording holds every hop it executed, so the prediction is read with
   ``config.chain_unroll_max`` at the world size (every chain unrolled;
   the JAX package's ``lax.scan`` body would count once).

``--tiers`` is the multi-pod tier-stack lane.  Per nested factorization
of the 8-rank world in :data:`TIER_STACKS`, the bandwidth-weighted
synthesis winner under a slow outer tier beats flat ``bidir`` with the
outer-tier byte reduction confirmed by ``analyze.tier_wire_table`` of the
recorded program; every searched composition
(:data:`TIER_PARITY_COVERED` / :data:`TIER_CENSUS_COVERED`) holds Mode
A/B bitwise parity and a self-adjoint transposition; the 2-level stack
records identical to the historical hier forms; and ``obs.reconcile(...,
tiers=)`` prices the traced Mode B per-tier traffic EXACTLY.

Every world is rank threads on one device: CUDA unless ``--device cpu``
is given.
"""

from __future__ import annotations

import json
import sys
from typing import Iterable, List

# Coverage literals of the ``--tiers`` lane: which per-tier (algorithm x
# codec) compositions of the tier synthesis search space hold a Mode A/B
# bitwise parity cell and a per-tier census cell below.
# ``analyze.registry.tier_program_problems`` compares them against
# ``csched.TIER_COMPOSITIONS``.
TIER_PARITY_COVERED = ("exact", "q8-slow")
TIER_CENSUS_COVERED = ("exact", "q8-slow")

# The nested factorizations the lane exercises on the 8-rank world ((8,)
# is the degenerate single-tier stack: everything is top tier and the
# weighted census reduces to the flat one).
TIER_STACKS = ((2, 2, 2), (4, 2), (2, 4), (8,))

#: World size of both lanes (the JAX CLI's 8 host devices).
NRANKS = 8


def _record(fn, n: int, x, det: bool, dev):
    """The recorded program of ``fn(ctx, x)`` on an ``n``-rank
    ``run_spmd`` world (``ctx``: the region's ``SpmdContext``) under
    ``deterministic_mode(det)``."""
    from .. import analyze, config, run_spmd
    from ..ops.spmd import current_spmd_context

    call = run_spmd(lambda v: fn(current_spmd_context(), v), nranks=n,
                    device=dev)
    with config.deterministic_mode(det):
        return analyze.lower(call, x)


def _same_program(a, b) -> bool:
    """Two recorded programs run the same collectives (kind, types,
    groups, pairs, channel, span) and the same op sequence on the
    program's rank (aten op, span, kernel)."""
    def ops(p):
        return [(e.kind, e.scope, e.target) for e in p.events]

    return a.collectives == b.collectives and ops(a) == ops(b)


def _unrolled_census(prog, n: int, nelems: int, itemsize: int) -> dict:
    """The IR's predicted collective counts with every chain unrolled
    (``config.chain_unroll_max`` at the world size): what a recording,
    which holds every executed hop, censuses."""
    from .. import config, csched

    saved = config.chain_unroll_max()
    config.set_chain_unroll_max(max(saved, n))
    try:
        return csched.program_census(prog, nelems, itemsize)["hlo"]
    finally:
        config.set_chain_unroll_max(saved)


def smoke(device=None) -> int:
    """The ``--smoke`` lane: registry guard, re-expression matrix,
    synthesis verdict.  Non-zero on ANY divergence."""
    import numpy as np
    import torch

    from .. import constants as C
    from .. import csched
    from .. import tune as _tune
    from ..analyze import parse_program
    from ..analyze.registry import csched_problems
    from ..compress import get_codec
    from ..compress import spmd as _cspmd
    from ..ops import eager as _eager
    from ..ops import spmd as _spmd
    from ..runtime import resolve_device

    dev = resolve_device(device)
    failures: List[str] = []
    report = {"worlds": [NRANKS], "device": str(dev), "reexpression": {},
              "codec": {}, "bcast_reduce": {}, "synthesis": {}}

    def check(ok: bool, label: str):
        if not ok:
            failures.append(label)
        return bool(ok)

    n = NRANKS
    x = torch.arange(512, dtype=torch.float32, device=dev) / 3.0
    rng = np.random.default_rng(7)
    vals = [torch.from_numpy(rng.standard_normal(257).astype(np.float32))
            .to(dev) for _ in range(n)]

    # ---- leg 1: registry guard -------------------------------------
    problems = csched_problems()
    check(not problems, f"registry guard: {problems}")
    report["registry_problems"] = problems

    # ---- leg 2: re-expression matrix -------------------------------
    for algo in sorted(_tune.available_algorithms()):
        cell = {}
        for det in (False, True):
            legacy = _record(
                lambda c, v: _spmd._handwritten_allreduce_value(
                    c, v, C.MPI_SUM, algo), n, x, det, dev)
            ir = _record(
                lambda c, v: _spmd._allreduce_fwd_value(
                    c, v, C.MPI_SUM, algo), n, x, det, dev)
            cell[f"fwd_record_det={det}"] = check(
                _same_program(legacy, ir), f"{algo} fwd record det={det}")
            legacy = _record(
                lambda c, v: _spmd._handwritten_allreduce_value(
                    c, v, C.MPI_SUM, algo, reverse=True), n, x, det, dev)
            ir = _record(
                lambda c, v: _spmd._allreduce_bwd_value(c, v, algo), n,
                x, det, dev)
            cell[f"bwd_record_det={det}"] = check(
                _same_program(legacy, ir), f"{algo} bwd record det={det}")
        # interpreter == the eager rendezvous fold, bitwise
        prog = csched.allreduce_program(
            algo, n, C.MPI_SUM, deterministic=True, nelems=257,
            itemsize=4)
        _, fold = _eager._rendezvous_fold(n, algo)
        cell["interp_bitwise"] = check(
            torch.equal(csched.interpret_allreduce(prog, C.MPI_SUM, vals),
                        fold(C.MPI_SUM, vals)),
            f"{algo} interpreter vs rendezvous fold")
        # the transposition-derived VJP declaration (JAX's
        # AlgorithmSpec.vjp_census)
        cell["vjp_census"] = check(
            csched.declared_vjp_census(algo, n) == "self",
            f"{algo} transposition vs declared vjp_census")
        report["reexpression"][algo] = cell

    # ---- leg 2b: the q8 codec rides per-step rewrites ---------------
    for cname in ("q8", "q8_ef_hop"):
        codec = get_codec(cname)
        for algo in ("ring", "bidir", "torus"):
            legacy = _record(
                lambda c, v: _cspmd._fused_allreduce_value(
                    c, v, codec, algo, False), n, x, False, dev)
            ir = _record(
                lambda c, v: _cspmd._allreduce_value(c, v, codec, algo),
                n, x, False, dev)
            report["codec"][f"{cname}/{algo}"] = check(
                _same_program(legacy, ir), f"codec {cname}/{algo} record")
            base = codec.base()
            prog = csched.q8_allreduce_program(algo, n, cname,
                                               base.block)
            inner = _tune.resolve_hier_group(n) if algo == "torus" \
                else None
            ref = C.reduce_q8_hop(
                vals, block=base.block, algorithm=algo, inner=inner,
                stochastic=getattr(base, "stochastic", False),
                hop_ef=getattr(base, "hop_ef", False),
                ef_rounds=codec.ef_rounds)
            report["codec"][f"{cname}/{algo}/interp"] = check(
                torch.equal(csched.interpret_allreduce(
                    prog, C.MPI_SUM, vals), ref),
                f"codec {cname}/{algo} interp vs reduce_q8_hop")

    # ---- leg 2c: tree Bcast_/Reduce_ transposition pair -------------
    nbytes = x.numel() * 4
    bcast = _record(lambda c, v: _spmd._tree_bcast_value(c, v, 1), n, x,
                    False, dev)
    bcast_ir = _record(
        lambda c, v: csched.lower_value(
            csched.bcast_program("tree", n, 1, nbytes=nbytes), c, v),
        n, x, False, dev)
    report["bcast_reduce"]["bcast_tree_record"] = check(
        _same_program(bcast, bcast_ir), "tree Bcast_ record")
    reduce = _record(
        lambda c, v: _spmd._tree_reduce_value(c, v, C.MPI_SUM, 1), n, x,
        False, dev)
    reduce_t = _record(
        lambda c, v: csched.lower_value(
            csched.transpose(csched.bcast_program(
                "tree", n, 1, nbytes=nbytes)), c, v), n, x, False, dev)
    report["bcast_reduce"]["reduce_is_transposed_bcast"] = check(
        _same_program(reduce, reduce_t),
        "transpose(tree Bcast_) == tree Reduce_")

    # ---- leg 3: synthesized-schedule census verdict -----------------
    res = csched.synthesize(n, 1 << 14, 4)
    res_again = csched.synthesize(n, 1 << 14, 4)
    synth_cell = {
        "winner": res["winner"],
        "chain": res["chain"],
        "wire_bytes_per_rank": res["census"]["wire_bytes_per_rank"],
        "ring_wire_bytes_per_rank":
            res["ring_census"]["wire_bytes_per_rank"],
        "synthesis_beats_ring": res["synthesis_beats_ring"],
    }
    check(res["synthesis_beats_ring"], "synthesis beats ring")
    synth_cell["deterministic"] = check(
        res["winner"] == res_again["winner"], "synthesis determinism")
    prog = res["program"]
    name = csched.install(prog)
    rec = _record(
        lambda c, v: _spmd._allreduce_fwd_value(c, v, C.MPI_SUM, name),
        n, x, True, dev)
    got = parse_program(rec).census()
    pred = _unrolled_census(prog, n, x.numel(), 4)
    synth_cell["census_recorded"] = got
    synth_cell["census_predicted"] = pred
    synth_cell["hlo_reconciles"] = check(
        got == pred, f"synth census reconcile: recorded={got} "
                     f"predicted={pred}")
    oracle = csched.interpret_allreduce(prog, C.MPI_SUM, vals)
    synth_cell["interp_finite"] = check(
        bool(torch.isfinite(oracle).all()), "synth interp finite")
    report["synthesis"] = synth_cell

    report["failures"] = failures
    report["ok"] = not failures
    print(json.dumps(report, indent=1, sort_keys=True))
    return 0 if not failures else 1


def _mode_a_rows(name: str, n: int, vals, dev, det: bool = True):
    """Run an installed program under ``run_spmd`` on ``n`` ranks with
    per-rank values ``vals``; returns the per-rank result rows."""
    import torch

    from .. import COMM_WORLD, config, run_spmd
    from .. import constants as C
    from ..ops import spmd as _spmd

    def body(v):
        return _spmd._allreduce_fwd_value(
            _spmd.current_spmd_context(), v[COMM_WORLD.rank], C.MPI_SUM,
            name)

    with config.deterministic_mode(det):
        return run_spmd(body, nranks=n, device=dev)(torch.stack(vals))


def tiers(device=None) -> int:
    """``--tiers``: the multi-pod tier-stack verdict lane.  Non-zero
    exit on ANY divergence."""
    import numpy as np
    import torch

    from .. import COMM_WORLD, MPI_SUM, analyze, obs, run_ranks, run_spmd
    from .. import config as _config
    from .. import constants as C
    from .. import csched
    from ..analyze.registry import tier_program_problems
    from ..mesh import device_mesh
    from ..ops import spmd as _spmd
    from ..ops.spmd import HierMeshBackend, TierStackBackend
    from ..runtime import resolve_device

    dev = resolve_device(device)
    failures: List[str] = []
    report = {"nranks": NRANKS, "device": str(dev),
              "stacks": [list(s) for s in TIER_STACKS],
              "synthesis": {}, "parity": {}, "census": {},
              "two_level": {}, "reconcile": {}}

    def check(ok: bool, label: str):
        if not ok:
            failures.append(label)
        return bool(ok)

    n = NRANKS
    x = torch.arange(1024, dtype=torch.float32, device=dev)
    nbytes = x.numel() * 4
    # Integer-valued per-rank payloads: po2-scale block-q8 round-trips
    # integer grids exactly, so the q8-slow composition's Mode A/B
    # bitwise check compares one value, not two rounding paths.
    rng = np.random.default_rng(18)
    vals = [torch.from_numpy(rng.integers(-40, 40, 257).astype(np.float32))
            .to(dev) for _ in range(n)]

    def fwd(name):
        return lambda c, v: _spmd._allreduce_fwd_value(c, v, C.MPI_SUM,
                                                       name)

    # ---- leg 1: registry guard -------------------------------------
    problems = tier_program_problems(TIER_PARITY_COVERED,
                                     TIER_CENSUS_COVERED)
    check(not problems, f"tier registry guard: {problems}")
    report["registry_problems"] = problems

    # ---- leg 2: weighted-census synthesis verdict -------------------
    # Skewed slow-outer bandwidths: the outermost tier 20x under the
    # inner tiers.
    for stack in TIER_STACKS:
        skew = tuple([1.0] * (len(stack) - 1) + [0.05]) \
            if len(stack) > 1 else (1.0,)
        res = csched.synthesize_tiers(n, nbytes, 4, tiers=stack,
                                      tier_bandwidths=skew)
        res2 = csched.synthesize_tiers(n, nbytes, 4, tiers=stack,
                                       tier_bandwidths=skew)
        key = "x".join(map(str, stack))
        cell = {
            "winner": res["winner"], "chain": res["chain"],
            "composition": res["composition"],
            "tier_wire": res["tier_wire"],
            "weighted_cost": res["weighted_cost"],
            "bidir_tier_wire": res["bidir_tier_wire"],
            "bidir_weighted_cost": res["bidir_weighted_cost"],
            "beats_bidir": res["beats_bidir"],
            "exact_beats_bidir": res["exact_beats_bidir"],
        }
        cell["deterministic"] = check(
            res["winner"] == res2["winner"],
            f"tiers {key}: synthesis determinism")
        if len(stack) > 1:
            cell["beats_bidir"] = check(
                res["beats_bidir"],
                f"tiers {key}: synthesized winner beats flat bidir on "
                "the weighted census")
            # The outer-tier reduction, read off the recorded programs
            # of the winner and of flat bidir.
            won = analyze.tier_wire_table(
                _record(fwd(csched.install(res["program"])), n, x, True,
                        dev), stack)
            flat = analyze.tier_wire_table(
                _record(fwd("bidir"), n, x, False, dev), stack)
            cell["recorded_tier_wire"] = won
            cell["recorded_bidir_tier_wire"] = flat
            cell["outer_tier_reduced"] = check(
                won[-1] < flat[-1],
                f"tiers {key}: outer-tier bytes reduced vs bidir "
                f"({won[-1]} vs {flat[-1]})")
            # Uniform bandwidths: the lossy variants vanish and the
            # ranking degenerates to the unweighted census.
            uni = csched.synthesize_tiers(n, nbytes, 4, tiers=stack)
            cell["uniform_all_exact"] = check(
                all(c["composition"] == "exact"
                    for c in uni["candidates"]),
                f"tiers {key}: uniform bandwidths admit lossy variants")
        report["synthesis"][key] = cell

        # ---- leg 3: per-tier census of the recorded program ---------
        for label, prog in (("winner", res["program"]),
                            ("exact", res["exact_program"])):
            rec = _record(fwd(csched.install(prog)), n, x, True, dev)
            got = analyze.tier_wire_table(rec, stack)
            pred = csched.program_tier_census(prog, x.numel(), 4, stack)
            report["census"][f"{key}/{label}"] = check(
                got == pred,
                f"tiers {key}/{label}: analyze tier table {got} != "
                f"program tier census {pred}")
            wc = analyze.weighted_wire_cost(rec, skew, tiers=stack)
            report["census"][f"{key}/{label}/weighted"] = check(
                wc == csched.weighted_cost(pred, skew),
                f"tiers {key}/{label}: weighted_wire_cost mismatch")

    # ---- leg 4: Mode A/B bitwise parity per composition -------------
    stack = (2, 2, 2)
    for comp in TIER_PARITY_COVERED:
        prog = csched.fold_program(n, stack, stack)
        if comp == "q8-slow":
            prog = csched.rewrite_fold_codec(prog, (len(stack) - 1,))
        rows = _mode_a_rows(csched.install(prog), n, vals, dev)
        oracle = csched.interpret_allreduce(prog, C.MPI_SUM, vals)
        cell = {}
        cell["a_vs_b_bitwise"] = check(
            torch.equal(rows[0], oracle),
            f"tiers parity {comp}: Mode A != Mode B bitwise")
        cell["ranks_agree"] = check(
            all(torch.equal(rows[r], rows[0]) for r in range(n)),
            f"tiers parity {comp}: ranks disagree")
        # The ONE transposition rule still derives the backward: the
        # transposed program censuses as the forward does
        # (allreduce(SUM) is self-adjoint).
        bwd = csched.transpose(prog)
        cell["vjp_self"] = check(
            csched.program_tier_census(bwd, x.numel(), 4, stack)
            == csched.program_tier_census(prog, x.numel(), 4, stack),
            f"tiers parity {comp}: transposed tier census differs")
        report["parity"][comp] = cell

    # ---- leg 5: 2-level tier stack == hier, recorded identical ------
    # (a) flat world: config.tier_stack=(2,4) must record the 'hier'
    # schedule identical to the pre-tier hier_group_size form.
    base = _record(fwd("hier"), n, x, True, dev)
    _config.set_tier_stack((2, 4))
    try:
        tiered = _record(fwd("hier"), n, x, True, dev)
    finally:
        _config.set_tier_stack(None)
    report["two_level"]["flat_hier_record"] = check(
        _same_program(base, tiered),
        "2-level tier_stack changes the flat hier recording")
    # (b) mesh world: the 2-axis TierStackBackend vs HierMeshBackend.
    mesh2 = device_mesh({"g": 2, "l": 4}, devices=[dev] * n)

    def record_backend(back):
        call = run_spmd(lambda v: back.allreduce(v, C.MPI_SUM),
                        mesh=mesh2, axis_name="g")
        return analyze.lower(call, x)

    report["two_level"]["mesh_record"] = check(
        _same_program(record_backend(TierStackBackend(("g", "l"), (2, 4))),
                      record_backend(HierMeshBackend(("g", "l"), (2, 4)))),
        "2-axis TierStackBackend records differently from "
        "HierMeshBackend")

    # ---- leg 6: obs.reconcile prices per-tier traffic EXACTLY -------
    stack = (2, 2, 2)
    res = csched.synthesize_tiers(n, nbytes, 4, tiers=stack,
                                  tier_bandwidths=(1.0, 1.0, 0.05))
    name = csched.install(res["program"])
    with obs.trace() as t:
        run_ranks(lambda rank: COMM_WORLD.Allreduce(
            x * (rank + 1), MPI_SUM, algorithm=name), n, device=dev)
    rep = obs.reconcile(t.events, _record(fwd(name), n, x, True, dev),
                        dropped=t.dropped, tiers=stack, device=dev)
    report["reconcile"] = {
        "measured_tier_wire": rep["measured"].get("tier_wire"),
        "predicted_tier_wire": rep["predicted"].get("tier_wire"),
        "matches": rep["matches"],
        "ok": rep["ok"],
    }
    check(rep["ok"] and rep["matches"].get("tier_wire"),
          f"reconcile per-tier mismatch: measured "
          f"{rep['measured'].get('tier_wire')} vs predicted "
          f"{rep['predicted'].get('tier_wire')} "
          f"(matches={rep['matches']})")

    report["failures"] = failures
    report["ok"] = not failures
    print(json.dumps(report, indent=1, sort_keys=True))
    return 0 if not failures else 1


def _main(argv: Iterable[str]) -> int:
    argv = list(argv)
    device = argv[argv.index("--device") + 1] if "--device" in argv \
        else None
    if "--smoke" in argv:
        return smoke(device)
    if "--tiers" in argv:
        return tiers(device)
    print(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
