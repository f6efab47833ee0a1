"""Registry-wide lint sweep: record everything registered, lint it all.

Port of ``mpi4torch_tpu/analyze/sweep.py``.  The lints only help if
they run over the schedules the registries can actually emit, so this
module enumerates, from the live registries,

* every (algorithm x codec) Allreduce pair (``tune.available_algorithms()``
  x the codecs declaring each algorithm, by the facade's
  ``codec_rides_algorithm``), forward AND with its gradient taken from
  outside, the VJP-symmetry lint checking each algorithm's declaration
  (``csched.declared_vjp_census``);
* the Bcast_/Reduce_ forms of the algorithms serving those collectives;
* every reshard strategy (``reshard.STRATEGIES``), each on a transition
  that exercises it, forward and adjoint — feeding the step-kind
  coverage leg of the reshard registry guard;
* the overlap schedules (a windowed fused tree and the serve decode
  primitive ``overlap_split_allreduce``), the split-phase lint's
  real-program coverage;
* the serve decode schedule (``Engine.lower_step``), overlap and
  blocking.

Every program is recorded on rank threads of ``device`` (the card unless
the caller passes ``"cpu"``) and runs the full structural lint set; a
single violation anywhere fails the sweep (``python -m
mpi4torch_tpu_torch.analyze --sweep`` exits non-zero).  Schedules a
world cannot serve (rhd on a non-power-of-two world, torus without a
factorization) are recorded as *skipped with the registry's own
reason*, never silently dropped.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .accounting import scheduled_exposure
from .lints import check_vjp_symmetry, run_lints
from .parse import parse_program
from .record import lower as _lower

__all__ = ["run_sweep", "sweep_worlds"]


def sweep_worlds(ndev: int) -> List[Tuple]:
    """The standard sweep worlds of an ``ndev``-rank harness: the full
    flat world, the (3,) non-power-of-two world, the single-rank world,
    and the (2, 4) two-axis mesh at 8 ranks."""
    worlds: List[Tuple] = [(ndev,)]
    if ndev >= 3:
        worlds.append((3,))
    worlds.append((1,))
    if ndev == 8:
        worlds.append((2, 4))
    return worlds


def _with_gradient(call):
    """The value-and-gradient program of ``call``: its (tensor) output
    summed and differentiated from outside, which runs every rank's
    backward on the same world (JAX's ``value_and_grad`` of the summed
    output)."""
    def run(x):
        x = x.detach().requires_grad_()
        torch.autograd.grad(call(x).sum(), x)

    return run


def _flat_lowerer(nranks: int, device):
    """``(lower, lower_grad)`` over an ``nranks`` world:
    ``lower(body, *args)`` records ``body(COMM_WORLD, *args)`` under
    ``run_spmd``, ``lower_grad`` with its gradient."""
    from ..comm import COMM_WORLD
    from ..ops.spmd import run_spmd

    def make(body):
        return run_spmd(lambda *a: body(COMM_WORLD, *a), nranks=nranks,
                        device=device)

    def lower(body, *args):
        return _lower(make(body), *args)

    def lower_grad(body, *args):
        return _lower(_with_gradient(make(body)), *args)

    return lower, lower_grad


def _mesh2d_lowerer(shape: Tuple[int, int], device):
    from ..comm import comm_from_mesh
    from ..mesh import device_mesh
    from ..ops.spmd import run_spmd
    from ..runtime import resolve_device

    a, b = shape
    dev = resolve_device(device)
    mesh = device_mesh({"outer": a, "inner": b}, devices=[dev] * (a * b))
    comm = comm_from_mesh(mesh, ("outer", "inner"))

    def make(body):
        return run_spmd(lambda *x: body(comm, *x), mesh=mesh,
                        axis_name="outer")

    def lower(body, *args):
        return _lower(make(body), *args)

    def lower_grad(body, *args):
        return _lower(_with_gradient(make(body)), *args)

    return lower, lower_grad


def _lint_case(records: List[dict], case: str, fwd_prog,
               fwdbwd_prog=None, vjp_declaration=None,
               extra: Optional[dict] = None):
    """Run the structural lints (and, when a declaration is given, the
    VJP-symmetry lint) and append one sweep record."""
    fwd = parse_program(fwd_prog)
    violations = run_lints(fwd)
    if fwdbwd_prog is not None:
        bwd = parse_program(fwdbwd_prog)
        violations += run_lints(bwd)
        if vjp_declaration is not None:
            violations += check_vjp_symmetry(
                fwd, bwd, vjp_declaration, context=case)
    rec = {"case": case, "skipped": None,
           "census": {k: v for k, v in fwd.census().items() if v},
           "violations": [str(v) for v in violations]}
    if extra:
        rec.update(extra)
    records.append(rec)


def _lint_grad_case(records: List[dict], case: str, fwdbwd,
                    vjp_declaration=None):
    """:func:`_lint_case` of a value-and-gradient recording, its forward
    the recording's first run (what a forward recording holds: one run
    of the same call)."""
    _lint_case(records, case, fwdbwd.region(0), fwdbwd, vjp_declaration)


def _skip(records: List[dict], case: str, reason: str):
    records.append({"case": case, "skipped": reason, "census": {},
                    "violations": []})


def _sweep_allreduce_flat(records: List[dict], nranks: int, device,
                          nelem: int = 512):
    from .. import csched, tune
    from ..compress import available_codecs, codec_rides_algorithm, \
        get_codec
    from ..constants import MPI_SUM
    from ..runtime import resolve_device

    lower, lower_grad = _flat_lowerer(nranks, device)
    x = torch.ones((nelem,), dtype=torch.float32,
                   device=resolve_device(device))

    for algo in tune.available_algorithms():
        spec = tune.get_algorithm(algo)
        why = spec.why_not(nranks)
        if why is not None:
            _skip(records, f"({nranks},) allreduce.{algo}", why)
            continue
        codecs = [None] + [
            c for c in available_codecs()
            if codec_rides_algorithm(get_codec(c), algo)]
        decl = csched.declared_vjp_census(algo, max(nranks, 2)) \
            if nranks > 1 else "self"
        for codec in codecs:
            tag = f"({nranks},) allreduce.{algo}" + (
                f".{codec}" if codec else "")

            def body(c, v, algo=algo, codec=codec):
                return c.Allreduce(v, MPI_SUM, algorithm=algo,
                                   compression=codec or False)

            _lint_grad_case(records, tag, lower_grad(body, x), decl)

    # The bcast/reduce forms of the algorithms that serve them: the
    # adjoint of Bcast_ is a Reduce_ (and vice versa), so these legs run
    # the structural lints on the forward recording.
    for collective, op in (("bcast", "Bcast_"), ("reduce", "Reduce_")):
        for algo in tune.available_algorithms():
            spec = tune.get_algorithm(algo)
            if spec.why_not(nranks, collective) is not None:
                continue

            def body(c, v, algo=algo, op=op):
                if op == "Bcast_":
                    return c.Bcast_(v, 0, algorithm=algo)
                return c.Reduce_(v, MPI_SUM, 0, algorithm=algo)

            _lint_case(records, f"({nranks},) {collective}.{algo}",
                       lower(body, x))


def _sweep_allreduce_2d(records: List[dict], shape: Tuple[int, int],
                        device, nelem: int = 512):
    from ..constants import MPI_SUM
    from ..runtime import resolve_device

    _, lower_grad = _mesh2d_lowerer(shape, device)
    x = torch.ones((nelem,), dtype=torch.float32,
                   device=resolve_device(device))
    label = f"{shape}"

    # The 2-axis backend owns its algorithm resolution: its native
    # grouped schedule plus the explicit hier/torus forms; no codec.
    for algo in (None, "hier", "torus"):
        tag = f"{label} allreduce." + (algo or "native")

        def body(c, v, algo=algo):
            return c.Allreduce(v, MPI_SUM, algorithm=algo)

        _lint_grad_case(records, tag, lower_grad(body, x), "self")


def _reshard_factors(n: int) -> Optional[Tuple[int, int]]:
    for a in range(2, n):
        if n % a == 0 and n // a > 1:
            return (a, n // a)
    return None


def _sweep_reshard(records: List[dict], nranks: int, device):
    """Every reshard strategy on a transition that exercises it;
    returns the step kinds the planned forward+adjoint programs covered
    (the registry guard's sweep-coverage leg)."""
    from .. import reshard as rs
    from ..runtime import resolve_device

    _, lower_grad = _flat_lowerer(nranks, device)
    n = nranks
    factors = _reshard_factors(n)
    G = (4 * n, n)
    exercised: set = set()

    cases: List[Tuple[str, object, object]] = [
        ("local", rs.layout((n,), None, None), rs.layout((n,), 0, None)),
        ("gather", rs.layout((n,), None, None),
         rs.layout((n,), 0, None)),
    ]
    if factors is not None:
        a, b = factors
        cases += [
            ("alltoall", rs.layout((n,), 0, None),
             rs.layout((a, b), 0, 1)),
            ("rounds", rs.layout((n,), 0, None),
             rs.layout((a, b), 0, 1)),
            ("allgather", rs.layout((n,), 0, None),
             rs.layout((a, b), (0,), None)),
            ("permute", rs.layout((a, b), (0, 1), None),
             rs.layout((a, b), (1, 0), None)),
            ("gather", rs.layout((n,), 0, None),
             rs.layout((a, b), 0, 1)),
        ]
    ran = set()
    for strategy, fl, tl in cases:
        tag = f"({nranks},) reshard.{strategy}"
        if tag in ran:
            tag += ".migrate"
        ran.add(tag)
        plan = rs.plan_reshard(fl, tl, G, torch.float32, strategy)
        exercised |= {s.kind for s in plan.steps}
        exercised |= {s.kind for s in plan.adjoint().steps}

        def body(c, v, fl=fl, tl=tl, strategy=strategy):
            return c.Reshard(v, fl, tl, strategy=strategy)

        x = torch.zeros(fl.shard_shape(G), dtype=torch.float32,
                        device=resolve_device(device))
        _lint_grad_case(records, tag, lower_grad(body, x))

    missing = sorted(set(rs.STRATEGIES) - {c[0] for c in cases})
    for strategy in missing:
        _skip(records, f"({nranks},) reshard.{strategy}",
              f"needs a 2-level factorization; {n} has none")
    return exercised, factors is not None


def _sweep_overlap(records: List[dict], nranks: int, device):
    from ..constants import MPI_SUM
    from ..overlap import overlap_split_allreduce
    from ..runtime import resolve_device

    dev = resolve_device(device)
    lower, _ = _flat_lowerer(nranks, device)
    tree = {f"p{i}": torch.ones((192 + 8 * i,), dtype=torch.float32,
                                device=dev) for i in range(4)}

    def fused(c, t):
        return c.Allreduce_tree(t, MPI_SUM, bucket_bytes=1024, overlap=2)

    prog = lower(fused, tree)
    _lint_case(records, f"({nranks},) overlap.allreduce_tree", prog,
               extra={"scheduled_exposure":
                      scheduled_exposure(prog)["exposed_fraction"]})

    def split(c, v):
        return overlap_split_allreduce(c, v, MPI_SUM, nsplits=3)

    prog = lower(split, torch.ones((1536,), dtype=torch.float32,
                                   device=dev))
    _lint_case(records, f"({nranks},) overlap.split_allreduce", prog,
               extra={"scheduled_exposure":
                      scheduled_exposure(prog)["exposed_fraction"]})


def _sweep_serve(records: List[dict], nranks: int, device):
    import numpy as np

    from ..models import transformer as T
    from ..runtime import resolve_device
    from ..serve import Engine, ServeConfig

    dev = resolve_device(device)
    size = min(nranks, 4)
    cfg = T.TransformerConfig(vocab=37, d_model=16, n_heads=4,
                              n_layers=1, d_ff=32, max_seq=16)
    params = T.init_transformer(0, cfg, dtype=torch.float32, device=dev)
    for name, ov in (("overlap", True), ("blocking", False)):
        eng = Engine(cfg, params, ServeConfig(slots=2, overlap=ov),
                     spmd=True, nranks=size, device=dev)
        eng.submit(np.array([1, 2, 3]), max_new=2)
        eng.step()
        prog = eng.lower_step()
        _lint_case(
            records, f"({size},) serve.decode.{name}", prog,
            extra={"scheduled_exposure":
                   scheduled_exposure(prog)["exposed_fraction"]})


def run_sweep(world: Tuple[int, ...], include_serve: bool = True,
              device=None) -> Dict:
    """Lint-sweep every registered schedule a ``world`` (a flat ``(n,)``
    or two-axis ``(a, b)`` rank shape of rank threads on ``device``) can
    run.  Returns ``{"world", "records", "n_cases", "n_skipped",
    "violations", "problems"}`` — ``problems`` carries the standing
    registry-sync guards plus the reshard step-kind coverage of this
    sweep's own plans."""
    from .registry import reshard_step_problems, standing_problems

    world = tuple(int(d) for d in world)
    if len(world) not in (1, 2) or min(world) < 1:
        raise ValueError(
            f"world {world} is not a flat (n,) or two-axis (a, b) shape "
            "of positive rank counts")

    records: List[dict] = []
    problems: List[str] = []
    if len(world) == 2:
        _sweep_allreduce_2d(records, world, device)
    else:
        n = world[0]
        _sweep_allreduce_flat(records, n, device)
        exercised, factorable = _sweep_reshard(records, n, device)
        problems += reshard_step_problems(
            exercised if factorable else None)
        if n >= 2:
            _sweep_overlap(records, n, device)
        if include_serve:
            _sweep_serve(records, n, device)
    problems += standing_problems()

    violations = [v for r in records for v in r["violations"]]
    return {
        "world": world,
        "records": records,
        "n_cases": sum(1 for r in records if r["skipped"] is None),
        "n_skipped": sum(1 for r in records if r["skipped"]),
        "violations": violations,
        "problems": problems,
    }
