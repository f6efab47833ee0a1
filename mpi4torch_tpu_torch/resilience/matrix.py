"""The censused fault matrix: every fault kind x one representative
collective per subsystem, with a typed expected outcome per cell.

Port of ``mpi4torch_tpu/resilience/matrix.py``: :data:`COVERAGE` is the
literal coverage table, checked against :data:`~.faults.FAULT_KINDS`, so
a fault kind cannot be registered without a row.

Cell outcomes:

* ``"raise"`` — the fault surfaces as its typed, rank-attributed error
  (:data:`EXPECTED_ERROR`): ``err.ranks`` names the injected rank.
* ``"recover"`` — a transient fault: with ``config.comm_retries`` and
  ``comm_backoff`` set, the collective completes, the result is bitwise
  the fault-free run's, and the plan's fired ledger proves the fault
  acted.
* ``"inert"`` — the fault has no eligible target in this subsystem
  (``drop_p2p`` off the p2p wire, ``bitflip`` off the int8 wire): the
  plan must not fire and the result stays bitwise exact.

Representative collectives, on the rank threads: ``plain`` =
``Allreduce``; ``fused`` = ``Allreduce_tree`` in several buckets;
``compressed`` = the q8 ``Allreduce``, except for ``bitflip``, whose
int8 wire is the q8 ``Allgather``'s; ``overlap`` = the fused
``overlap=2`` Isend/Irecv pipeline.  Worlds: ``(3,)``, ``(8,)``, and the
8-rank world on ``algorithm="torus"`` (the (2, 4) factorization).
``truncate_save`` has its own cell, :func:`run_checkpoint_cell`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..runtime import DeadlockError, IntegrityError, RankFailedError
from ..utils.tree import tree_leaves
from .faults import FaultSpec, fault_scope

__all__ = ["COVERAGE", "EXPECTED_ERROR", "COMM_SUBSYSTEMS", "WORLDS",
           "run_cell", "run_checkpoint_cell", "coverage_cells"]

COMM_SUBSYSTEMS = ("plain", "fused", "compressed", "overlap")

# The literal coverage table (checked against FAULT_KINDS).
COVERAGE: Dict[str, Dict[str, str]] = {
    "rank_death": {"plain": "raise", "fused": "raise",
                   "compressed": "raise", "overlap": "raise"},
    "delay": {"plain": "recover", "fused": "recover",
              "compressed": "recover", "overlap": "recover"},
    "drop_p2p": {"plain": "inert", "fused": "inert",
                 "compressed": "inert", "overlap": "recover"},
    "corrupt_nan": {"plain": "raise", "fused": "raise",
                    "compressed": "raise", "overlap": "raise"},
    "corrupt_inf": {"plain": "raise", "fused": "raise",
                    "compressed": "raise", "overlap": "raise"},
    "bitflip": {"plain": "inert", "fused": "inert",
                "compressed": "raise", "overlap": "inert"},
    # With count=1 (the cell default) the notice window is empty: notice
    # and death land on one call, so a job that does not drain sees the
    # rank_death shape, the typed attributed raise.
    "preempt": {"plain": "raise", "fused": "raise",
                "compressed": "raise", "overlap": "raise"},
    "truncate_save": {"checkpoint": "recover"},
    # Gray kinds are transients here: recovered bitwise under retries, or
    # inert where they have no eligible wire (flaky_link off the p2p
    # mailboxes).
    "slow_rank": {"plain": "recover", "fused": "recover",
                  "compressed": "recover", "overlap": "recover"},
    "jitter": {"plain": "recover", "fused": "recover",
               "compressed": "recover", "overlap": "recover"},
    "flaky_link": {"plain": "inert", "fused": "inert",
                   "compressed": "inert", "overlap": "recover"},
    "brownout": {"plain": "recover", "fused": "recover",
                 "compressed": "recover", "overlap": "recover"},
}

EXPECTED_ERROR = {
    "rank_death": RankFailedError,
    "preempt": RankFailedError,
    "corrupt_nan": IntegrityError,
    "corrupt_inf": IntegrityError,
    "bitflip": IntegrityError,
    "delay": DeadlockError,        # the unrecovered form (retries=0)
    "drop_p2p": DeadlockError,     # the unrecovered form
    "slow_rank": DeadlockError,
    "jitter": DeadlockError,
    "flaky_link": DeadlockError,
    "brownout": DeadlockError,
}

# The matrix worlds: flat 3, flat 8, and 8 as the (2, 4) torus.
WORLDS = ((3, None), (8, None), (8, "torus"))

# Cell timing: a small world timeout keeps the failure cells fast; the
# retry budget must outwait DELAY_S in the recover cells.
CELL_TIMEOUT_S = 0.3
DELAY_S = 0.5
RETRIES = 5
BACKOFF_S = 0.15
GRAY_SLOW_S = 0.35        # slow_rank per-call tax
GRAY_JITTER_S = 0.4       # jitter maximum
GRAY_PER_BYTE_S = 2e-3    # brownout: 256 B plain payload -> ~0.5 s
GRAY_COUNT = 3            # persistence window of the gray kinds


def _spec_for(kind: str, target: int, op_prefix: Optional[str]
              ) -> FaultSpec:
    if kind == "slow_rank":
        return FaultSpec(kind, rank=target, op=op_prefix,
                         seconds=GRAY_SLOW_S, count=GRAY_COUNT)
    if kind == "jitter":
        return FaultSpec(kind, rank=target, op=op_prefix,
                         seconds=GRAY_JITTER_S, count=GRAY_COUNT)
    if kind == "brownout":
        return FaultSpec(kind, rank=target, op=op_prefix,
                         per_byte_s=GRAY_PER_BYTE_S, count=GRAY_COUNT)
    if kind == "flaky_link":
        return FaultSpec(kind, rank=target, op=op_prefix, p=1.0, count=2)
    return FaultSpec(kind, rank=target, op=op_prefix, seconds=DELAY_S)


def _cell_fn(subsystem: str, kind: str, algorithm: Optional[str]):
    """The per-rank body of a cell and the op token its fault spec
    targets.  Data is a function of the rank alone; every cell returns
    tensors for a bitwise comparison."""
    import mpi4torch_tpu_torch as mpi

    comm = mpi.COMM_WORLD

    def arange(n):
        return torch.arange(n, dtype=torch.float32, device=comm.device)

    if subsystem == "plain":
        def fn(rank):
            x = arange(64) * (rank + 1)
            return comm.Allreduce(x, mpi.MPI_SUM, algorithm=algorithm)
        return fn, "Allreduce"

    def tree(rank):
        return {"a": arange(24) * (rank + 1),
                "b": torch.ones(8, device=comm.device) * rank}

    if subsystem == "fused":
        def fn(rank):
            return comm.Allreduce_tree(tree(rank), mpi.MPI_SUM,
                                       bucket_bytes=64)
        return fn, "Allreduce"

    if subsystem == "compressed":
        if kind == "bitflip":
            # The q8 Allgather's rendezvous wire carries int8 blocks; the
            # q8 Allreduce's exchanged contributions are raw floats.
            def fn(rank):
                x = torch.linspace(-2.0, 2.0, 48,
                                   device=comm.device) * (rank + 1)
                return comm.Allgather(x, 0, compression="q8")
            return fn, "Allgather.c"

        def fn(rank):
            x = torch.linspace(-2.0, 2.0, 96,
                               device=comm.device) * (rank + 1)
            return comm.Allreduce(x, mpi.MPI_SUM, compression="q8",
                                  algorithm=algorithm)
        return fn, "Allreduce"

    if subsystem == "overlap":
        def fn(rank):
            return comm.Allreduce_tree(tree(rank), mpi.MPI_SUM,
                                       bucket_bytes=64, overlap=2)
        # The pipeline's comm sites are the Isend/Irecv mailboxes.
        return fn, "p2p" if kind in ("drop_p2p", "flaky_link") else None

    raise ValueError(f"unknown matrix subsystem {subsystem!r}")


def _tree_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x.cpu(), y.cpu()) for x, y in zip(la, lb))


class _knob:
    """Save and restore process-wide config knobs around a cell."""

    def __init__(self, **kw):
        self._kw = kw

    def __enter__(self):
        from .. import config as _cfg

        self._prev = {}
        self._setters = {"comm_retries": _cfg.set_comm_retries,
                         "comm_backoff": _cfg.set_comm_backoff,
                         "comm_finite_guard": _cfg.set_comm_finite_guard,
                         "comm_wire_checksum": _cfg.set_comm_wire_checksum}
        for k, v in self._kw.items():
            self._prev[k] = getattr(_cfg, k)()
            self._setters[k](v)
        return self

    def __exit__(self, *exc):
        for k, v in self._prev.items():
            self._setters[k](v)
        return False


_baselines: Dict[tuple, list] = {}


def _baseline(subsystem: str, kind: str, nranks: int,
              algorithm: Optional[str], device):
    """Fault-free results, cached per cell shape (the body is a function
    of the rank, so one baseline serves every kind sharing it)."""
    import mpi4torch_tpu_torch as mpi

    rep = "allgather" if (subsystem, kind) == ("compressed", "bitflip") \
        else subsystem
    key = (rep, nranks, algorithm, str(device))
    if key not in _baselines:
        fn, _op = _cell_fn(subsystem, kind, algorithm)
        _baselines[key] = mpi.run_ranks(fn, nranks, timeout=30.0,
                                        backend="thread", device=device)
    return _baselines[key]


def run_cell(kind: str, subsystem: str, nranks: int = 3,
             algorithm: Optional[str] = None,
             backend: Optional[str] = None, device=None) -> dict:
    """Run one matrix cell; returns a verdict record with ``status``
    ``"ok"`` or ``"fail"`` and a readable ``detail``.  ``device`` is the
    rank world's (CUDA unless ``"cpu"`` is asked for); ``backend`` is the
    transport the faulted run takes (None: ``config.comm_transport()``),
    recorded in the verdict.  The fault-free baseline always comes from
    the rank threads, so a ``backend="process"`` cell holds recovery and
    inertness bitwise across backends, and its ``rank_death`` and
    ``preempt`` kills are SIGKILLs of real worker processes."""
    import mpi4torch_tpu_torch as mpi

    expected = COVERAGE.get(kind, {}).get(subsystem)
    if expected is None:
        return {"kind": kind, "subsystem": subsystem, "nranks": nranks,
                "status": "fail",
                "detail": "no COVERAGE row — the registry check should "
                          "have caught this"}
    target = 1 if nranks > 1 else 0
    fn, op_prefix = _cell_fn(subsystem, kind, algorithm)
    baseline = _baseline(subsystem, kind, nranks, algorithm, device)

    spec = _spec_for(kind, target, op_prefix)
    knobs = {}
    if expected == "recover":
        knobs.update(comm_retries=RETRIES, comm_backoff=BACKOFF_S)
    if kind in ("corrupt_nan", "corrupt_inf"):
        knobs.update(comm_finite_guard="raise")
    if kind == "bitflip":
        knobs.update(comm_wire_checksum=True)

    got, err = None, None
    with _knob(**knobs), fault_scope([spec]) as plan:
        try:
            got = mpi.run_ranks(fn, nranks, timeout=CELL_TIMEOUT_S,
                                backend=backend, device=device)
        except Exception as e:  # noqa: BLE001 — classified below
            err = e

    rec = {"kind": kind, "subsystem": subsystem, "nranks": nranks,
           "algorithm": algorithm, "expected": expected,
           "backend": backend or mpi.config.comm_transport(),
           "fired": sorted(plan.fired_kinds())}

    def fail(detail):
        rec.update(status="fail", detail=detail)
        return rec

    if expected == "raise":
        want = EXPECTED_ERROR[kind]
        if err is None:
            return fail(f"fault went UNDETECTED: expected {want.__name__}, "
                        "collective completed")
        if not isinstance(err, want):
            return fail(f"expected {want.__name__}, got "
                        f"{type(err).__name__}: {err}")
        ranks = getattr(err, "ranks", frozenset())
        if target not in ranks:
            return fail(f"{want.__name__} is UNATTRIBUTED: expected rank "
                        f"{target} in {sorted(ranks)}")
        rec.update(status="ok", detail=f"{want.__name__} naming rank "
                                       f"{sorted(ranks)}")
        return rec

    if err is not None:
        return fail(f"expected {expected}, got "
                    f"{type(err).__name__}: {err}")
    if not _tree_equal(got, baseline):
        return fail("result DIVERGES from the fault-free baseline "
                    "(silent corruption)")
    fired = plan.fired_kinds()
    if expected == "recover" and kind not in fired:
        return fail("vacuous pass: the fault never fired "
                    f"(fired={sorted(fired)})")
    if expected == "inert" and kind in fired:
        return fail("fault fired on a subsystem declared inert for it")
    rec.update(status="ok",
               detail="recovered bitwise" if expected == "recover"
               else "inert (no eligible target), result bitwise exact")
    return rec


def run_checkpoint_cell(workdir: str) -> dict:
    """The ``truncate_save`` x checkpoint cell: three saved steps, the
    last save torn by the fault plan; :func:`~.recovery.restore_or_init`
    must fall back to the previous complete step bit for bit."""
    import warnings

    from ..utils.checkpoint import CheckpointManager
    from .recovery import restore_or_init

    rec = {"kind": "truncate_save", "subsystem": "checkpoint",
           "expected": "recover"}

    def state_at(step):
        return {"w": torch.arange(6, dtype=torch.float32) * (step + 1),
                "step": torch.tensor(step, dtype=torch.int32)}

    spec = FaultSpec("truncate_save", rank=0, op="ckpt_save", index=2)
    with fault_scope([spec]) as plan:
        with CheckpointManager(workdir) as mgr:
            for step in range(3):
                mgr.save(step, state_at(step), force=True)
            mgr.wait_until_finished()
    if "truncate_save" not in plan.fired_kinds():
        rec.update(status="fail",
                   detail="vacuous pass: the save fault never fired")
        return rec
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        state, step = restore_or_init(workdir, template=state_at(0))
    if step != 1:
        rec.update(status="fail",
                   detail=f"expected fallback to step 1, got {step}")
        return rec
    if not _tree_equal(state, state_at(1)):
        rec.update(status="fail",
                   detail="fallback state diverges from step 1")
        return rec
    rec.update(status="ok", detail="mid-save kill fell back to the last "
                                   "complete step bit-for-bit")
    return rec


def coverage_cells():
    """Every (kind, subsystem) cell of the coverage table, in a fixed
    order."""
    for kind in sorted(COVERAGE):
        for subsystem in COVERAGE[kind]:
            yield kind, subsystem
