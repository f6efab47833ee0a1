"""mpi4torch_tpu_torch.analyze — the static collective-schedule verifier.

Port of ``mpi4torch_tpu.analyze``.  The paper's core contract — every
collective is an AD node whose backward is itself a collective, with
handle machinery encoding the cross-rank ordering the per-rank DAG
cannot see — is a property of the program a rank runs, checkable before
the wire runs in production.  The JAX package reads it off the StableHLO
text of a lowering; the port has no compiler, so its lowering is a
recorded run (:func:`lower`, :mod:`.record`): the program runs once on
its rank threads, and every ``World.exchange`` becomes a typed
collective record, every aten op and kernel launch an event.  On top:

* **one parser** (:mod:`.parse`): :func:`parse_program` gives the
  :class:`ParsedProgram` — typed :class:`CollectiveOp` records (kind,
  ``replica_groups``, ``source_target_pairs``, channel, payload
  dtype/bytes, span path) and the :class:`OpEvent` stream;
* **soundness lints** (:mod:`.lints`): permute tables form valid partial
  permutations, replica groups exactly partition the participating axis,
  split-phase start/wait spans pair up per bucket with no dangling or
  double-completed handle, and each registered algorithm's backward
  census is its declared transpose;
* **unified accounting** (:mod:`.accounting`):
  :func:`wire_bytes_per_device`, :func:`peak_live_bytes`,
  :func:`scheduled_exposure`; ``overlap.scheduled_exposure``,
  ``reshard.peak_live_bytes`` and ``compress.int8_rotation_census``
  delegate here;
* **the registry-wide sweep** (:mod:`.sweep`, ``python -m
  mpi4torch_tpu_torch.analyze --sweep``) and the **seeded-defect
  corpus** (:mod:`.defects`, ``--defects``), which proves every lint
  fires on a mutated schedule.

:mod:`.registry` holds the registry-sync guards.  Every entry point runs
on the card unless the caller passes ``device="cpu"``.
"""

from .accounting import (peak_live_bytes, scheduled_exposure,
                         tier_wire_table, weighted_wire_cost,
                         wire_bytes_per_device, wire_contribution)
from .defects import (DEFECTS, Defect, DefectPrograms,
                      defect_ledger_problems, run_defect_corpus)
from .lints import (LINT_NAMES, LintViolation, check_vjp_symmetry,
                    run_lints)
from .parse import (COLLECTIVE_KINDS, WIRE_OPS, CollectiveOp, OpEvent,
                    ParsedProgram, bucket_of, parse_program,
                    tensor_bytes)
from .record import LoweredProgram, lower
from .sweep import run_sweep, sweep_worlds

__all__ = [
    "COLLECTIVE_KINDS",
    "WIRE_OPS",
    "CollectiveOp",
    "OpEvent",
    "ParsedProgram",
    "bucket_of",
    "parse_program",
    "tensor_bytes",
    "LINT_NAMES",
    "LintViolation",
    "run_lints",
    "check_vjp_symmetry",
    "wire_bytes_per_device",
    "wire_contribution",
    "tier_wire_table",
    "weighted_wire_cost",
    "peak_live_bytes",
    "scheduled_exposure",
    "DEFECTS",
    "Defect",
    "DefectPrograms",
    "run_defect_corpus",
    "defect_ledger_problems",
    "run_sweep",
    "sweep_worlds",
    "LoweredProgram",
    "lower",
]
