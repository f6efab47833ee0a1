"""The collective-schedule IR (GC3-style, arXiv:2201.11840).

Port of ``mpi4torch_tpu/csched``: algorithms are typed IR programs
(:mod:`.ir`, :mod:`.programs`), ONE lowering emits the Mode A schedule of
a ``run_spmd`` rank thread (:mod:`.lower`), ONE transposition rule
derives every backward (:func:`.ir.transpose`), ONE interpreter is the
Mode B / deterministic-mode fold oracle (:mod:`.interp`), ONE census
generator accounts for wire bytes, steps and collective counts
(:mod:`.census`), and schedule synthesis is a search over programs
(:mod:`.synth`) whose winners the tune cache persists.  Every Mode A
``Allreduce``, ``Bcast_`` and ``Reduce_`` builds its program and lowers
it at the call site (``ops/spmd.py``), the block-q8 compressed Allreduce
lowers its codec-rewritten program (``compress/spmd.py``), and the
rank-thread grouped folds and synthesized schedules run through the
interpreter (``constants.reduce_grouped``/``reduce_torus``,
``ops/eager.py``).  Programs, their JSON and their digests are the JAX
package's.  The port's recorded programs (:mod:`mpi4torch_tpu_torch.
analyze`) hold the exchanges these programs lower to; ``python -m
mpi4torch_tpu_torch.csched --smoke|--tiers`` holds the IR routes against
the hand-written ones and the census against the recordings.
"""

from __future__ import annotations

from .census import (census_covers, program_census,
                     program_tier_census, tier_of_group,
                     tier_of_groups, weighted_cost)
from .interp import interpret_allreduce, interpreter_covers, \
    level_fold_groups
from .ir import (Phase, Program, STEP_KINDS, Step, transpose,
                 transposition_covers)
from .lower import (lower_allreduce, lower_q8_allreduce, lower_value,
                    lowering_covers)
from .programs import (NATIVE_EXEMPT, PROGRAM_ALGORITHMS,
                       allreduce_program, bcast_program, has_program,
                       q8_allreduce_program, reduce_program,
                       rewrite_codec)
from .synth import (TIER_COMPOSITIONS, autotune_synthesis,
                    autotune_tier_synthesis, factorization_chains,
                    fold_program, install, installed_program,
                    is_synth_name, rewrite_fold_codec,
                    synth_applicable, synthesize, synthesize_tiers)

__all__ = [
    "Program", "Phase", "Step", "STEP_KINDS", "transpose",
    "allreduce_program", "bcast_program", "reduce_program",
    "q8_allreduce_program", "rewrite_codec", "has_program",
    "PROGRAM_ALGORITHMS", "NATIVE_EXEMPT",
    "lower_allreduce", "lower_value", "lower_q8_allreduce",
    "interpret_allreduce", "level_fold_groups",
    "program_census", "program_tier_census", "tier_of_group",
    "tier_of_groups", "weighted_cost",
    "synthesize", "fold_program", "factorization_chains",
    "autotune_synthesis", "install", "installed_program",
    "is_synth_name", "synth_applicable",
    "synthesize_tiers", "autotune_tier_synthesis",
    "rewrite_fold_codec", "TIER_COMPOSITIONS",
    "lowering_covers", "interpreter_covers", "transposition_covers",
    "census_covers",
    "declared_vjp_census",
]


def declared_vjp_census(algorithm: str, nranks: int = 8):
    """The VJP-symmetry declaration derived from the transposition rule:
    ``"self"`` when the transposed program's census equals the
    forward's (every shipped allreduce schedule: allreduce(SUM) is
    self-adjoint and direction flips keep the census)."""
    import torch

    from .. import constants as C

    prog = allreduce_program(algorithm, nranks, C.MPI_SUM,
                             deterministic=False, nelems=1024,
                             itemsize=torch.float32.itemsize)
    fwd = program_census(prog, 1024, 4)
    bwd = program_census(transpose(prog), 1024, 4)
    return "self" if fwd == bwd else {"mismatch": (fwd, bwd)}
