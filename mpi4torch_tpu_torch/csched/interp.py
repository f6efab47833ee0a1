"""The one Mode B / deterministic-mode fold oracle.

Port of ``mpi4torch_tpu/csched/interp.py``.  ``interpret_allreduce(
program, op, values)`` executes an IR program over the rank-ordered
contribution list the rank-thread backend collects through
``World.exchange``: the fold whose association IS the program's reduce
order, so Mode A (the lowering of the same program) and Mode B stay
bitwise comparable.  ``constants.reduce_grouped`` / ``reduce_torus`` and
the eager ``hier`` fold of a deeper tier stack run through its one
``level_fold`` path (:func:`level_fold_groups`), and codec programs
interpret channel for channel through ``constants._sim_quant_ring``, the
simulator ``reduce_q8_hop`` runs (every hop the CUDA kernel K1 on a
card, its plain version on the CPU).

Step semantics on the rank-ordered value list:

* ``native_allreduce`` / ``ring_fold`` / ``ring_chain`` — the
  ascending-rank fold (``constants.reduce_ordered``);
* ``level_fold`` — one tier of a grouped ordered reduction: each group
  folds its members ascending and every member adopts the partial;
* ``butterfly`` — the balanced rhd pairing (``reduce_rhd``);
* ``tree_reduce`` / ``tree_bcast`` / ``mask_root`` — the binomial-tree
  association relative to the root, non-roots zeroed / broadcast;
* ``grouped_sum`` — its deterministic tier structure (two grouped
  level folds);
* ``q8_ring_channel`` / ``q8_level_fold`` — the bit-exact quantized
  simulations.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..runtime import CommError
from .ir import Phase, Program, Step
from .programs import resolve_sigma

# ---------------------------------------------------------------------------
# Per-kind interpretations: (step, op, vals) -> vals'.
# ---------------------------------------------------------------------------


def _interp_ordered(step: Step, op: int, vals):
    r = C.reduce_ordered(op, vals)
    return [r] * len(vals)


def level_fold_groups(step_groups, op: int, vals):
    """One grouped tier: every group folds its members ascending and
    each member adopts the partial.  Groups whose members hold the same
    value objects (every group of an outer tier folds the identical
    partial list) fold once and share the result."""
    out = list(vals)
    memo = {}
    for group in step_groups:
        key = tuple(id(vals[r]) for r in group)
        p = memo.get(key)
        if p is None:
            p = C.reduce_ordered(op, [vals[r] for r in group])
            memo[key] = p
        for r in group:
            out[r] = p
    return out


def _interp_level_fold(step: Step, op: int, vals):
    groups, g = step.params
    if groups is None:
        return _interp_ordered(step, op, vals)
    return level_fold_groups(groups, op, vals)


def _interp_butterfly(step: Step, op: int, vals):
    r = C.reduce_rhd(op, vals)
    return [r] * len(vals)


def _interp_tree_reduce(step: Step, op: int, vals):
    (root,) = step.params
    vals = list(vals)
    r = C.reduce_tree(op, vals[root:] + vals[:root])
    return [r if i == root else torch.zeros_like(r)
            for i in range(len(vals))]


def _interp_tree_bcast(step: Step, op: int, vals):
    (root,) = step.params
    return [vals[root]] * len(vals)


def _interp_mask_root(step: Step, op: int, vals):
    (root,) = step.params
    return [v if i == root else torch.zeros_like(v)
            for i, v in enumerate(vals)]


def _interp_grouped_sum(step: Step, op: int, vals):
    g, rs, ar, ag = step.params
    return level_fold_groups(ar, op, level_fold_groups(rs, op, vals))


def _interp_q8_ring_channel(step: Step, op: int, vals, codec=None):
    """Bit-exact simulation of one quantized ring channel: the
    ``constants._sim_quant_ring`` walk ``reduce_q8_hop`` composes, with
    the channel's walk, direction and salt taken from the step."""
    if codec is None:
        raise CommError(
            "q8_ring_channel interpretation needs the program's codec")
    from ..ops import quant_kernels as _qk

    base = codec.base()
    sigma_spec, d, chan, _rev = step.params
    n = len(vals)
    sigma = resolve_sigma(sigma_spec, n)
    out, resids = C._sim_quant_ring(vals, base.block, sigma, d,
                                    _qk.ring_salt(0, chan), base.stochastic,
                                    base.hop_ef, track=codec.ef_rounds > 1)
    for r in range(1, codec.ef_rounds):
        last = r == codec.ef_rounds - 1
        more, resids = C._sim_quant_ring(resids, base.block, sigma, d,
                                         _qk.ring_salt(r, chan),
                                         base.stochastic, base.hop_ef,
                                         track=not last)
        out = out + more
    return out


def _interp_q8_level_fold(step: Step, op: int, vals):
    """Every member's contribution crosses the wire encoded and is
    decoded on arrival (:func:`.lower.q8_fold_roundtrip`, the op sequence
    the Mode A emitter applies to each gathered member); then each group
    folds the decoded values ascending, as ``level_fold``."""
    from .lower import _fold_block, q8_fold_roundtrip

    groups, g = step.params
    block = _fold_block(step)
    dec = [q8_fold_roundtrip(v, block) for v in vals]
    if groups is None:
        return _interp_ordered(step, op, dec)
    return level_fold_groups(groups, op, dec)


INTERP = {
    "native_allreduce": _interp_ordered,
    "level_fold": _interp_level_fold,
    "ring_fold": _interp_ordered,
    "butterfly": _interp_butterfly,
    "tree_reduce": _interp_tree_reduce,
    "tree_bcast": _interp_tree_bcast,
    "mask_root": _interp_mask_root,
    "ring_chain": _interp_ordered,
    "grouped_sum": _interp_grouped_sum,
    "q8_ring_channel": _interp_q8_ring_channel,
    "q8_level_fold": _interp_q8_level_fold,
}


def interpreter_covers():
    """Step kinds the interpreter table serves (registry-guard probe)."""
    return tuple(INTERP)


# ---------------------------------------------------------------------------
# Program interpretation
# ---------------------------------------------------------------------------


def _interp_multipath(phase: Phase, op: int, vals):
    n = len(vals)
    shape = vals[0].shape
    flats = [v.reshape(-1) for v in vals]
    total = flats[0].numel()
    m = C.multipath_split(total)
    by_span = {}
    for s in phase.steps:
        by_span.setdefault(s.span, []).append(s)

    def key(sp):
        return sp[1] if isinstance(sp, tuple) else -1

    outs = []
    for k, span in enumerate(sorted(by_span, key=key)):
        if k > 0 and m >= total:
            break
        cv = [f[:m] if k == 0 else f[m:] for f in flats]
        for step in by_span[span]:
            cv = INTERP[step.kind](step, op, cv)
        outs.append(cv[0])
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return [out.reshape(shape)] * n


def _interp_q8(program: Program, vals):
    from ..compress import get_codec

    codec = get_codec(program.codec)
    shape, dtype = vals[0].shape, vals[0].dtype
    flats = [v.to(torch.float32).reshape(-1) for v in vals]
    total = flats[0].numel()
    steps = program.phases[0].steps
    m = C.multipath_split(total) if len(steps) > 1 else total
    outs = []
    for k, step in enumerate(steps):
        if k > 0 and m >= total:
            break
        chan = [f[:m] if k == 0 else f[m:] for f in flats]
        outs.append(_interp_q8_ring_channel(step, C.MPI_SUM, chan,
                                            codec=codec))
    flat_out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return flat_out.reshape(shape).to(dtype)


def interpret_allreduce(program: Program, op: int, values):
    """Execute an allreduce program over the rank-ordered contribution
    list; returns the (rank-uniform) reduced value.  The eager
    rendezvous fold of an algorithm is this function on the algorithm's
    program."""
    vals = list(values)
    if not vals:
        raise ValueError("interpret_allreduce needs at least one value")
    n = len(vals)
    if program is None or not program.phases or n == 1:
        return vals[0]
    if program.nranks != n:
        raise CommError(
            f"program was built for {program.nranks} ranks; got a "
            f"{n}-rank contribution list")
    if program.codec is not None:
        return _interp_q8(program, vals)
    for phase in program.phases:
        if phase.kind == "multipath":
            vals = _interp_multipath(phase, op, vals)
        else:
            for step in phase.steps:
                vals = INTERP[step.kind](step, op, vals)
    return vals[0]
