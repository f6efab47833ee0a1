"""The one Mode A emitter: IR program -> the exchange rounds of a rank.

Port of ``mpi4torch_tpu/csched/lower.py``.  One lowering serves every
registered program: it walks the phases, dispatches each step through
:data:`EMIT` (the closed per-kind emitter table) and handles the
multipath striping (flat view, :func:`constants.multipath_split`,
per-channel emission in span order, half 1 sliced only after half 0 is
emitted, concatenation) in the order the hand-written schedules use, so
a lowered program issues the same ``World.exchange`` rendezvous in the
same order and folds the same bits as its hand-written form.  The
emitters are thin calls into the schedule bodies of
:mod:`mpi4torch_tpu_torch.ops.spmd`; the quantized channel reuses
:func:`mpi4torch_tpu_torch.compress.spmd._fused_channel` (every hop the
CUDA kernel K1 on a card), so a codec rewrite changes which steps lower,
never how a hop runs.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..runtime import CommError
from .ir import Phase, Program, Step
from .programs import resolve_sigma

# ---------------------------------------------------------------------------
# Per-kind emitters: (step, ctx, x, op) -> value.
# ---------------------------------------------------------------------------


def _emit_native_allreduce(step: Step, ctx, x, op: int):
    from ..ops import spmd as _spmd

    if op in (C.MPI_SUM, C.MPI_MAX, C.MPI_MIN):
        return _spmd._psum(ctx, x, op)
    raise CommError(
        f"no native collective for {C.op_name(op)}; allreduce_program "
        "routes such ops through the ordered fold")


def _emit_level_fold(step: Step, ctx, x, op: int):
    from ..ops import spmd as _spmd

    groups, g = step.params
    if groups is None:
        return _spmd._gather_fold_allreduce(ctx, x, op)
    stacked = _spmd._all_gather(ctx, x, groups)
    out = stacked[0]
    for i in range(1, g):
        out = C.combine2(op, out, stacked[i])
    return out


def _emit_ring_fold(step: Step, ctx, x, op: int):
    from ..ops import spmd as _spmd

    return _spmd._ring_fold_allreduce(ctx, x, op)


def _emit_butterfly(step: Step, ctx, x, op: int):
    from ..ops import spmd as _spmd

    return _spmd._rhd_allreduce_value(ctx, x, op)


def _emit_tree_reduce(step: Step, ctx, x, op: int):
    from ..ops import spmd as _spmd

    (root,) = step.params
    return _spmd._tree_reduce_value(ctx, x, op, root)


def _emit_tree_bcast(step: Step, ctx, x, op: int):
    from ..ops import spmd as _spmd

    (root,) = step.params
    return _spmd._tree_bcast_value(ctx, x, root)


def _emit_mask_root(step: Step, ctx, x, op: int):
    from ..ops import spmd as _spmd

    (root,) = step.params
    return _spmd._mask_to_root(ctx, x, root)


def _emit_ring_chain(step: Step, ctx, x, op: int):
    from ..ops import spmd as _spmd

    (d,) = step.params
    return _spmd._ring_allreduce_chain(ctx, x, op, d)


def _emit_grouped_sum(step: Step, ctx, x, op: int):
    from ..ops import spmd as _spmd

    g, rs, ar, ag = step.params
    return _spmd._grouped_sum_schedule(x, g, (ctx, rs), (ctx, ar),
                                       (ctx, ag))


def _emit_q8_ring_channel(step: Step, ctx, x, op: int):
    raise CommError(
        "q8_ring_channel steps lower through lower_q8_allreduce (the "
        "codec-rewritten pipeline), not the exact emitter")


def q8_fold_blocks(flat, block: int):
    """The ``(nblocks, block)`` zero-padded block view of a flat f32
    payload: the ``q8_level_fold`` wire layout, one padding rule for the
    emitter, the interpreter and the census."""
    nb = -(-max(flat.numel(), 1) // block)
    pad = nb * block - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(nb, block)


def q8_fold_roundtrip(x, block: int):
    """``decode(encode(x))`` through the ``q8_level_fold`` wire codec:
    what a peer's contribution looks like after the grouped gather.  The
    same ``quant_kernels.requant_blocks`` op sequence as the emitter, so
    both modes fold the same values."""
    from ..ops import quant_kernels as _qk

    shape, dtype = x.shape, x.dtype
    flat = x.to(torch.float32).reshape(-1)
    q, scale = _qk.requant_blocks(q8_fold_blocks(flat, block))
    dec = q.to(torch.float32) * scale[:, None]
    return dec.reshape(-1)[:flat.numel()].reshape(shape).to(dtype)


def _fold_block(step: Step) -> int:
    from ..compress import get_codec

    return get_codec(step.codec or "q8").base().block


def _emit_q8_level_fold(step: Step, ctx, x, op: int):
    from ..ops import quant_kernels as _qk
    from ..ops import spmd as _spmd

    groups, g = step.params
    block = _fold_block(step)
    shape, dtype = x.shape, x.dtype
    flat = x.to(torch.float32).reshape(-1)
    q, scale = _qk.requant_blocks(q8_fold_blocks(flat, block))
    qs = _spmd._all_gather(ctx, q, groups)
    ss = _spmd._all_gather(ctx, scale, groups)
    out = None
    for i in range(g):
        dec = (qs[i].to(torch.float32) * ss[i][:, None]
               ).reshape(-1)[:flat.numel()].reshape(shape).to(dtype)
        out = dec if out is None else C.combine2(op, out, dec)
    return out


EMIT = {
    "native_allreduce": _emit_native_allreduce,
    "level_fold": _emit_level_fold,
    "ring_fold": _emit_ring_fold,
    "butterfly": _emit_butterfly,
    "tree_reduce": _emit_tree_reduce,
    "tree_bcast": _emit_tree_bcast,
    "mask_root": _emit_mask_root,
    "ring_chain": _emit_ring_chain,
    "grouped_sum": _emit_grouped_sum,
    "q8_ring_channel": _emit_q8_ring_channel,
    "q8_level_fold": _emit_q8_level_fold,
}


def lowering_covers():
    """Step kinds the emitter table serves (registry-guard probe)."""
    return tuple(EMIT)


# ---------------------------------------------------------------------------
# Program lowering
# ---------------------------------------------------------------------------


def _span_channels(phase: Phase):
    """A multipath phase's steps grouped by span, in span order; each
    channel's steps run in sequence, channels are independent."""
    by_span = {}
    for s in phase.steps:
        by_span.setdefault(s.span, []).append(s)

    def key(sp):
        return sp[1] if isinstance(sp, tuple) else -1

    return [(sp, by_span[sp]) for sp in sorted(by_span, key=key)]


def _emit_multipath(phase: Phase, ctx, x, op: int):
    shape = x.shape
    flat = x.reshape(-1)
    total = flat.numel()
    m = C.multipath_split(total)
    outs = []
    for k, (span, steps) in enumerate(_span_channels(phase)):
        if k > 0 and m >= total:
            break
        part = flat[:m] if k == 0 else flat[m:]
        for step in steps:
            part = EMIT[step.kind](step, ctx, part, op)
        outs.append(part)
    if len(outs) == 1:
        return outs[0].reshape(shape)
    return torch.cat(outs).reshape(shape)


def lower_allreduce(program: Program, ctx, x, op: int):
    """Lower an allreduce program at the call site: the value this
    returns is what the hand-written schedule returns, exchange for
    exchange."""
    if program is None or not program.phases:
        return x
    if program.codec is not None:
        raise CommError(
            "codec-annotated programs lower through lower_q8_allreduce")
    for phase in program.phases:
        if phase.kind == "multipath":
            x = _emit_multipath(phase, ctx, x, op)
        else:
            for step in phase.steps:
                x = EMIT[step.kind](step, ctx, x, op)
    return x


def lower_value(program: Program, ctx, x, op: int = C.MPI_SUM):
    """Lower a bcast/reduce program (sequential phases only)."""
    if program is None or not program.phases:
        return x
    for phase in program.phases:
        for step in phase.steps:
            x = EMIT[step.kind](step, ctx, x, op)
    return x


def lower_q8_allreduce(program: Program, ctx, x, codec):
    """Lower a codec-rewritten allreduce program: the in-schedule
    block-q8 pipeline, channel for channel and salt for salt the
    hand-composed form (``compress/spmd._fused_allreduce_value``): f32
    staging, one :func:`_fused_channel` per channel with
    ``ring_salt(round, channel)``, the codec's error-feedback rounds,
    concatenation, the final cast."""
    if program is None or not program.phases:
        return x
    from ..compress.spmd import _fused_channel
    from ..ops import quant_kernels as _qk

    base = codec.base()
    shape, dtype = x.shape, x.dtype
    flat = x.to(torch.float32).reshape(-1)
    total = flat.numel()
    steps = program.phases[0].steps
    m = C.multipath_split(total) if len(steps) > 1 else total
    outs = []
    for k, step in enumerate(steps):
        if k > 0 and m >= total:
            break
        sigma_spec, d, chan, _reversible = step.params
        sigma = resolve_sigma(sigma_spec, ctx.size)
        part = flat[:m] if k == 0 else flat[m:]
        out, resid = _fused_channel(ctx, part, base,
                                    _qk.ring_salt(0, chan), sigma, d,
                                    track=codec.ef_rounds > 1)
        for r in range(1, codec.ef_rounds):
            last = r == codec.ef_rounds - 1
            more, resid = _fused_channel(ctx, resid, base,
                                         _qk.ring_salt(r, chan), sigma,
                                         d, track=not last)
            out = out + more
        outs.append(out)
    flat_out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return flat_out.reshape(shape).to(dtype)
