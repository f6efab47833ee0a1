"""Mode A: the compressed collectives over a ``run_spmd`` mesh axis.

Port of ``mpi4torch_tpu/compress/spmd.py`` on the rank threads of
:func:`~mpi4torch_tpu_torch.ops.spmd.run_spmd`.  The Allreduce is the
EQuARX pipeline: quantize, ring reduce-scatter in low precision,
all-gather of the encoded shards.  Each ring hop ships the *encoded*
partial sum through one ``_ppermute`` rendezvous (int8 blocks and their
per-block scales for the block-q8 codecs, bf16 words for the bf16
family), and every rank decodes the same gathered payload, so the result
is bitwise the same on every rank.

Each public op is one ``torch.autograd.Function`` whose backward is
itself a compressed collective: the adjoint of the compressed Allreduce
is the compressed Allreduce of the cotangents (``bidir`` with its two
chains swapped), that of the compressed Allgather a compressed
reduce-scatter on the quantized ring.

The block-q8 codecs (``q8``, ``q8_ef``, ``q8_ef_hop``) take the
in-schedule pipeline (:func:`_fused_channel`): each rank runs its own
hops on its own rank thread, every hop one fused
dequantize-accumulate-requantize pass
(``ops/quant_kernels.dequant_accum_requant``: the CUDA kernel K1 on a
card, its plain version on the CPU), over the multipath channels of
``ring``, ``bidir`` or ``torus`` and the codec's error-feedback rounds.
A channel costs each rank one requantize (its first encode) and
``n - 1`` hops.  As in the JAX package the Allreduce takes the schedule
IR: the exact program of the algorithm, rewritten so each multipath
channel is one ``q8_ring_channel`` step (``csched.q8_allreduce_program``;
the backward is its transpose), lowered by ``csched.lower_q8_allreduce``
onto :func:`_fused_channel`.  The hand-composed
:func:`_fused_allreduce_value` stays as the reference the tests and the
card smoke hold that route to, bitwise and launch for launch.  The same
schedule folded on one rank is Mode B's ``constants.reduce_q8_hop`` (and
``csched.interpret_allreduce`` of the program), so Mode A and Mode B
agree bitwise per algorithm and codec.

Stochastic codecs outside the hop schedule (``bf16r``, and ``q8_ef_hop``
as a plain encode) key every encode with :func:`_hop_key`: the salt, the
rank and the bits of the f32 sum of the encoded values.  XLA picks the
order of that sum, so the noise of these encodes is not bitwise the JAX
package's (ROADMAP.md Queue 3); their results are bitwise the same on
every rank and unbiased.
"""

from __future__ import annotations

import math

import torch

from .. import constants as C
from ..ops import quant_kernels as _qk
from ..ops.eager import _norm_axis
from ..ops.spmd import SpmdContext, _all_gather, _check_payload, _ppermute
from ..runtime import CommError
from ..utils import threefry
from .codecs import Codec

__all__ = ["allreduce", "allgather", "resolve_algorithm"]


def _hop_key(codec: Codec, ctx: SpmdContext, salt: int, data=None):
    """The key of one stochastic encode (None for a deterministic codec):
    ``fold_in(fold_in(PRNGKey(0), salt), rank)``, then, when ``data`` is
    given, folded with the bit pattern of ``data``'s f32 sum, so
    different payloads round with different noise.  The fingerprint stays
    on the device (the key is a ``(2,)`` word tensor then).  As in the
    JAX package there is no call counter: the same collective on the
    same tensor rounds with the same noise."""
    if not codec.stochastic:
        return None
    key = threefry.fold_in(threefry.PRNGKey(0), salt)
    key = threefry.fold_in(key, ctx.index)
    if data is None:
        return key
    fp = torch.sum(data.to(torch.float32)).view(torch.int32) \
        .to(torch.int64) & 0xFFFFFFFF
    w1, w2 = threefry.threefry2x32(key[0], key[1], 0, fp)
    return torch.stack([torch.as_tensor(w1, device=fp.device),
                        torch.as_tensor(w2, device=fp.device)])


def _tree_ppermute(ctx: SpmdContext, payload, ring):
    return {k: _ppermute(ctx, v, ring) for k, v in payload.items()}


def _tree_all_gather(ctx: SpmdContext, payload):
    return {k: _all_gather(ctx, v) for k, v in payload.items()}


def _tree_index(payload, r: int):
    return {k: v[r] for k, v in payload.items()}


def _ring_reduce_scatter_chunks(ctx: SpmdContext, xc, codec: Codec,
                                salt: int, track_err: bool = False):
    """Quantized ring reduce-scatter over pre-chunked ``(n, m)`` f32 data,
    row ``c`` this rank's contribution to chunk ``c``.  Returns ``(part,
    err)``: the ``(m,)`` fully reduced chunk this rank owns (chunk ``r``
    lands on rank ``r``) and, with ``track_err``, an ``(n, m)`` buffer of
    this rank's quantization residual per hop at the row of the chunk it
    encoded.  At step ``s`` rank ``r`` sends its partial of chunk ``(r - 1
    - s) mod n`` and adds its own row to the arriving partial of chunk
    ``(r - 2 - s) mod n``, accumulating in f32."""
    n, idx = ctx.size, ctx.index
    ring = tuple((i, (i + 1) % n) for i in range(n))
    err = torch.zeros_like(xc) if track_err else None
    part = xc[(idx - 1) % n]
    for s in range(n - 1):
        payload, meta = codec.encode(
            part, _hop_key(codec, ctx, salt * 1000 + s, data=part))
        if track_err:
            err[(idx - 1 - s) % n] = part - codec.decode(payload, meta)
        recv = _tree_ppermute(ctx, payload, ring)
        part = xc[(idx - 2 - s) % n] + codec.decode(recv, meta)
    return part, err


def _allreduce_round(ctx: SpmdContext, x, codec: Codec, salt: int,
                     track_err: bool = False):
    """One compressed sum-Allreduce round of the encoded ring: chunk,
    quantized ring reduce-scatter, encoded all-gather, decode and
    reassemble.  With ``track_err`` also returns this rank's residual of
    every encode it made (ring hops and the gather encode), shaped like
    ``x``: their sum over ranks is the round's first-order error, which
    an error-feedback round transfers."""
    n, idx = ctx.size, ctx.index
    shape, dtype = x.shape, x.dtype
    flat = x.to(torch.float32).reshape(-1)
    total = flat.numel()
    seg = -(-max(total, 1) // n)
    if seg * n != total:
        flat = torch.cat([flat, flat.new_zeros(seg * n - total)])
    xc = flat.reshape(n, seg)
    part, err = _ring_reduce_scatter_chunks(ctx, xc, codec, salt,
                                            track_err=track_err)
    payload, meta = codec.encode(
        part, _hop_key(codec, ctx, salt * 1000 + n, data=part))
    gathered = _tree_all_gather(ctx, payload)
    pieces = [codec.decode(_tree_index(gathered, r), meta)
              for r in range(n)]
    out = torch.cat(pieces)[:total].reshape(shape).to(dtype)
    if not track_err:
        return out
    err[idx] = err[idx] + (part - codec.decode(payload, meta))
    return out, err.reshape(-1)[:total].reshape(shape).to(dtype)


def _fused_channel(ctx: SpmdContext, flat, codec: Codec, salt: int, sigma,
                   d: int, track: bool):
    """One in-schedule quantized ring channel on flat f32 data.  The
    payload (int8 blocks and per-block f32 scales) stays encoded on the
    wire end to end, and every hop is one fused pass
    (:func:`~mpi4torch_tpu_torch.ops.quant_kernels.dequant_accum_requant`)
    with fresh block scales; the first encode is the same pass with
    nothing arriving.  ``sigma``/``d`` give the ring walk
    (:func:`constants.multipath_ring_orders`).  The last hop's requant is
    the wire encode, so the closing all-gather ships encoded chunks and
    every rank decodes the same payload.

    ``q8_ef_hop`` draws each hop's rounding noise from the schedule key
    (salt, hop, rank) and carries the hop's residual into this rank's
    next contribution; with ``track`` (``q8_ef``'s residual round) each
    residual is recorded at the row of the chunk it encoded.  Returns
    ``(reduced_flat, residual_flat or None)``; bitwise
    :func:`constants._sim_quant_ring`, the Mode B oracle."""
    n, idx = ctx.size, ctx.index
    total = flat.numel()
    block = codec.block
    xcb, nb = _qk.chunk_blocks(flat, n, block)
    sig = list(range(n)) if sigma is None else list(sigma)
    pos = sig.index(idx)
    perm = tuple((sig[p], sig[(p + d) % n]) for p in range(n))
    hop_ef = codec.hop_ef
    want = hop_ef or track

    def noise(t):
        if not codec.stochastic:
            return None
        return _qk.hop_noise(_qk.schedule_key(salt, t, idx), nb, block,
                             device=flat.device)

    err = torch.zeros_like(xcb) if track else None
    q = s = carry = None
    for t in range(n):
        if t:
            q = _ppermute(ctx, q, perm)
            s = _ppermute(ctx, s, perm)
        c = (pos - d * (t + 1)) % n
        mine = xcb[c] if carry is None else xcb[c] + carry
        q, s, res = _qk.dequant_accum_requant(q, s, mine, noise=noise(t),
                                              want_resid=want)
        if hop_ef:
            carry = res
        if track:
            err[c] = res
    gq = _all_gather(ctx, q)
    gs = _all_gather(ctx, s)
    out = torch.cat([(gq[sig[c]].to(torch.float32)
                      * gs[sig[c]][:, None]).reshape(-1)
                     for c in range(n)])[:total]
    return out, (err.reshape(-1)[:total] if track else None)


def _fused_allreduce_value(ctx: SpmdContext, x, codec: Codec,
                           algorithm: str, reverse: bool):
    """Block-q8 Allreduce on the in-schedule pipeline, composed over the
    multipath channels of ``algorithm`` (disjoint halves at
    ``constants.multipath_split``) and the codec's error-feedback rounds
    (each residual round on the channel of the values it corrects).
    ``reverse`` swaps ``bidir``'s channel directions (the backward)."""
    base = codec.base()
    n = ctx.size
    shape, dtype = x.shape, x.dtype
    flat = x.to(torch.float32).reshape(-1)
    total = flat.numel()
    inner = None
    if algorithm == "torus":
        from ..tune import resolve_hier_group

        inner = resolve_hier_group(n)
    orders = C.multipath_ring_orders(n, algorithm, inner=inner,
                                     reverse=reverse)
    m = C.multipath_split(total) if len(orders) > 1 else total
    outs = []
    for k, (sigma, d) in enumerate(orders):
        if k > 0 and m >= total:
            break
        part = flat[:m] if k == 0 else flat[m:]
        out, resid = _fused_channel(ctx, part, base, _qk.ring_salt(0, k),
                                    sigma, d, track=codec.ef_rounds > 1)
        for r in range(1, codec.ef_rounds):
            more, resid = _fused_channel(ctx, resid, base,
                                         _qk.ring_salt(r, k), sigma, d,
                                         track=r < codec.ef_rounds - 1)
            out = out + more
        outs.append(out)
    flat_out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return flat_out.reshape(shape).to(dtype)


def _allreduce_value(ctx: SpmdContext, x, codec: Codec,
                     algorithm: str = "ring", reverse: bool = False):
    if ctx.size == 1:
        return x
    base = codec.base()
    if base.hop_fused:
        from .. import csched

        prog = csched.programs.cached(
            csched.q8_allreduce_program, algorithm, ctx.size, codec.name,
            base.block, reverse=reverse)
        return csched.lower_q8_allreduce(prog, ctx, x, codec)
    if codec.ef_rounds <= 1:
        return _allreduce_round(ctx, x, base, salt=0)
    # In-call error feedback: round 1 tracks every residual this rank
    # produced; their sum over ranks is the round's first-order error,
    # which the next round transfers.
    y, resid = _allreduce_round(ctx, x, base, salt=0, track_err=True)
    for round_idx in range(1, codec.ef_rounds - 1):
        more, resid = _allreduce_round(ctx, resid, base, salt=round_idx,
                                       track_err=True)
        y = y + more
    return y + _allreduce_round(ctx, resid, base,
                                salt=codec.ef_rounds - 1)


def _reduce_scatter_value(ctx: SpmdContext, g, ax: int, codec: Codec):
    """Compressed sum-reduce-scatter along ``ax`` in equal segments, the
    adjoint of the compressed Allgather: segment ``r`` of the cross-rank
    sum reaches rank ``r`` over the quantized ring.  Error-feedback rounds
    run as in the forward: the tracked hop residuals ride a further ring,
    row for row, so each rank gets the correction of its own segment."""
    n = ctx.size
    if n == 1:
        return g
    if g.shape[ax] % n != 0:
        raise CommError(
            f"compressed reduce-scatter axis {ax} length {g.shape[ax]} "
            f"must be divisible by the communicator size {n}")
    base = codec.base()
    m = g.shape[ax] // n
    gm = torch.movedim(g, ax, 0)
    rest = tuple(gm.shape[1:])
    xc = gm.to(torch.float32).reshape(n, m * math.prod(rest))
    part, err = _ring_reduce_scatter_chunks(ctx, xc, base, salt=7,
                                            track_err=codec.ef_rounds > 1)
    for round_idx in range(1, codec.ef_rounds):
        more, err = _ring_reduce_scatter_chunks(
            ctx, err, base, salt=7 + round_idx,
            track_err=round_idx < codec.ef_rounds - 1)
        part = part + more
    seg = part.reshape((m,) + rest).to(g.dtype)
    return torch.movedim(seg, 0, ax).contiguous()


def _allgather_round(ctx: SpmdContext, x, ax: int, codec: Codec,
                     salt: int):
    payload, meta = codec.encode(x, _hop_key(codec, ctx, salt, data=x))
    gathered = _tree_all_gather(ctx, payload)
    return torch.cat([codec.decode(_tree_index(gathered, r), meta)
                      for r in range(ctx.size)], dim=ax)


def _allgather_value(ctx: SpmdContext, x, ax: int, codec: Codec):
    if ctx.size == 1:
        return x
    base = codec.base()
    out = _allgather_round(ctx, x, ax, base, salt=11)
    for round_idx in range(1, codec.ef_rounds):
        key = _hop_key(base, ctx, -100 - round_idx)
        resid = (x.to(torch.float32)
                 - base.roundtrip(x, key).to(torch.float32)).to(x.dtype)
        out = out + _allgather_round(ctx, resid, ax, base,
                                     salt=11 + round_idx)
    return out


def _bwd_scope(opname: str, codec: Codec):
    """Profiler span of a compressed adjoint
    (``mpi4torch.<Op>Backward.<codec>``)."""
    return torch.profiler.record_function(
        f"mpi4torch.{opname}Backward.{codec.name}")


def resolve_algorithm(ctx_size: int, x, codec: Codec, algorithm,
                      algorithm_explicit: bool) -> str:
    """The concrete wire algorithm of a compressed collective, by the rank
    threads' rule (:func:`.eager.resolve_algorithm`: ``None`` is the
    selector restricted to the codec's algorithms, a codec that is not
    ``hop_fused`` runs ``ring``), with the JAX package's degrade: a
    ``torus`` request the communicator cannot factor raises when
    explicit and falls back to ``ring`` otherwise."""
    from .eager import resolve_algorithm as _resolve

    try:
        return _resolve(ctx_size, x, codec, algorithm)
    except CommError:
        if algorithm_explicit:
            raise
        return "ring"


def _same(x, out):
    """An autograd output that is the input itself must be a view."""
    return x.view_as(x) if out is x else out


class _CompressedAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, codec, algo):
        fctx.sctx, fctx.codec, fctx.algo = ctx, codec, algo
        return _same(x, _allreduce_value(ctx, x, codec, algo))

    @staticmethod
    def backward(fctx, g):
        with _bwd_scope("Allreduce", fctx.codec):
            return (_allreduce_value(fctx.sctx, g.contiguous(), fctx.codec,
                                     fctx.algo, reverse=True),
                    None, None, None)


def allreduce(ctx: SpmdContext, x, op: int, codec: Codec, algorithm=None,
              algorithm_explicit: bool = False):
    """Compressed SPMD Allreduce, ``MPI_SUM`` only; the backward is the
    same compressed collective on the cotangents, on the matching
    schedule.  ``algorithm`` picks the wire among the codec's set
    (``None``: the selector)."""
    if op != C.MPI_SUM:
        raise CommError(
            f"compressed Allreduce supports MPI_SUM only; got "
            f"{C.op_name(op)} — drop compression= for non-sum reductions")
    _check_payload(ctx, x, "Allreduce")
    # The finite guard and the Mode A step event, with the codec label.
    from ..obs.trace import spmd_collective_event
    from ..resilience import guards as _guards

    x = _guards.spmd_finite_value(x, f"Allreduce[{codec.name}]")
    x = spmd_collective_event(x, f"Allreduce[{codec.name}]")
    algo = resolve_algorithm(ctx.size, x, codec, algorithm,
                             algorithm_explicit)
    return _CompressedAllreduce.apply(x, ctx, codec, algo)


class _CompressedAllgather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, codec, ax):
        fctx.sctx, fctx.codec, fctx.ax = ctx, codec, ax
        return _same(x, _allgather_value(ctx, x, ax, codec))

    @staticmethod
    def backward(fctx, g):
        with _bwd_scope("Allgather", fctx.codec):
            return (_reduce_scatter_value(fctx.sctx, g.contiguous(),
                                          fctx.ax, fctx.codec),
                    None, None, None)


def allgather(ctx: SpmdContext, x, gatheraxis: int, codec: Codec):
    """Compressed SPMD Allgather: the shard travels encoded through one
    all-gather and every rank decodes the same payload.  The adjoint is
    the compressed reduce-scatter of the cotangents on the quantized
    ring."""
    _check_payload(ctx, x, "Allgather")
    return _CompressedAllgather.apply(x, ctx, codec,
                                      _norm_axis(gatheraxis, x.dim()))
