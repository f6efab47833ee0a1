"""The compressed Allreduce and Allgather on the rank-thread runtime.

Port of ``mpi4torch_tpu/compress/eager.py`` (the JAX package's Mode B).

The block-q8 codecs' Allreduce: the ranks exchange their raw
contributions and rank 0 folds them once with the quantized fold oracle
:func:`~mpi4torch_tpu_torch.constants.reduce_q8_hop` — every rank's ring
hops, replayed over the multipath channels of the algorithm and the
codec's error-feedback rounds — and a second rendezvous shares the
result; ranks other than 0 take a private copy, as the exact Allreduce
does.  The adjoint is the same oracle on the cotangents, with ``bidir``'s
channel directions swapped.

Every other codec (the bf16 family) runs at the rendezvous: each rank
encodes its tensor, the ranks exchange ``(meta, payload)``, and the
decoded contributions fold in ascending rank order, once on rank 0 and
shared at or above ``_FOLD_ONCE_MIN`` elements.  The compressed
Allgather ships encoded shards the same way; its adjoint is a compressed
reduce-scatter.  Stochastic codecs (``bf16r``, and ``q8_ef_hop`` outside
the ring) key every encode with :func:`_rank_key`, a per-(world, rank)
call counter, so repeated calls round with fresh noise and the noise is
bitwise the JAX package's when the calls come in the same order.

One deviation from the JAX package, by design: there the oracle runs
every hop through the plain jnp version, and the Pallas kernel K1 serves
only the compiled backend.  Here every hop, and every block-q8 encode of
the Allgather, goes through ``ops/quant_kernels.dequant_accum_requant``,
so on a card they run on the CUDA kernel K1.  The kernel and the plain
version are bitwise equal (power-of-two scales make every product and
division exact), so the results keep the JAX package's bits.

Both integrity guards of ``resilience.guards`` ride these wires, off by
default as in the JAX package.  ``config.comm_wire_checksum`` adds a
CRC32 of each encoded ``(meta, payload)`` to the rendezvous item
(:func:`_wire_exchange`): the sender computes it once, and the item as
deposited, after fault injection, is verified once, so a flipped bit or
a corrupt scale raises an ``IntegrityError`` naming its contributor on
every rank.  ``config.comm_finite_guard`` checks each rank's raw
contribution to the hop oracle and each decoded contribution of the
rendezvous codecs and of the compressed Allgather.
"""

from __future__ import annotations

import torch

from .. import config as _config
from .. import constants as C
from ..ops.eager import _FOLD_ONCE_MIN, _check_payload, _norm_axis, \
    _own, _shape_sig
from ..resilience import guards as _guards
from ..runtime import CommError, RankContext
from ..utils import threefry
from .codecs import Codec


def _wire_exchange(world, rank: int, sig, meta, payload, opname: str,
                   read, decode=None):
    """Ship an encoded ``(meta, payload)`` through the rendezvous and
    return ``read`` of the rank-ordered ``(meta, payload)`` list.

    With ``config.comm_wire_checksum`` on, the item also carries the
    CRC32 of its wire bytes (the signature gains ``"crc"``), and each
    rank's item is verified as deposited: a mismatch raises
    ``IntegrityError`` naming the corrupt contributor(s) on every rank.
    With ``decode`` given and the finite guard on, each rank's decoded
    contribution is checked as well.  Off, the item and the signature
    are the unguarded wire's."""
    checks = ()
    item = (meta, payload)
    if _config.comm_wire_checksum():
        item = (meta, payload, _guards.wire_checksum((meta, payload)))
        sig = sig + ("crc",)
        checks = _guards.wire_check(opname)
        plain_read = read

        def read(vals):
            return plain_read([v[:2] for v in vals])
    if decode is not None:
        checks += _guards.finite_check(
            opname, decode=lambda it: decode(it[1], it[0]))
    return world.exchange(rank, sig, item, read=read, checks=checks)


def _rank_key(codec: Codec, ctx: RankContext, salt: int):
    """The key of one stochastic encode (None for a deterministic codec):
    ``fold_in(fold_in(fold_in(PRNGKey(0), salt), rank), n)`` with ``n``
    this rank's count of earlier keyed encodes in this world."""
    if not codec.stochastic:
        return None
    # Each rank touches only its own slot of the counter.
    seq = ctx.world.__dict__.setdefault("_compress_call_seq", {})
    n = seq.get(ctx.rank, 0)
    seq[ctx.rank] = n + 1
    key = threefry.fold_in(threefry.PRNGKey(0), salt)
    key = threefry.fold_in(key, ctx.rank)
    return threefry.fold_in(key, n)


def resolve_algorithm(nranks: int, x, codec: Codec, algorithm) -> str:
    """The concrete wire algorithm of a compressed Allreduce (the JAX
    package's ``compress/spmd.py`` ``resolve_algorithm``, which its eager
    path calls too): ``None`` is codec-aware auto selection; a named
    request arrives reconciled by the facade.  ``torus`` validates the
    2-level group rule against this world and raises when it has none.
    A codec that is not ``hop_fused`` (the bf16 family) runs the encoded
    ring: ``ring``."""
    from .. import tune

    if not codec.base().hop_fused:
        return "ring"
    if algorithm is None:
        return tune.select_auto(
            collective="allreduce", nbytes=x.numel() * x.element_size(),
            dtype=x.dtype, nranks=nranks,
            deterministic=_config.deterministic_reductions(), codec=codec)
    if algorithm == "torus" and nranks > 1:
        tune.resolve_hier_group(nranks)
    return algorithm


def _hop_oracle_value(ctx: RankContext, x, codec: Codec, algo: str,
                      reverse: bool):
    world, rank = ctx.world, ctx.rank
    if world.device is not None and x.device != world.device:
        raise CommError(
            f"Allreduce payload is on {x.device} but this rank world runs "
            f"on {world.device}")
    if world.size == 1:
        return x
    base = codec.base()
    sig = ("Allreduce.q8hop", codec.name, algo, bool(reverse),
           (tuple(x.shape), str(x.dtype)))
    inner = None
    if algo == "torus":
        from ..tune import resolve_hier_group

        inner = resolve_hier_group(world.size)

    def fold(vals):
        if rank != 0:
            return None
        return C.reduce_q8_hop(
            vals, block=base.block, algorithm=algo, inner=inner,
            reverse=reverse, stochastic=base.stochastic, hop_ef=base.hop_ef,
            ef_rounds=codec.ef_rounds)

    # Rank 0 folds and the others copy its result inside the rendezvous,
    # before any owner can modify its payload in place.
    red = world.exchange(rank, sig, x, read=fold,
                         checks=_guards.finite_check(
                             f"Allreduce[{codec.name}]"))
    return world.exchange(rank, sig + ("fold",), red,
                          read=lambda vals: vals[0] if rank == 0
                          else vals[0].clone())


class _HopOracleAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, rctx, codec, algo):
        fctx.rctx, fctx.codec, fctx.algo = rctx, codec, algo
        return _hop_oracle_value(rctx, x, codec, algo, reverse=False)

    @staticmethod
    def backward(fctx, g):
        return _hop_oracle_value(fctx.rctx, g.contiguous(), fctx.codec,
                                 fctx.algo, reverse=fctx.algo == "bidir"), \
            None, None, None


def _rendezvous_round(ctx: RankContext, v, codec: Codec, salt: int):
    """One round of the rendezvous-codec Allreduce: ``(sum of every
    rank's decoded payload in ascending rank order, this rank's own
    roundtrip)``."""
    world, rank = ctx.world, ctx.rank
    base = codec.base()
    payload, meta = base.encode(v, _rank_key(base, ctx, salt))
    own = base.decode(payload, meta)
    sig = ("Allreduce.c", codec.name, salt, _shape_sig(v))

    opname = f"Allreduce[{codec.name}]"

    def fold(vals):
        return C.reduce_ordered(C.MPI_SUM,
                                [base.decode(p, m) for (m, p) in vals])

    if v.numel() >= _FOLD_ONCE_MIN:
        # Rank 0 decodes and folds once; the others take a copy.
        red = _wire_exchange(world, rank, sig, meta, payload, opname,
                             lambda vals: fold(vals) if rank == 0
                             else None, decode=base.decode)
        out = world.exchange(rank, ("Allreduce.c.fold", codec.name, salt,
                                    _shape_sig(v)), red,
                             read=lambda vals: _own(vals[0], rank, 0))
        return out, own
    return _wire_exchange(world, rank, sig, meta, payload, opname, fold,
                          decode=base.decode), own


def _rendezvous_value(ctx: RankContext, v, codec: Codec):
    if ctx.world.size == 1:
        return v
    out, own = _rendezvous_round(ctx, v, codec, 0)
    for round_idx in range(1, codec.ef_rounds):
        # In-call error feedback: the residual of what this rank has put
        # on the wire so far rides the next round.
        more, own_r = _rendezvous_round(ctx, v - own, codec, round_idx)
        out = out + more
        own = own + own_r
    return out


class _RendezvousAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, rctx, codec):
        fctx.rctx, fctx.codec = rctx, codec
        return _rendezvous_value(rctx, x, codec)

    @staticmethod
    def backward(fctx, g):
        return _rendezvous_value(fctx.rctx, g.contiguous(), fctx.codec), \
            None, None


def allreduce(ctx: RankContext, x, op: int, codec: Codec, algorithm=None,
              algorithm_explicit: bool = False):
    """Compressed, differentiable Allreduce over ``ctx``'s world:
    ``MPI_SUM`` only; the backward is the same compressed Allreduce of the
    gradient.  Every rank gets the same bits.  The block-q8 codecs take
    the quantized fold oracle on ``algorithm``'s channels; the others
    fold the decoded payloads at the rendezvous.  A ``torus`` this world
    cannot factor raises when ``algorithm_explicit`` and takes ``ring``
    otherwise."""
    if op != C.MPI_SUM:
        raise CommError(
            f"compressed Allreduce supports MPI_SUM only; got "
            f"{C.op_name(op)} — drop compression= for non-sum reductions")
    try:
        algo = resolve_algorithm(ctx.world.size, x, codec, algorithm)
    except CommError:
        if algorithm_explicit:
            raise
        algo = "ring"
    if codec.base().hop_fused:
        return _HopOracleAllreduce.apply(x, ctx, codec, algo)
    ctx.world.check_not_consumed(ctx.rank, x)
    _check_payload(ctx, x, "Allreduce")
    return _RendezvousAllreduce.apply(x, ctx, codec)


def _gather_round(ctx: RankContext, v, codec: Codec, ax: int, salt: int):
    """One round of the compressed Allgather: every rank's decoded
    shard, in rank order."""
    base = codec.base()
    payload, meta = base.encode(v, _rank_key(base, ctx, salt))
    othershape = tuple(s for i, s in enumerate(v.shape) if i != ax)
    sig = ("Allgather.c", codec.name, salt, ax, othershape, str(v.dtype))
    return _wire_exchange(
        ctx.world, ctx.rank, sig, meta, payload, f"Allgather[{codec.name}]",
        lambda vals: [base.decode(p, m) for (m, p) in vals],
        decode=base.decode)


def _scatter_round(ctx: RankContext, g, codec: Codec, ax: int, counts,
                   salt: int):
    """One round of the compressed reduce-scatter (the Allgather's
    adjoint): ``(this rank's segment of every rank's decoded cotangent,
    summed in ascending rank order; this rank's own roundtrip)``."""
    world, rank = ctx.world, ctx.rank
    base = codec.base()
    payload, meta = base.encode(g, _rank_key(base, ctx, salt))
    offset = sum(counts[:rank])
    sig = ("Allgather.c.bwd", codec.name, salt, ax, _shape_sig(g))
    seg = _wire_exchange(
        world, rank, sig, meta, payload, f"Allgather.bwd[{codec.name}]",
        lambda vals: C.reduce_ordered(C.MPI_SUM, [
            base.decode(p, m).narrow(ax, offset, counts[rank])
            for (m, p) in vals]))
    return seg, base.decode(payload, meta)


class _CompressedAllgather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, rctx, codec, ax):
        fctx.rctx, fctx.codec, fctx.ax = rctx, codec, ax
        decoded = _gather_round(rctx, x, codec, ax, 0)
        out = torch.cat(decoded, dim=ax)
        fctx.counts = tuple(d.shape[ax] for d in decoded)
        for round_idx in range(1, codec.ef_rounds):
            more = _gather_round(rctx, x - decoded[rctx.rank], codec, ax,
                                 round_idx)
            out = out + torch.cat(more, dim=ax)
            decoded = [d + d2 for d, d2 in zip(decoded, more)]
        return out

    @staticmethod
    def backward(fctx, g):
        rctx, codec, ax, counts = fctx.rctx, fctx.codec, fctx.ax, \
            fctx.counts
        g = g.contiguous()
        # The backward's salts are 100 + round, apart from the forward's.
        seg, own = _scatter_round(rctx, g, codec, ax, counts, 100)
        for round_idx in range(1, codec.ef_rounds):
            more, own_r = _scatter_round(rctx, g - own, codec, ax, counts,
                                         100 + round_idx)
            seg = seg + more
            own = own + own_r
        return seg, None, None, None


def allgather(ctx: RankContext, x, gatheraxis: int, codec: Codec):
    """Compressed, differentiable Allgather along ``gatheraxis``: each
    rank's shard travels encoded and every rank decodes the full list, so
    every rank gets the same bits; per-rank axis lengths may differ.  The
    adjoint is a compressed reduce-scatter: every rank's cotangent
    travels encoded and each rank sums its own segment of the decoded
    cotangents in ascending rank order.  The codec's error-feedback
    rounds run both ways.  A one-rank world returns ``x``."""
    world = ctx.world
    world.check_not_consumed(ctx.rank, x)
    _check_payload(ctx, x, "Allgather")
    if world.size == 1:
        return x
    return _CompressedAllgather.apply(x, ctx, codec,
                                      _norm_axis(gatheraxis, x.dim()))
