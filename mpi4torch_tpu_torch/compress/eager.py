"""The compressed Allreduce on the rank-thread runtime.

Port of the block-q8 part of ``mpi4torch_tpu/compress/eager.py`` (the
JAX package's Mode B).  The ranks exchange their raw contributions and
rank 0 folds them once with the quantized fold oracle
:func:`~mpi4torch_tpu_torch.constants.reduce_q8_hop` — every rank's ring
hops, replayed over the multipath channels of the algorithm and the
codec's error-feedback rounds — and a second rendezvous shares the
result; ranks other than 0 take a private copy, as the exact Allreduce
does.  The adjoint is the same oracle on the cotangents, with ``bidir``'s
channel directions swapped.

One deviation from the JAX package, by design: there the oracle runs
every hop through the plain jnp version, and the Pallas kernel K1 serves
only the compiled backend.  Here every hop goes through
``ops/quant_kernels.dequant_accum_requant``, so on a card the hops run on
the CUDA kernel K1.  The kernel and the plain version are bitwise equal
(power-of-two scales make every product and division exact), so the
results keep the JAX package's bits.
"""

from __future__ import annotations

import torch

from .. import config as _config
from .. import constants as C
from ..runtime import CommError, RankContext
from .codecs import Codec


def resolve_algorithm(nranks: int, x, codec: Codec, algorithm) -> str:
    """The concrete wire algorithm of a compressed Allreduce (the JAX
    package's ``compress/spmd.py`` ``resolve_algorithm``, which its eager
    path calls too): ``None`` is codec-aware auto selection; a named
    request arrives reconciled by the facade.  ``torus`` validates the
    2-level group rule against this world and raises when it has none."""
    from .. import tune

    if algorithm is None:
        return tune.select_auto(
            nbytes=x.numel() * x.element_size(), nranks=nranks,
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
    red = world.exchange(rank, sig, x, read=fold)
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


def allreduce(ctx: RankContext, x, op: int, codec: Codec, algorithm=None):
    """Compressed, differentiable Allreduce over ``ctx``'s world:
    ``MPI_SUM`` only; the backward is the same compressed Allreduce of the
    gradient.  Every rank gets the same bits."""
    if op != C.MPI_SUM:
        raise CommError(
            f"compressed Allreduce supports MPI_SUM only; got "
            f"{C.op_name(op)} — drop compression= for non-sum reductions")
    if not codec.base().hop_fused:
        raise NotImplementedError(
            f"compression={codec.name!r}: only the block-q8 codecs (q8, "
            "q8_ef, q8_ef_hop) are ported; the others come with ROADMAP.md "
            "Queue 1 item 1")
    algo = resolve_algorithm(ctx.world.size, x, codec, algorithm)
    return _HopOracleAllreduce.apply(x, ctx, codec, algo)
