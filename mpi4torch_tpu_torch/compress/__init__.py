"""Compressed collectives: the block-scaled quantized and bf16 wires.

Port of ``mpi4torch_tpu/compress``: the codec registry
(:mod:`.codecs`), the compressed Allreduce and Allgather on the rank
threads (:mod:`.eager`, Mode B) and under ``run_spmd`` (:mod:`.spmd`,
Mode A), and cross-step error feedback for training loops (:mod:`.ef`).  Pick a codec per call, per scope, or process-wide::

    y = comm.Allreduce(g, MPI_SUM, compression="q8")
    full = comm.Allgather(shard, 0, compression="bf16")

    with config.compression_scope("q8_ef"):
        y = comm.Allreduce(g, MPI_SUM)

The block-q8 codecs (``q8``, ``q8_ef``, ``q8_ef_hop``) ride ``ring``,
``bidir`` and ``torus``; the bf16 codecs (``bf16``, ``bf16r``) ride
``ring`` only.  The backward of a compressed Allreduce is itself a
compressed Allreduce, and that of a compressed Allgather a compressed
reduce-scatter.
"""

from __future__ import annotations

from ..config import (compression_scope, default_compression,
                      set_default_compression)
from .codecs import (BF16Codec, BF16StochasticCodec, BlockQ8Codec, Codec,
                     ErrorFeedbackCodec, HopEFQ8Codec, available_codecs,
                     get_codec, register_codec)
from .ef import ef_allreduce, ef_init


def codec_rides_algorithm(codec, algorithm) -> bool:
    """True when ``codec`` may ride wire algorithm ``algorithm``: the
    codec declares it (``Codec.algorithms``) and the registry marks the
    algorithm ``codec_capable``.  Both sides are read at each call, so
    registering a codec or an algorithm changes what composes without
    touching this rule."""
    if codec is None:
        return False
    from ..tune import codec_algorithms, get_algorithm

    if algorithm not in codec_algorithms(codec):
        return False
    return get_algorithm(algorithm).codec_capable


def codec_applicable(codec, dtype, algorithm=None) -> bool:
    """True when ``codec`` may touch a tensor of ``dtype`` and, when
    ``algorithm`` is given, ride that wire algorithm
    (:func:`codec_rides_algorithm`).  Only floating tensors are
    compressible: quantizing counts or masks would truncate them."""
    if codec is None or not dtype.is_floating_point:
        return False
    if algorithm is not None:
        return codec_rides_algorithm(codec, algorithm)
    return True


def int8_rotation_census(lowered, nranks):
    """Both-rotations census of a recorded q8 dual-ring program
    (``analyze.lower``): returns ``(seen, fwd, bwd)``, where ``seen`` is
    the set of ``source_target_pairs`` tables of the int8
    ``collective_permute`` ops and ``fwd``/``bwd`` are the forward and
    backward full-ring tables for ``nranks``, each written as the JAX
    package writes them (``[[0,1],[1,2],...]``, no spaces), so ``fwd in
    seen and bwd in seen`` is the census criterion."""
    from ..analyze.parse import parse_program

    def table(pairs):
        return str([list(p) for p in pairs]).replace(" ", "")

    seen = {table(op.source_target_pairs)
            for op in parse_program(lowered).ops("collective_permute",
                                                 dtype="i8")}
    fwd = table((i, (i + 1) % nranks) for i in range(nranks))
    bwd = table((i, (i - 1) % nranks) for i in range(nranks))
    return seen, fwd, bwd


__all__ = [
    "codec_applicable", "codec_rides_algorithm", "int8_rotation_census",
    "HopEFQ8Codec", "Codec",
    "BlockQ8Codec", "BF16Codec", "BF16StochasticCodec", "ErrorFeedbackCodec",
    "available_codecs", "get_codec", "register_codec",
    "compression_scope", "default_compression",
    "set_default_compression", "ef_init", "ef_allreduce",
]
