"""Compressed collectives: the block-scaled quantized wire.

Port of ``mpi4torch_tpu/compress``: the codec registry
(:mod:`.codecs`), the compressed eager Allreduce (:mod:`.eager`) and
cross-step error feedback for training loops (:mod:`.ef`).  Pick a codec
per call, per scope, or process-wide::

    y = comm.Allreduce(g, MPI_SUM, compression="q8")

    with config.compression_scope("q8_ef"):
        y = comm.Allreduce(g, MPI_SUM)

The block-q8 codecs (``q8``, ``q8_ef``, ``q8_ef_hop``) ride ``ring``,
``bidir`` and ``torus``; the backward of a compressed Allreduce is itself
a compressed Allreduce.
"""

from __future__ import annotations

from ..config import (compression_scope, default_compression,
                      set_default_compression)
from .codecs import (BlockQ8Codec, Codec, ErrorFeedbackCodec, HopEFQ8Codec,
                     available_codecs, get_codec)
from .ef import ef_allreduce, ef_init


def codec_rides_algorithm(codec, algorithm) -> bool:
    """True when ``codec`` may ride wire algorithm ``algorithm``: the
    codec declares it (``Codec.algorithms``)."""
    return codec is not None and algorithm in codec.algorithms


def codec_applicable(codec, dtype) -> bool:
    """True when ``codec`` may touch a tensor of ``dtype``.  Only floating
    tensors are compressible: quantizing counts or masks would truncate
    them."""
    return codec is not None and dtype.is_floating_point


__all__ = [
    "codec_applicable", "codec_rides_algorithm", "HopEFQ8Codec", "Codec",
    "BlockQ8Codec", "ErrorFeedbackCodec", "available_codecs", "get_codec",
    "compression_scope", "default_compression",
    "set_default_compression", "ef_init", "ef_allreduce",
]
