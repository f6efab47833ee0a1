"""Wire-compression codecs.

Port of ``mpi4torch_tpu/compress/codecs.py``.  A codec is a pair of maps

    encode(x, key=None) -> (payload, meta)      # payload: dict of tensors
    decode(payload, meta) -> x_approx           # original shape and dtype

plus the flags the collectives read.  The registered codecs:

=============  =====================================  ======
name           scheme                                 rounds
=============  =====================================  ======
``q8``         per-256-block power-of-two-scaled int8  1
``q8_ef``      q8 + one in-call error-feedback round   2
``q8_ef_hop``  q8 with per-hop stochastic rounding     1
               and per-hop error feedback
``bf16``       round-to-nearest-even bfloat16          1
``bf16r``      stochastically rounded bfloat16 (keyed) 1
=============  =====================================  ======

:func:`register_codec` adds a codec under its name, and every facade op
then accepts ``compression="<name>"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..utils import threefry

Payload = Dict[str, Any]
Meta = Tuple


@dataclasses.dataclass(frozen=True)
class Codec:
    """Base codec: the flags the collectives read and the registry
    contract.

    ``ef_rounds`` > 1 marks an error-feedback codec (the residuals of the
    first round ride a second one).  ``algorithms`` are the wire
    algorithms it composes with.  ``stochastic`` codecs consume a key per
    encode; inside the quantized ring the key comes from the schedule
    (salt × hop × rank), so two runs give the same bits.  ``hop_fused``
    codecs encode block-shaped data with exactly the requantization of
    ``ops/quant_kernels.py``, so the ring may run each hop as one fused
    kernel; ``hop_ef`` folds each hop's residual into the same rank's next
    contribution.

    ``schedule_keyed`` marks stochastic codecs whose noise is a pure
    function of the collective schedule (salt × hop × rank), so the
    quantized fold oracle reproduces it bit for bit.  ``bf16r`` is not
    schedule-keyed: the rank-thread collectives fold a per-rank call
    counter into its key, so repeated calls round with fresh noise."""

    name: str
    stochastic: bool = False
    ef_rounds: int = 1
    algorithms: Tuple[str, ...] = ("ring",)
    schedule_keyed: bool = False
    hop_fused: bool = False
    hop_ef: bool = False

    def base(self) -> "Codec":
        """The single-round codec used for each error-feedback round."""
        return self

    def encode(self, x, key=None) -> Tuple[Payload, Meta]:
        raise NotImplementedError

    def decode(self, payload: Payload, meta: Meta):
        raise NotImplementedError

    def roundtrip(self, x, key=None):
        """decode(encode(x)): the local lossy approximation."""
        payload, meta = self.encode(x, key)
        return self.decode(payload, meta)

    def wire_bytes(self, shape, dtype) -> int:
        """Bytes a tensor of ``shape`` and ``dtype`` occupies on the wire
        once encoded: the sizes of the payload's tensors, taken from the
        codec's own encode run on the ``meta`` device (shapes and dtypes,
        no data), so the number cannot drift from the implementation."""
        x = torch.zeros(shape, dtype=dtype, device="meta")
        payload, _ = self.encode(
            x, threefry.PRNGKey(0) if self.stochastic else None)
        return int(sum(t.numel() * t.element_size()
                       for t in payload.values()))


@dataclasses.dataclass(frozen=True)
class BlockQ8Codec(Codec):
    """Block-scaled int8: each ``block``-element block of the flattened
    tensor is scaled by a power of two (``ops/quant_kernels.po2_scale``:
    the smallest ``2^k`` with ``127·2^k >= absmax``) and rounded to int8.
    The scale makes the arithmetic exact except for the one rounding, so
    the quantized ring is bitwise reproducible; the error per element is
    at most half a step, at most one int8 step of the block's absmax."""

    name: str = "q8"
    algorithms: Tuple[str, ...] = ("ring", "bidir", "torus")
    hop_fused: bool = True
    block: int = 256

    def _blocks(self, x):
        """Flatten and zero-pad ``x`` to (nblocks, block) f32."""
        flat = x.to(torch.float32).reshape(-1)
        nb = -(-max(flat.numel(), 1) // self.block)
        pad = nb * self.block - flat.numel()
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat.reshape(nb, self.block)

    def _encode_blocks(self, x, noise_key):
        from ..ops.quant_kernels import hop_noise, requant_blocks

        blocks = self._blocks(x)
        noise = None if noise_key is None else hop_noise(
            noise_key, blocks.shape[0], self.block, device=blocks.device)
        q, scale = requant_blocks(blocks, noise)
        return {"q": q, "scale": scale}, ("q8", tuple(x.shape), x.dtype)

    def encode(self, x, key=None):
        return self._encode_blocks(x, None)

    def decode(self, payload, meta):
        _, shape, dtype = meta
        blocks = payload["q"].to(torch.float32) \
            * payload["scale"][:, None].to(torch.float32)
        total = math.prod(shape)
        return blocks.reshape(-1)[:total].reshape(shape).to(dtype)


@dataclasses.dataclass(frozen=True)
class HopEFQ8Codec(BlockQ8Codec):
    """``q8`` with per-hop stochastic rounding (``floor(v + u)``, ``u``
    from the schedule key) and per-hop error feedback, at single-round
    wire cost.  Outside a ring (the standalone ``encode``) it is
    stochastically rounded q8, keyed by ``key`` (``PRNGKey(0)`` when
    None)."""

    name: str = "q8_ef_hop"
    stochastic: bool = True
    schedule_keyed: bool = True
    hop_ef: bool = True

    def encode(self, x, key=None):
        return self._encode_blocks(
            x, threefry.PRNGKey(0) if key is None else key)


@dataclasses.dataclass(frozen=True)
class BF16Codec(Codec):
    """Round-to-nearest-even bfloat16: half the f32 wire bytes, relative
    error at most 2^-8 (half an ulp of 8 significant bits); deterministic
    and key-free."""

    name: str = "bf16"

    def encode(self, x, key=None):
        q = x.to(torch.float32).to(torch.bfloat16).reshape(-1)
        return {"q": q}, ("bf16", tuple(x.shape), x.dtype)

    def decode(self, payload, meta):
        _, shape, dtype = meta
        return payload["q"].to(torch.float32).reshape(shape).to(dtype)


@dataclasses.dataclass(frozen=True)
class BF16StochasticCodec(Codec):
    """Stochastically rounded bfloat16: 16 uniform random bits are added
    to the f32 bit pattern (wrapping in 32 bits) before its high 16 bits
    are kept, so rounding is unbiased (``E[decode(encode(x))] = x``).  The
    bits are ``jax.random.bits(key, n, uint32) & 0xFFFF``
    (:func:`~mpi4torch_tpu_torch.utils.threefry.random_bits`), so the
    encode is bitwise the JAX package's for the same key.  The words are
    carried in int64, masked to 32 bits: torch has no uint32 arithmetic
    on every device."""

    name: str = "bf16r"
    stochastic: bool = True

    def encode(self, x, key=None):
        if key is None:
            key = threefry.PRNGKey(0)
        x32 = x.to(torch.float32).reshape(-1)
        bits = x32.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        noise = threefry.random_bits(key, 32, x32.shape,
                                     device=x32.device) & 0xFFFF
        hi = ((bits + noise) & 0xFFFFFFFF) >> 16
        # The 16-bit pattern as a signed int16, then read as bfloat16.
        hi = hi - ((hi >> 15) << 16)
        q = hi.to(torch.int16).view(torch.bfloat16)
        return {"q": q}, ("bf16r", tuple(x.shape), x.dtype)

    def decode(self, payload, meta):
        _, shape, dtype = meta
        return payload["q"].to(torch.float32).reshape(shape).to(dtype)


@dataclasses.dataclass(frozen=True)
class ErrorFeedbackCodec(Codec):
    """A base codec run with one in-call error-feedback round: the
    collective transfers ``base(x)`` and then the residuals of that
    round, and sums both."""

    name: str = "q8_ef"
    ef_rounds: int = 2
    algorithms: Tuple[str, ...] = ("ring", "bidir", "torus")
    _base: Codec = dataclasses.field(default_factory=BlockQ8Codec)

    def base(self) -> Codec:
        return self._base

    def encode(self, x, key=None):
        return self._base.encode(x, key)

    def decode(self, payload, meta):
        return self._base.decode(payload, meta)


    def wire_bytes(self, shape, dtype) -> int:
        return self.ef_rounds * self._base.wire_bytes(shape, dtype)


_REGISTRY: Dict[str, Codec] = {}


def register_codec(codec: Codec) -> Codec:
    """Register ``codec`` under ``codec.name``; returns it."""
    if not codec.name:
        raise ValueError("codec must have a non-empty name")
    _REGISTRY[codec.name] = codec
    return codec


def available_codecs() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_codec(spec) -> Optional[Codec]:
    """Resolve a ``compression=`` argument: ``None``/``False``/``"none"``/
    ``"off"`` mean none, a string looks up the registry, a :class:`Codec`
    passes through; anything else raises."""
    if spec is None or spec is False:
        return None
    if isinstance(spec, str):
        if spec in ("none", "off"):
            return None
        codec = _REGISTRY.get(spec)
        if codec is not None:
            return codec
        raise ValueError(
            f"unknown compression codec {spec!r}; available: "
            f"{', '.join(available_codecs())}")
    if isinstance(spec, Codec):
        return spec
    raise TypeError(
        f"compression must be a registered codec name, a Codec subclass "
        f"instance, or None; got {spec!r}")


for _codec in (BlockQ8Codec(), HopEFQ8Codec(), BF16Codec(),
               BF16StochasticCodec(), ErrorFeedbackCodec()):
    register_codec(_codec)
