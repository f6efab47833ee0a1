"""The fused dequantize → accumulate → requantize hop of a quantized ring.

Port of ``mpi4torch_tpu/ops/quant_kernels.py``.  One hop of the block-q8
ring takes the arriving encoded partial sum (int8 blocks ``q`` with one
power-of-two f32 ``scale`` per block), adds this rank's f32 contribution
``mine``, and requantizes the sum with fresh per-block scales, optionally
returning the quantization residual ``part - q'·s'`` (what the
error-feedback codecs carry).  On a CUDA tensor it runs as the
hand-written kernel K1 (``ops/csrc/quant_hop.cu``, the counterpart of the
Pallas ``_hop_kernel``); on a CPU tensor as the plain version
:func:`_torch_hop`, which the tests hold against the JAX package.

Kernel and plain version are BITWISE equal by construction.  The scale is
a power of two (:func:`po2_scale`), so every ``q·s`` product and the
division ``part / s`` are exact, and the only rounding step is the one
round to int8 (half to even, or ``floor(v + noise)`` with the noise an
operand).  That is what lets the port's eager fold oracle
(``constants.reduce_q8_hop``) run every hop on the card and still
reproduce the JAX package's bits.

Block layout (shared with ``compress/codecs.py`` ``BlockQ8Codec``):
``q`` is ``(nblocks, block)`` int8, ``scale`` ``(nblocks,)`` f32, ``mine``
and ``noise`` ``(nblocks, block)`` f32.  Hop 0 of a ring (nothing has
arrived yet) passes ``q=None``: ``part = mine``; it is also the codec's
encode (:func:`requant_blocks`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import config as _config
from ..utils import threefry

_IMPLS = ("auto", "torch", "cuda")
_MIN_NORMAL = 2.0 ** -126


def ring_salt(round_idx: int, channel: int) -> int:
    """The salt of one quantized ring channel: round ``round_idx`` of the
    codec's error-feedback rounds, channel ``channel`` of the multipath
    schedule (0 for ``ring``; 0/1 for ``bidir``/``torus``)."""
    return round_idx * 2 + channel


def chunk_blocks(flat, n: int, block: int):
    """The chunk layout of the quantized ring: the flat f32 payload splits
    into ``n`` chunks of ``nb = ceil(ceil(total / n) / block)`` whole
    ``block``-element blocks, zero-padded at the tail, so no scale ever
    spans two chunks.  Returns ``(xcb, nb)`` with ``xcb`` shaped ``(n,
    nb, block)``."""
    total = flat.numel()
    seg = -(-max(total, 1) // n)
    nb = -(-seg // block)
    pad = n * nb * block - total
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(n, nb, block), nb


def schedule_key(salt: int, hop: int, rank: int):
    """The per-hop key of the schedule-keyed stochastic codec: a pure
    function of (salt, hop, rank), ``fold_in`` three times from
    ``PRNGKey(0)`` as in the JAX package, so both draw the same noise."""
    key = threefry.fold_in(threefry.PRNGKey(0), salt)
    key = threefry.fold_in(key, hop)
    return threefry.fold_in(key, rank)


def hop_noise(key, nblocks: int, block: int, device=None):
    """Uniform [0, 1) stochastic-rounding noise for one hop, in the block
    shape the hop consumes, made outside the kernel and passed to it as
    an operand."""
    return threefry.uniform(key, (nblocks, block), device=device)


def po2_scale(amax):
    """The block-floating-point scale: the smallest power of two ``s``
    with ``127 * s >= amax``, clamped to the smallest normal f32 for zero
    and subnormal blocks; computed from the exponent bits and one
    doubling test, never an inexact ``log2``."""
    a = amax.to(torch.float32)
    s0 = (a.view(torch.int32) & 0x7F800000).view(torch.float32)
    scale = s0 * (2.0 ** -6)
    scale = torch.where(127.0 * scale < a, scale * 2, scale)
    return torch.clamp_min(scale, _MIN_NORMAL)


def _requant(part, noise):
    """Fresh-block-scale requantization of ``part`` ((rows, block)): the
    power-of-two absmax scale, round half to even (or ``floor(v + u)``),
    clip to ±127.  ``torch.amax`` propagates NaN, so a block holding a NaN
    gets a non-finite scale."""
    amax = part.abs().amax(dim=1, keepdim=True)
    scale = po2_scale(amax)
    v = part / scale
    r = torch.round(v) if noise is None else torch.floor(v + noise)
    return r.clamp(-127, 127).to(torch.int8), scale


def _torch_hop(q, scale, mine, noise=None, want_resid: bool = False):
    """The plain version of one hop (the JAX package's ``_hop_jnp``);
    ``q=None`` is hop 0."""
    part = mine if q is None else mine + q.to(torch.float32) * scale[:, None]
    q2, scale2 = _requant(part, noise)
    resid = part - q2.to(torch.float32) * scale2 if want_resid else None
    return q2, scale2[:, 0], resid


def block_residual(x, q, scale):
    """Quantization residual of block-shaped data against its encode,
    ``x - decode(q, scale)`` (plain version; the ring's own hops get it
    from :func:`dequant_accum_requant` with ``want_resid``)."""
    return x - q.to(torch.float32) * scale[:, None]


def dequant_accum_requant(
        q, scale, mine, *, noise=None, want_resid: bool = False,
        impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """One fused quantized ring hop on block-shaped data.

    ``q``/``scale`` — the arriving encoded partial ((nblocks, block) int8
    and (nblocks,) f32), or ``None`` for hop 0; ``mine`` — this rank's
    zero-padded f32 contribution; ``noise`` — uniform [0, 1) samples for
    stochastic rounding (None: round half to even).  Returns ``(q',
    scale', resid)``, ``resid`` only with ``want_resid``.

    ``impl`` overrides :func:`config.quant_hop_impl`: ``"auto"`` launches
    the CUDA kernel for a CUDA tensor and runs the plain version for a
    CPU tensor, ``"cuda"`` demands the kernel, ``"torch"`` asks for the
    plain version on any device.  On a CUDA tensor the kernel launches or
    raises; it never falls back."""
    if impl is None:
        impl = _config.quant_hop_impl()
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {_IMPLS}")
    if impl == "auto":
        impl = "cuda" if mine.is_cuda else "torch"
    if impl == "cuda":
        if not mine.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors; got device "
                             f"{mine.device}")
        from . import _kernels

        return _kernels.quant_hop(q, scale, mine, noise, want_resid)
    return _torch_hop(q, scale, mine, noise, want_resid)


def requant_blocks(part, noise=None):
    """Encode block-shaped f32 data ((nblocks, block)) with fresh
    per-block scales: hop 0 of the fused hop, and exactly
    ``BlockQ8Codec.encode``.  Returns ``(q, scale)``."""
    q, scale, _ = dequant_accum_requant(None, None, part, noise=noise)
    return q, scale
