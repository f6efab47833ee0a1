"""Threefry-2x32 random bits, bit-exact with ``jax.random``.

The JAX package draws random numbers from ``jax.random`` keys in two
places the port reproduces: the stochastic-rounding noise of the
``q8_ef_hop`` codec (``ops/quant_kernels.schedule_key`` and
``hop_noise``), and sampled decoding (``models/transformer.select_token``
and the serving engine's per-request key discipline).  This module is a
plain-PyTorch threefry-2x32 (Salmon et al., SC'11, 20 rounds) matching
``jax.random`` under ``jax_threefry_partitionable=True`` (the default
since jax 0.5):

* :func:`PRNGKey` — a key is a pair of 32-bit words, ``PRNGKey(s)`` is
  ``(s >> 32, s & 0xFFFFFFFF)``;
* :func:`fold_in` — the hash of the counter pair ``(0, d)`` under the key;
* :func:`split` — new key ``i`` of ``num`` is the hash of the counter pair
  ``(0, i)``: both output words;
* :func:`random_bits` — each flat index ``i`` of the shape hashes the
  counters ``(i >> 32, i & 0xFFFFFFFF)``; 32 bits are the two output
  words XOR-ed, 8 or 16 bits that XOR's low bits, 64 bits the two words
  side by side;
* :func:`uniform` — the dtype's mantissa bits of :func:`random_bits`
  under the exponent of 1.0, minus 1, scaled to ``[minval, maxval)``.
  A type with fewer than 8 mantissa bits (bfloat16) draws 8-bit words,
  as ``jax.random`` does;
* :func:`gumbel` and :func:`categorical` — ``jax.random``'s default
  ("low") mode: ``-log(-log(uniform(tiny, 1)))`` and the Gumbel-max
  ``argmax(gumbel + logits)`` (:func:`gumbel_scores` is the sum).

Words are carried in int64 tensors masked to 32 bits, because arithmetic
on ``torch.uint32`` is not supported alike on every device.  The same
code runs on the CPU and on the card and gives the same bits on both.

A key is two Python ints, or an int64 tensor whose last axis holds the
two words: a ``(rows, 2)`` tensor draws one table of ``rows`` rows, each
row bitwise the draw of its own key (the serving engine samples every
slot in one call this way).  The device of a draw is the key tensor's, or
``device`` resolved by :func:`~mpi4torch_tpu_torch.runtime.resolve_device`
(CUDA unless the caller names another device).
"""

from __future__ import annotations

import torch

from ..runtime import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# dtype -> (bits of the type, mantissa bits, the bits of 1.0).
_FLOAT_BITS = {
    torch.float16: (16, 10, 0x3C00),
    torch.bfloat16: (16, 7, 0x3F80),
    torch.float32: (32, 23, 0x3F800000),
    torch.float64: (64, 52, 0x3FF0000000000000),
}
_INT_VIEW = {16: torch.int16, 32: torch.int32, 64: torch.int64}


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash of the counter pairs ``(x1, x2)`` under the
    key ``(k1, k2)``; keys and counters are Python ints or int64 tensors
    of 32-bit words (broadcast against each other), and so are the two
    returned words."""
    ks = (k1 & _MASK, k2 & _MASK, (k1 ^ k2 ^ _PARITY) & _MASK)
    x1, x2 = (x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def as_key(key):
    """A key as two Python ints: from a pair of ints or any two-element
    array of 32-bit words (a ``jax.random.PRNGKey`` read with numpy)."""
    k1, k2 = (int(w) for w in key)
    return (k1 & _MASK, k2 & _MASK)


def PRNGKey(seed: int):
    """The key ``jax.random.PRNGKey(seed)`` holds, as two Python ints."""
    seed = int(seed)
    return ((seed >> 32) & _MASK, seed & _MASK)


def fold_in(key, data: int):
    """``jax.random.fold_in(key, data)`` for a non-negative 32-bit
    ``data``."""
    return threefry2x32(key[0], key[1], 0, int(data) & _MASK)


def split(key, num: int = 2):
    """``jax.random.split(key, num)``: ``num`` new keys, each two Python
    ints.  A host computation (one hash per new key), so splitting a
    request's key costs no device work."""
    k1, k2 = as_key(key)
    return [threefry2x32(k1, k2, 0, i) for i in range(int(num))]


def _key_words(key, ndim: int, device):
    """The two key words, broadcastable over ``ndim`` trailing axes, and
    the device of the draw."""
    if isinstance(key, torch.Tensor):
        k = key.to(torch.int64)
        pad = (1,) * ndim
        return (k[..., 0].reshape(k.shape[:-1] + pad),
                k[..., 1].reshape(k.shape[:-1] + pad), key.device)
    k1, k2 = as_key(key)
    return k1, k2, resolve_device(device)


def _words(key, shape, device):
    """The two threefry output words for every flat index of ``shape``
    (leading key-batch axes first when ``key`` is a tensor)."""
    shape = tuple(int(s) for s in shape)
    k1, k2, dev = _key_words(key, len(shape), device)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=dev).reshape(shape)
    return threefry2x32(k1, k2, idx >> 32, idx & _MASK)


def random_bits(key, bit_width: int, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint<bit_width>)``: the random words
    as an int64 tensor of non-negative values below ``2 ** bit_width``
    for 8, 16 and 32 bits; 64 bits come back as int64 holding the unsigned
    word's bit pattern.  A ``(..., 2)`` key tensor prepends its batch
    axes to ``shape``."""
    b1, b2 = _words(key, shape, device)
    if bit_width == 32:
        return b1 ^ b2
    if bit_width in (8, 16):
        return (b1 ^ b2) & ((1 << bit_width) - 1)
    if bit_width == 64:
        return (b1 << 32) | b2
    raise ValueError(f"bit_width must be 8, 16, 32 or 64, got {bit_width}")


def uniform(key, shape, dtype=torch.float32, minval=0.0, maxval=1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` for
    float16, bfloat16, float32 and float64: the dtype's mantissa bits of
    :func:`random_bits` under the exponent of 1.0, minus 1, times
    ``maxval - minval`` plus ``minval`` (one fused multiply-add; in
    bfloat16 two rounded ops), then at least ``minval``.  Bitwise equal
    to JAX's for every dtype and range but float64 with a range other than ``[0, 1)`` or ``[tiny,
    1)``, where the product is inexact and torch has no fused
    multiply-add: there it may differ by one ulp of the range."""
    if dtype not in _FLOAT_BITS:
        raise TypeError(f"uniform takes a float dtype of "
                        f"{sorted(map(str, _FLOAT_BITS))}; got {dtype}")
    nbits, nmant, one = _FLOAT_BITS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    if nbits == 64:
        b1, b2 = _words(key, shape, device)
        # The 64-bit word shifted right by 12, from its two halves (an
        # int64 shift of the whole word would carry the sign).
        mant = (b1 << (32 - (64 - nmant))) | (b2 >> (64 - nmant))
    else:
        mant = random_bits(key, rng_bits, shape, device) \
            >> (rng_bits - nmant)
    floats = (mant | one).to(_INT_VIEW[nbits]).view(dtype) - 1.0
    lo = torch.tensor(minval, dtype=dtype, device=floats.device)
    hi = torch.tensor(maxval, dtype=dtype, device=floats.device)
    if dtype == torch.bfloat16:
        # XLA computes bfloat16 in float32 and rounds after each op.
        return torch.maximum(lo, floats * (hi - lo) + lo)
    # Otherwise XLA contracts ``floats * (hi - lo) + lo`` into one fused
    # multiply-add.  Below float64 the product is exact in float64, so
    # one rounding from there is the fused result.
    wide = torch.float64
    scaled = (floats.to(wide) * (hi - lo).to(wide) + lo.to(wide)).to(dtype)
    return torch.maximum(lo, scaled)


def gumbel(key, shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, dtype)`` in its default "low"
    mode: ``-log(-log(u))`` of ``u = uniform(key, shape, dtype,
    finfo.tiny, 1)``, each step rounded to ``dtype`` as XLA rounds it.
    The logarithms are torch's and may differ from XLA's in the last
    bit: the noise is bitwise the JAX package's in bfloat16 (the
    serving dtype) and within one ulp of its scale in float32 and
    float64 (eight in float16), while the uniforms under it are bitwise
    equal."""
    u = uniform(key, shape, dtype, torch.finfo(dtype).tiny, 1.0, device)
    return -torch.log(-torch.log(u))


def gumbel_scores(key, logits) -> torch.Tensor:
    """``logits`` plus Gumbel noise in their dtype, the scores
    :func:`categorical` takes the argmax of, the noise drawn over the
    logits' whole shape.  A ``(rows, 2)`` key tensor draws row ``r`` of
    ``(rows, vocab)`` logits with its own key over ``(vocab,)``, so each
    row is what ``gumbel_scores(key[r], logits[r:r + 1])`` gives."""
    if isinstance(key, torch.Tensor):
        if logits.dim() != 2 or key.shape != (logits.shape[0], 2):
            raise ValueError(
                f"a key table draws (rows, vocab) logits with one (rows, 2) "
                f"key per row; got keys {tuple(key.shape)}, logits "
                f"{tuple(logits.shape)}")
        noise = gumbel(key, logits.shape[1:], logits.dtype)
    else:
        noise = gumbel(key, logits.shape, logits.dtype, logits.device)
    return noise + logits


def categorical(key, logits, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)``: the Gumbel-max draw
    ``argmax(gumbel + logits)`` along ``axis`` (the first maximal index
    on ties).  A ``(rows, 2)`` key tensor draws each row of ``(rows,
    vocab)`` logits with its own key, along the last axis (see
    :func:`gumbel_scores`)."""
    if isinstance(key, torch.Tensor) and axis not in (-1, 1):
        raise ValueError(f"a key table draws along the last axis; got axis "
                         f"{axis}")
    return torch.argmax(gumbel_scores(key, logits), dim=axis)
