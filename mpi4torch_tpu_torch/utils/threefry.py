"""Threefry-2x32 random bits, bit-exact with ``jax.random``.

The JAX package draws the stochastic-rounding noise of the ``q8_ef_hop``
codec from ``jax.random`` keys (``ops/quant_kernels.schedule_key`` and
``hop_noise``), so the port must reproduce those bits to keep its
compressed Allreduce bitwise equal to the reference.  This module is a
plain-PyTorch threefry-2x32 (Salmon et al., SC'11, 20 rounds) with the
three functions that path calls, matching ``jax.random`` under
``jax_threefry_partitionable=True`` (the default since jax 0.5):

* :func:`PRNGKey` — a key is a pair of 32-bit words, ``PRNGKey(s)`` is
  ``(s >> 32, s & 0xFFFFFFFF)``;
* :func:`fold_in` — the hash of the counter pair ``(0, d)`` under the key;
* :func:`uniform` — float32 in [0, 1): each flat index ``i`` hashes the
  counters ``(i >> 32, i & 0xFFFFFFFF)``, the two output words are
  XOR-ed, and ``(bits >> 9) | 0x3F800000`` read as a float, minus 1.

Words are carried in int64 tensors masked to 32 bits, because arithmetic
on ``torch.uint32`` is not supported alike on every device.  The same
code runs on the CPU and on the card and gives the same bits on both.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: int, k2: int, x1, x2):
    """The threefry-2x32 hash of the counter pairs ``(x1, x2)`` under the
    key ``(k1, k2)``; the counters are Python ints or int64 tensors of
    32-bit words, and so are the two returned words."""
    ks = (k1 & _MASK, k2 & _MASK, (k1 ^ k2 ^ _PARITY) & _MASK)
    x1, x2 = (x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def PRNGKey(seed: int):
    """The key ``jax.random.PRNGKey(seed)`` holds, as two Python ints."""
    seed = int(seed)
    return ((seed >> 32) & _MASK, seed & _MASK)


def fold_in(key, data: int):
    """``jax.random.fold_in(key, data)`` for a non-negative 32-bit
    ``data``."""
    return threefry2x32(key[0], key[1], 0, int(data) & _MASK)


def uniform(key, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, jnp.float32)``: float32 samples
    in [0, 1) of ``shape`` on ``device``."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & _MASK)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(shape)
