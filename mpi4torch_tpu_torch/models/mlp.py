"""Data-parallel MLP: the minimal end-to-end training slice.

Port of ``mpi4torch_tpu/models/mlp.py``.  The loss holds one
communication call, the parameter-averaging Allreduce of
:func:`~mpi4torch_tpu_torch.parallel.dp.dp_loss`, whose adjoint sums the
per-rank gradients, so N ranks on N data shards stay in lock-step with
one rank on the whole data.  Parameters are a list of ``(w, b)`` pairs,
``w`` shaped ``(in, out)`` and used as ``x @ w``, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..runtime import resolve_device
from ..utils.tree import tree_map


def init_params(generator, sizes: Sequence[int], dtype=torch.float32,
                device=None) -> List:
    """Normal weights over ``sqrt(fan_in)`` and zero biases for an MLP of
    layer widths ``sizes``.  ``generator`` is a ``torch.Generator`` on
    ``device`` or an integer seed; the numbers differ from the JAX
    package's, whose generator differs."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    params = []
    for m, n in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((m, n), generator=generator, dtype=dtype,
                        device=dev) / math.sqrt(m)
        params.append((w, torch.zeros(n, dtype=dtype, device=dev)))
    return params


def params_from_jax(params, device, dtype=None) -> List:
    """The port's parameters from the JAX package's (a list of ``(w, b)``
    pairs with numpy leaves): the same layout, each leaf a tensor on
    ``device`` (cast to ``dtype`` when given)."""
    def leaf(a):
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=device, dtype=dtype or t.dtype)
    return [(leaf(w), leaf(b)) for w, b in params]


def apply(params, x):
    """Forward pass with tanh-form GELU hidden activations (the form of
    ``jax.nn.gelu``'s default)."""
    for w, b in params[:-1]:
        x = F.gelu(x @ w + b, approximate="tanh")
    w, b = params[-1]
    return x @ w + b


def local_loss(params, batch):
    """Mean squared error on the rank-local batch ``(x, y)``."""
    x, y = batch
    return torch.mean((apply(params, x) - y) ** 2)


def dp_loss(comm, params, batch):
    """The global data-parallel loss
    (:func:`~mpi4torch_tpu_torch.parallel.dp.dp_loss`)."""
    from ..parallel import dp as _dp
    return _dp.dp_loss(comm, local_loss, params, batch)


def dp_train_step(comm, params, batch, lr: float = 1e-2) -> Tuple:
    """One SGD step on the data-parallel loss; returns ``(loss,
    new_params)``."""
    from ..parallel import dp as _dp
    loss, grads = _dp.dp_value_and_grad(comm, local_loss)(params, batch)
    with torch.no_grad():
        new_params = tree_map(lambda p, g: p - lr * g, params, grads)
    return loss, new_params
