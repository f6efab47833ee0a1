"""Functional optimizers: the port's counterpart of the two optax
transforms its ZeRO recipes use.

The JAX package's ZeRO helpers take any optax ``GradientTransformation``
(``opt.init(params) -> state``; ``opt.update(grads, state, params) ->
(updates, state)``, the new parameters being ``params + updates``).  The
port cannot import optax, so it keeps its own functional counterpart of
:func:`sgd` and :func:`adam`, working on the port's trees of tensors
(``utils/tree.py``) with optax 0.2.6's order of operations and state
dtypes: the moments and the momentum trace in the parameter dtype, every
scalar cast to the tensor's dtype before it multiplies (as JAX's
weakly-typed Python scalars are), and Adam's step count a Python int
(optax keeps an int32 scalar).

``torch.optim``'s classes do not fit: they update parameters in place
and keep their state inside the optimizer object, while ZeRO needs the
pure ``(shards, state) -> (new shards, new state)`` step that runs on a
rank's shards and hands the state back.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from .tree import tree_map

__all__ = ["Optimizer", "AdamState", "sgd", "adam"]


class Optimizer(NamedTuple):
    """An ``(init, update)`` pair with optax's calling convention."""
    init: Any
    update: Any


class AdamState(NamedTuple):
    count: int
    mu: Any
    nu: Any


def _c(value: float, like):
    """``value`` as a scalar of ``like``'s dtype."""
    return torch.tensor(value, dtype=like.dtype)


def _scale(updates, step_size: float):
    return tree_map(lambda g: _c(step_size, g) * g, updates)


def sgd(learning_rate: float, momentum: Optional[float] = None) -> Optimizer:
    """``optax.sgd(learning_rate, momentum)``: with ``momentum`` the
    trace ``t = g + momentum * t`` is the update, then every update is
    scaled by ``-learning_rate``.  The state is the trace (a tree shaped
    like the parameters), or None without momentum."""

    def init(params):
        if momentum is None:
            return None
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params=None):
        if momentum is not None:
            state = tree_map(lambda g, t: g + _c(momentum, t) * t, grads,
                             state)
            grads = state
        return _scale(grads, -learning_rate), state

    return Optimizer(init, update)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """``optax.adam(learning_rate, b1, b2, eps)``:
    ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, both
    bias-corrected by ``1 - b^count`` (computed in double precision, then
    cast to the moment's dtype), the update ``mu_hat / (sqrt(nu_hat) +
    eps)`` scaled by ``-learning_rate``."""

    def init(params):
        return AdamState(count=0, mu=tree_map(torch.zeros_like, params),
                         nu=tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        mu = tree_map(lambda g, t: _c(1 - b1, g) * g + _c(b1, t) * t,
                      grads, state.mu)
        nu = tree_map(lambda g, t: _c(1 - b2, g) * (g * g) + _c(b2, t) * t,
                      grads, state.nu)
        count = state.count + 1
        bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
        updates = tree_map(
            lambda m, v: (m / _c(bc1, m))
            / (torch.sqrt(v / _c(bc2, v)) + _c(eps, v)), mu, nu)
        return _scale(updates, -learning_rate), AdamState(count, mu, nu)

    return Optimizer(init, update)
