"""Parameter trees: nested dictionaries, lists and tuples of tensors.

The JAX package keeps parameters as pytrees and maps over them with
``jax.tree.map``; the port keeps the same nested layout and walks it
here, always in one order (dictionary insertion order, then list order),
so leaves and gradients line up.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in traversal order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and trees of the same
    structure ``rest``; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def value_and_grad(fn: Callable, params, *args):
    """``(fn(params, *args), d fn / d params)`` for a scalar ``fn``: the
    counterpart of ``jax.value_and_grad``.  The gradient is a tree shaped
    like ``params``, zero for a leaf ``fn`` does not read (as in JAX);
    the value is detached."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    value = fn(tree_unflatten(params, leaves), *args)
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return value.detach(), tree_unflatten(params, grads)
