"""Parameter trees: nested dictionaries, lists and tuples of tensors.

The JAX package keeps parameters as pytrees and maps over them with
``jax.tree.map``; the port keeps the same nested layout and walks it
here in the JAX package's pytree order — dictionary keys sorted, then
list order — so leaves and gradients line up with each other and with
the JAX package's leaves.  Rebuilt dictionaries keep their keys'
insertion order.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in traversal order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf, in traversal order, to ``tree`` and
    trees of the same structure ``rest``; the result has ``tree``'s
    structure."""
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_structure(tree):
    """A hashable description of ``tree``'s structure (the counterpart of
    a JAX treedef): two trees with equal structures flatten to the same
    number of leaves in corresponding places."""
    if isinstance(tree, dict):
        return (dict, tuple(tree),
                tuple(tree_structure(tree[k]) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(tree_structure(v) for v in tree))
    return None


def tree_flatten(tree):
    """``(leaves, treedef)``: :func:`tree_leaves` and
    :func:`tree_structure` of ``tree``."""
    return tree_leaves(tree), tree_structure(tree)


def tree_from_structure(treedef, leaves):
    """Inverse of :func:`tree_flatten`: a tree of structure ``treedef``
    holding ``leaves`` in traversal order."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        if d[0] is dict:
            keys = d[1]
            vals = {k: build(c) for k, c in zip(sorted(keys), d[2])}
            return {k: vals[k] for k in keys}
        return d[0]([build(c) for c in d[1]])

    return build(treedef)


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
