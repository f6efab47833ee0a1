"""Partition rules: regex -> Layout over whole parameter trees.

Port of ``mpi4torch_tpu/reshard/rules.py``.  Instead of writing a Layout
per leaf of a transformer state tree, write a short ordered rule list;
the first regex that matches the leaf's ``/``-joined tree path wins::

    rules = [
        (r"embed",        reshard.layout((2, 4), (0, 1))),   # rows
        (r"blocks/\\d+/wo", reshard.layout((2, 4), 0, 1)),
        (r".*",           reshard.layout((2, 4), None)),      # replicate
    ]
    to_specs = reshard.match_partition_rules(rules, params)
    sharded = comm.Reshard(shards, from_specs, to_specs)

Paths read as the JAX package's do (``blocks/0/wo``: dictionary keys and
list indices joined by ``/``).  Scalar leaves never partition: they take
the replicated layout of the first rule's mesh.
"""

from __future__ import annotations

import math
import re
from typing import Sequence, Tuple

import numpy as np

from ..runtime import CommError
from ..utils.tree import tree_map
from .plan import Layout

__all__ = ["tree_paths", "match_partition_rules"]


def _shape(leaf) -> Tuple[int, ...]:
    shape = getattr(leaf, "shape", None)
    return tuple(shape) if shape is not None else np.shape(leaf)


def tree_paths(tree, sep: str = "/"):
    """A tree of ``tree``'s structure whose leaves are the ``sep``-joined
    key paths (``{"a": {"b": [x]}} -> "a/b/0"``)."""

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, prefix + (str(i),))
                              for i, v in enumerate(node))
        return sep.join(prefix)

    return walk(tree, ())


def match_partition_rules(rules: Sequence[Tuple[str, Layout]], tree,
                          sep: str = "/"):
    """A Layout tree for ``tree``: each leaf takes the first rule whose
    regex ``re.search``-matches its path.  Scalar (0-d or 1-element)
    leaves take the replicated form of the first rule's mesh; a leaf no
    rule matches raises (a silent default would shard a tensor the
    author never considered)."""
    rules = [(p, lay) for p, lay in rules]
    if not rules:
        raise CommError("match_partition_rules needs at least one rule")
    mesh = rules[0][1].mesh

    def pick(path, leaf):
        shape = _shape(leaf)
        if len(shape) == 0 or math.prod(shape) == 1:
            return Layout(mesh, ((),) * len(shape))
        for pattern, lay in rules:
            if re.search(pattern, path) is not None:
                if lay.ndim != len(shape):
                    raise CommError(
                        f"rule {pattern!r} assigns a {lay.ndim}-axis "
                        f"layout to {path!r} of shape {shape}")
                return lay
        raise CommError(f"no partition rule matches leaf {path!r} "
                        f"(shape {shape}); add a catch-all rule")

    return tree_map(pick, tree_paths(tree, sep), tree)
