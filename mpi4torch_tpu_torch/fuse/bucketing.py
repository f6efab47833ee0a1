"""Tree → flat-bucket layouts for the fused collectives.

Port of ``mpi4torch_tpu/fuse/bucketing.py``.  The DP/ZeRO recipes would
issue one collective per tree leaf; the fused forms flatten the tree into
a few **dtype-homogeneous flat buckets** of ~``bucket_bytes`` each and
run one collective per bucket.

* :func:`bucket_layout` computes a :class:`BucketLayout` for a tree
  *structure* — which leaf lands in which bucket at which offset.  It is
  ``functools.lru_cache``'d on ``(treedef, leaf shapes and dtypes,
  bucket_bytes)``, the tree flattened as ``utils/tree.py`` walks it (the
  JAX package's pytree order), so re-flattening the same gradient tree
  every step costs a dictionary lookup.
* :func:`flatten_buckets` / :func:`unflatten_buckets` move values
  between the tree and the buckets with ``torch.cat`` and
  ``torch.split``, both differentiable, so the adjoint of "flatten →
  collective → unflatten" is "flatten → adjoint collective → unflatten".

Bucket assignment is greedy in leaf order, per dtype: a leaf joins its
dtype's open bucket unless that would push the bucket past
``bucket_bytes`` (then a fresh bucket opens).  A leaf larger than
``bucket_bytes`` gets a bucket of its own — leaves are never split, so
every leaf maps to one contiguous ``[offset, offset+size)`` slot of one
bucket, and a bucket's slots tile it in leaf order.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, List, Sequence, Tuple

import torch

from ..utils.tree import tree_flatten, tree_from_structure


@dataclass(frozen=True)
class LeafSlot:
    """Where one leaf lives: bucket ``bucket``, elements
    ``[offset, offset + size)``, restored to ``shape``/``dtype``."""
    bucket: int
    offset: int
    size: int
    shape: Tuple[int, ...]
    dtype: Any


@dataclass(frozen=True)
class BucketLayout:
    """Full placement of a tree structure into flat buckets."""
    treedef: Any
    slots: Tuple[LeafSlot, ...]          # one per leaf, in tree order
    bucket_sizes: Tuple[int, ...]        # elements per bucket
    bucket_dtypes: Tuple[Any, ...]
    bucket_bytes: int

    @property
    def num_buckets(self) -> int:
        return len(self.bucket_sizes)


def _leaf_avals(leaves) -> Tuple[Tuple[Tuple[int, ...], Any], ...]:
    """Hashable (shape, dtype) signature per leaf; anything with
    ``.shape`` and ``.dtype`` (a tensor, a meta tensor) serves as a
    template leaf."""
    return tuple((tuple(l.shape), l.dtype) for l in leaves)


@functools.lru_cache(maxsize=512)
def _layout(treedef, avals, bucket_bytes: int) -> BucketLayout:
    open_bucket = {}                      # dtype -> (bucket idx, fill elems)
    sizes: List[int] = []
    dtypes: List[Any] = []
    slots: List[LeafSlot] = []
    for shape, dtype in avals:
        n = math.prod(shape)
        itemsize = dtype.itemsize
        cur = open_bucket.get(dtype)
        if cur is not None:
            b, fill = cur
            if (fill + n) * itemsize > bucket_bytes and fill > 0:
                cur = None                # would overflow: close it
        if cur is None:
            b, fill = len(sizes), 0
            sizes.append(0)
            dtypes.append(dtype)
        slots.append(LeafSlot(bucket=b, offset=fill, size=n,
                              shape=shape, dtype=dtype))
        fill += n
        sizes[b] = fill
        open_bucket[dtype] = (b, fill)
    return BucketLayout(treedef=treedef, slots=tuple(slots),
                        bucket_sizes=tuple(sizes),
                        bucket_dtypes=tuple(dtypes),
                        bucket_bytes=int(bucket_bytes))


def bucket_layout(tree, bucket_bytes: int) -> BucketLayout:
    """The (cached) :class:`BucketLayout` for ``tree``'s structure."""
    leaves, treedef = tree_flatten(tree)
    return _layout(treedef, _leaf_avals(leaves), int(bucket_bytes))


def _bucket_members(slots, nbuckets: int) -> List[List[int]]:
    members: List[List[int]] = [[] for _ in range(nbuckets)]
    for j, s in enumerate(slots):
        members[s.bucket].append(j)
    return members


def flatten_buckets(tree, bucket_bytes: int):
    """``tree -> (buckets, layout)``: the list of 1-D dtype-homogeneous
    flat buckets holding every leaf, plus the layout to undo it."""
    leaves, treedef = tree_flatten(tree)
    layout = _layout(treedef, _leaf_avals(leaves), int(bucket_bytes))
    parts: List[List[Any]] = [[] for _ in layout.bucket_sizes]
    for leaf, slot in zip(leaves, layout.slots):
        parts[slot.bucket].append(leaf.reshape(-1))
    buckets = [p[0] if len(p) == 1 else torch.cat(p) for p in parts]
    return buckets, layout


def unflatten_buckets(buckets: Sequence, layout: BucketLayout):
    """Inverse of :func:`flatten_buckets` (over possibly-transformed
    bucket values of the same sizes and dtypes)."""
    leaves: List[Any] = [None] * len(layout.slots)
    for b, members in enumerate(_bucket_members(layout.slots,
                                                layout.num_buckets)):
        parts = buckets[b].split([layout.slots[j].size for j in members])
        for j, part in zip(members, parts):
            leaves[j] = part.reshape(layout.slots[j].shape)
    return tree_from_structure(layout.treedef, leaves)


# ---------------------------------------------------------------------------
# Sharded layouts: buckets whose rows are rank segments
# ---------------------------------------------------------------------------
#
# The ZeRO wire pattern works on per-leaf shards: each leaf is flattened,
# zero-padded to a multiple of the communicator size n, and rank r owns
# segment r (parallel/zero.py).  The fused forms pack many leaves'
# segments into one (n, total_per_rank) block bucket so one
# Reduce_scatter (axis 0, n rows) or one Allgather delivers every leaf's
# shard at once: row r is the concatenation, in slot order, of each
# leaf's r-th segment.


@dataclass(frozen=True)
class ShardSlot:
    bucket: int
    offset: int        # within a row, in elements
    per_rank: int      # ceil(leaf.size / n)
    size: int          # unpadded leaf element count
    shape: Tuple[int, ...]
    dtype: Any


@dataclass(frozen=True)
class ShardLayout:
    treedef: Any
    slots: Tuple[ShardSlot, ...]
    row_sizes: Tuple[int, ...]           # per-rank elements per bucket
    bucket_dtypes: Tuple[Any, ...]
    nranks: int
    bucket_bytes: int

    @property
    def num_buckets(self) -> int:
        return len(self.row_sizes)


@functools.lru_cache(maxsize=512)
def _shard_layout(treedef, avals, nranks: int,
                  bucket_bytes: int) -> ShardLayout:
    open_bucket = {}
    rows: List[int] = []
    dtypes: List[Any] = []
    slots: List[ShardSlot] = []
    for shape, dtype in avals:
        n = math.prod(shape)
        per = -(-n // nranks)             # ceil-padded per-rank length
        itemsize = dtype.itemsize
        cur = open_bucket.get(dtype)
        if cur is not None:
            b, fill = cur
            # The budget counts the full padded leaf (n ranks x per), the
            # block bucket's actual footprint.
            if (fill + per) * nranks * itemsize > bucket_bytes and fill > 0:
                cur = None
        if cur is None:
            b, fill = len(rows), 0
            rows.append(0)
            dtypes.append(dtype)
        slots.append(ShardSlot(bucket=b, offset=fill, per_rank=per,
                               size=n, shape=shape, dtype=dtype))
        fill += per
        rows[b] = fill
        open_bucket[dtype] = (b, fill)
    return ShardLayout(treedef=treedef, slots=tuple(slots),
                       row_sizes=tuple(rows), bucket_dtypes=tuple(dtypes),
                       nranks=int(nranks), bucket_bytes=int(bucket_bytes))


def shard_layout(tree, nranks: int, bucket_bytes: int) -> ShardLayout:
    leaves, treedef = tree_flatten(tree)
    return _shard_layout(treedef, _leaf_avals(leaves), int(nranks),
                         int(bucket_bytes))


def flatten_shard_buckets(tree, nranks: int, bucket_bytes: int):
    """``tree -> (block buckets, layout)``: each bucket has shape
    ``(nranks, row_size)`` — row r holds every member leaf's (zero-padded)
    r-th segment, so a single axis-0 Reduce_scatter delivers rank r all
    of its leaf shards in one collective."""
    leaves, treedef = tree_flatten(tree)
    layout = _shard_layout(treedef, _leaf_avals(leaves), int(nranks),
                           int(bucket_bytes))
    parts: List[List[Any]] = [[] for _ in layout.row_sizes]
    for leaf, slot in zip(leaves, layout.slots):
        flat = leaf.reshape(-1)
        padded = slot.per_rank * nranks
        if padded != slot.size:
            flat = torch.cat([flat, flat.new_zeros(padded - slot.size)])
        parts[slot.bucket].append(flat.reshape(nranks, slot.per_rank))
    buckets = [p[0] if len(p) == 1 else torch.cat(p, dim=1)
               for p in parts]
    return buckets, layout


def unflatten_shard_rows(rows: Sequence, layout: ShardLayout):
    """Split per-rank bucket rows (shape ``(row_size,)`` each) back into
    the tree of flat per-leaf shards (length ``per_rank`` each) — the
    representation :func:`~mpi4torch_tpu_torch.parallel.zero.zero_step`
    updates."""
    leaves: List[Any] = [None] * len(layout.slots)
    for b, members in enumerate(_bucket_members(layout.slots,
                                                layout.num_buckets)):
        parts = rows[b].split([layout.slots[j].per_rank for j in members])
        for j, part in zip(members, parts):
            leaves[j] = part
    return tree_from_structure(layout.treedef, leaves)


def flatten_shard_rows(shard_tree, layout: ShardLayout):
    """Inverse of :func:`unflatten_shard_rows`: pack a tree of flat
    per-leaf shards into per-bucket rows of ``row_size`` elements.  The
    shard tree must have the layout's (the template's) structure; a
    mismatch raises rather than misassign shards to slots."""
    leaves, treedef = tree_flatten(shard_tree)
    if treedef != layout.treedef:
        raise ValueError(
            f"shard tree structure {treedef} does not match the layout's "
            f"template structure {layout.treedef}; rebuild the shards "
            "from the current template (zero3_shard_params)")
    parts: List[List[Any]] = [[] for _ in layout.row_sizes]
    for leaf, slot in zip(leaves, layout.slots):
        flat = leaf.reshape(-1)
        if flat.shape[0] != slot.per_rank:
            raise ValueError(
                f"shard of {flat.shape[0]} elements where the template "
                f"expects {slot.per_rank} (leaf shape {slot.shape}); the "
                "shard tree does not belong to this template")
        parts[slot.bucket].append(flat)
    return [p[0] if len(p) == 1 else torch.cat(p) for p in parts]


def unflatten_gathered(full_rows: Sequence, layout: ShardLayout):
    """From per-bucket gathered blocks of shape ``(nranks, row_size)``
    back to the tree of full leaves: leaf j is the concatenation over
    ranks of its segment column, unpadded and reshaped."""
    leaves: List[Any] = [None] * len(layout.slots)
    for b, members in enumerate(_bucket_members(layout.slots,
                                                layout.num_buckets)):
        cols = full_rows[b].split([layout.slots[j].per_rank
                                   for j in members], dim=1)
        for j, block in zip(members, cols):
            s = layout.slots[j]
            leaves[j] = block.reshape(-1)[:s.size].reshape(s.shape)
    return tree_from_structure(layout.treedef, leaves)
