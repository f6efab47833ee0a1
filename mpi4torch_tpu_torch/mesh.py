"""Rank <-> mesh-coordinate convention (port of ``mpi4torch_tpu/mesh.py``).

:func:`mesh_coords` and :func:`rank_of_coords` fix how a flat rank maps
onto a virtual mesh: row-major, the LAST mesh axis varying fastest.  The
reshard planner's layouts (:mod:`mpi4torch_tpu_torch.reshard`) key off
it, so a world of 8 rank threads reads as the ``(2, 4)`` mesh the same
way in both packages.

The device meshes of the JAX package (:func:`device_mesh`,
:func:`hybrid_mesh`) return ``jax.sharding.Mesh`` objects for the
compiled backend; they are not ported yet and raise.
"""

from __future__ import annotations

import math
from typing import Sequence

__all__ = ["device_mesh", "hybrid_mesh", "mesh_coords", "rank_of_coords"]


def mesh_coords(rank: int, mesh_shape: Sequence[int]) -> tuple:
    """Row-major mesh coordinates of a flat rank: the last mesh axis
    varies fastest."""
    rank = int(rank)
    total = math.prod(mesh_shape)
    if not (0 <= rank < total):
        raise ValueError(f"rank {rank} out of range for mesh "
                         f"{tuple(mesh_shape)} ({total} ranks)")
    coords = []
    for m in reversed(tuple(mesh_shape)):
        coords.append(rank % m)
        rank //= m
    return tuple(reversed(coords))


def rank_of_coords(coords: Sequence[int], mesh_shape: Sequence[int]) -> int:
    """Inverse of :func:`mesh_coords`: the flat rank of row-major mesh
    coordinates."""
    coords, mesh_shape = tuple(coords), tuple(mesh_shape)
    if len(coords) != len(mesh_shape):
        raise ValueError(
            f"coords {coords} do not match mesh {mesh_shape}")
    r = 0
    for c, m in zip(coords, mesh_shape):
        if not (0 <= int(c) < m):
            raise ValueError(f"coords {coords} out of mesh {mesh_shape}")
        r = r * m + int(c)
    return r


def device_mesh(axes, *, devices=None):
    """A device mesh over one slice: not ported yet (raises)."""
    raise NotImplementedError(
        "device_mesh: device meshes come with the compiled/device backend "
        "(ROADMAP.md, Queue 1 item 4)")


def hybrid_mesh(ici_axes, dcn_axes, *, devices=None):
    """A two-tier device mesh: not ported yet (raises)."""
    raise NotImplementedError(
        "hybrid_mesh: device meshes come with the compiled/device backend "
        "(ROADMAP.md, Queue 1 item 4)")
