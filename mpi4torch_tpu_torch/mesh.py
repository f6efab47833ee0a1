"""Rank <-> mesh-coordinate convention (port of ``mpi4torch_tpu/mesh.py``).

:func:`mesh_coords` and :func:`rank_of_coords` fix how a flat rank maps
onto a virtual mesh: row-major, the LAST mesh axis varying fastest.  The
reshard planner's layouts (:mod:`mpi4torch_tpu_torch.reshard`) key off
it, so a world of 8 rank threads reads as the ``(2, 4)`` mesh the same
way in both packages.

:func:`device_mesh` and :func:`hybrid_mesh` build the port's
:class:`Mesh` (axis names, sizes and the device of each rank) for
``run_spmd(mesh=...)`` and ``comm_from_mesh``.  One recorded difference
from the JAX package: without ``devices=`` every rank of the mesh gets
the world's one device, since rank threads share a card.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "device_mesh", "hybrid_mesh", "mesh_coords",
           "rank_of_coords"]


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


class Mesh:
    """A named device mesh: ``axis_names`` (outermost first), ``shape``
    (axis name -> size) and ``devices``, an object array of
    ``torch.device`` of that shape (row-major, the last axis fastest).
    The port's counterpart of ``jax.sharding.Mesh``, for
    :func:`~mpi4torch_tpu_torch.ops.spmd.run_spmd` and
    :func:`~mpi4torch_tpu_torch.comm_from_mesh`."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"a {arr.ndim}-d device array for axis names "
                             f"{names}")
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [torch.device(d) for d in arr.reshape(-1)]
        self.axis_names = names
        self.devices = flat.reshape(arr.shape)
        self.shape = dict(zip(names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, devices="
                f"{sorted({str(d) for d in self.devices.reshape(-1)})})")


def _check_sizes(shape: Mapping[str, int], n: int, what: str) -> None:
    total = math.prod(shape.values())
    if total != n:
        raise ValueError(
            f"{what} axis sizes {dict(shape)} multiply to {total}, but "
            f"{n} devices are available")


def _default_devices(n: int) -> list:
    """One device repeated for every rank: every rank of a mesh without
    ``devices=`` is a thread on the world's device (CUDA; the JAX package
    gives each rank its own device)."""
    from .runtime import resolve_device
    return [resolve_device(None)] * n


def device_mesh(axes: Mapping[str, int], *,
                devices: Optional[Sequence] = None) -> Mesh:
    """A :class:`Mesh` over one host.

    ``axes`` maps axis name -> size, in significance order: the LAST axis
    varies fastest over the device order, so put the axis with the
    heaviest collective traffic (usually TP or SP) last and DP first.
    With ``devices=`` the sizes must multiply to their number (the JAX
    package's check); without, every rank gets the world's one device
    (rank threads share a card), a deliberate difference from the JAX
    package, which needs distinct devices."""
    if devices is None:
        devices = _default_devices(math.prod(axes.values()))
    _check_sizes(axes, len(devices), "device_mesh")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(tuple(axes.values())), tuple(axes.keys()))


def hybrid_mesh(ici_axes: Mapping[str, int], dcn_axes: Mapping[str, int],
                *, devices: Optional[Sequence] = None) -> Mesh:
    """A :class:`Mesh` with explicit tier assignment: the ``dcn_axes``
    cross the slow tier (their total size must equal the number of
    granules), the ``ici_axes`` stay inside one.  The mesh carries the
    DCN axes first, then the ICI axes: ``hybrid_mesh({"tp": 4},
    {"dp": 2})`` has axis names ``("dp", "tp")``.

    Rank threads of one process are one granule, so every ``dcn_axes``
    size must be 1 and the call degrades to :func:`device_mesh`, as the
    JAX package does on one slice."""
    both = {**dcn_axes, **ici_axes}
    if len(both) != len(dcn_axes) + len(ici_axes):
        raise ValueError(
            f"axis names must be disjoint between tiers; got ICI "
            f"{tuple(ici_axes)} and DCN {tuple(dcn_axes)}")
    if devices is None:
        devices = _default_devices(math.prod(both.values()))
    _check_sizes(both, len(devices), "hybrid_mesh")
    dcn_total = math.prod(dcn_axes.values())
    if dcn_total != 1:
        raise ValueError(
            f"dcn axes {dict(dcn_axes)} require {dcn_total} "
            "slices/processes but all devices are in one granule — "
            "move those factors to ici_axes (single-slice) or launch "
            "multi-process (init_distributed)")
    return device_mesh(both, devices=devices)
